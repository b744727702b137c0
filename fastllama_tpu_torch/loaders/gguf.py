"""GGUF (llama.cpp) checkpoint reader.

Port of ``fastllama_tpu/loaders/gguf.py`` (numpy only), the equivalent of
the C++ engine's GGUF loader (``gguf_loader.cpp``): parses the
``general.*`` / ``llama.*`` / ``tokenizer.ggml.*`` metadata keys
(gguf_loader.cpp:246-318), the tensor-name -> weight map
(gguf_loader.cpp:347-373), and supports F32, F16 and Q8_0 tensor data.
Q8_0 blocks (fp16 scale + 32 x int8) are repacked into separate data/scales
arrays with group size 32 (the C++ engine does the same repack,
gguf_loader.cpp:467-476, and sets quant_group_size=32 at
gguf_loader.cpp:239).

Written against the public GGUF v2/v3 spec — not a translation of the C++.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

from fastllama_tpu_torch.config import ModelConfig, QuantType
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer, VocabType

GGUF_MAGIC = 0x46554747  # "GGUF"

# gguf metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, _T_STR, \
    _T_ARR, _T_U64, _T_I64, _T_F64 = range(13)

_SCALAR_FMT = {_T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
               _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_BOOL: "<B",
               _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d"}

# ggml tensor types
GGML_F32, GGML_F16 = 0, 1
GGML_Q8_0 = 8
Q8_0_BLOCK = 32


def is_gguf(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return struct.unpack("<I", f.read(4))[0] == GGUF_MAGIC
    except (OSError, struct.error):
        return False


def _read_str(f) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f, vtype: int):
    if vtype == _T_STR:
        return _read_str(f)
    if vtype == _T_ARR:
        (etype,) = struct.unpack("<I", f.read(4))
        (n,) = struct.unpack("<Q", f.read(8))
        if etype == _T_STR:
            return [_read_str(f) for _ in range(n)]
        fmt = _SCALAR_FMT[etype]
        size = struct.calcsize(fmt)
        raw = f.read(size * n)
        return list(struct.unpack(f"<{n}{fmt[-1]}", raw))
    fmt = _SCALAR_FMT[vtype]
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]


def _repack_q8_0(raw: bytes, shape) -> Tuple[np.ndarray, np.ndarray]:
    """Q8_0: blocks of (fp16 scale, 32 int8) -> (int8 data, f32 scales)."""
    blk = np.frombuffer(raw, dtype=np.dtype([("d", "<f2"), ("q", "i1", (Q8_0_BLOCK,))]))
    data = blk["q"].reshape(shape)
    n_last = shape[-1] // Q8_0_BLOCK
    scales = blk["d"].astype(np.float32).reshape(*shape[:-1], n_last)
    return data, scales


def load_gguf(path: str, tokenizer_only: bool = False
              ) -> Tuple[ModelConfig, dict, Tokenizer]:
    with open(path, "rb") as f:
        magic, version = struct.unpack("<2I", f.read(8))
        if magic != GGUF_MAGIC:
            raise ValueError(f"not a GGUF file: {path}")
        if version < 2:
            # v1 strings are u32-length; _read_str parses v2+ u64 — a v1
            # file would misparse into garbage, so reject it explicitly
            raise ValueError(f"unsupported GGUF version {version} (< 2)")
        n_tensors, n_kv = struct.unpack("<2Q", f.read(16))

        meta: Dict[str, object] = {}
        for _ in range(n_kv):
            key = _read_str(f)
            (vtype,) = struct.unpack("<I", f.read(4))
            meta[key] = _read_value(f, vtype)

        infos = []
        for _ in range(n_tensors):
            name = _read_str(f)
            (nd,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{nd}Q", f.read(8 * nd))
            gtype, offset = struct.unpack("<IQ", f.read(12))
            # ggml dims are innermost-first; numpy shape is the reverse
            infos.append((name, tuple(reversed(dims)), gtype, offset))

        align = int(meta.get("general.alignment", 32))
        data_start = f.tell()
        data_start += (-data_start) % align

        arch = str(meta.get("general.architecture", "llama"))
        p = arch  # key prefix
        cfg = ModelConfig(
            quant_type=QuantType.NONE,   # F32/F16 file; Q8_0 replaces below
            dim=int(meta[f"{p}.embedding_length"]),
            hidden_dim=int(meta[f"{p}.feed_forward_length"]),
            n_layers=int(meta[f"{p}.block_count"]),
            n_heads=int(meta[f"{p}.attention.head_count"]),
            n_kv_heads=int(meta.get(f"{p}.attention.head_count_kv",
                                    meta[f"{p}.attention.head_count"])),
            vocab_size=len(meta.get("tokenizer.ggml.tokens", []))
            or int(meta.get(f"{p}.vocab_size", 0)),
            max_seq_len=int(meta[f"{p}.context_length"]),
            rope_theta=float(meta.get(f"{p}.rope.freq_base", 10000.0)),
            norm_eps=float(meta.get(f"{p}.attention.layer_norm_rms_epsilon", 1e-5)),
            name=str(meta.get("general.name", "")),
        )

        tok = Tokenizer(vocab_type=VocabType.SPM
                        if meta.get("tokenizer.ggml.model") == "llama"
                        else VocabType.BPE)
        tok.index_texts = list(meta.get("tokenizer.ggml.tokens", []))
        tok.scores = [float(s) for s in meta.get("tokenizer.ggml.scores", [])]
        tok.types = [int(t) for t in meta.get("tokenizer.ggml.token_type", [])]
        tok.bos_token_id = int(meta.get("tokenizer.ggml.bos_token_id", 1))
        tok.eos_token_id = int(meta.get("tokenizer.ggml.eos_token_id", 2))
        tok.pad_token_id = int(meta.get("tokenizer.ggml.padding_token_id", -1))
        tok.finalize()
        if tokenizer_only:
            return cfg, {}, tok

        name_map = {  # gguf name -> our field (gguf_loader.cpp:347-373)
            "token_embd.weight": "embedding",
            "output_norm.weight": "out_norm",
            "output.weight": "classifier",
        }
        layer_map = {
            "attn_norm": "attn_norm", "attn_q": "wq", "attn_k": "wk",
            "attn_v": "wv", "attn_output": "wo", "ffn_norm": "ffn_norm",
            "ffn_gate": "w1", "ffn_down": "w2", "ffn_up": "w3",
        }

        per_layer: Dict[str, dict] = {}
        glob: Dict[str, object] = {}
        used_q8 = False
        for name, shape, gtype, offset in infos:
            f.seek(data_start + offset)
            n = int(np.prod(shape))
            if gtype == GGML_F32:
                val = np.frombuffer(f.read(4 * n), dtype="<f4").reshape(shape)
            elif gtype == GGML_F16:
                val = np.frombuffer(f.read(2 * n), dtype="<f2").reshape(shape) \
                    .astype(np.float32)
            elif gtype == GGML_Q8_0:
                raw = f.read(n // Q8_0_BLOCK * 34)
                val = _repack_q8_0(raw, shape)
                used_q8 = True
            else:
                raise ValueError(
                    f"unsupported GGML type {gtype} for {name} "
                    "(supported: F32, F16, Q8_0 — like the C++ engine, "
                    "gguf_loader.cpp:403-409)")
            if name in name_map:
                glob[name_map[name]] = val
            elif name.startswith("blk."):
                _, lid, rest = name.split(".", 2)
                field = layer_map.get(rest.rsplit(".", 1)[0])
                if field:
                    per_layer.setdefault(field, {})[int(lid)] = val

        if used_q8:
            cfg = cfg.replace(quant_type=QuantType.INT8, group_size=Q8_0_BLOCK)

    from fastllama_tpu_torch.loaders.registry import stack_layers
    weights: Dict[str, object] = dict(glob)
    weights.update(stack_layers(per_layer, cfg.n_layers))
    if "classifier" not in weights:
        weights["classifier"] = weights["embedding"]
    return cfg, weights, tok
