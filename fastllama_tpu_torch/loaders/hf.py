"""HuggingFace checkpoint directory loader (safetensors / pytorch .bin).

Port of ``fastllama_tpu/loaders/hf.py``: ``config.json`` (rope scaling
among it), the tokenizer (``tokenizer.model`` through ``sentencepiece``
where it is installed, else ``tokenizer.json``) and the weights, loaded
directly; conversion to FLM is optional (``tools/convert.py``).

``.safetensors`` shards are read by :func:`read_safetensors`, a small
reader of the format (an 8-byte little-endian header length, a JSON
header, then raw little-endian data), so no ``safetensors`` package is
needed.  ``.bin`` shards load through ``torch.load(..., weights_only=True)``.

HF q/k projections are already in the rotate-half convention the runtime
uses, so no permutation happens.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, Tuple

import numpy as np

from fastllama_tpu_torch.config import ModelConfig, QuantType
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer, TokenType, VocabType

_HF_LAYER_MAP = {
    "input_layernorm.weight": "attn_norm",
    "self_attn.q_proj.weight": "wq",
    "self_attn.k_proj.weight": "wk",
    "self_attn.v_proj.weight": "wv",
    "self_attn.o_proj.weight": "wo",
    "post_attention_layernorm.weight": "ffn_norm",
    "mlp.gate_proj.weight": "w1",
    "mlp.down_proj.weight": "w2",
    "mlp.up_proj.weight": "w3",
}


def is_hf_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json"))


def _config_from_json(d: dict) -> ModelConfig:
    """config.json key mapping (the C++ converter's), plus HF
    ``rope_scaling`` -> the engine's YaRN knobs (ops/rope.py)."""
    n_heads = int(d["num_attention_heads"])
    rope = dict(rope_freq_scale=1.0, rope_ext_factor=0.0,
                rope_attn_factor=1.0, rope_orig_ctx=0)
    rs = d.get("rope_scaling") or {}
    rtype = str(rs.get("rope_type", rs.get("type", ""))).lower()
    if rtype in ("linear",):
        rope["rope_freq_scale"] = 1.0 / float(rs.get("factor", 1.0))
    elif rtype in ("yarn",):
        factor = float(rs.get("factor", 1.0))
        rope["rope_freq_scale"] = 1.0 / factor
        rope["rope_ext_factor"] = 1.0
        if "attention_factor" in rs and rs["attention_factor"] is not None:
            # HF semantics: an explicit attention_factor REPLACES the
            # 1 + 0.1*ln(factor) formula; the runtime always multiplies the
            # formula in (the C++ engine's rope_v2 semantics), so
            # compensate here
            import math
            rope["rope_attn_factor"] = (float(rs["attention_factor"])
                                        / (1.0 + 0.1 * math.log(factor)))
        rope["rope_orig_ctx"] = int(
            rs.get("original_max_position_embeddings", 0))
    # other rope_type values (e.g. llama3) are left as plain RoPE for now
    return ModelConfig(
        quant_type=QuantType.NONE,       # fp32/bf16 checkpoint
        dim=int(d["hidden_size"]),
        hidden_dim=int(d["intermediate_size"]),
        n_layers=int(d["num_hidden_layers"]),
        n_heads=n_heads,
        n_kv_heads=int(d.get("num_key_value_heads", n_heads)),
        vocab_size=int(d["vocab_size"]),
        max_seq_len=int(d.get("max_position_embeddings", 2048)),
        rope_theta=float(d.get("rope_theta", 10000.0)),
        norm_eps=float(d.get("rms_norm_eps", 1e-5)),
        name=str(d.get("_name_or_path", "") or d.get("model_type", "")),
        **rope,
    )


# the dtypes a safetensors file's numpy view reads (the ``safetensors``
# package's ``framework="np"`` path); bfloat16 has no numpy dtype there
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
              "I32": "<i4", "I16": "<i2", "I8": "i1", "U64": "<u8",
              "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file, by name, in file order:
    an 8-byte little-endian header size, a JSON header of ``{name:
    {"dtype", "shape", "data_offsets": [begin, end]}}`` (and an optional
    ``__metadata__``), then the data, offsets counted from its start.
    Raises ValueError naming a dtype it does not read."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n).decode("utf-8"))
        base = 8 + n
        out = {}
        entries = sorted(((k, v) for k, v in header.items()
                          if k != "__metadata__"),
                         key=lambda kv: kv[1]["data_offsets"][0])
        for name, info in entries:
            dt = _ST_DTYPES.get(info["dtype"])
            if dt is None:
                raise ValueError(f"{path}: tensor {name} has dtype "
                                 f"{info['dtype']}, which the safetensors "
                                 f"reader does not read")
            begin, end = info["data_offsets"]
            shape = tuple(int(d) for d in info["shape"])
            f.seek(base + begin)
            raw = f.read(end - begin)
            arr = np.frombuffer(raw, dtype=np.dtype(dt))
            if arr.size != int(np.prod(shape)):
                raise ValueError(f"{path}: tensor {name} holds {arr.size} "
                                 f"values, not the {shape} of its header")
            out[name] = arr.reshape(shape)
    return out


def _iter_state_dict(path: str):
    """Yield (name, np.ndarray) from safetensors shards or pytorch .bin."""
    st_files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if st_files:
        for fn in st_files:
            yield from read_safetensors(os.path.join(path, fn)).items()
        return
    bin_files = sorted(f for f in os.listdir(path)
                       if f.startswith("pytorch_model") and f.endswith(".bin"))
    if not bin_files:
        raise FileNotFoundError(f"no safetensors/.bin weights under {path}")
    import torch
    for fn in bin_files:
        sd = torch.load(os.path.join(path, fn), map_location="cpu",
                        weights_only=True)
        for key, t in sd.items():
            yield key, t.to(torch.float32).numpy()


def _load_hf_tokenizer(path: str, vocab_size: int) -> Tokenizer:
    """Prefer tokenizer.model (sentencepiece), fall back to tokenizer.json."""
    spm_path = os.path.join(path, "tokenizer.model")
    if os.path.exists(spm_path):
        try:
            import sentencepiece as spm
            sp = spm.SentencePieceProcessor(model_file=spm_path)
            tk = Tokenizer(vocab_type=VocabType.SPM)
            n = sp.get_piece_size()
            tk.index_texts = [sp.id_to_piece(i) for i in range(n)]
            tk.scores = [sp.get_score(i) for i in range(n)]
            tk.types = [TokenType.BYTE if sp.is_byte(i)
                        else TokenType.CONTROL if sp.is_control(i)
                        else TokenType.UNKNOWN if sp.is_unknown(i)
                        else TokenType.NORMAL for i in range(n)]
            tk.bos_token_id = sp.bos_id()
            tk.eos_token_id = sp.eos_id()
            tk.pad_token_id = sp.pad_id()
            return tk.finalize()
        except ImportError:
            pass
    tj = os.path.join(path, "tokenizer.json")
    if os.path.exists(tj):
        with open(tj, encoding="utf-8") as f:
            data = json.load(f)
        vocab = data.get("model", {}).get("vocab", {})
        tk = Tokenizer(vocab_type=VocabType.BPE)
        items = sorted(vocab.items(), key=lambda kv: kv[1])
        tk.index_texts = [k for k, _ in items]
        tk.scores = [-float(i) for i in range(len(items))]
        return tk.finalize()
    return Tokenizer().finalize()


def load_hf(path: str, tokenizer_only: bool = False
            ) -> Tuple[ModelConfig, dict, Tokenizer]:
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        cfg = _config_from_json(json.load(f))
    tok = _load_hf_tokenizer(path, cfg.vocab_size)
    if tokenizer_only:
        return cfg, {}, tok

    L = cfg.n_layers
    per_layer: Dict[str, dict] = {}
    weights: Dict[str, np.ndarray] = {}
    for name, arr in _iter_state_dict(path):
        arr = np.asarray(arr)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        if name == "model.embed_tokens.weight":
            weights["embedding"] = arr
        elif name == "model.norm.weight":
            weights["out_norm"] = arr
        elif name == "lm_head.weight":
            weights["classifier"] = arr
        elif name.startswith("model.layers."):
            parts = name.split(".", 3)
            lid = int(parts[2])
            field = _HF_LAYER_MAP.get(parts[3])
            if field:
                per_layer.setdefault(field, {})[lid] = arr
    for field, layers in per_layer.items():
        weights[field] = np.stack([layers[i] for i in range(L)])
    if "classifier" not in weights:
        weights["classifier"] = weights["embedding"]  # tied embeddings
    return cfg, weights, tok
