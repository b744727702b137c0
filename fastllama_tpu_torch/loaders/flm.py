"""FLM (fast-llama native) container format: reader and writer.

Port of ``fastllama_tpu/loaders/flm.py``: byte-compatible with the C++
engine's self-describing block container (its ``flm_loader.cpp`` reader
and ``convert_flm.py`` writer), and the same bytes as the JAX package's
``write_flm`` on the same inputs.  ``write_flm`` also takes torch tensors
(on any device) and per-layer mappings, so a 7B file is written one layer
at a time:

* file header: u32 tag 0xFA571AEA + version u8,u8,u16
* BASE_ITEM blocks: 4B header {block_type, data_type, header_size,
  data_size}, value inline (4B values at offset 4, 8B values at offset 8
  after 4B pad), NUL-terminated name, padded to 8
* medium blocks (DICT/TENSOR/STRING): 16B header {4B base, name_offset u8,
  name_size u8, tail_pad u16, data_size u64} + optional header_data
  (tensors: shape u32[4] + tensor_type u16 + layer_id u16 + scales_size u32)
  + name + head padding, then data (+ tail pad).  Tensor data = raw values
  followed by fp32 group scales.
* "model_config" DICT of BASE_ITEMs, "tokenizer" DICT with the TokenizerHeader
  layout of flm_loader.cpp:452-462, per-layer TENSOR blocks.

Tensors are stored in the C++ engine's **interleaved** RoPE convention (its
converter permutes HF->interleaved), so files are interchangeable with that
engine; the registry deinterleaves Wq/Wk after loading.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from fastllama_tpu_torch.config import (ActivationType, ModelArchitecture,
                                  ModelConfig, QuantType)
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
from fastllama_tpu_torch.quant.groupquant import (pack_int4_np, quantize,
                                                  unpack_int4_np)

FLM_FILE_TAG = 0xFA571AEA
# files containing DT_INT4X extension blocks use this tag so the C++
# loader (which only checks the tag, flm_loader.cpp:575) fails cleanly
# instead of misparsing the unknown data type
FLM_FILE_TAG_X4 = 0xFA571AEB

# BlockType (flm_loader.cpp:22-30)
BT_BASE_ITEM, BT_DICT, BT_TENSOR, BT_ARRAY, BT_STRING, BT_STRING_ARRAY = range(6)

# DataType (flm_loader.cpp:32-46)
DT_NONE, DT_INT8, DT_INT16, DT_INT32, DT_INT64 = 0, 1, 2, 3, 4
DT_UINT8, DT_UINT16, DT_UINT32, DT_UINT64 = 5, 6, 7, 8
DT_FLOAT16, DT_FLOAT32, DT_FLOAT64, DT_BLOCK = 10, 11, 12, 15
# EXTENSION (ours): packed INT4 tensor data — Bit4Pair bytes (low nibble =
# even element, high = odd, quant_operators.h:25-31) with the block's shape4
# holding the LOGICAL shape.  The C++ engine's DataType enum tops out at
# BLOCK=15 but its loader maps unknown data_types to QuantType::NONE and
# falls back to fp32 byte counts (flm_loader.cpp:32-46) — it would MISPARSE
# an INT4 block rather than reject it — so INT4 files are written under a
# distinct file tag (FLM_FILE_TAG_X4) the C++ loader refuses outright
# (flm_loader.cpp:575).  INT8/INT16 files keep the standard tag and remain
# fully interchangeable.
DT_INT4X = 20

_DT_NP = {DT_INT8: np.int8, DT_INT16: np.int16, DT_INT32: np.int32,
          DT_UINT8: np.uint8, DT_FLOAT16: np.float16, DT_FLOAT32: np.float32}

# TensorType (flm_loader.cpp:48-65)
TT_NONE, TT_EMBD, TT_OUT_NORM, TT_CLS = 0, 1, 2, 3
TT_LAYER = 16
TT_IN_NORM, TT_Q, TT_K, TT_V, TT_O = 17, 18, 19, 20, 21
TT_GATE, TT_UP, TT_DOWN, TT_POST_NORM = 22, 23, 24, 25

_TT_TO_FIELD = {
    TT_EMBD: "embedding", TT_OUT_NORM: "out_norm", TT_CLS: "classifier",
    TT_IN_NORM: "attn_norm", TT_Q: "wq", TT_K: "wk", TT_V: "wv", TT_O: "wo",
    TT_GATE: "w1", TT_DOWN: "w2", TT_UP: "w3", TT_POST_NORM: "ffn_norm",
}

SPECIAL_MAX = 8  # SpecialTokenType::MAX (tokenizer.h:30-36)


def is_flm(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return struct.unpack("<I", f.read(4))[0] in (FLM_FILE_TAG,
                                                         FLM_FILE_TAG_X4)
    except (OSError, struct.error):
        return False


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _pad8(b: bytes) -> bytes:
    return b + b"\x00" * (-len(b) % 8)


class _Writer:
    def __init__(self, fh):
        self.f = fh

    def base_item(self, name: str, value, data_type: int) -> None:
        """convert_flm.py:583-631 layout."""
        nm = name.encode("utf-8") + b"\x00"
        if data_type in (DT_INT64, DT_UINT64, DT_FLOAT64):
            data = struct.pack("<q" if data_type == DT_INT64 else
                               "<Q" if data_type == DT_UINT64 else "<d", value)
        elif data_type == DT_FLOAT32:
            data = struct.pack("<f", value)
        else:
            data = struct.pack("<i", int(value))
        ds = len(data)
        item_size = (8 if ds <= 4 else 16) + len(nm)
        header_size = (item_size + 7) & ~7
        out = struct.pack("<4B", BT_BASE_ITEM, data_type, header_size, ds)
        if ds > 4:
            out += b"\x00" * 4
        out += data + b"\x00" * ((4 - ds) if ds <= 4 else (8 - ds))
        out += nm + b"\x00" * (header_size - item_size)
        self.f.write(out)

    def block(self, name: str, data: bytes, block_type: int,
              data_type: int = DT_NONE, align: int = 8,
              header_data: bytes = b"") -> None:
        """convert_flm.py:698-748 layout."""
        file_pos = self.f.tell()
        nm = (name.encode("utf-8") + b"\x00") if name else b""
        name_size = max(0, len(nm) - 1)
        hd = _pad8(header_data) if header_data else b""
        name_offset = 16 + len(hd)
        header_size = name_offset + len(nm)
        head_pad = (-(file_pos + header_size)) % align
        header_size += head_pad
        block_size = (header_size + len(data) + align - 1) & ~(align - 1)
        tail_pad = block_size - header_size - len(data)
        self.f.write(struct.pack("<4B2BHQ", block_type, data_type, header_size,
                                 len(hd), name_offset, name_size, tail_pad,
                                 len(data)))
        self.f.write(hd + nm + b"\x00" * head_pad + data + b"\x00" * tail_pad)

    def tensor(self, name: str, arr: np.ndarray, scales: Optional[np.ndarray],
               tensor_type: int, layer_id: int = 0, align: int = 64,
               data_type: Optional[int] = None,
               logical_shape: Optional[tuple] = None) -> None:
        dt = data_type if data_type is not None else \
            {np.dtype(np.int8): DT_INT8, np.dtype(np.int16): DT_INT16,
             np.dtype(np.float32): DT_FLOAT32}[arr.dtype]
        data = arr.tobytes()
        scales_size = 0
        if scales is not None:
            scales_size = scales.size
            data += scales.astype("<f4").tobytes()
        shape = logical_shape if logical_shape is not None else arr.shape
        shape4 = list(shape[:4]) + [0] * (4 - len(shape))
        hd = struct.pack("<4I2HI", *shape4, tensor_type, layer_id, scales_size)
        self.block(name, data, BT_TENSOR, dt, align, hd)


def _serialize_tokenizer(tk: Tokenizer) -> bytes:
    """convert_flm.py:942-1016 layout."""
    def enc(s: str) -> bytes:
        return _pad8(s.encode("utf-8") + b"\x00")

    tokn, text = b"", b""
    for i, t in enumerate(tk.index_texts):
        idx_pos = len(text)
        text += enc(t)
        if t.startswith(tk.conn_tag):
            show_pos = len(text)
            text += enc(" " + t[len(tk.conn_tag):])
        else:
            show_pos = idx_pos
        tokn += struct.pack("<3if", idx_pos, show_pos,
                            tk.types[i] if tk.types else 1, tk.scores[i])
    conn_pos = len(text)
    text += enc(tk.conn_tag)
    specials = [-1] * SPECIAL_MAX
    specials[1], specials[2], specials[3] = (tk.bos_token_id, tk.eos_token_id,
                                             tk.pad_token_id)
    head = struct.pack("<2I", tk.vocab_type, conn_pos)
    head += struct.pack(f"<{SPECIAL_MAX}i", *specials)
    head += struct.pack("<2I", tk.vocab_size, len(text))
    return head + tokn + text


_CONFIG_KEYS = [  # names load_config matches (flm_loader.cpp:399-429)
    ("name", str), ("model_type", int), ("act_type", int), ("vocab_size", int),
    ("dim", int), ("hidden_dim", int), ("n_heads", int), ("n_kv_heads", int),
    ("n_layers", int), ("max_length", int), ("rope_theta", float),
    ("rms_norm_eps", float), ("quant_type", int), ("quant_group_size", int),
]


def _serialize_config(cfg: ModelConfig, qtype: QuantType) -> bytes:
    import io
    buf = io.BytesIO()
    w = _Writer(buf)
    vals = dict(
        name=cfg.name or "model", model_type=cfg.arch.value,
        act_type=cfg.act_type.value, vocab_size=cfg.vocab_size, dim=cfg.dim,
        hidden_dim=cfg.hidden_dim, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, n_layers=cfg.n_layers,
        max_length=cfg.max_seq_len, rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.norm_eps, quant_type=_qt_to_flm(qtype),
        quant_group_size=cfg.group_size,
    )
    for key, typ in _CONFIG_KEYS:
        v = vals[key]
        if typ is str:
            w.block(key, v.encode("utf-8") + b"\x00", BT_STRING, DT_INT8)
        elif typ is float:
            w.base_item(key, float(v), DT_FLOAT32)
        else:
            w.base_item(key, int(v), DT_INT32)
    return buf.getvalue()


def _qt_to_flm(qt: QuantType) -> int:
    # the C++ QuantType enum order: NONE=0, INT16=1, INT8=2, INT4=3
    return {QuantType.NONE: 0, QuantType.INT16: 1, QuantType.INT8: 2,
            QuantType.INT4: 3}[qt]


def _qt_from_flm(v: int) -> QuantType:
    return {0: QuantType.NONE, 1: QuantType.INT16, 2: QuantType.INT8,
            3: QuantType.INT4}[v]


def permute_qk_to_interleaved(w: np.ndarray, n_heads: int) -> np.ndarray:
    """Half (HF) -> interleaved (Meta/FLM) row permutation per head.  Unlike
    the C++ converter's permute_qk (convert_flm.py:1018-1023, which erroneously
    uses n_kv_heads for Q on GQA models), the caller passes the tensor's own
    head count."""
    out_dim = w.shape[0]
    return (w.reshape(n_heads, 2, out_dim // n_heads // 2, *w.shape[1:])
            .swapaxes(1, 2).reshape(w.shape))


def _f32(arr) -> torch.Tensor:
    """An fp32 numpy array (copied when read-only) or a torch tensor on
    any device, as an fp32 tensor on that device."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().to(torch.float32)
    return torch.from_numpy(np.require(arr, np.float32, "W"))


def write_flm(path: str, cfg: ModelConfig, tokenizer: Tokenizer,
              weights: Mapping[str, Any], qtype: QuantType,
              rope_convention: str = "half") -> None:
    """Write an FLM file the C++ engine can load.  ``weights``: fp32 numpy
    arrays or torch tensors in ``rope_convention`` ('half' = HF layout,
    permuted to interleaved on write); a per-layer field may be any
    object whose ``[l]`` gives layer ``l`` (such as a mapping that makes
    each layer when asked).  Torch tensors are quantized on their own
    device."""
    with open(path, "wb") as fh:
        tag = FLM_FILE_TAG_X4 if qtype == QuantType.INT4 else FLM_FILE_TAG
        fh.write(struct.pack("<IBBH", tag, 1, 0, 0))
        w = _Writer(fh)
        w.block("model_config", _serialize_config(cfg, qtype), BT_DICT)
        w.block("tokenizer", _serialize_tokenizer(tokenizer), BT_DICT)

        def dump(name, arr, tt, layer_id=0, quant=True):
            x = _f32(arr)
            if quant and qtype != QuantType.NONE and x.ndim > 1:
                # quantize on the CPU gives quantize_np's bits
                q = quantize(x, qtype, cfg.group_size)
                data, scales = q.data.cpu().numpy(), q.scales.cpu().numpy()
                if qtype == QuantType.INT4:
                    # extension block (DT_INT4X): Bit4Pair-packed values,
                    # logical shape in the header
                    w.tensor(name, pack_int4_np(data), scales, tt, layer_id,
                             data_type=DT_INT4X, logical_shape=data.shape)
                else:
                    w.tensor(name, data, scales, tt, layer_id)
            else:
                w.tensor(name, x.cpu().numpy(), None, tt, layer_id)

        def qk(key, l, n_heads):
            v = weights[key][l]
            return (permute_qk_to_interleaved(v, n_heads)
                    if rope_convention == "half" else v)

        # embedding stays fp32 like the C++ converter (needq excludes it)
        dump("model.embed_tokens.weight", weights["embedding"], TT_EMBD,
             quant=False)
        for l in range(cfg.n_layers):
            p = f"model.layers.{l}."
            dump(p + "input_layernorm.weight", weights["attn_norm"][l],
                 TT_IN_NORM, l, quant=False)
            dump(p + "self_attn.q_proj.weight", qk("wq", l, cfg.n_heads),
                 TT_Q, l)
            dump(p + "self_attn.k_proj.weight", qk("wk", l, cfg.n_kv_heads),
                 TT_K, l)
            dump(p + "self_attn.v_proj.weight", weights["wv"][l], TT_V, l)
            dump(p + "self_attn.o_proj.weight", weights["wo"][l], TT_O, l)
            dump(p + "post_attention_layernorm.weight",
                 weights["ffn_norm"][l], TT_POST_NORM, l, quant=False)
            dump(p + "mlp.gate_proj.weight", weights["w1"][l], TT_GATE, l)
            dump(p + "mlp.down_proj.weight", weights["w2"][l], TT_DOWN, l)
            dump(p + "mlp.up_proj.weight", weights["w3"][l], TT_UP, l)
        dump("model.norm.weight", weights["out_norm"], TT_OUT_NORM, quant=False)
        dump("lm_head.weight", weights["classifier"], TT_CLS)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class _Block:
    __slots__ = ("block_type", "data_type", "header_size", "hds", "name",
                 "data_size", "tail_pad", "shape", "tensor_type", "layer_id",
                 "scales_size", "value", "pos")


def _read_block(f) -> Optional[_Block]:
    pos = f.tell()
    hdr = f.read(8)
    if len(hdr) < 8:
        return None
    b = _Block()
    b.pos = pos
    b.block_type, b.data_type, b.header_size, b.hds = struct.unpack("<4B", hdr[:4])
    rest = f.read(b.header_size - 8)
    buf = hdr + rest
    if b.block_type == BT_BASE_ITEM:
        b.data_size = b.hds
        b.tail_pad = 0
        if b.hds <= 4:
            raw = buf[4:8]
            b.name = buf[8:].split(b"\x00")[0].decode("utf-8")
        else:
            raw = buf[8:16]
            b.name = buf[16:].split(b"\x00")[0].decode("utf-8")
        if b.data_type == DT_FLOAT32:
            b.value = struct.unpack("<f", raw[:4])[0]
        elif b.data_type == DT_FLOAT64:
            b.value = struct.unpack("<d", raw[:8])[0]
        elif b.data_type in (DT_INT64, DT_UINT64):
            b.value = struct.unpack("<q", raw[:8])[0]
        else:
            b.value = struct.unpack("<i", raw[:4])[0]
    else:
        name_offset, name_size, b.tail_pad, b.data_size = struct.unpack(
            "<2BHQ", buf[4:16])
        b.name = buf[name_offset:name_offset + name_size].decode("utf-8")
        if b.block_type == BT_TENSOR:
            sh = struct.unpack("<4I", buf[16:32])
            b.tensor_type, b.layer_id = struct.unpack("<2H", buf[32:36])
            b.scales_size = struct.unpack("<I", buf[36:40])[0]
            b.shape = tuple(v for v in sh if v > 0)
    return b


def _block_total(b: _Block) -> int:
    if b.block_type == BT_BASE_ITEM:
        return b.header_size
    return b.header_size + b.data_size + b.tail_pad


def _parse_config(data: bytes) -> Tuple[ModelConfig, QuantType]:
    import io
    f = io.BytesIO(data)
    kv = {}
    while True:
        b = _read_block(f)
        if b is None:
            break
        if b.block_type == BT_BASE_ITEM:
            kv[b.name] = b.value
        else:
            raw = f.read(b.data_size)
            f.read(b.tail_pad)
            if b.block_type == BT_STRING:
                kv[b.name] = raw.split(b"\x00")[0].decode("utf-8")
    qtype = _qt_from_flm(int(kv.get("quant_type", 0)))
    cfg = ModelConfig(
        dim=int(kv["dim"]), hidden_dim=int(kv["hidden_dim"]),
        n_layers=int(kv["n_layers"]), n_heads=int(kv["n_heads"]),
        n_kv_heads=int(kv.get("n_kv_heads") or kv["n_heads"]),
        vocab_size=int(kv["vocab_size"]), max_seq_len=int(kv["max_length"]),
        arch=ModelArchitecture(int(kv.get("model_type", 1))),
        act_type=ActivationType(int(kv.get("act_type", 2))),
        rope_theta=float(kv.get("rope_theta", 10000.0)),
        norm_eps=float(kv.get("rms_norm_eps", 1e-5)),
        quant_type=qtype,
        group_size=int(kv.get("quant_group_size", 64)),
        name=str(kv.get("name", "")),
    )
    return cfg, qtype


def _parse_tokenizer(data: bytes) -> Tokenizer:
    off = 0
    vocab_type, conn_pos = struct.unpack_from("<2I", data, off); off += 8
    specials = struct.unpack_from(f"<{SPECIAL_MAX}i", data, off)
    off += 4 * SPECIAL_MAX
    vocab_size, text_size = struct.unpack_from("<2I", data, off); off += 8
    items = np.frombuffer(data, dtype=np.dtype(
        [("idx", "<u4"), ("show", "<u4"), ("type", "<u4"), ("score", "<f4")]),
        count=vocab_size, offset=off)
    off += 16 * vocab_size
    text = data[off:off + text_size]

    def cstr(p: int) -> str:
        return text[p:text.index(b"\x00", p)].decode("utf-8", errors="replace")

    tk = Tokenizer(vocab_type=int(vocab_type))
    tk.index_texts = [cstr(int(p)) for p in items["idx"]]
    tk.show_texts = [cstr(int(p)) for p in items["show"]]
    tk.scores = [float(s) for s in items["score"]]
    tk.types = [int(t) for t in items["type"]]
    tk.conn_tag = cstr(int(conn_pos))
    if specials[1] >= 0:
        tk.bos_token_id = specials[1]
    if specials[2] >= 0:
        tk.eos_token_id = specials[2]
    tk.pad_token_id = specials[3]
    return tk.finalize()


def load_flm(path: str, tokenizer_only: bool = False
             ) -> Tuple[ModelConfig, dict, Tokenizer]:
    """Parse an FLM file into (config, weights dict, tokenizer).

    Quantized tensors come back as ``(data, scales)`` tuples; per-layer
    blocks are stacked into (L, ...) arrays.  Weights are in the interleaved
    RoPE convention (the registry converts)."""
    import os
    fsize = os.path.getsize(path)
    cfg = None
    qtype = QuantType.NONE
    tok = None
    per_layer: Dict[str, dict] = {}
    glob: Dict[str, object] = {}

    with open(path, "rb") as f:
        tag, v1, v2, v3 = struct.unpack("<IBBH", f.read(8))
        if tag not in (FLM_FILE_TAG, FLM_FILE_TAG_X4):
            raise ValueError(f"not an FLM file: {path}")
        while f.tell() < fsize:
            b = _read_block(f)
            if b is None:
                break
            nxt = b.pos + _block_total(b)
            if b.name == "model_config" and b.block_type == BT_DICT:
                cfg, qtype = _parse_config(f.read(b.data_size))
            elif b.name == "tokenizer" and b.block_type == BT_DICT:
                tok = _parse_tokenizer(f.read(b.data_size))
                if tokenizer_only:
                    return cfg, {}, tok
            elif b.block_type == BT_TENSOR:
                field = _TT_TO_FIELD.get(b.tensor_type)
                if field is None:
                    f.seek(nxt)
                    continue
                count = int(np.prod(b.shape))
                if b.data_type == DT_INT4X:
                    # extension: Bit4Pair bytes, logical shape in header
                    packed = np.frombuffer(f.read(count // 2), dtype=np.uint8)
                    arr = unpack_int4_np(packed).reshape(b.shape)
                else:
                    npdt = _DT_NP[b.data_type]
                    arr = np.frombuffer(f.read(count * npdt().itemsize),
                                        dtype=npdt).reshape(b.shape)
                scales = None
                if b.scales_size:
                    scales = np.frombuffer(f.read(b.scales_size * 4),
                                           dtype="<f4")
                    lead = int(np.prod(arr.shape[:-1]))
                    scales = scales.reshape(*arr.shape[:-1],
                                            b.scales_size // lead)
                val = arr if scales is None else (arr, scales)
                if b.tensor_type >= TT_LAYER:
                    per_layer.setdefault(field, {})[b.layer_id] = val
                else:
                    glob[field] = val
            f.seek(nxt)

    if cfg is None:
        raise ValueError(f"FLM file {path} has no model_config block")

    from fastllama_tpu_torch.loaders.registry import stack_layers
    weights: Dict[str, object] = dict(glob)
    weights.update(stack_layers(per_layer, cfg.n_layers))
    # norm tensors may arrive (1, dim) per layer — squeeze to (L, dim)
    for name in ("attn_norm", "ffn_norm"):
        if name in weights and not isinstance(weights[name], tuple):
            w = weights[name]
            if w.ndim == 3 and w.shape[1] == 1:
                weights[name] = w[:, 0, :]
    if "classifier" not in weights and "embedding" in weights:
        weights["classifier"] = weights["embedding"]  # shared
    return cfg, weights, tok or Tokenizer().finalize()
