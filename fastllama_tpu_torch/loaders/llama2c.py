"""Karpathy llama2.c checkpoint loader (stories110M et al).

Port of ``fastllama_tpu/loaders/llama2c.py`` (numpy only).

Format (the C++ engine's ``llama2c_loader.cpp``): 7 little-endian int32s
(dim, hidden_dim, n_layers, n_heads, n_kv_heads, vocab_size, max_seq_len) —
negative vocab_size means an unshared classifier — followed by fp32 tensors
in order: token_embedding, attn_norm, wq, wk, wv, wo, ffn_norm, w1, w2, w3,
out_norm, rope freq_cis real+imag (ignored; RoPE is recomputed, as in
the C++ engine's rope_v2 path), then the classifier unless shared.

The C++ engine quantizes each tensor to INT8 while streaming it in; here
quantize-on-load happens in ``models.llama.build_params`` after the
registry normalizes conventions.
"""
from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np

from fastllama_tpu_torch.config import ModelConfig, QuantType
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer


def is_llama2c(path: str) -> bool:
    """Header plausibility check (the C++ engine's)."""
    try:
        with open(path, "rb") as f:
            raw = f.read(28)
        if len(raw) < 28:
            return False
        d, h, l, nh, nkv, v, s = struct.unpack("<7i", raw)
        return (512 <= d <= 64000 and 512 <= h <= 64000 and 0 < l < 512
                and 4 <= nh <= 1024 and 1 <= nkv <= nh
                and 1000 <= abs(v) < (256 << 10))
    except OSError:
        return False


def load_llama2c(ckpt_path: str, tokenizer_path: str = "",
                 tokenizer_only: bool = False) -> Tuple[ModelConfig, dict, Tokenizer]:
    with open(ckpt_path, "rb") as f:
        d, h, L, nh, nkv, v, s = struct.unpack("<7i", f.read(28))
        shared = v > 0
        v = abs(v)
        cfg = ModelConfig(dim=d, hidden_dim=h, n_layers=L, n_heads=nh,
                          n_kv_heads=nkv, vocab_size=v, max_seq_len=s,
                          quant_type=QuantType.NONE)  # fp32 checkpoint
        cfg.validate()
        hs, kd = cfg.head_size, cfg.kv_dim

        tok = Tokenizer.from_llama2c_bin(tokenizer_path, v) if tokenizer_path \
            else Tokenizer().finalize()
        if tokenizer_only:
            return cfg, {}, tok

        size = os.fstat(f.fileno()).st_size
        at = [28]

        def rd(*shape):
            # a read-only map of the file: the pages a caller slices are
            # read, and processes sharing the file share them
            n = int(np.prod(shape))
            if at[0] + 4 * n > size:
                raise ValueError(f"truncated llama2.c file {ckpt_path}")
            arr = np.memmap(ckpt_path, dtype="<f4", mode="r",
                            offset=at[0], shape=(n,))
            at[0] += 4 * n
            return arr.reshape(shape)

        w = {}
        w["embedding"] = rd(v, d)
        w["attn_norm"] = rd(L, d)
        w["wq"] = rd(L, nh * hs, d)
        w["wk"] = rd(L, kd, d)
        w["wv"] = rd(L, kd, d)
        w["wo"] = rd(L, d, nh * hs)
        w["ffn_norm"] = rd(L, d)
        w["w1"] = rd(L, h, d)
        w["w2"] = rd(L, d, h)
        w["w3"] = rd(L, h, d)
        w["out_norm"] = rd(d)
        rd(s, hs // 2)  # freq_cis_real — unused
        rd(s, hs // 2)  # freq_cis_imag — unused
        w["classifier"] = w["embedding"] if shared else rd(v, d)
    return cfg, w, tok


def write_llama2c(ckpt_path: str, cfg: ModelConfig, weights: dict,
                  shared_classifier: bool = True) -> None:
    """Write the llama2.c format (for tests and synthetic checkpoints).
    ``weights`` must be fp32 numpy in the interleaved RoPE convention."""
    with open(ckpt_path, "wb") as f:
        v = cfg.vocab_size if shared_classifier else -cfg.vocab_size
        f.write(struct.pack("<7i", cfg.dim, cfg.hidden_dim, cfg.n_layers,
                            cfg.n_heads, cfg.n_kv_heads, v, cfg.max_seq_len))
        order = ["embedding", "attn_norm", "wq", "wk", "wv", "wo",
                 "ffn_norm", "w1", "w2", "w3", "out_norm"]
        for name in order:
            np.ascontiguousarray(weights[name], dtype="<f4").tofile(f)
        # rope freq tables (real, imag) — present in the format
        hs = cfg.head_size
        pos = np.arange(cfg.max_seq_len, dtype=np.float32)[:, None]
        freqs = cfg.rope_theta ** (
            -np.arange(hs // 2, dtype=np.float32) * 2.0 / hs)[None, :]
        np.cos(pos * freqs).astype("<f4").tofile(f)
        np.sin(pos * freqs).astype("<f4").tofile(f)
        if not shared_classifier:
            np.ascontiguousarray(weights["classifier"], dtype="<f4").tofile(f)


def write_llama2c_tokenizer(path: str, tokenizer: Tokenizer) -> None:
    with open(path, "wb") as f:
        max_len = max((len(t.encode("utf-8")) for t in tokenizer.index_texts),
                      default=0)
        f.write(struct.pack("<i", max_len))
        for text, score in zip(tokenizer.index_texts, tokenizer.scores):
            raw = text.encode("utf-8")
            f.write(struct.pack("<fi", score, len(raw)))
            f.write(raw)
