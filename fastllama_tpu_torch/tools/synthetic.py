"""Synthetic tiny checkpoints + vocab for tests and offline demos (port of
``fastllama_tpu/tools/synthetic.py``; numpy, the same values): the
stand-in for stories110M-style fixtures, with no download."""
from __future__ import annotations

import numpy as np

from fastllama_tpu_torch.config import ModelConfig
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer, TokenType

TINY = ModelConfig(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                   vocab_size=512, max_seq_len=64)


def tiny_weights(cfg: ModelConfig = TINY, seed: int = 0, scale: float = 0.08
                 ) -> dict:
    """fp32 weights dict in the interleaved (Meta) convention — what a
    llama2.c / FLM file stores on disk."""
    rng = np.random.default_rng(seed)
    L, D, H, V = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.vocab_size
    kd, nh, hs = cfg.kv_dim, cfg.n_heads, cfg.head_size

    def w(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return dict(
        embedding=w(V, D), attn_norm=(1 + 0.1 * w(L, D)),
        wq=w(L, nh * hs, D), wk=w(L, kd, D), wv=w(L, kd, D),
        wo=w(L, D, nh * hs), ffn_norm=(1 + 0.1 * w(L, D)),
        w1=w(L, H, D), w2=w(L, D, H), w3=w(L, H, D),
        out_norm=(1 + 0.1 * w(D)), classifier=w(V, D),
    )


def tiny_tokenizer(vocab_size: int = 512) -> Tokenizer:
    """SPM-style vocab: <unk>/<s>/</s> + 256 byte tokens + ▁-prefixed words
    and merge fragments, enough for real BPE merges in tests."""
    tk = Tokenizer()
    texts = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    scores = [0.0] * len(texts)
    types = [TokenType.UNKNOWN, TokenType.CONTROL, TokenType.CONTROL] \
        + [TokenType.BYTE] * 256
    words = ["▁", "▁the", "▁a", "▁and", "▁to", "▁of", "▁in", "▁was",
             "▁he", "▁she", "▁it", "▁that", "▁on", "▁for", "▁story",
             "th", "he", "the", "an", "nd", "and", "▁t", "▁th", "▁s", "▁w",
             "▁o", "on", "or", "ory", "st", "to", "▁st", "▁sto", "at", "▁c",
             "▁cat", "er", "▁dog", "ing", "ed", "▁b", "▁boy", "y", "s", "a",
             "e", "i", "o", "u", "t", "h", "n", "d", "r", "l", "c", "b", "g",
             "w", "f", "m", "p"]
    for j, piece in enumerate(words):
        texts.append(piece)
        scores.append(float(len(piece) * 10 + j))  # longer pieces win merges
        types.append(TokenType.NORMAL)
    while len(texts) < vocab_size:
        texts.append(f"<extra_{len(texts)}>")
        scores.append(-1e9)
        types.append(TokenType.UNUSED)
    tk.index_texts, tk.scores, tk.types = texts[:vocab_size], \
        scores[:vocab_size], types[:vocab_size]
    return tk.finalize()


def write_tiny_llama2c(dirpath: str, cfg: ModelConfig = TINY, seed: int = 0):
    """Create model.bin + tokenizer.bin in llama2.c format; returns paths."""
    import os
    from fastllama_tpu_torch.loaders.llama2c import (
        write_llama2c, write_llama2c_tokenizer)
    os.makedirs(dirpath, exist_ok=True)
    ckpt = os.path.join(dirpath, "model.bin")
    tokp = os.path.join(dirpath, "tokenizer.bin")
    # tiny_weights has a distinct classifier -> unshared (negative vocab_size)
    write_llama2c(ckpt, cfg, tiny_weights(cfg, seed), shared_classifier=False)
    write_llama2c_tokenizer(tokp, tiny_tokenizer(cfg.vocab_size))
    return ckpt, tokp
