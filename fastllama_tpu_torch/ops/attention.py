"""GQA attention, plain PyTorch (port of
``fastllama_tpu/ops/attention.py:26-209``).

``update_kv_cache`` writes new rows into one layer's cache in place at a
host position, ``update_kv_cache_at`` at device positions.
``gqa_attention`` is the prefill attention, which the JAX package also
computes outside Pallas; ``gqa_attention_batched`` its per-slot form.
``gqa_attention_decode_batched`` is the reference form of decode
attention with deferred cache writes (strict mask plus the fresh row), ``gqa_attention_spec_batched`` that of the batched
speculative verify (T rows per slot, a causal fresh block); the
flash-decode kernels and their plain versions live in
``ops/kernels/flash_decode.py``.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor, pos: int):
    """Write T new rows at [pos, pos+T), in place.  k_cache (n_kv, S, hs);
    k_new (n_kv, T, hs); ``pos`` a host int.  Raises when the rows do not
    fit (JAX's ``dynamic_update_slice`` clamps the start instead, which
    would overwrite valid history).  Returns the same two tensors."""
    T, S = k_new.shape[-2], k_cache.shape[-2]
    if not 0 <= pos <= S - T:
        raise ValueError(f"KV rows [{pos}, {pos + T}) do not fit a cache "
                         f"of {S} rows")
    k_cache[..., pos:pos + T, :] = k_new.to(k_cache.dtype)
    v_cache[..., pos:pos + T, :] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def update_kv_cache_at(k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       positions: torch.Tensor):
    """Write T new rows at the device ``positions`` (T,) along the row
    axis, in place: the same rows :func:`update_kv_cache` writes at a host
    int, without reading the position back.  The caller keeps the
    positions inside the cache (an index past it raises on the CPU and is
    undefined on the card).  Returns the same two tensors."""
    idx = positions.to(torch.long)
    k_cache.index_copy_(-2, idx, k_new.to(k_cache.dtype))
    v_cache.index_copy_(-2, idx, v_new.to(v_cache.dtype))
    return k_cache, v_cache


def gqa_attention(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: int = 0) -> torch.Tensor:
    """Masked GQA attention.  q (..., n_heads, T, hs) at absolute positions
    pos..pos+T-1; caches (..., n_kv, S, hs), rows >= pos+T stale.  Leading
    dims batch independent problems (prefill_many's block-diagonal
    attention).  All math in f32; returns q.dtype."""
    *lead, n_heads, T, hs = q.shape
    n_kv, S = k_cache.shape[-3], k_cache.shape[-2]
    hgs = n_heads // n_kv
    qf = q.reshape(*lead, n_kv, hgs, T, hs).to(torch.float32)
    kf = k_cache.to(torch.float32).unsqueeze(-3)          # (..., n_kv, 1, S, hs)
    vf = v_cache.to(torch.float32).unsqueeze(-3)
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(hs))
    s_idx = torch.arange(S, device=q.device)[None, :]
    t_idx = torch.arange(T, device=q.device)[:, None]
    mask = s_idx <= (t_idx + pos)                          # (T, S)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, vf)                          # (..., n_kv, hgs, T, hs)
    return out.reshape(*lead, n_heads, T, hs).to(q.dtype)


def gqa_attention_batched(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos: torch.Tensor
                          ) -> torch.Tensor:
    """Per-slot masked GQA attention (``fastllama_tpu/ops/attention.py:179``).
    q (B, n_heads, T, hs) at positions pos[b]..pos[b]+T-1; caches (B, n_kv,
    S, hs), slot b's rows >= pos[b]+T stale; pos (B,).  All math in f32;
    returns q.dtype."""
    B, n_heads, T, hs = q.shape
    n_kv, S = k_cache.shape[1], k_cache.shape[2]
    hgs = n_heads // n_kv
    qf = q.reshape(B, n_kv, hgs, T, hs).to(torch.float32)
    scores = torch.einsum("bkgth,bksh->bkgts", qf,
                          k_cache.to(torch.float32)) * (1.0 / math.sqrt(hs))
    s_idx = torch.arange(S, device=q.device)[None, None, :]
    t_idx = torch.arange(T, device=q.device)[None, :, None]
    mask = s_idx <= t_idx + pos.to(torch.long)[:, None, None]     # (B, T, S)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bksh->bkgth", probs, v_cache.to(torch.float32))
    return out.reshape(B, n_heads, T, hs).to(q.dtype)


def gqa_attention_decode_batched(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor,
                                 pos: torch.Tensor) -> torch.Tensor:
    """Single-token per-slot attention over cache rows [0, pos[b]) plus the
    fresh K/V row.  q (B, n_heads, hs); caches (B, n_kv, S, hs) already in
    float; k_new/v_new (B, n_kv, hs); pos (B,).  Returns (B, n_heads, hs)."""
    B, n_heads, hs = q.shape
    n_kv, S = k_cache.shape[1], k_cache.shape[2]
    hgs = n_heads // n_kv
    scale = 1.0 / math.sqrt(hs)
    qf = q.reshape(B, n_kv, hgs, hs).to(torch.float32)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    scores = torch.einsum("bkgh,bksh->bkgs", qf, kf) * scale
    mask = torch.arange(S, device=q.device)[None, :] < pos[:, None]
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    s_new = torch.einsum("bkgh,bkh->bkg", qf, k_new.to(torch.float32)) * scale
    probs = torch.softmax(torch.cat([scores, s_new[..., None]], dim=-1), -1)
    out = torch.einsum("bkgs,bksh->bkgh", probs[..., :S], vf)
    out = out + probs[..., -1:] * v_new.to(torch.float32)[:, :, None]
    return out.reshape(B, n_heads, hs).to(q.dtype)


def gqa_attention_spec_batched(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, pos: torch.Tensor,
                               k_self=None, v_self=None) -> torch.Tensor:
    """T-row per-slot attention with deferred cache writes, the batched
    speculative-verify reference (attention.py:111-176): slot b's T query
    rows at positions pos[b]..pos[b]+T-1 attend cache rows [0, pos[b])
    strictly plus the causal prefix of the fresh K/V block.

    q (B, n_heads, T, hs); caches (B, n_kv, S, hs) already in float;
    k_new/v_new (B, n_kv, T, hs); pos (B,).  With a quantized cache
    ``k_new``/``v_new`` are the quantize-roundtripped rows and
    ``k_self``/``v_self`` the exact rows, used only on the diagonal.
    Returns (B, n_heads, T, hs)."""
    B, n_heads, T, hs = q.shape
    n_kv, S = k_cache.shape[1], k_cache.shape[2]
    hgs = n_heads // n_kv
    f32 = torch.float32
    scale = 1.0 / math.sqrt(hs)
    qf = q.reshape(B, n_kv, hgs, T, hs).to(f32)
    scores = torch.einsum("bkgth,bksh->bkgts", qf, k_cache.to(f32)) * scale
    mask = torch.arange(S, device=q.device)[None, :] < pos[:, None]
    scores = torch.where(mask[:, None, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    s_new = torch.einsum("bkgth,bkjh->bkgtj", qf, k_new.to(f32)) * scale
    j_idx = torch.arange(T, device=q.device)[None, :]
    t_idx = torch.arange(T, device=q.device)[:, None]
    eye = j_idx == t_idx
    if k_self is not None:
        s_diag = torch.einsum("bkgth,bkth->bkgt", qf, k_self.to(f32)) * scale
        s_new = torch.where(eye, s_diag[..., None], s_new)
    s_new = torch.where(j_idx <= t_idx, s_new, torch.full_like(s_new, NEG_INF))
    probs = torch.softmax(torch.cat([scores, s_new], dim=-1), dim=-1)
    out = torch.einsum("bkgts,bksh->bkgth", probs[..., :S], v_cache.to(f32))
    pn = probs[..., S:]
    if v_self is not None:
        diag_p = torch.where(eye, pn, torch.zeros_like(pn)).sum(dim=-1)
        pn = torch.where(eye, torch.zeros_like(pn), pn)
        out = out + diag_p[..., None] * v_self.to(f32)[:, :, None]
    out = out + torch.einsum("bkgtj,bkjh->bkgth", pn, v_new.to(f32))
    return out.reshape(B, n_heads, T, hs).to(q.dtype)
