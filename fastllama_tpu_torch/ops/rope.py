"""Rotary position embeddings in the rotate-half convention (port of
``fastllama_tpu/ops/rope.py``).

Checkpoints in the interleaved convention have their Wq/Wk rows permuted
at load time, so the runtime only ever applies rotate-half RoPE.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _freqs(head_size: int, theta: float, device) -> torch.Tensor:
    """theta^(-2i/head_size).  The base is filled on the device, not
    copied from the host: a host copy is a synchronizing call, and a
    decode step makes these tables every step."""
    idx = torch.arange(0, head_size // 2, dtype=torch.float32, device=device)
    return torch.pow(torch.full((), theta, dtype=torch.float32,
                                device=device), -idx * (2.0 / head_size))


def rope_cos_sin(positions: torch.Tensor, head_size: int,
                 theta: float = 10000.0, dtype=torch.float32):
    """cos/sin tables for absolute positions: (*pos, head_size // 2)."""
    p = positions.to(torch.float32)
    ang = p[..., None] * _freqs(head_size, theta, positions.device)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def rope_tables(cfg, positions: torch.Tensor, dtype=torch.float32):
    """cos/sin tables for a ModelConfig: plain RoPE unless the config's
    YaRN knobs are set."""
    if cfg.rope_ext_factor != 0.0 or cfg.rope_freq_scale != 1.0 \
            or cfg.rope_attn_factor != 1.0:
        return rope_cos_sin_yarn(
            positions, cfg.head_size, cfg.rope_theta, cfg.rope_freq_scale,
            cfg.rope_ext_factor, cfg.rope_attn_factor, cfg.rope_beta_fast,
            cfg.rope_beta_slow, cfg.rope_orig_ctx or cfg.max_seq_len, dtype)
    return rope_cos_sin(positions, cfg.head_size, cfg.rope_theta, dtype)


def _yarn_corr_dim(n_dims: int, orig_ctx: int, n_rot: float,
                   base: float) -> float:
    return (n_dims * math.log(orig_ctx / (n_rot * 2.0 * math.pi))
            / (2.0 * math.log(base)))


def rope_cos_sin_yarn(positions: torch.Tensor, head_size: int,
                      theta: float = 10000.0, freq_scale: float = 1.0,
                      ext_factor: float = 0.0, attn_factor: float = 1.0,
                      beta_fast: float = 32.0, beta_slow: float = 1.0,
                      orig_ctx: int = 4096, dtype=torch.float32):
    """YaRN-extended cos/sin tables: with ``ext_factor != 0`` a
    per-frequency ramp between the position-scaled and the raw angle, and
    magnitudes scaled by ``attn_factor * (1 + 0.1 ln(1/freq_scale))``;
    ``ext_factor == 0`` is plain RoPE at ``freq_scale``."""
    n_dims = head_size
    p = positions.to(torch.float32)
    idx = torch.arange(0, head_size // 2, dtype=torch.float32,
                       device=positions.device)
    ang_base = p[..., None] * _freqs(head_size, theta, positions.device)

    if ext_factor != 0.0:
        c0 = max(0.0, float(math.floor(_yarn_corr_dim(n_dims, orig_ctx,
                                                      beta_fast, theta))))
        c1 = min(float(n_dims - 1),
                 float(math.ceil(_yarn_corr_dim(n_dims, orig_ctx, beta_slow,
                                                theta))))
        ramp = 1.0 - torch.clamp((idx - c0) / max(1e-3, c1 - c0), 0.0, 1.0)
        ang = freq_scale * ang_base * (1.0 - ramp) + ang_base * ramp
        mscale = attn_factor * (1.0 + 0.1 * float(math.log(1.0 / freq_scale)))
    else:
        ang = freq_scale * ang_base
        mscale = attn_factor
    return ((torch.cos(ang) * mscale).to(dtype),
            (torch.sin(ang) * mscale).to(dtype))


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                    ) -> torch.Tensor:
    """Rotate-half RoPE.  x: (..., head_size); cos/sin broadcastable to
    (..., head_size // 2)."""
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """RoPE on adjacent pairs, the C++ engine's convention.  Used only in
    parity tests; the runtime applies rotate-half on deinterleaved
    weights."""
    shape = x.shape
    xp = x.reshape(*shape[:-1], shape[-1] // 2, 2)
    x0, x1 = xp[..., 0], xp[..., 1]
    o0 = x0 * cos - x1 * sin
    o1 = x0 * sin + x1 * cos
    return torch.stack([o0, o1], dim=-1).reshape(shape)


def deinterleave_perm(head_size: int) -> np.ndarray:
    """Permutation of interleaved dims to half-layout dims:
    [0, 2, 4, ..., 1, 3, 5, ...]."""
    return np.concatenate([np.arange(0, head_size, 2),
                           np.arange(1, head_size, 2)])


def deinterleave_heads(w: np.ndarray, head_size: int) -> np.ndarray:
    """Reorder the output rows of a (..., n_heads*head_size, in_dim) weight
    so that interleaved-pair RoPE becomes rotate-half.  Applied at load to
    Wq/Wk (and their scales) of llama2c, FLM and GGUF checkpoints."""
    out_dim = w.shape[-2]
    n_heads = out_dim // head_size
    perm = deinterleave_perm(head_size)
    idx = (np.arange(n_heads)[:, None] * head_size + perm[None, :]).reshape(-1)
    return np.take(w, idx, axis=-2)
