"""Numeric debugging aids.

Port of ``fastllama_tpu/utils/debug.py``: the C++ engine's
activation fingerprint (``print_vector_feat``), top-k probe and weight
statistics, used to chase numerics layer by layer.  Every function takes
numpy arrays, torch tensors (on any device) or the port's QArrays.
"""
from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    """``x`` as a host f32 array (a torch tensor is copied off its
    device)."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def tensor_fingerprint(x, name: str = "", sample: int = 8) -> str:
    """Compact stats line: shape, dtype, mean/std/min/max, head sample,
    checksum — the equivalent of print_vector_feat."""
    full = _np(x)
    a = full.reshape(-1)
    if a.size == 0:
        return f"{name}: <empty>"
    head = np.array2string(a[:sample], precision=4, separator=",")
    csum = float(np.sum(a, dtype=np.float64))
    return (f"{name} shape={tuple(full.shape)} "
            f"mean={a.mean():.5f} std={a.std():.5f} "
            f"min={a.min():.4f} max={a.max():.4f} sum={csum:.4f} head={head}")


def top_k(logits, k: int = 8, tokenizer=None) -> str:
    """Top-k logits probe."""
    a = _np(logits).reshape(-1)
    idx = np.argsort(-a)[:k]
    parts = []
    for i in idx:
        piece = ""
        if tokenizer is not None:
            piece = repr(tokenizer.decode_one(int(i)))
        parts.append(f"{int(i)}{piece}:{a[i]:.4f}")
    return "  ".join(parts)


def assert_finite(x, name: str = "tensor") -> None:
    a = _np(x)
    if not np.isfinite(a).all():
        n_nan = int(np.isnan(a).sum())
        n_inf = int(np.isinf(a).sum())
        raise FloatingPointError(f"{name}: {n_nan} NaNs, {n_inf} Infs "
                                 f"in {a.shape}")


def weight_stats(value, name: str = "weights", max_rows: int = 4096) -> str:
    """Weight-statistics probe — the C++ engine's ``analyze_weights``
    analogue: per-row dynamic-range summary of a weight tensor (mean
    half-range ``midf``, mean max-magnitude ``maxf``) plus global min/max.
    Accepts an array, a tensor or a QArray (dequantized first, on its
    device); leading layer axes are flattened into rows."""
    import torch
    from fastllama_tpu_torch.quant.groupquant import QArray, dequantize
    if isinstance(value, QArray):
        value = dequantize(value, torch.float32)
    a = _np(value)
    rows = a.reshape(-1, a.shape[-1]) if a.ndim > 1 else a.reshape(1, -1)
    if rows.shape[0] > max_rows:                 # sample evenly, stay cheap
        rows = rows[:: rows.shape[0] // max_rows + 1]
    rmin = rows.min(axis=1)
    rmax = rows.max(axis=1)
    midf = float(np.mean((rmax - rmin) / 2))
    maxf = float(np.mean(np.maximum(np.abs(rmax), np.abs(rmin))))
    return (f"{name} shape={tuple(np.shape(a))} rows={rows.shape[0]} "
            f"midf={midf:.5f} maxf={maxf:.5f} "
            f"min={float(a.min()):.4f} max={float(a.max()):.4f}")


def params_stats(params, print_fn=print) -> None:
    """Run :func:`weight_stats` over every ``LlamaParams`` leaf (the
    full-model sweep; the C++ engine runs it on attn_q only)."""
    import dataclasses
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if v is not None:
            print_fn(weight_stats(v, name=f.name))


def compare(a, b, name: str = "", rtol: float = 1e-5) -> str:
    """Side-by-side diff summary."""
    av = _np(a)
    bv = _np(b)
    diff = np.abs(av - bv)
    denom = max(np.abs(bv).max(), 1e-30)
    return (f"{name} max_abs_diff={diff.max():.3e} "
            f"rel={diff.max()/denom:.3e} "
            f"{'OK' if diff.max()/denom < rtol else 'MISMATCH'}")
