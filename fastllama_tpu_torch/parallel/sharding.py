"""Sharding helpers (part of ``fastllama_tpu/parallel/sharding.py``).

Only the host-side padding of the FFN hidden size is here: the loaders
use it to pad the INT4 build to a multiple of 512.  Multi-device serving
is not ported.
"""
from __future__ import annotations

import numpy as np

from fastllama_tpu_torch.config import ModelConfig


def pad_hidden_for_sharding(cfg: ModelConfig, weights: dict,
                            model_parallel: int) -> ModelConfig:
    """Zero-pad the FFN hidden dimension to a multiple of
    ``group_size * model_parallel`` (LLaMA2-7B's 11008 -> 11264 at 8).
    Exact: padded w1/w3 output rows are zero, so silu(0)*0 = 0 flows into
    zero w2 columns.  Mutates ``weights`` (numpy arrays or ``(data,
    scales)`` pairs in checkpoint layout) in place and returns the updated
    config."""
    align = cfg.group_size * model_parallel
    H = cfg.hidden_dim
    newH = -(-H // align) * align
    if newH == H:
        return cfg
    padH = newH - H

    def pad_axis(v, axis: int, n: int):
        if isinstance(v, tuple):
            data, scales = v
            dpad = [(0, 0)] * data.ndim
            dpad[axis] = (0, n)
            spad = [(0, 0)] * scales.ndim
            # a scales axis matching a group axis shrinks by group_size
            spad[axis] = (0, n if scales.shape[axis] == data.shape[axis]
                          else n // cfg.group_size)
            return (np.pad(data, dpad), np.pad(scales, spad))
        pad = [(0, 0)] * v.ndim
        pad[axis] = (0, n)
        return np.pad(v, pad)

    weights["w1"] = pad_axis(weights["w1"], 1, padH)   # (L, H, D): O rows
    weights["w3"] = pad_axis(weights["w3"], 1, padH)
    weights["w2"] = pad_axis(weights["w2"], 2, padH)   # (L, D, H): I cols
    return cfg.replace(hidden_dim=newH)
