"""Quantized matmul, the plain version (port of
``fastllama_tpu/ops/qmatmul.py:27-43``).

``qmatmul`` dequantizes the whole weight in ``compute_dtype`` and multiplies
in f32.  It is the JAX package's jnp path: the engines use it where no
kernel applies (plain weights).  The hand-written kernel and its own plain
version, which follows the Pallas kernel's rounding, live in
``ops/kernels/qmm.py``.  ``qmatmul_parity`` is the engine's ``parity_mode``
matmul (qmatmul.py:46-63): the reference's activation re-quantization and
grouped integer dot.
"""
from __future__ import annotations

import torch

from fastllama_tpu_torch.quant.groupquant import QArray, dequantize, quantize


def qmatmul(x: torch.Tensor, w, compute_dtype=torch.float32) -> torch.Tensor:
    """``x @ w`` with ``w`` a QArray in the transposed (I, O) layout
    (group_axis=-2; a packed INT4 one is unpacked, then dequantized in
    ``compute_dtype``) or a plain (I, O) tensor.  x: (..., I).  Returns
    (..., O) in x.dtype.  The product runs in f32 on operands rounded to
    ``compute_dtype`` (f32 accumulation, as ``preferred_element_type``)."""
    if isinstance(w, QArray):
        wf = dequantize(w, compute_dtype)
    else:
        wf = w.to(compute_dtype)
    out = torch.matmul(x.to(compute_dtype).to(torch.float32),
                       wf.to(torch.float32))
    return out.to(x.dtype)


def qmatmul_parity(x: torch.Tensor, w: QArray) -> torch.Tensor:
    """Bit-faithful reference math: quantize the activation per group, an
    integer dot per group, f32 accumulation of ``int_dot * ws * xs``.
    x (..., I) f32; w a (I, O) QArray with groups along I (a packed one
    is unpacked first).  The integer dot runs in f64, where every product
    sum of a group is exact (CUDA has no integer matmul)."""
    w = w.unpacked()
    gs = w.group_size
    I, O = w.data.shape
    G = I // gs
    xq = quantize(x, w.qtype, gs)
    wd = w.data.reshape(G, gs, O).to(torch.float64)
    xd = xq.data.reshape(*x.shape[:-1], G, gs).to(torch.float64)
    acc = torch.einsum("gko,...gk->...og", wd, xd)
    scaled = (acc.to(torch.float32)
              * w.scales.to(torch.float32).transpose(0, 1)
              * xq.scales[..., None, :])
    return scaled.sum(dim=-1)
