"""Group-wise symmetric quantization core (port of
``fastllama_tpu/quant/groupquant.py``).

* groups of ``group_size`` (default 64) elements,
* per-group scale ``s = max|x| / QF`` with QF = 5792 / 127 / 7 for
  INT16 / INT8 / INT4,
* weights quantized by truncation toward zero, so converted checkpoints
  stay bit-identical to the JAX package's;
* KV-cache rows quantized per row with round-half-to-even and a clip at
  ±127 (``quantize_rows``; ``torch.round`` rounds half to even, as
  ``jnp.round`` does).

A :class:`QArray` is two tensors (integer ``data``, per-group ``scales``)
plus the static layout flags the JAX dataclass carries.  INT4 projection
weights ship nibble-packed in split-half order (``pack_int4_rows``) where
``pack_supported`` says, as the JAX package lays them out.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from fastllama_tpu_torch.config import QuantType

QDTYPE = {
    QuantType.INT16: torch.int16,
    QuantType.INT8: torch.int8,
    QuantType.INT4: torch.int8,      # int4 values carried in int8 lanes
}


@dataclasses.dataclass
class QArray:
    """Group-quantized tensor: integer ``data`` + per-group ``scales``.

    ``group_axis`` -1: groups along the last axis (the embedding table
    ``(V, D)``, scales ``(V, D/gs)``).  -2: groups along the contraction
    axis of a transposed ``(in, out)`` projection, scales ``(in/gs, out)``,
    so neighbouring output columns sit next to each other in memory.
    ``packed``: split-half INT4 nibble packing along axis -2: ``data`` is
    int8 of half height, byte row ``r`` holding logical row ``r`` in its
    low nibble and row ``r + I/2`` in its high nibble; the scales stay
    ``(I/gs, O)``."""

    data: torch.Tensor
    scales: torch.Tensor
    qtype: QuantType
    group_size: int
    group_axis: int = -1
    packed: bool = False

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __getitem__(self, idx) -> "QArray":
        """Leading-axis indexing (layer slicing).  On contiguous stacked
        tensors an integer index is a view: no copy."""
        return QArray(self.data[idx], self.scales[idx], self.qtype,
                      self.group_size, self.group_axis, self.packed)

    def to(self, device) -> "QArray":
        return QArray(self.data.to(device), self.scales.to(device),
                      self.qtype, self.group_size, self.group_axis,
                      self.packed)

    def unpacked(self) -> "QArray":
        """The int8-held values of a nibble-packed INT4 QArray."""
        if not self.packed:
            return self
        return QArray(unpack_int4_rows(self.data), self.scales, self.qtype,
                      self.group_size, self.group_axis, packed=False)


def compress_scales(params, dtype=torch.bfloat16):
    """Store the group scales of every non-wide QArray field of the
    dataclass ``params`` as ``dtype`` (``EngineConfig.scale_dtype``).
    INT16 keeps f32 scales: its wide path dequantizes in f32."""
    def conv(x):
        if isinstance(x, QArray) and x.qtype != QuantType.INT16:
            return QArray(x.data, x.scales.to(dtype), x.qtype,
                          x.group_size, x.group_axis, x.packed)
        return x

    return dataclasses.replace(params, **{
        f.name: conv(getattr(params, f.name))
        for f in dataclasses.fields(params)})


def _check(n: int, gs: int) -> None:
    if n % gs != 0:
        raise ValueError(f"last dim {n} not a multiple of group_size {gs}")


def quantize(x: torch.Tensor, qtype: QuantType, group_size: int = 64
             ) -> QArray:
    """Quantize along the last axis: scale = max|group| / QF, values
    truncated toward zero (an all-zero group keeps scale 0, values 0)."""
    if qtype == QuantType.NONE:
        raise ValueError("quantize() with QuantType.NONE")
    gs = group_size
    _check(x.shape[-1], gs)
    g = x.reshape(*x.shape[:-1], x.shape[-1] // gs, gs).to(torch.float32)
    scale = g.abs().amax(dim=-1) / float(qtype.factor)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.trunc(g / safe[..., None]).to(QDTYPE[qtype])
    return QArray(q.reshape(x.shape), scale, qtype, gs)


def dequantize(q: QArray, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`: ``data * scale`` computed in ``dtype``
    (a packed QArray is unpacked first)."""
    q = q.unpacked()
    gs = q.group_size
    shape = q.data.shape
    if q.group_axis == -1:
        g = q.data.reshape(*shape[:-1], shape[-1] // gs, gs).to(dtype)
        out = g * q.scales[..., None].to(dtype)
    elif q.group_axis == -2:
        g = q.data.reshape(*shape[:-2], shape[-2] // gs, gs,
                           shape[-1]).to(dtype)
        out = g * q.scales[..., :, None, :].to(dtype)
    else:
        raise ValueError(f"unsupported group_axis {q.group_axis}")
    return out.reshape(shape)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization over the last axis (the KV-cache
    scheme): round half to even, clip at ±127.  Returns (int8 data, f32
    scales with a trailing singleton axis)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`."""
    return (q.to(torch.float32) * scales).to(dtype)


# -- split-half INT4 nibble packing (the projection weights' layout) --------

def pack_int4_rows(q: torch.Tensor) -> torch.Tensor:
    """Nibble-pack int8-held int4 values along axis -2 in split-half order:
    (…, I, O) int8 -> (…, I/2, O) int8, byte row ``i`` = row ``i`` in the
    low nibble, row ``i + I/2`` in the high nibble (``pack_int4_rows_np``
    of the JAX package).  On the tensor's device, in byte-wide temporaries
    (a 7B gate|up stack is 1.5 G values)."""
    if q.shape[-2] % 2:
        raise ValueError(f"odd contraction extent {q.shape[-2]}")
    half = q.shape[-2] // 2
    u = q.view(torch.uint8)
    lo = u[..., :half, :] & 0x0F
    hi = (u[..., half:, :] & 0x0F) << 4
    return (lo | hi).view(torch.int8)


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4_rows`: two sign-extending int32 shifts
    and a half-concat, as ``groupquant.unpack_int4_rows`` of the JAX
    package."""
    p = packed.to(torch.int32)
    lo = ((p << 28) >> 28).to(torch.int8)
    hi = ((p << 24) >> 28).to(torch.int8)
    return torch.cat([lo, hi], dim=-2)


# The JAX package packs a projection only where its TPU kernel can tile it
# (``_pick_tiles_packed`` and ``_pick_to`` in its ops/pallas/qmm.py, at
# their default caps).  That choice is part of the parameters' layout, so
# the port copies the arithmetic; its own kernel needs only (I/2) % gs == 0.
_PACK_TK = (4096, 2048, 1024, 512)
_PACK_MAX_TO = 512
_PACK_TILE_ELEMS = 512 * 1024


def _pick_to(O: int, cap: int) -> int:
    """Largest multiple of 128 <= cap that divides O (0 if none)."""
    to = min(cap, O) // 128 * 128
    while to >= 128 and O % to != 0:
        to -= 128
    return to


def pack_supported(I: int, O: int, gs: int) -> bool:
    """True if an (I, O) INT4 weight with group size ``gs`` ships packed.
    For gs = 64 this is ``I % 1024 == 0 and O % 128 == 0``."""
    if I % 2 or (I // 2) % gs or O % 128:
        return False
    Ih = I // 2
    for tk in _PACK_TK:
        if Ih % tk == 0 and tk % gs == 0 and (tk // gs) % 8 == 0:
            to = _pick_to(O, _PACK_MAX_TO)
            while to > 128 and tk * to > _PACK_TILE_ELEMS:
                to = _pick_to(O, to - 128)
            if to and tk * to <= _PACK_TILE_ELEMS:
                return True
    return False
