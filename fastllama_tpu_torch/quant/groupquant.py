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

import numpy as np
import torch

from fastllama_tpu_torch.config import QuantType

QDTYPE = {
    QuantType.INT16: torch.int16,
    QuantType.INT8: torch.int8,
    QuantType.INT4: torch.int8,      # int4 values carried in int8 lanes
}
QDTYPE_NP = {QuantType.INT16: np.int16, QuantType.INT8: np.int8,
             QuantType.INT4: np.int8}


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
    amax = g.abs().amax(dim=-1)
    # a tensor divisor: on a CUDA tensor, division by a Python number
    # multiplies by its reciprocal, which rounds differently from the
    # division that numpy (and so the JAX package's quantize_np) does
    scale = amax / torch.full_like(amax, float(qtype.factor))
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


# -- numpy versions (host side: the loaders, the FLM writer, the converter) --

def transpose_weight(data: np.ndarray, scales: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(…, O, I) data + (…, O, I/gs) scales -> (…, I, O) + (…, I/gs, O):
    checkpoint layout to the transposed (group_axis=-2) layout."""
    return (np.ascontiguousarray(np.swapaxes(data, -1, -2)),
            np.ascontiguousarray(np.swapaxes(scales, -1, -2)))


def quantize_np(x: np.ndarray, qtype: QuantType, group_size: int = 64
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Host quantization along the last axis: the same bits as
    :func:`quantize` (scale = max|group| / QF, truncation toward zero)."""
    gs = group_size
    _check(x.shape[-1], gs)
    g = np.ascontiguousarray(x, dtype=np.float32).reshape(
        *x.shape[:-1], x.shape[-1] // gs, gs)
    scale = np.abs(g).max(axis=-1) / float(qtype.factor)
    safe = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.trunc(g / safe[..., None]).astype(QDTYPE_NP[qtype])
    return q.reshape(x.shape), scale.astype(np.float32)


def dequantize_np(q: np.ndarray, scales: np.ndarray, group_size: int = 64
                  ) -> np.ndarray:
    gs = group_size
    g = q.reshape(*q.shape[:-1], q.shape[-1] // gs, gs).astype(np.float32)
    return (g * scales[..., None]).reshape(q.shape)


def pack_int4_np(q: np.ndarray) -> np.ndarray:
    """Pack int8-held int4 values into the C++ engine's ``Bit4Pair`` bytes:
    low nibble the even element, high nibble the odd one."""
    assert q.shape[-1] % 2 == 0
    lo = q[..., 0::2].astype(np.uint8) & 0x0F
    hi = (q[..., 1::2].astype(np.uint8) & 0x0F) << 4
    return (lo | hi).astype(np.uint8)


def unpack_int4_np(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_int4_np`: two's-complement nibbles -> int8."""
    lo = (packed & 0x0F).astype(np.int8)
    hi = ((packed >> 4) & 0x0F).astype(np.int8)
    lo = np.where(lo >= 8, lo - 16, lo).astype(np.int8)
    hi = np.where(hi >= 8, hi - 16, hi).astype(np.int8)
    out = np.empty(packed.shape[:-1] + (packed.shape[-1] * 2,), dtype=np.int8)
    out[..., 0::2] = lo
    out[..., 1::2] = hi
    return out


def pack_int4_rows_np(q: np.ndarray) -> np.ndarray:
    """:func:`pack_int4_rows` on the host: (…, I, O) int8 -> (…, I/2, O)
    int8, split-half order."""
    assert q.shape[-2] % 2 == 0
    half = q.shape[-2] // 2
    lo = q[..., :half, :].astype(np.uint8) & 0x0F
    hi = (q[..., half:, :].astype(np.uint8) & 0x0F) << 4
    return (lo | hi).astype(np.int8)


def unpack_int4_rows_np(packed: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_int4_rows_np`."""
    u = packed.astype(np.uint8)
    lo = (u & 0x0F).astype(np.int8)
    hi = ((u >> 4) & 0x0F).astype(np.int8)
    lo = np.where(lo >= 8, lo - 16, lo).astype(np.int8)
    hi = np.where(hi >= 8, hi - 16, hi).astype(np.int8)
    return np.concatenate([lo, hi], axis=-2)


def host_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A copy of the host array ``a`` on ``device``; ``a`` may be read-only
    (``np.frombuffer`` of a file's bytes) or unaligned."""
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")
        return torch.from_numpy(a).to(device)
    return torch.from_numpy(a).to(device, copy=True)


def from_prequantized(data: np.ndarray, scales: np.ndarray, qtype: QuantType,
                      group_size: int = 64, device="cpu") -> QArray:
    """Wrap pre-quantized host arrays (read from an FLM file) as a QArray
    on ``device``."""
    return QArray(host_tensor(data, device),
                  host_tensor(scales.astype(np.float32), device),
                  qtype, group_size)
