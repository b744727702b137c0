"""K3: in-place KV row scatter (``csrc/kv_write.cu``) and its plain
versions.

Replaces ``decode_write`` (fastllama_tpu/ops/pallas/kv_write.py:119),
``prefill_write`` (kv_write.py:244) and ``spec_write`` (kv_write.py:392).
All three call one kernel that writes
fresh rows ``(L, N, n_kv, T, hs)`` into slot ``slots[n]`` at rows
``start[n] + t`` of the ``(L, B, n_kv, S, hs)`` cache, with the f32 row
scales of an int8 cache, for all layers in one launch.  The JAX writers
return a new (aliased) cache; these update the cache's tensors in place and
return the same cache object.

Dispatch: CPU tensors take the plain version; CUDA tensors launch the
kernel or raise.  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from fastllama_tpu_torch.ops.kernels import _build


def kv_scatter_plain(cache, kq, vq, ks, vs, slots, starts):
    """cache.k[l, slots[n], h, starts[n] + t] = kq[l, n, h, t] (and V, and
    the row scales when ``ks`` is given) by indexed assignment.  Rows that
    would land outside [0, S) are dropped, as the kernel drops them (the
    selection of the rows that land syncs with the device).  Duplicate
    slots carry identical rows, so which write lands last is immaterial."""
    L, N, n_kv, T, hs = kq.shape
    dev = cache.k.device
    rows = (starts.to(dev, torch.long)[:, None]
            + torch.arange(T, device=dev)[None, :])          # (N, T)
    n_i, t_i = ((rows >= 0) & (rows < cache.k.shape[3])).nonzero(
        as_tuple=True)
    s_i, r_i = slots.to(dev, torch.long)[n_i], rows[n_i, t_i]
    # advanced indices around a slice: the selected rows come first,
    # (M, L, n_kv[, hs]) on both sides
    cache.k[:, s_i, :, r_i] = kq[:, n_i, :, t_i]
    cache.v[:, s_i, :, r_i] = vq[:, n_i, :, t_i]
    if ks is not None:
        cache.k_scale[:, s_i, :, r_i] = ks[:, n_i, :, t_i]
        cache.v_scale[:, s_i, :, r_i] = vs[:, n_i, :, t_i]
    return cache


def _vec_bytes(row_bytes: int, tensors) -> int:
    for v in (16, 8, 4, 2, 1):
        if row_bytes % v == 0 and all(t.data_ptr() % v == 0 for t in tensors):
            return v
    return 1


def _validate(cache, kq, vq, ks, vs, slots, starts):
    L, N, n_kv, T, hs = kq.shape
    Lc, B, n_kv_c, S, hs_c = cache.k.shape
    if (Lc, n_kv_c, hs_c) != (L, n_kv, hs):
        raise ValueError(f"fresh rows {tuple(kq.shape)} do not match the "
                         f"cache {tuple(cache.k.shape)}")
    quant = ks is not None
    if quant != cache.quantized:
        raise ValueError("row scales are needed exactly for an int8 cache")
    if kq.dtype != cache.k.dtype or vq.dtype != cache.v.dtype \
            or vq.shape != kq.shape:
        raise ValueError(f"fresh rows {kq.dtype} vs cache {cache.k.dtype}")
    ts = [kq, vq, cache.k, cache.v, slots, starts]
    if quant:
        if ks.shape != (L, N, n_kv, T) or vs.shape != ks.shape \
                or ks.dtype != torch.float32:
            raise ValueError("fresh row scales must be (L, N, n_kv, T) f32")
        ts += [ks, vs, cache.k_scale, cache.v_scale]
    for t in ts:
        if t.device != cache.k.device or not t.is_contiguous():
            raise ValueError("kv_write operands must be contiguous on the "
                             "cache's device")
    if slots.dtype != torch.int32 or starts.dtype != torch.int32 \
            or slots.shape != (N,) or starts.shape != (N,):
        raise ValueError("slots/starts must be (N,) int32")


def _launch(cache, kq, vq, ks, vs, slots, starts):
    L, N, n_kv, T, hs = kq.shape
    B, S = cache.k.shape[1], cache.k.shape[3]
    quant = ks is not None
    row_bytes = hs * kq.element_size()
    vec = _vec_bytes(row_bytes, [kq, vq, cache.k, cache.v])
    fn = _build.load("kv_write").kv_scatter_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(kq), _build.ptr(vq), _build.ptr(ks), _build.ptr(vs),
            _build.ptr(cache.k), _build.ptr(cache.v),
            _build.ptr(cache.k_scale if quant else None),
            _build.ptr(cache.v_scale if quant else None),
            _build.ptr(slots), _build.ptr(starts), L, N, n_kv, T, B, S,
            row_bytes, vec, _build.stream_of(kq))
    _build.check(rc, "kv_scatter_launch")


def _spec_args(cache, kq, vq, ks, vs, pos):
    """spec_write's operands in the scatter's (L, N, n_kv, T, hs) form:
    N = B slots, slot b's D rows at pos[b]."""
    slots = torch.arange(kq.shape[1], dtype=torch.int32, device=kq.device)
    return cache, kq, vq, ks, vs, slots, pos


def _decode_args(cache, kq, vq, ks, vs, pos):
    """decode_write's operands: spec_write's with D = 1."""
    return _spec_args(cache, kq.unsqueeze(3), vq.unsqueeze(3),
                      None if ks is None else ks.unsqueeze(-1),
                      None if vs is None else vs.unsqueeze(-1), pos)


def _prefill_args(cache, kq, vq, ks, vs, slots, starts=None):
    """prefill_write's operands: every prompt lands at row 0 unless
    ``starts`` says otherwise."""
    if starts is None:
        starts = torch.zeros(kq.shape[1], dtype=torch.int32,
                             device=kq.device)
    return cache, kq, vq, ks, vs, slots, starts


def decode_write(cache, kq, vq, ks, vs, pos):
    """Write every slot's fresh decode row in one launch: kq/vq
    (L, B, n_kv, hs) in the cache dtype, ks/vs (L, B, n_kv) f32 row scales
    (None for an unquantized cache), pos (B,) int32 — row ``pos[b]`` of
    slot b.  In place; returns ``cache``."""
    args = _decode_args(cache, kq, vq, ks, vs, pos)
    _validate(*args)
    if kq.device.type == "cpu":
        return kv_scatter_plain(*args)
    if kq.device.type != "cuda":
        raise ValueError(f"decode_write: unsupported device {kq.device}")
    _launch(*args)
    decode_write.launches += 1
    return cache


def prefill_write(cache, kq, vq, ks, vs, slots, starts=None):
    """Write N prefilled prompts in one launch: kq/vq (L, N, n_kv, T, hs)
    land at rows [0, T) of slot ``slots[n]``, or at rows [starts[n],
    starts[n]+T) with ``starts`` (N,) int32 (a prefix-cache tail,
    ``models.batched.prefill_into_slot_at``); ks/vs (L, N, n_kv, T) f32 or
    None.  Duplicate slot ids carry identical rows.  In place; returns
    ``cache``."""
    args = _prefill_args(cache, kq, vq, ks, vs, slots, starts)
    _validate(*args)
    if kq.device.type == "cpu":
        return kv_scatter_plain(*args)
    if kq.device.type != "cuda":
        raise ValueError(f"prefill_write: unsupported device {kq.device}")
    _launch(*args)
    prefill_write.launches += 1
    return cache


def spec_write(cache, kq, vq, ks, vs, pos):
    """Write every slot's D speculative-verify rows in one launch (replaces
    ``spec_write``, kv_write.py:392): kq/vq (L, B, n_kv, D, hs) in the
    cache dtype land at rows [pos[b], pos[b]+D) of slot b, all layers;
    ks/vs (L, B, n_kv, D) f32 row scales, or None for an unquantized
    cache; pos (B,) int32 on the device.  It is the K3 scatter with
    slots = arange(B), starts = pos, T = D, so it needs no kernel of its
    own.  The JAX writer straddles two sublane slabs and gates on
    ``D <= sublanes``: TPU tiling with no counterpart here, so any D is
    written.  Rows past S-1 are dropped, never clamped onto earlier rows;
    the engine keeps pos + R*D <= S (``plan_R``), so none is dropped in
    practice.  In place; returns ``cache``."""
    args = _spec_args(cache, kq, vq, ks, vs, pos)
    _validate(*args)
    if kq.device.type == "cpu":
        return kv_scatter_plain(*args)
    if kq.device.type != "cuda":
        raise ValueError(f"spec_write: unsupported device {kq.device}")
    _launch(*args)
    spec_write.launches += 1
    return cache


decode_write.launches = 0
prefill_write.launches = 0
spec_write.launches = 0


def make_kv_writer():
    """writer(cache, kq, vq, ks, vs, pos) for models.batched.decode_step."""
    return decode_write


def make_spec_writer():
    """writer(cache, kq, vq, ks, vs, pos) for
    models.batched.spec_decode_step."""
    return spec_write


def make_prefill_writer():
    """writer(cache, kq, vq, ks, vs, slots, starts=None) for
    models.batched.prefill_many and prefill_into_slot_at."""
    return prefill_write


def decode_write_plain(cache, kq, vq, ks, vs, pos):
    """The plain version of :func:`decode_write` on any device."""
    return kv_scatter_plain(*_decode_args(cache, kq, vq, ks, vs, pos))


def prefill_write_plain(cache, kq, vq, ks, vs, slots, starts=None):
    """The plain version of :func:`prefill_write` on any device."""
    return kv_scatter_plain(*_prefill_args(cache, kq, vq, ks, vs, slots,
                                           starts))


def spec_write_plain(cache, kq, vq, ks, vs, pos):
    """The plain version of :func:`spec_write` on any device."""
    return kv_scatter_plain(*_spec_args(cache, kq, vq, ks, vs, pos))
