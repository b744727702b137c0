"""K2: bounded flash-decode attention (``csrc/flash_decode.cu``), its
speculative-verify (K2s) and block-attend (K2b) modes, and their plain
versions.  The sources go by kernel family, one ``nvcc`` and library each:
the tiled kernels and K2b's f32 mode in ``csrc/flash_decode.cu``, the
split-row kernels of K2 and K2s in ``csrc/flash_decode_split.cu``, K2's
fresh and stats split mode in ``csrc/flash_decode_fresh.cu``, K2b's
tensor-core modes in ``csrc/flash_block_tc.cu`` and
``csrc/flash_block_tf32.cu``.

Replaces ``flash_decode_batched`` (fastllama_tpu/ops/pallas/
flash_decode.py:203) in its two modes:

* fresh — the deferred-write path that ``make_attn_batched_flash`` drives
  from ``models/batched.decode_step``: one query row per slot over that
  slot's cache rows [0, pos[b]) of layer ``layer`` (strict), plus the
  fresh K/V row merged last in f32; with ``stats=True`` (the deferred
  staged-KV path, ``decode_step_deferred``) it also returns each query
  row's final running max and sum, counted in ``.launches_stats``;
* non-fresh — rows [0, pos[b]] (the mask ``col <= pos``), the form that
  ``flash_decode_single`` (flash_decode.py:299) gives the single-stream
  ``models/llama.forward`` through ``make_attn_indexed_flash`` (:561).

With hs a multiple of 16 (up to 256) and the caches and fresh rows on a
16-byte boundary, every call runs a split-row mode (``decode_mode``): the
rows of a (slot, kv head) shared by up to ``split_count`` blocks, merged
in the same launch; ``flash_decode_split_kernel`` for a non-fresh call
without stats, ``flash_decode_fresh_split_kernel`` (``csrc/
flash_decode_fresh.cu``) for fresh rows, stats or both.  A split launch
counts also in ``.launches_split``, one with stats in
``.launches_stats_split``; the tiled ``flash_decode_kernel`` keeps the
other calls.

The same kernel serves ``ops/kernels/attention.py``.  K2s
(:func:`flash_spec_batched`, replacing flash_decode.py:700) is its
speculative-verify mode: T query rows per slot over rows [0, pos[b]) plus
a causal fresh block; a call with hgs * T <= 8 query
rows a (slot, kv head) and hs a multiple of 16 takes its split-row mode
(``spec_mode``, ``flash_spec_split_kernel``), counted also in
``.launches_split``.  K2b
(:func:`flash_block_attend`, replacing flash_decode.py:426) attends one
slot's prefill tail: T query rows over that slot's rows [0, start) and
the causal block, for the prefix cache; bf16 q over an int8 or bf16
cache takes its tensor-core mode (``block_mode``), counted also in
``.launches_tc``; every other call with hs a multiple of 8 and 16-byte
aligned operands its split-TF32 tensor-core mode (``csrc/
flash_block_tf32.cu``), counted also in ``.launches_tf32``; the rest the
f32 CUDA-core kernel.  The TPU's host ``s_bound``
window (``round_bound``) has no counterpart: the kernel reads ``pos``
from the device and only the rows the mask keeps.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from fastllama_tpu_torch.ops.kernels import _build

NEG_INF = -1e30
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
HGS_SUPPORTED = (1, 2, 4, 8)
HS_MAX = 256


def flash_decode_plain(q, ck, cv, pos, layer: int, k_scale=None,
                       v_scale=None, k_new=None, v_new=None,
                       stats: bool = False):
    """The kernel's math in plain PyTorch, all in f32 (``_flash_kernel``,
    flash_decode.py:123-200): scores (q.k)/sqrt(hs) times the K row scale,
    the mask (strict ``col < pos`` with fresh rows, ``col <= pos``
    without), softmax jointly with the fresh row's score, probabilities
    times the V row scale before P.V.  Not the jnp fallback, which rounds
    dequantized K/V to the compute dtype first.  With ``stats`` also the
    softmax's max and sum of every query row, (B, n_kv, hgs) f32."""
    B, H, _, hs = q.shape
    n_kv, S = ck.shape[2], ck.shape[3]
    hgs = H // n_kv
    scale = 1.0 / math.sqrt(hs)
    fresh = k_new is not None
    qf = q.reshape(B, n_kv, hgs, hs).to(torch.float32)
    s = torch.einsum("bkgh,bksh->bkgs", qf,
                     ck[layer, :B].to(torch.float32)) * scale
    if k_scale is not None:
        s = s * k_scale[layer, :B][:, :, None, :]
    col = torch.arange(S, device=q.device)[None, :]
    p = pos.to(q.device)[:, None]
    mask = (col < p if fresh else col <= p)[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    if fresh:
        s_new = torch.einsum("bkgh,bkh->bkg", qf,
                             k_new.to(torch.float32)) * scale
        m = torch.maximum(m, s_new)
        e_new = torch.exp(s_new - m)
    e = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    den = e.sum(dim=-1)
    if v_scale is not None:
        e = e * v_scale[layer, :B][:, :, None, :]
    acc = torch.einsum("bkgs,bksh->bkgh", e, cv[layer, :B].to(torch.float32))
    if fresh:
        den = den + e_new
        acc = acc + e_new[..., None] * v_new.to(torch.float32)[:, :, None, :]
    out = (acc / den[..., None]).reshape(B, H, 1, hs).to(q.dtype)
    return (out, m, den) if stats else out


def _check_operands(name, q, ck, cv, pos, layer, k_scale, v_scale,
                    fresh, fresh_shape, B=None):
    """The checks K2, K2s and K2b share: slots and layer in range, row
    scales exactly for an int8 cache, dtypes, fresh rows of
    ``fresh_shape`` in q's dtype, pos (B,) int32 (K2b has none and names
    its slot count ``B``), every operand contiguous on one device."""
    B = q.shape[0] if B is None else B
    L, Bc, n_kv, S, _ = ck.shape
    if B > Bc or not 0 <= layer < L:
        raise ValueError(f"{name} kernel: B={B} Bc={Bc} layer={layer}")
    quant = k_scale is not None
    if (ck.dtype == torch.int8) != quant or cv.dtype != ck.dtype:
        raise ValueError("an int8 cache needs its row scales (and only it)")
    if q.dtype not in (torch.float32, torch.bfloat16) or ck.dtype not in _DT:
        raise ValueError(f"{name} kernel: dtypes q {q.dtype} cache "
                         f"{ck.dtype}")
    for t in fresh:
        if t.dtype != q.dtype or t.shape != fresh_shape:
            raise ValueError(f"fresh rows must be {fresh_shape} in q's "
                             f"dtype")
    if pos is not None and (pos.dtype != torch.int32 or pos.shape != (B,)):
        raise ValueError("pos must be (B,) int32")
    for t in ([q, ck, cv] + ([] if pos is None else [pos]) + fresh
              + ([k_scale, v_scale] if quant else [])):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous on one "
                             f"device")
    if quant and (k_scale.dtype != torch.float32
                  or k_scale.shape != (L, Bc, n_kv, S)
                  or v_scale.shape != k_scale.shape):
        raise ValueError("row scales must be (L, B, n_kv, S) f32")


def _validate(q, ck, cv, pos, layer, k_scale, v_scale, k_new, v_new):
    B, H, T, hs = q.shape
    n_kv = ck.shape[2]
    if T != 1 or H % n_kv or H // n_kv not in HGS_SUPPORTED or hs > HS_MAX:
        raise ValueError(f"flash_decode kernel: unsupported shape q "
                         f"{tuple(q.shape)} cache {tuple(ck.shape)}")
    if (k_new is None) != (v_new is None):
        raise ValueError("fresh rows come as a pair (k_new, v_new)")
    fresh = [] if k_new is None else [k_new, v_new]
    _check_operands("flash_decode", q, ck, cv, pos, layer, k_scale, v_scale,
                    fresh, (B, n_kv, hs))


def _launch(q, ck, cv, pos, layer, k_scale, v_scale, k_new, v_new, stats):
    B, H, _, hs = q.shape
    _, Bc, n_kv, S, _ = ck.shape
    out = torch.empty_like(q)
    m = l = None
    if stats:
        m = torch.empty((B, n_kv, H // n_kv), dtype=torch.float32,
                        device=q.device)
        l = torch.empty_like(m)
    fn = _build.load("flash_decode").flash_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(q), _build.ptr(ck), _build.ptr(cv),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(k_new),
            _build.ptr(v_new), _build.ptr(pos), _build.ptr(out),
            _build.ptr(m), _build.ptr(l), B, layer, Bc, n_kv, S, hs,
            H // n_kv, 1.0 / math.sqrt(hs), _DT[q.dtype], _DT[ck.dtype],
            _build.stream_of(q))
    _build.check(rc, "flash_decode_launch")
    return (out, m, l) if stats else out


# -- K2's split-row modes ----------------------------------------------------

SPLIT_MAX = 16             # splits a (slot, kv head) (csrc)
SPLIT_UNIT = 16            # a split's rows are a multiple of this (csrc)
SPLIT_MIN_CHUNK = 256      # rows a split takes at the least
SPLIT_WAVE_WARPS = 16 * 132  # one wave of 16 warps on each H100 SM
SPLIT_MIN_ROWS = 512       # cache rows a split at the least, in a full cache


def aligned16(*ts) -> bool:
    """Every tensor given (None skipped) starts on a 16-byte boundary, as
    the split modes' 8- and 16-byte loads and ``cp.async`` copies need."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def decode_mode(q, ck, fresh: bool = False, stats: bool = False, cv=None,
                k_new=None, v_new=None) -> str:
    """K2's mode, a function of the operands: ``"split"`` for f32 or bf16
    q over an f32, bf16 or int8 cache, hgs in {1, 2, 4, 8}, hs a multiple
    of 16 up to 256, and the caches and fresh rows given (``ck`` always,
    ``cv``, ``k_new``, ``v_new`` when passed) on a 16-byte boundary, in
    every form of the call: the kernel is ``flash_decode_split_kernel``
    for a non-fresh call without stats, ``flash_decode_fresh_split_kernel``
    with ``fresh`` rows, ``stats`` or both; ``"tiled"``
    (``flash_decode_kernel``) for every other call: other head sizes and
    misaligned views."""
    hs = q.shape[-1]
    n_kv = ck.shape[2]
    return ("split" if q.dtype in (torch.float32, torch.bfloat16)
            and ck.dtype in _DT and q.shape[1] % n_kv == 0
            and q.shape[1] // n_kv in HGS_SUPPORTED
            and hs % 16 == 0 and 16 <= hs <= HS_MAX
            and aligned16(ck, cv, k_new, v_new) else "tiled")


def split_warps(hgs: int, int8: bool = False) -> int:
    """The most warps a block of the split mode takes (csrc
    ``split_warps``): 16 at hgs 1 (8 over an int8 cache), 8 at hgs 2, 4
    from hgs 4 on, where q and the accumulators take more registers."""
    return 4 if hgs >= 4 else 8 if hgs == 2 or int8 else 16


def split_count(B: int, n_kv: int, S: int, hgs: int = 1,
                int8: bool = False) -> int:
    """NSPLIT, the blocks that may share a (slot, kv head)'s rows, from
    host ints only (the engines keep pos on the device): about one wave of
    ``SPLIT_WAVE_WARPS`` warps in all, at most ``S // SPLIT_MIN_ROWS`` and
    ``SPLIT_MAX``, 1 once B * n_kv blocks fill the wave.  A short pos
    uses fewer of them (:func:`split_bounds`)."""
    want = SPLIT_WAVE_WARPS // (B * n_kv * split_warps(hgs, int8))
    return max(1, min(want, S // SPLIT_MIN_ROWS, SPLIT_MAX))


def split_block_warps(B: int, n_kv: int, nsplit: int, hgs: int = 1,
                      int8: bool = False) -> int:
    """Warps a block of the launch: the most :func:`split_warps` allows
    while the (B * n_kv, nsplit) grid fits one wave of
    ``SPLIT_WAVE_WARPS``, fewer (down to 4, a power of two) as it grows,
    so that a large batch keeps several blocks on an SM."""
    nw = split_warps(hgs, int8)
    while nw > 4 and B * n_kv * nsplit * nw > SPLIT_WAVE_WARPS:
        nw //= 2
    return nw


def fresh_block_warps(B: int, n_kv: int, nsplit: int, hgs: int, int8: bool,
                      wave_blocks) -> int:
    """Warps a block of the fresh and stats split mode: the most (a power
    of two from :func:`split_warps` down to 4) at which the grid of
    B * n_kv * nsplit blocks fits one wave of the card, ``wave_blocks(nw)``
    blocks of nw warps at once (the runtime's occupancy count times the
    SMs: on an H100 3 blocks of 8 warps an SM, or 6 of 4, at the 7B
    instantiation); 4 when none fits.  So B=12 at S=2048 takes blocks of
    8 warps and B=48 blocks of 4, the faster at each on the card
    (PERF.md)."""
    nw = split_warps(hgs, int8)
    while nw > 4 and B * n_kv * nsplit > wave_blocks(nw):
        nw //= 2
    return nw


def split_bounds(p: int, nsplit: int, min_chunk: int = SPLIT_MIN_CHUNK):
    """The cache rows [r0, r1) each split takes of [0, p), as the kernel
    divides them on the device: ceil(p / nsplit) rows, at least
    ``min_chunk``, rounded up to ``SPLIT_UNIT``, in order; the splits past
    p take none and stay out of the merge."""
    chunk = max(-(-p // nsplit), min_chunk)
    chunk = -(-chunk // SPLIT_UNIT) * SPLIT_UNIT
    return [(min(s * chunk, p), min(s * chunk + chunk, p))
            for s in range(nsplit)]


# The split mode's workspace, one per device: the splits' partial
# (m, l, acc) and a ticket per (slot, kv head), which the merging block
# puts back to 0.  Shared by every launch, so safe on one stream (the port
# uses one); it grows to the largest call and is kept.
_SPLIT_WS = {}


def _split_workspace(device, n_bh: int, n_part: int, hs: int):
    ws = list(_SPLIT_WS.get(device, (None, None, None)))
    for i, (n, dt) in enumerate(((n_part * hs, torch.float32),
                                 (2 * n_part, torch.float32),
                                 (n_bh, torch.int32))):
        if ws[i] is None or ws[i].numel() < n:
            ws[i] = torch.zeros(n, dtype=dt, device=device)
    _SPLIT_WS[device] = ws
    return ws


def _split_launch(q, ck, cv, pos, layer, k_scale, v_scale, nsplit=None,
                  min_chunk=SPLIT_MIN_CHUNK, nw=None, k_new=None, v_new=None,
                  stats=False, lib=None):
    """Launch K2's split-row mode on validated CUDA operands: the fresh
    and stats kernel with fresh rows ``k_new``/``v_new`` or ``stats``
    (then returning (out, m, l)), else the non-fresh one.  ``nsplit``
    defaults to :func:`split_count`, ``nw`` to :func:`split_block_warps`
    (the non-fresh kernel) or :func:`fresh_block_warps` (the fresh and
    stats kernel, :func:`fresh_split_plan`); phase 5 of ``chip_smoke.py``
    and the card tests try others, and other ``min_chunk``.  ``lib``: a
    build of ``flash_decode_fresh.cu`` with other tuning constants
    (``tools/fresh_split_design.py``) for the fresh and stats kernel."""
    B, H, _, hs = q.shape
    _, Bc, n_kv, S, _ = ck.shape
    hgs = H // n_kv
    int8 = ck.dtype == torch.int8
    fresh = k_new is not None or stats
    if fresh:
        lib = _build.load("flash_decode_fresh") if lib is None else lib
        nsplit, nw = fresh_split_plan(q, ck, nsplit, nw, lib)
    else:
        if nsplit is None:
            nsplit = split_count(B, n_kv, S, hgs, int8)
        if nw is None:
            nw = split_block_warps(B, n_kv, nsplit, hgs, int8)
    out = torch.empty_like(q)
    acc = ml = ticket = None
    if nsplit > 1:
        acc, ml, ticket = _split_workspace(q.device, B * n_kv,
                                           B * n_kv * nsplit * hgs, hs)
    if fresh:
        return _fresh_split_launch(q, ck, cv, pos, layer, k_scale, v_scale,
                                   k_new, v_new, stats, nsplit, min_chunk,
                                   nw, out, acc, ml, ticket, lib)
    fn = _build.load("flash_decode_split").flash_decode_split_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(q), _build.ptr(ck), _build.ptr(cv),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(pos),
            _build.ptr(out), _build.ptr(acc), _build.ptr(ml),
            _build.ptr(ticket), B, layer, Bc, n_kv, S, hs, hgs, nsplit,
            min_chunk, nw, 1.0 / math.sqrt(hs), _DT[q.dtype], _DT[ck.dtype],
            _build.stream_of(q))
    _build.check(rc, "flash_decode_split_launch")
    return out


_RESIDENT = {}      # (library, device, cache dtype, hs, hgs, warps) -> blocks


def _fresh_resident(lib, device, cache_dtype, hs: int, hgs: int,
                    nw: int) -> int:
    """Blocks of nw warps of the fresh and stats split mode's instantiation
    that an SM of ``device`` holds at once, asked of the CUDA runtime once
    a library, device and instantiation."""
    key = (id(lib), device.index, cache_dtype, hs, hgs, nw)
    if key not in _RESIDENT:
        fn = lib.flash_decode_fresh_split_resident
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = fn(_DT[cache_dtype], hs, hgs, nw, ctypes.byref(blocks))
        _build.check(rc, "flash_decode_fresh_split_resident")
        _RESIDENT[key] = blocks.value
    return _RESIDENT[key]


def fresh_split_plan(q, ck, nsplit=None, nw=None, lib=None):
    """(nsplit, nw) of a fresh or stats launch on CUDA operands: the given
    values, else :func:`split_count` and :func:`fresh_block_warps` with
    the card's occupancy count of the instantiation (of ``lib``, a build
    of ``flash_decode_fresh.cu``; by default the wrapper's)."""
    B, H, _, hs = q.shape
    _, _, n_kv, S, _ = ck.shape
    hgs = H // n_kv
    int8 = ck.dtype == torch.int8
    if nsplit is None:
        nsplit = split_count(B, n_kv, S, hgs, int8)
    if nw is None:
        lib = _build.load("flash_decode_fresh") if lib is None else lib
        n_sm = torch.cuda.get_device_properties(
            q.device).multi_processor_count
        nw = fresh_block_warps(
            B, n_kv, nsplit, hgs, int8,
            lambda w: n_sm * _fresh_resident(lib, q.device, ck.dtype, hs,
                                             hgs, w))
    return nsplit, nw


def _fresh_split_launch(q, ck, cv, pos, layer, k_scale, v_scale, k_new,
                        v_new, stats, nsplit, min_chunk, nw, out, acc, ml,
                        ticket, lib):
    B, H, _, hs = q.shape
    _, Bc, n_kv, S, _ = ck.shape
    m = l = None
    if stats:
        m = torch.empty((B, n_kv, H // n_kv), dtype=torch.float32,
                        device=q.device)
        l = torch.empty_like(m)
    fn = lib.flash_decode_fresh_split_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(q), _build.ptr(ck), _build.ptr(cv),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(k_new),
            _build.ptr(v_new), _build.ptr(pos), _build.ptr(out),
            _build.ptr(m), _build.ptr(l), _build.ptr(acc), _build.ptr(ml),
            _build.ptr(ticket), B, layer, Bc, n_kv, S, hs, H // n_kv,
            nsplit, min_chunk, nw, 1.0 / math.sqrt(hs), _DT[q.dtype],
            _DT[ck.dtype], _build.stream_of(q))
    _build.check(rc, "flash_decode_fresh_split_launch")
    return (out, m, l) if stats else out


def attend(wrapper, q, ck, cv, pos, layer: int, k_scale=None, v_scale=None,
           k_new=None, v_new=None, stats: bool = False):
    """Check the operands, then run the plain version (CPU tensors) or
    launch K2 (CUDA tensors) in the mode :func:`decode_mode` picks, and add
    one to ``wrapper.launches`` (to ``wrapper.launches_stats`` with
    ``stats``) and, in the split mode, also to ``wrapper.launches_split``
    (to ``wrapper.launches_stats_split`` with ``stats``)."""
    _validate(q, ck, cv, pos, layer, k_scale, v_scale, k_new, v_new)
    if q.device.type == "cpu":
        return flash_decode_plain(q, ck, cv, pos, layer, k_scale, v_scale,
                                  k_new, v_new, stats)
    if q.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device "
                         f"{q.device}")
    if decode_mode(q, ck, k_new is not None, stats, cv, k_new,
                   v_new) == "split":
        out = _split_launch(q, ck, cv, pos, layer, k_scale, v_scale,
                            k_new=k_new, v_new=v_new, stats=stats)
        if stats:
            wrapper.launches_stats_split += 1
        else:
            wrapper.launches_split += 1
    else:
        out = _launch(q, ck, cv, pos, layer, k_scale, v_scale, k_new,
                      v_new, stats)
    if stats:
        wrapper.launches_stats += 1
    else:
        wrapper.launches += 1
    return out


def flash_decode_batched(q, ck, cv, pos, layer: int, k_scale=None,
                         v_scale=None, k_new=None, v_new=None,
                         stats: bool = False):
    """Per-slot decode attention over the stacked cache.

    q (B, n_heads, 1, hs); caches (L, B, n_kv, S, hs) int8/bf16/f32; pos
    (B,) int32; ``k_scale``/``v_scale`` (L, B, n_kv, S) f32 mark an int8
    cache; ``k_new``/``v_new`` (B, n_kv, hs) the current token's rows
    (rows [0, pos) are read), or None (rows [0, pos] are read).  Returns
    (B, n_heads, 1, hs) in q.dtype; with ``stats`` also the final running
    max and sum of every query row (after the fresh row), two (B, n_kv,
    hgs) f32 tensors, and the launch counts in ``.launches_stats`` (in the
    split mode also in ``.launches_stats_split``)."""
    return attend(flash_decode_batched, q, ck, cv, pos, layer, k_scale,
                  v_scale, k_new, v_new, stats)


def pos_tensor(pos, device) -> torch.Tensor:
    """pos as the (1,) int32 device tensor the kernel reads: a device
    tensor passes through as a view; a Python int is filled on the device
    (no host-to-device copy)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(torch.int32)
    return torch.full((1,), int(pos), dtype=torch.int32, device=device)


def flash_decode_single(q, ck, cv, pos, layer: int):
    """Single-stream non-fresh decode attention: q (n_heads, 1, hs), caches
    (L, n_kv, S, hs) viewed as a B=1 batched cache (the same memory), rows
    [0, pos] of layer ``layer``.  Returns (n_heads, 1, hs)."""
    L, n_kv, S, hs = ck.shape
    return attend(flash_decode_single, q[None], ck.view(L, 1, n_kv, S, hs),
                  cv.view(L, 1, n_kv, S, hs), pos_tensor(pos, q.device),
                  layer)[0]


def flash_decode_single_plain(q, ck, cv, pos, layer: int):
    """The plain version of :func:`flash_decode_single` on any device."""
    L, n_kv, S, hs = ck.shape
    return flash_decode_plain(q[None], ck.view(L, 1, n_kv, S, hs),
                              cv.view(L, 1, n_kv, S, hs),
                              pos_tensor(pos, q.device), layer)[0]


flash_decode_batched.launches = 0
flash_decode_batched.launches_stats = 0
flash_decode_batched.launches_split = 0
flash_decode_batched.launches_stats_split = 0
flash_decode_single.launches = 0
flash_decode_single.launches_split = 0


def make_attn_batched_flash():
    """attn_bidx(q, cache, pos, layer, k_new, v_new) for
    models.batched.decode_step; q (B, n_heads, hs)."""
    def attn_bidx(q, cache, pos, layer, k_new, v_new):
        return flash_decode_batched(
            q[:, :, None].contiguous(), cache.k, cache.v, pos, layer,
            k_scale=cache.k_scale, v_scale=cache.v_scale,
            k_new=k_new.contiguous(), v_new=v_new.contiguous())[:, :, 0]

    return attn_bidx


def make_attn_batched_plain():
    """The plain version behind the same interface."""
    def attn_bidx(q, cache, pos, layer, k_new, v_new):
        return flash_decode_plain(
            q[:, :, None], cache.k, cache.v, pos, layer,
            k_scale=cache.k_scale, v_scale=cache.v_scale,
            k_new=k_new, v_new=v_new)[:, :, 0]

    return attn_bidx


def make_attn_batched_flash_stats():
    """attn_stats(q, cache, pos0, layer, k_new, v_new) for
    ``models.batched.decode_step_deferred`` (flash_decode.py:538-558): K2
    over cache rows [0, pos0) plus the current token's fresh row, also
    returning the softmax stats, so that the caller merges the staged rows
    of the chunk outside the kernel.  q (B, n_heads, hs); k_new/v_new
    (B, n_kv, hs).  Returns (o (B, n_heads, hs), m, l (B, n_kv, hgs))."""
    def attn_stats(q, cache, pos0, layer, k_new, v_new):
        o, m, l = flash_decode_batched(
            q[:, :, None].contiguous(), cache.k, cache.v, pos0, layer,
            k_scale=cache.k_scale, v_scale=cache.v_scale,
            k_new=k_new.contiguous(), v_new=v_new.contiguous(), stats=True)
        return o[:, :, 0], m, l

    return attn_stats


# -- K2s: speculative-verify attention --------------------------------------

SPEC_ROWS_MAX = 64         # hgs * T query rows per (slot, kv head) block
SPEC_SMEM_FLOATS = 8192    # hgs * T * hs: the block's query rows in f32
SPEC_T_MAX = 64            # the cache tile, which the fresh block reuses


def flash_spec_plain(q, ck, cv, pos, layer: int, k_scale=None, v_scale=None,
                     k_new=None, v_new=None, k_self=None, v_self=None):
    """The K2s arithmetic in plain PyTorch, all in f32
    (``_flash_spec_kernel``, flash_decode.py:579-697): cache scores
    (q.k)/sqrt(hs) times the K row scale over rows [0, pos[b]) strictly;
    the causal fresh block (query t sees fresh rows j <= t) with the
    diagonal from ``k_self`` when given; one softmax over both;
    probabilities times the V row scale before P.V; the diagonal's value
    from ``v_self`` when given.  Not the jnp path
    ``gqa_attention_spec_batched``, which attends a dequantized copy of
    the cache."""
    B, H, T, hs = q.shape
    n_kv, S = ck.shape[2], ck.shape[3]
    hgs = H // n_kv
    scale = 1.0 / math.sqrt(hs)
    f32 = torch.float32
    qf = q.reshape(B, n_kv, hgs, T, hs).to(f32)
    s = torch.einsum("bkgth,bksh->bkgts", qf, ck[layer, :B].to(f32)) * scale
    if k_scale is not None:
        s = s * k_scale[layer, :B][:, :, None, None, :]
    mask = (torch.arange(S, device=q.device)[None, :]
            < pos.to(q.device)[:, None])[:, None, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    s_new = torch.einsum("bkgth,bkjh->bkgtj", qf, k_new.to(f32)) * scale
    t_idx = torch.arange(T, device=q.device)[:, None]
    j_idx = torch.arange(T, device=q.device)[None, :]
    eye = j_idx == t_idx
    if k_self is not None:
        s_diag = torch.einsum("bkgth,bkth->bkgt", qf, k_self.to(f32)) * scale
        s_new = torch.where(eye, s_diag[..., None], s_new)
    s_new = torch.where(j_idx <= t_idx, s_new, torch.full_like(s_new, NEG_INF))
    m = torch.maximum(s.amax(dim=-1), s_new.amax(dim=-1))[..., None]
    e = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    e_new = torch.exp(s_new - m)
    den = e.sum(dim=-1) + e_new.sum(dim=-1)
    if v_scale is not None:
        e = e * v_scale[layer, :B][:, :, None, None, :]
    acc = torch.einsum("bkgts,bksh->bkgth", e, cv[layer, :B].to(f32))
    if v_self is not None:
        diag = torch.where(eye, e_new, torch.zeros_like(e_new)).sum(dim=-1)
        e_new = torch.where(eye, torch.zeros_like(e_new), e_new)
        acc = acc + diag[..., None] * v_self.to(f32)[:, :, None]
    acc = acc + torch.einsum("bkgtj,bkjh->bkgth", e_new, v_new.to(f32))
    return (acc / den[..., None]).reshape(B, H, T, hs).to(q.dtype)


def _validate_spec(q, ck, cv, pos, layer, k_scale, v_scale, k_new, v_new,
                   k_self, v_self):
    B, H, T, hs = q.shape
    n_kv = ck.shape[2]
    R = (H // n_kv) * T
    if (H % n_kv or hs > HS_MAX or not 1 <= T <= SPEC_T_MAX
            or R > SPEC_ROWS_MAX or R * hs > SPEC_SMEM_FLOATS):
        raise ValueError(f"flash_spec kernel: unsupported shape q "
                         f"{tuple(q.shape)} cache {tuple(ck.shape)}")
    exact = k_self is not None
    if k_new is None or v_new is None or exact != (v_self is not None):
        raise ValueError("fresh rows (k_new, v_new) are required; exact "
                         "diagonal rows come as a pair (k_self, v_self)")
    fresh = [k_new, v_new] + ([k_self, v_self] if exact else [])
    _check_operands("flash_spec", q, ck, cv, pos, layer, k_scale, v_scale,
                    fresh, (B, n_kv, T, hs))


SPEC_SPLIT_ROWS = (2, 4, 8)    # the split mode's padded query rows (csrc)


def spec_mode(q, ck) -> str:
    """K2s's mode, a function of shapes and dtypes only: ``"split"``
    (``flash_spec_split_kernel``) for f32 or bf16 q over an f32, bf16 or
    int8 cache with R = hgs * T <= 8 query rows a (slot, kv head) and hs
    a multiple of 16 up to 256; ``"tiled"`` (``flash_spec_kernel``) for
    every other call."""
    _, H, T, hs = q.shape
    n_kv = ck.shape[2]
    return ("split" if q.dtype in (torch.float32, torch.bfloat16)
            and ck.dtype in _DT and H % n_kv == 0
            and 1 <= (H // n_kv) * T <= SPEC_SPLIT_ROWS[-1]
            and hs % 16 == 0 and 16 <= hs <= HS_MAX else "tiled")


def spec_rows(R: int) -> int:
    """RP, the split mode's query rows a block: the least of
    ``SPEC_SPLIT_ROWS`` that holds R."""
    return next(rp for rp in SPEC_SPLIT_ROWS if rp >= R)


def _spec_split_launch(q, ck, cv, pos, layer, k_scale, v_scale, k_new,
                       v_new, k_self, v_self, nsplit=None,
                       min_chunk=SPLIT_MIN_CHUNK, nw=None):
    """Launch K2s's split-row mode on validated CUDA operands: K2's
    split-row loop over cache rows [0, pos) with the R = hgs * T query
    rows (padded to :func:`spec_rows`) as its rows, then the causal fresh
    block.  ``nsplit`` and ``nw`` default to :func:`split_count` and
    :func:`split_block_warps` at RP rows (phase 5 of ``chip_smoke.py``
    and the card tests try others, and other ``min_chunk``).  The caches
    and the fresh rows must start on a 16-byte boundary (the kernel
    raises otherwise), as the verify's own tensors do."""
    B, H, T, hs = q.shape
    _, Bc, n_kv, S, _ = ck.shape
    R = (H // n_kv) * T
    rp = spec_rows(R)
    int8 = ck.dtype == torch.int8
    if nsplit is None:
        nsplit = split_count(B, n_kv, S, rp, int8)
    if nw is None:
        nw = split_block_warps(B, n_kv, nsplit, rp, int8)
    out = torch.empty_like(q)
    acc = ml = ticket = None
    if nsplit > 1:
        acc, ml, ticket = _split_workspace(q.device, B * n_kv,
                                           B * n_kv * nsplit * rp, hs)
    fn = _build.load("flash_decode_split").flash_spec_split_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 11 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(q), _build.ptr(ck), _build.ptr(cv),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(k_new),
            _build.ptr(v_new), _build.ptr(k_self), _build.ptr(v_self),
            _build.ptr(pos), _build.ptr(out), _build.ptr(acc),
            _build.ptr(ml), _build.ptr(ticket), B, layer, Bc, n_kv, S, hs,
            T, R, nsplit, min_chunk, nw, 1.0 / math.sqrt(hs), _DT[q.dtype],
            _DT[ck.dtype], _build.stream_of(q))
    _build.check(rc, "flash_spec_split_launch")
    return out


def _spec_launch(q, ck, cv, pos, layer, k_scale, v_scale, k_new, v_new,
                 k_self, v_self):
    """Launch K2s's tiled kernel (``flash_spec_kernel``) on validated CUDA
    operands."""
    B, H, T, hs = q.shape
    _, Bc, n_kv, S, _ = ck.shape
    out = torch.empty_like(q)
    fn = _build.load("flash_decode").flash_spec_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(q), _build.ptr(ck), _build.ptr(cv),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(k_new),
            _build.ptr(v_new), _build.ptr(k_self), _build.ptr(v_self),
            _build.ptr(pos), _build.ptr(out), B, layer, Bc, n_kv, S, hs, T,
            (H // n_kv) * T, 1.0 / math.sqrt(hs), _DT[q.dtype],
            _DT[ck.dtype], _build.stream_of(q))
    _build.check(rc, "flash_spec_launch")
    return out


def flash_spec_batched(q, ck, cv, pos, layer: int, k_scale=None,
                       v_scale=None, k_new=None, v_new=None, k_self=None,
                       v_self=None):
    """K2s, batched speculative-verify attention over the stacked cache.

    q (B, n_heads, T, hs): slot b's T query rows at positions
    pos[b] .. pos[b]+T-1; caches (L, B, n_kv, S, hs) int8/bf16/f32, read
    in place at layer ``layer``, rows [0, pos[b]) only; ``k_scale``/
    ``v_scale`` (L, B, n_kv, S) f32 mark an int8 cache; ``k_new``/``v_new``
    (B, n_kv, T, hs) the fresh block (quantize-roundtripped with an int8
    cache), attended causally; ``k_self``/``v_self`` the exact rows for the
    diagonal, or None.  pos (B,) int32 on the device: a chunk of rounds
    needs no host value.  Returns (B, n_heads, T, hs) in q.dtype.  A CPU
    tensor takes :func:`flash_spec_plain`; a CUDA tensor launches K2s in
    the mode :func:`spec_mode` picks, or raises.  Every launch adds one to
    ``.launches``, one in the split-row mode also to
    ``.launches_split``."""
    _validate_spec(q, ck, cv, pos, layer, k_scale, v_scale, k_new, v_new,
                   k_self, v_self)
    if q.device.type == "cpu":
        return flash_spec_plain(q, ck, cv, pos, layer, k_scale, v_scale,
                                k_new, v_new, k_self, v_self)
    if q.device.type != "cuda":
        raise ValueError(f"flash_spec_batched: unsupported device {q.device}")
    args = (q, ck, cv, pos, layer, k_scale, v_scale, k_new, v_new, k_self,
            v_self)
    if spec_mode(q, ck) == "split":
        out = _spec_split_launch(*args)
        flash_spec_batched.launches_split += 1
    else:
        out = _spec_launch(*args)
    flash_spec_batched.launches += 1
    return out


flash_spec_batched.launches = 0
flash_spec_batched.launches_split = 0


def make_attn_spec_batched():
    """attn_sbidx(q, cache, pos, layer, k_new, v_new, k_self=, v_self=) for
    ``models.batched.spec_decode_step``: K2s on the stacked cache."""
    def attn_sbidx(q, cache, pos, layer, k_new, v_new, k_self=None,
                   v_self=None):
        def c(t):
            return None if t is None else t.contiguous()
        return flash_spec_batched(
            q.contiguous(), cache.k, cache.v, pos, layer,
            k_scale=cache.k_scale, v_scale=cache.v_scale, k_new=c(k_new),
            v_new=c(v_new), k_self=c(k_self), v_self=c(v_self))

    return attn_sbidx


# -- K2b: block-attend for one slot's prefill tail ---------------------------

BLOCK_ROWS_MAX = 64        # hgs * TQ query rows per (kv head, query tile)
BLOCK_GRID_MIN = 132       # blocks wanted in flight: one per H100 SM


def flash_block_plain(q, ck, cv, slot: int, layer: int, start: int,
                      k_scale=None, v_scale=None, k_new=None, v_new=None):
    """The K2b arithmetic in plain PyTorch, all in f32
    (``_flash_block_kernel``, flash_decode.py:331-423): scores
    (q.k)/sqrt(hs) over slot ``slot``'s cache rows [0, start) of layer
    ``layer``, times the K row scale; the causal fresh block (query t sees
    fresh rows j <= t), un-quantized; one softmax over both; the cache
    part's probabilities times the V row scale before P.V."""
    n_heads, T, hs = q.shape
    n_kv = ck.shape[2]
    hgs = n_heads // n_kv
    scale = 1.0 / math.sqrt(hs)
    f32 = torch.float32
    qf = q.reshape(n_kv, hgs, T, hs).to(f32)
    s = torch.einsum("kgth,ksh->kgts", qf,
                     ck[layer, slot, :, :start].to(f32)) * scale
    if k_scale is not None:
        s = s * k_scale[layer, slot, :, :start][:, None, None, :]
    s_new = torch.einsum("kgth,kjh->kgtj", qf, k_new.to(f32)) * scale
    causal = (torch.arange(T, device=q.device)[None, :]
              <= torch.arange(T, device=q.device)[:, None])
    s_new = torch.where(causal, s_new, torch.full_like(s_new, NEG_INF))
    e = torch.cat([s, s_new], dim=-1)
    e = torch.exp(e - e.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1, keepdim=True)
    e_c, e_n = e[..., :start], e[..., start:]
    if v_scale is not None:
        e_c = e_c * v_scale[layer, slot, :, :start][:, None, None, :]
    acc = (torch.einsum("kgts,ksh->kgth", e_c,
                        cv[layer, slot, :, :start].to(f32))
           + torch.einsum("kgtj,kjh->kgth", e_n, v_new.to(f32)))
    return (acc / den).reshape(n_heads, T, hs).to(q.dtype)


def _validate_block(q, ck, cv, slot, layer, start, k_scale, v_scale, k_new,
                    v_new):
    n_heads, T, hs = q.shape
    _, Bc, n_kv, S, _ = ck.shape
    if (n_heads % n_kv or n_heads // n_kv > BLOCK_ROWS_MAX or hs > HS_MAX
            or T < 1):
        raise ValueError(f"flash_block kernel: unsupported shape q "
                         f"{tuple(q.shape)} cache {tuple(ck.shape)}")
    if not (0 <= slot < Bc and 0 <= start <= S):
        raise ValueError(f"flash_block kernel: slot={slot} start={start} "
                         f"for a cache of {Bc} slots and {S} rows")
    if k_new is None or v_new is None:
        raise ValueError("the fresh block (k_new, v_new) is required")
    _check_operands("flash_block", q, ck, cv, None, layer, k_scale, v_scale,
                    [k_new, v_new], (n_kv, T, hs), B=1)


def block_mode(q, ck, cv=None, k_new=None, v_new=None) -> str:
    """K2b's mode, a function of dtypes, shapes and alignment only:
    ``"tc"`` (the bf16 tensor-core kernel) for bf16 q over an int8 or
    bf16 cache with hs a multiple of 16 up to 256 (past hs 128, where a
    block holds at most 32 query rows, hgs <= 32); ``"tf32"`` (the
    split-TF32 tensor-core kernel, ``csrc/flash_block_tf32.cu``) for every
    other call with hs a multiple of 8 up to 256 (past hs 128, at most 16
    query rows a block: hgs <= 16) and q and the caches and fresh block
    given (``cv``, ``k_new``, ``v_new`` when passed) on a 16-byte
    boundary; ``"f32"`` (the f32 CUDA-core kernel) for the rest: other
    head sizes and head groups, and misaligned views."""
    hs = q.shape[-1]
    hgs = q.shape[0] // ck.shape[2]
    if hs > HS_MAX:
        return "f32"
    if (q.dtype == torch.bfloat16 and ck.dtype in (torch.int8, torch.bfloat16)
            and hs % 16 == 0 and (hs <= 128 or hgs <= 32)):
        return "tc"
    if (hs % 8 == 0 and (hs <= 128 or hgs <= 16)
            and aligned16(q, ck, cv, k_new, v_new)):
        return "tf32"
    return "f32"


def block_rows(T: int, hgs: int, n_kv: int, mode: str = "f32",
               hs: int = 128) -> int:
    """TQ, the query positions a block takes: at most 64 // hgs rows (and
    no more than T needs), halved while the grid of n_kv x ceil(T / TQ)
    blocks would leave SMs idle -- down to 8 in the f32 mode; in the TC
    and TF32 modes (past hs 128 at most 32 and 16 rows) down to the least
    TQ that keeps hgs * TQ a multiple of 16 (a warp's 16 rows), where the
    row limit allows one (else the kernel pads its rows to 16)."""
    if mode == "f32":
        tq = min(BLOCK_ROWS_MAX // hgs, 1 << max(T - 1, 0).bit_length())
        while tq > 8 and n_kv * -(-T // tq) < BLOCK_GRID_MIN:
            tq //= 2
        return max(tq, 1)
    rows = (BLOCK_ROWS_MAX if hs <= 128 else
            BLOCK_ROWS_MAX // 2 if mode == "tc" else BLOCK_ROWS_MAX // 4)
    unit = 16 // math.gcd(hgs, 16)
    if hgs * unit > rows:
        unit = 1
    tq = min(rows // hgs // unit,
             1 << max(-(-T // unit) - 1, 0).bit_length()) * unit
    while tq % (2 * unit) == 0 and n_kv * -(-T // tq) < BLOCK_GRID_MIN:
        tq //= 2
    return tq


def flash_block_attend(q, ck, cv, slot: int, layer: int, start: int,
                       k_scale=None, v_scale=None, k_new=None, v_new=None):
    """K2b, T-row attention for one slot of the stacked cache: rows
    [0, start) of slot ``slot`` / layer ``layer`` plus the causal fresh
    block.  q (n_heads, T, hs) at positions start .. start+T-1; caches
    (L, B, n_kv, S, hs) int8/bf16/f32, read in place; ``k_scale``/
    ``v_scale`` (L, B, n_kv, S) f32 mark an int8 cache; ``k_new``/``v_new``
    (n_kv, T, hs) the block's own K/V in q's dtype; slot, layer and start
    host ints.  Any T <= S is taken (the TPU kernel's T * n_heads <= 4096
    limit is Mosaic's).  Returns (n_heads, T, hs) in q.dtype.  A CPU
    tensor takes :func:`flash_block_plain`; a CUDA tensor launches K2b in
    the mode :func:`block_mode` picks, or raises.  Every mode counts in
    ``.launches``, the TC mode also in ``.launches_tc``, the TF32 mode in
    ``.launches_tf32``."""
    _validate_block(q, ck, cv, slot, layer, start, k_scale, v_scale, k_new,
                    v_new)
    if q.device.type == "cpu":
        return flash_block_plain(q, ck, cv, slot, layer, start, k_scale,
                                 v_scale, k_new, v_new)
    if q.device.type != "cuda":
        raise ValueError(f"flash_block_attend: unsupported device {q.device}")
    return _block_launch(block_mode(q, ck, cv, k_new, v_new), q, ck, cv,
                         slot, layer, start, k_scale, v_scale, k_new, v_new)


def _block_launch(mode, q, ck, cv, slot, layer, start, k_scale, v_scale,
                  k_new, v_new, lib=None):
    """Launch K2b in ``mode`` on validated CUDA operands and count it.  The
    f32 mode takes any operands :func:`flash_block_attend` takes (phase 5
    of ``chip_smoke.py`` times it on the other modes' inputs too).
    ``lib``: another build of the TF32 mode's library (the design tool's
    variants, ``tools/block_tf32_design.py``)."""
    n_heads, T, hs = q.shape
    _, Bc, n_kv, S, _ = ck.shape
    hgs = n_heads // n_kv
    out = torch.empty_like(q)
    dts = [_DT[q.dtype], _DT[ck.dtype]]
    if mode == "tc":        # bf16 q: the cache's dtype code only
        fn, dts = _build.load("flash_block_tc").flash_block_tc_launch, dts[1:]
    elif mode == "tf32":
        fn = (lib or _build.load("flash_block_tf32")).flash_block_tf32_launch
    else:
        fn = _build.load("flash_decode").flash_block_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
        + [ctypes.c_float] + [ctypes.c_int] * len(dts) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(q), _build.ptr(ck), _build.ptr(cv),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(k_new),
            _build.ptr(v_new), _build.ptr(out), layer, slot, start, Bc, n_kv,
            S, hs, T, hgs, block_rows(T, hgs, n_kv, mode, hs),
            1.0 / math.sqrt(hs), *dts, _build.stream_of(q))
    _build.check(rc, f"flash_block_launch ({mode} mode)")
    flash_block_attend.launches += 1
    if mode == "tc":
        flash_block_attend.launches_tc += 1
    elif mode == "tf32":
        flash_block_attend.launches_tf32 += 1
    return out


flash_block_attend.launches = 0
flash_block_attend.launches_tc = 0
flash_block_attend.launches_tf32 = 0


def make_attn_tail():
    """attn_tail(q, cache, slot, layer, start, k_new, v_new) for
    ``models.batched.prefill_into_slot_at`` (flash_decode.py:495-509): K2b
    on the stacked cache.  q (n_heads, T, hs); k_new/v_new (n_kv, T, hs)."""
    def attn_tail(q, cache, slot, layer, start, k_new, v_new):
        return flash_block_attend(
            q.contiguous(), cache.k, cache.v, slot, layer, start,
            k_scale=cache.k_scale, v_scale=cache.v_scale,
            k_new=k_new.contiguous(), v_new=v_new.contiguous())

    return attn_tail


def make_attn_indexed_flash():
    """attn_idx(q, ck_full, cv_full, pos, layer) for
    ``models.llama.forward``: K2 non-fresh for one query row (T = 1), the
    plain masked attention on the layer's cache for a block of rows (the
    JAX package's jnp fallback for prefill, flash_decode.py:572-574)."""
    from fastllama_tpu_torch.ops.attention import gqa_attention

    def attn_idx(q, ck, cv, pos, layer):
        if q.shape[1] == 1:
            return flash_decode_single(q, ck, cv, pos, layer)
        return gqa_attention(q, ck[layer], cv[layer], pos)

    return attn_idx


def make_attn_indexed_plain():
    """The plain versions behind :func:`make_attn_indexed_flash`'s
    interface (rows [0, pos] for T = 1, masked attention otherwise)."""
    from fastllama_tpu_torch.ops.attention import gqa_attention

    def attn_idx(q, ck, cv, pos, layer):
        if q.shape[1] == 1:
            return flash_decode_single_plain(q, ck, cv, pos, layer)
        return gqa_attention(q, ck[layer], cv[layer], pos)

    return attn_idx
