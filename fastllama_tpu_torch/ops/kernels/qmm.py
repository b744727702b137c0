"""K1: group-dequant matmul (``csrc/qmm.cu``) and its plain version.

Replaces ``qmatmul_pallas`` (fastllama_tpu/ops/pallas/qmm.py:251) and
``qmatmul_pallas_indexed`` (qmm.py:551).  The indexed form is the same
kernel on ``w[layer]``, a free view of the contiguous stacked weight.

K1f, the same kernel with an rmsnorm prologue and/or a residual epilogue,
replaces ``_qmm_kernel_idx_fused`` (qmm.py:470, launched at :656): the
per-layer glue of ``models/llama.forward``.  The JAX package applies the
norm outside its kernel when its TPU tiling splits K (qmm.py:618-623) or
the shape is unsupported (:714-719); the port always fuses.

K1p, the packed mode of the same kernel, replaces the packed INT4 branches
(``_qmm_kernel_p4``, qmm.py:266-296 and :368-402; ``_qmm_kernel_p4_idx``,
:571-612 and :418-440): split-half nibble-packed (I/2, O) weights,
``bf16(f32(nibble) * f32(scale))`` with one rounding, bf16 x, f32 sums, at
any compute dtype (the packed kernel has no wide path).  The JAX indexed
form applies the norm outside and never reads ``residual`` (:571-612);
the port fuses both, so ``out = to_x_dtype(residual + norm(x) @ W)`` for
every layout.  An INT4 weight that does not pack stays int8-held and takes
K1's non-wide path, exactly like INT8.

The groupdot (scale-after-dot) mode of K1 and K1p replaces
``_qmm_chunk_groupdot`` (qmm.py:89-106, run by ``_qmm_kernel`` at
:109-119) and ``_groupdot_p4`` (:405-416, run by ``_qmm_kernel_p4``):
``qmatmul_pallas(..., groupdot=True)``, the plain form only, as in JAX.
The int8 values (or sign-extended nibbles) go to bf16 with no scale, x to
bf16, each gs-row group is contracted in f32 and its partial multiplied by
the group's scale as an exact f32 value (:func:`qmm_groupdot_plain`).  An
INT8 weight takes it when not wide; INT16 or f32 compute keep the
standard wide path (qmm.py:111) and count as ordinary K1 launches; a packed
weight takes it at any compute dtype.  The kernel takes group sizes that
are a multiple of 16 (a k = 16 tensor-core step never straddles two
groups); any other raises on a CUDA tensor.

``splits`` fixes the split-K count (the port's counterpart of the Pallas
``tiles``/``k_inner`` sweep overrides, qmm.py:251-262); a count that
leaves a split empty raises, as JAX raises on non-dividing tiles.

The pipelined mode (``qmm_pipe_kernel``) takes every standard-mode call
of K1 and K1p that is not wide, 16-byte aligned, has a group size that is
a multiple of 64 (an unpacked weight: of 32, :func:`pipe_gs_ok`) and T <=
128 rows: the batched decode step, the single stream with its K1f glue
and the speculative verify.  Below a multiple of 64 (GGUF ``Q8_0``'s 32)
it takes its G32 instantiation (``qmm_pipe_g32_kernel``, :func:`g32`): a
scale row a 32-row half of a stage.  Its groupdot instantiation
(``qmm_pipe_gd_kernel``) takes the groupdot calls of that kind at a
multiple of 64 (:func:`groupdot_kernel`).  The unaligned element path,
other group sizes (16, 80) and the T > 128 calls that the prefill mode
does not take stay on ``qmm_bf16_kernel``'s loop, groupdot or not.
:func:`qmm_mode` says which a call takes and :func:`pipe_plan` gives the
pipelined launch's row tile, warps and split-K count.  It computes what
the loop computes; only the f32 sum order differs.

The wide mode (f32 compute, or INT16; :func:`is_wide`) replaces the JAX
wide kernel (f32 dequant and a ``Precision.HIGHEST`` dot, qmm.py:62-74).
Its calls with a group size that is a multiple of 32, 16-byte aligned rows
and a residual, if any, at a 16-byte aligned address take one of two
kernels (each with a G32 instantiation below a multiple of 64, whose
32-row halves of a stage take a partial and a scale row each) that
compute it on bf16 tensor cores: the exact integers times x
split into three bf16 planes (hi, mid, lo: f32's 24-bit significand; one
plane for a bf16 x), each group's partial times its f32 scale.  An int16
weight is two exact bf16 planes, ``w = 256 * (w >> 8) + (w & 0xFF)``
(:func:`int16_planes`), both multiplied into the same partial: two passes
on bf16 x, six on f32 x.  Up to 128 rows the ring's wide
instantiation (``qmm_pipe_wide_kernel``, :func:`wide_kernel` ``"pipe"``;
``tests/test_torch_wide_pipe.py`` emulates it against the Pallas wide
kernel); above, the prefill mode's wide kernel (``qmm_wgmma_wide_kernel``
in ``csrc/qmm_prefill.cu``, ``"prefill"``: the batched prefill waves at
f32 compute and K1f's glue on a long single-stream block; a pre-pass
writes the planes once a call, TMA brings them and the raw weight into a
ring, the exact integers are ``wgmma``'s register A operand;
:func:`wide_prefill_plan`; ``tests/test_torch_wide_prefill.py``).  The
rest (other group sizes, unaligned rows, an offset residual) stays on
``qmm_f32_kernel`` (``"f32"``).  A groupdot call that is wide takes
the same kernel as the standard one.

The prefill mode (``qmm_wgmma_kernel`` in ``csrc/qmm_prefill.cu``, its
own library) takes the calls above 128 rows that would otherwise take the
loop: not wide, an int8-held or packed weight, a group size that is a
multiple of 64 (an unpacked weight: of 32 with I a multiple of 64; below
64 ``qmm_wgmma_g32_kernel``), 16-byte aligned rows and residual
(:func:`prefill_kernel` ``"prefill"``).  These are the prefill waves
(``prefill_many`` on up to 2048 rows, INT8 and INT4) and K1f's glue on a
single-stream block of more than 128 tokens.  TMA brings the raw weight
and x into a ring of stages,
each thread dequantizes its weight bytes into ``wgmma``'s register A
operand (the product is computed transposed) and x is the B operand in
shared memory; a pre-pass writes bf16 x once a call where x is f32 or the
norm runs.  It computes what the loop computes; only the f32 sum order
differs.  :func:`prefill_plan` gives its tile, ring, shared memory, boxes,
grid and split-K count.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  Each wrapper counts its launches in ``.launches``, and
those on a packed weight (K1p) in ``.launches_p4``, those in the
pipelined mode (K1 and K1p) also in ``.launches_pipe``, those in the
prefill mode (K1 and K1p) also in ``.launches_prefill``, those in the wide
mode's ring also in ``.launches_wide_pipe`` and those in its prefill
kernel in ``.launches_wide_prefill``; ``qmatmul_pallas``
counts its groupdot launches in ``.launches_groupdot`` (K1) and
``.launches_groupdot_p4`` (K1p), those on the pipelined ring also in
``.launches_groupdot_pipe``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from fastllama_tpu_torch.config import QuantType
from fastllama_tpu_torch.ops.kernels import _build
from fastllama_tpu_torch.quant.groupquant import QArray, dequantize

_DT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int16: 3}
BM, BN = 64, 64            # output tile of both kernel paths


def is_wide(w: QArray, compute_dtype) -> bool:
    """INT16 values overflow bf16's mantissa, and an f32 compute dtype asks
    for full precision: both take the f32 dequant + f32 dot path.  A packed
    INT4 weight has no wide path (the JAX kernel's contract)."""
    if w.packed:
        return False
    return w.qtype == QuantType.INT16 or compute_dtype == torch.float32


def _dot_f32(x: torch.Tensor, w: QArray, compute_dtype) -> torch.Tensor:
    """x @ dequant(w) in f32, rounded as the kernel rounds (see qmm_plain
    and qmm_p4_plain)."""
    if w.packed:
        wf = dequantize(w, torch.float32).to(torch.bfloat16)
        return torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                            wf.to(torch.float32))
    if is_wide(w, compute_dtype):
        return torch.matmul(x.to(torch.float32), dequantize(w, torch.float32))
    wf = dequantize(w, torch.bfloat16).to(torch.float32)
    return torch.matmul(x.to(torch.bfloat16).to(torch.float32), wf)


def qmm_plain(x: torch.Tensor, w: QArray,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: INT8 non-wide dequantizes
    to bf16(bf16(w) * bf16(s)) and multiplies bf16-rounded x in f32 (bf16
    products are exact in f32); the wide path dequantizes and multiplies in
    f32; a packed weight takes :func:`qmm_p4_plain`'s arithmetic.  Returns
    x.dtype."""
    return _dot_f32(x, w, compute_dtype).to(x.dtype)


def qmm_fused_plain(x: torch.Tensor, w: QArray, compute_dtype=torch.bfloat16,
                    norm_gain=None, eps: float = 1e-5,
                    residual=None) -> torch.Tensor:
    """K1f's arithmetic (``_qmm_kernel_idx_fused``, qmm.py:505-527):
    ``norm_gain`` normalizes x over its whole row with ONE rounding,
    ``to_x_dtype(x * rsqrt(mean(x^2) + eps) * gain)`` in f32 (not
    ``ops.norms.rmsnorm``, which rounds before the gain); ``residual``
    starts the f32 accumulator, so ``out = to_x_dtype(residual + x @ W)``."""
    if norm_gain is not None:
        xf = x.to(torch.float32)
        r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        xn = (xf * r * norm_gain.to(torch.float32)).to(x.dtype)
    else:
        xn = x
    out = _dot_f32(xn, w, compute_dtype)
    if residual is not None:
        out = residual.to(torch.float32) + out
    return out.to(x.dtype)


def qmm_p4_plain(x: torch.Tensor, w: QArray, compute_dtype=torch.bfloat16,
                 norm_gain=None, eps: float = 1e-5,
                 residual=None) -> torch.Tensor:
    """K1p's arithmetic (``_qmm_kernel_p4``, qmm.py:368-402) on a packed
    (I/2, O) QArray: each nibble sign-extended to [-8, 7], dequantized as
    ``bf16(f32(nibble) * f32(scale))`` (one rounding; a bf16 scale enters
    as its exact f32 value), times bf16-rounded x, summed in f32, at any
    ``compute_dtype``.  The glue is K1f's (:func:`qmm_fused_plain`), and
    the residual is always added."""
    if not w.packed:
        raise ValueError("qmm_p4_plain takes a packed INT4 QArray")
    return qmm_fused_plain(x, w, compute_dtype, norm_gain, eps, residual)


def qmm_groupdot_plain(x: torch.Tensor, w: QArray,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The groupdot mode's arithmetic (``_qmm_chunk_groupdot``,
    qmm.py:89-106; ``_groupdot_p4``, :405-416): the int8 values, or the
    sign-extended nibbles of a packed weight, to bf16 unscaled; x to bf16;
    each gs-row group contracted in f32 (bf16 products are exact in f32);
    each group's partial times the group scale as an exact f32 value (a
    bf16-stored scale promoted, the product not rounded); the groups
    summed in f32; x's dtype out.  A wide unpacked weight (INT16, or f32
    compute) takes :func:`qmm_plain`, as the JAX kernel takes its standard
    wide path."""
    if not w.packed and is_wide(w, compute_dtype):
        return qmm_plain(x, w, compute_dtype)
    u = w.unpacked()
    I, O = u.data.shape
    G = I // w.group_size
    wb = u.data.to(torch.bfloat16).to(torch.float32).reshape(G, -1, O)
    xb = x.to(torch.bfloat16).to(torch.float32).reshape(x.shape[0], G, -1)
    part = torch.bmm(xb.transpose(0, 1), wb)          # (G, T, O)
    out = (part * w.scales.to(torch.float32)[:, None, :]).sum(dim=0)
    return out.to(x.dtype)


def _split_k(T: int, I: int, O: int, kstep: int, n_sm: int):
    """(splits, k_per_split): split the contraction over blocks when the
    output tiles alone give fewer than four blocks per SM (decode shapes),
    so that enough weight loads are in flight to stream device memory."""
    tiles = -(-O // BN) * -(-T // BM)
    target = 4 * n_sm
    if tiles >= target:
        return 1, I
    splits = min(-(-target // tiles), max(1, I // (8 * kstep)), 16)
    per_split = -(-I // splits)
    kps = -(-per_split // kstep) * kstep
    return -(-I // kps), kps


def split_plan(T: int, I: int, O: int, w: QArray, compute_dtype,
               splits=None, n_sm: int = 132):
    """(splits, k_per_split) of a launch: ``splits=None`` takes the
    :func:`_split_k` rule for ``n_sm`` SMs; an explicit count must be a
    positive int that leaves no split empty, else ValueError.
    k_per_split counts the rows of W the kernel walks (K1p: the I/2 packed
    rows, 32 a stage; K1: 64, or 16 on the wide path), whole stages."""
    k_rows, kstep = ((I // 2, 32) if w.packed else
                     (I, 16 if is_wide(w, compute_dtype) else 64))
    if splits is None:
        return _split_k(T, k_rows, O, kstep, n_sm)
    return _explicit_split(k_rows, kstep, splits)


PIPE_MAX_T = 128           # the pipelined mode's largest row count
PIPE_COLS = 128            # output columns of a pipelined block
PIPE_ROWS = (16, 48, 64, 128)  # the row tiles
PIPE_STAGES = 3            # the ring's depth (qmm.cu's PK_NS)
# the wide ring's depth at 48 rows, by weight bytes (qmm.cu's
# QMM_WIDE_STAGES48 and QMM_WIDE16_STAGES48)
WIDE_PIPE_STAGES48 = {1: 2, 2: 2}
PIPE_X_COLS = 64           # x columns a stage (qmm.cu's PK_X)


def qmm_mode(x: torch.Tensor, w: QArray, compute_dtype=torch.bfloat16,
             groupdot: bool = False, residual=None) -> str:
    """The kernel a call takes, from dtypes, shapes, alignment and flags:
    ``"groupdot"`` (the scale-after-dot mode, on the ring or the loop by
    :func:`groupdot_kernel`), ``"wide"`` (INT16 or f32 compute, unpacked:
    the wide ring, the wide prefill kernel or ``qmm_f32_kernel`` by
    :func:`wide_kernel`),
    ``"scalar"`` (rows not 16-byte aligned: the loop's element path),
    ``"pipe"`` (the pipelined mode: T <= 128, a group size of
    :func:`pipe_gs_ok`, so that a stage (or each 32-row half of it) holds
    one group, and a ``residual``, if any, at a 16-byte aligned address,
    since its epilogue reads the residual by vectors) or
    ``"loop"`` (the rest: prefill waves, other group sizes, an offset
    residual; :func:`prefill_kernel` sends those above 128 rows with a
    group size of :func:`pipe_gs_ok`, I a multiple of 64 and an aligned
    residual to the prefill mode, the others to ``qmm_bf16_kernel``'s
    vector loop)."""
    if groupdot and (w.packed or not is_wide(w, compute_dtype)):
        return "groupdot"
    if is_wide(w, compute_dtype):
        return "wide"
    if not _vec_ok(x, w):
        return "scalar"
    if x.shape[0] <= PIPE_MAX_T and pipe_gs_ok(w) and (
            residual is None or residual.data_ptr() % 16 == 0):
        return "pipe"
    return "loop"


def pipe_gs_ok(w: QArray) -> bool:
    """The group sizes of the ring's and the prefill mode's standard and
    wide kernels: a multiple of 64 (a stage's 64 rows, or K1p's plane, in
    one group), or for an unpacked weight of 32 (each 32-row half of a
    stage in one group: the G32 instantiations, :func:`g32`)."""
    return w.group_size % (64 if w.packed else 32) == 0


def g32(w: QArray) -> bool:
    """Whether a call on ``w`` that the ring or the prefill mode takes
    runs their G32 instantiation (an unpacked weight at a group size that
    is a multiple of 32 and not of 64, such as GGUF ``Q8_0``'s 32: a scale
    row a 32-row half of a stage, each half's own partial in the wide
    mode)."""
    return not w.packed and w.group_size % 64 != 0


def groupdot_kernel(x: torch.Tensor, w: QArray,
                    compute_dtype=torch.bfloat16) -> str:
    """The kernel of a groupdot call (:func:`qmm_mode` ``"groupdot"``):
    ``"pipe"``, the groupdot instantiation of ``qmm_pipe_kernel``'s ring,
    for T <= 128, a group size that is a multiple of 64 (a stage's plane
    lies in one group) and 16-byte aligned rows; else ``"loop"``,
    ``qmm_bf16_kernel``'s ``mma.sync`` groupdot mode (T > 128, group sizes
    of 16, 32, 80..., rows off 16 bytes such as O = 1000).  A wide
    unpacked call is no groupdot call (it takes the standard wide path):
    ValueError."""
    if not w.packed and is_wide(w, compute_dtype):
        raise ValueError("a wide unpacked call takes the standard wide "
                         "path, not the groupdot mode")
    if x.shape[0] <= PIPE_MAX_T and w.group_size % 64 == 0 and _vec_ok(x, w):
        return "pipe"
    return "loop"


def wide_kernel(x: torch.Tensor, w: QArray, compute_dtype=torch.float32,
                residual=None) -> str:
    """The kernel of a wide call (:func:`qmm_mode` ``"wide"``), for an
    int8-held weight (INT8, or INT4 that did not pack) or an int16 one
    (INT16, as two bf16 planes), a group size that is a multiple of 32
    (below 64 the kernels' G32 instantiations, :func:`g32`), 16-byte
    aligned rows and a ``residual``, if any, at a 16-byte aligned address:
    ``"pipe"``, the wide instantiation of ``qmm_pipe_kernel``'s ring, for
    T <= 128; ``"prefill"``, ``qmm_wgmma_wide_kernel``, above (prefill
    waves, a long K1f block) where I is a multiple of 64 (its stages).
    Else ``"f32"``, ``qmm_f32_kernel`` (gs of 16 or 80, O = 1000, an offset
    residual...).  A packed weight has no wide path, and a call that is not
    wide takes another mode: ValueError."""
    if w.packed or not is_wide(w, compute_dtype):
        raise ValueError("not a wide call: a packed weight or a non-wide "
                         "compute dtype takes another mode")
    if (pipe_gs_ok(w) and _vec_ok(x, w)
            and (residual is None or residual.data_ptr() % 16 == 0)):
        if x.shape[0] <= PIPE_MAX_T:
            return "pipe"
        if x.shape[1] % 64 == 0:
            return "prefill"
    return "f32"


def int16_planes(data: torch.Tensor):
    """The wide kernels' two planes of an int16 weight, ``(hi, lo)`` with
    ``data == 256 * hi + lo``: ``hi = data >> 8`` (arithmetic shift, the
    signed high byte) and ``lo = data & 0xFF`` (the unsigned low byte).  Each
    of ``lo`` and ``256 * hi`` is exact in bf16 (at most 8 significant
    bits)."""
    return data >> 8, data & 0xFF


def prefill_kernel(x: torch.Tensor, w: QArray,
                   compute_dtype=torch.bfloat16, residual=None) -> str:
    """The kernel of a call that :func:`qmm_mode` calls ``"loop"``:
    ``"prefill"``, the ``wgmma`` prefill mode, for T > 128, a group size
    of :func:`pipe_gs_ok` (a stage's plane, or each 32-row half, lies in
    one group), I a multiple of 64 (its stages) and a ``residual``, if
    any, at a 16-byte aligned address (its epilogue reads it by vectors);
    else ``"loop"``, ``qmm_bf16_kernel`` (group sizes of 16, 80..., an
    offset residual, T <= 128 off the ring).  A call that
    :func:`qmm_mode` sends elsewhere: ValueError."""
    mode = qmm_mode(x, w, compute_dtype, False, residual)
    if mode != "loop":
        raise ValueError(f"not a loop call: qmm_mode gives {mode!r}")
    return _loop_kernel(x, w, residual)


def _loop_kernel(x: torch.Tensor, w: QArray, residual) -> str:
    """:func:`prefill_kernel`'s choice for a call :func:`qmm_mode` calls
    ``"loop"`` (unchecked)."""
    if (x.shape[0] > PIPE_MAX_T and pipe_gs_ok(w)
            and x.shape[1] % 64 == 0
            and (residual is None or residual.data_ptr() % 16 == 0)):
        return "prefill"
    return "loop"


def _kernel(x: torch.Tensor, w: QArray, compute_dtype, groupdot: bool,
            residual) -> str:
    """:func:`qmm_mode`'s choice, a groupdot call resolved to its kernel by
    :func:`groupdot_kernel`, a wide call by :func:`wide_kernel`
    (``"wide_pipe"`` the ring, ``"wide_prefill"``
    ``qmm_wgmma_wide_kernel``, ``"wide"`` ``qmm_f32_kernel``) and a loop
    call by :func:`prefill_kernel` (``"prefill"`` or ``"loop"``)."""
    mode = qmm_mode(x, w, compute_dtype, groupdot, residual)
    if mode == "groupdot":
        return groupdot_kernel(x, w, compute_dtype)
    if mode == "wide":
        return {"pipe": "wide_pipe", "prefill": "wide_prefill"}.get(
            wide_kernel(x, w, compute_dtype, residual), "wide")
    if mode == "loop":
        return _loop_kernel(x, w, residual)
    return mode


@dataclass(frozen=True)
class PipePlan:
    """A pipelined launch: ``rows`` the row tile (16, 48, 64 or 128, at
    least T); ``warps`` over ``cols`` output columns a block; the split-K
    count and the W rows a split (K1p: packed rows; whole stages of
    ``kstep``)."""
    rows: int
    warps: int
    cols: int
    splits: int
    k_per_split: int
    kstep: int


def pipe_shape(T: int, I: int, O: int, groupdot: bool = False) -> tuple:
    """(rows, warps) of the pipelined launch of a (T, I) x (I, O) product.
    The row tile is the least of 16, 48, 64, 128 that holds T; its 128
    columns go to 4 warps, or at 128 rows on a weight of I <= 4096 and
    O <= 12288 to 8 (half the accumulators a thread, twice the warps an
    SM: the faster on those 7B shapes in the H100 sweep, the slower on the
    others).  The groupdot mode (``groupdot``; the wide ring, which runs
    its body, too) keeps a partial beside the accumulators, which 4 warps
    of 128 rows have no registers for: it takes 8 warps at every 128-row
    launch."""
    if not 1 <= T <= PIPE_MAX_T:
        raise ValueError(f"the pipelined mode takes 1 <= T <= {PIPE_MAX_T},"
                         f" not {T}")
    rows = next(r for r in PIPE_ROWS if r >= T)
    eight = rows == 128 and (groupdot or (I <= 4096 and O <= 12288))
    return rows, 8 if eight else 4


def pipe_plan(T: int, I: int, O: int, packed: bool, *, resident: int,
              splits=None, n_sm: int = 132,
              groupdot: bool = False) -> PipePlan:
    """The pipelined launch of a (T, I) x (I, O) product: the row tile and
    warps of :func:`pipe_shape` (``groupdot``: of the groupdot mode or the
    wide ring), and the split-K count.
    ``splits=None``: at 16 rows as many splits as leave each at least 4
    stages (the partials are one row), up to 16; above, as many blocks as
    the SMs hold at once (``resident`` blocks an SM, the card's occupancy
    count for this launch, :func:`_pipe_resident`), rounded down to whole
    splits of the output tiles, since each split adds T x O f32 partials
    to write and sum (the rule that read best in the sweep on an H100 at
    T <= 64; at 128 rows it splits some shapes too little, see PERF.md).
    An explicit count must leave no split empty (:func:`split_plan`)."""
    rows, warps = pipe_shape(T, I, O, groupdot)
    kstep = 32 if packed else 64
    k_rows = I // 2 if packed else I
    if splits is None:
        most = max(1, min(k_rows // (4 * kstep), 16))
        tiles = -(-O // PIPE_COLS)
        splits = (most if rows == 16 else
                  max(1, min(resident * n_sm // tiles, most)))
        kps = -(-(-(-k_rows // splits)) // kstep) * kstep
        splits = -(-k_rows // kps)
    else:
        splits, kps = _explicit_split(k_rows, kstep, splits)
    return PipePlan(rows, warps, PIPE_COLS, splits, kps, kstep)


def pipe_smem(rows: int, warps: int, x_f32: bool, s_f32: bool,
              conv: bool, wide: bool = False, w_bytes: int = 1) -> dict:
    """The shared memory of a ring block (mirrors ``pipe_smem`` and
    ``pipe_allow_smem`` in ``csrc/qmm.cu``), unpacked weights: ``stages``
    slots of ``stage_bytes`` (64 W rows of ``w_bytes``-byte weights at a
    pitch of ``w_bytes * 128 + 16``, the x tile of ``rows`` rows at its row
    + 16, the scale row), the bf16 x planes when x is converted (``conv``:
    f32 x or the norm; three planes in the wide mode on f32 x), ``smem`` in
    all and the ``static`` arrays beside it.  ``wide``: the wide ring
    (int8-held or, ``w_bytes=2``, INT16).  The G32 instantiations
    (:func:`g32`) take the same: their second scale row a stage sits in
    the 16-byte pads that end the first W rows (:func:`g32_pad_offset`)."""
    xs, ss = (4 if x_f32 else 2), (4 if s_f32 else 2)
    stage = 64 * (w_bytes * PIPE_COLS + 16) + rows * (PIPE_X_COLS * xs + 16) \
        + PIPE_COLS * ss
    stages = (WIDE_PIPE_STAGES48[w_bytes] if wide and rows == 48
              else PIPE_STAGES)
    planes = 3 if wide and x_f32 else 1
    smem = stages * stage + (planes * rows * (PIPE_X_COLS * 2 + 16)
                             if conv else 0)
    return {"stages": stages, "stage_bytes": stage, "smem": smem,
            "static": 4 * rows * (1 + warps)}


def g32_pad_offset(col: int, scale_bytes: int, w_bytes: int = 1) -> int:
    """The byte offset in a ring slot of column ``col``'s scale in a G32
    stage's second scale row (``pad_scales`` and ``copy_stage`` in
    ``csrc/qmm.cu``): its 16-byte chunk q of the row sits in the pad after
    W row q (rows of ``w_bytes * 128`` bytes at a pitch 16 bytes more)."""
    off = col * scale_bytes
    return (off // 16) * (w_bytes * PIPE_COLS + 16) + w_bytes * PIPE_COLS \
        + off % 16


def _explicit_split(k_rows: int, kstep: int, splits):
    """(splits, k_per_split) of an explicit split count: a positive int that
    leaves no split empty, else ValueError."""
    if isinstance(splits, int) and splits >= 1:
        kps = -(-(-(-k_rows // splits)) // kstep) * kstep
        if -(-k_rows // kps) == splits:
            return splits, kps
    raise ValueError(f"splits {splits!r} does not fit {k_rows} rows in "
                     f"stages of {kstep}: each split needs a stage")


PREFILL_ROWS = 256         # rows of x a prefill block (the wgmma N)
PREFILL_COLS = 128         # output columns a prefill block: one W box
PREFILL_STAGES = {False: 5, True: 4}   # the prefill ring's depth (K1, K1p)
PREFILL_XK = 32            # x columns a plane of a stage
PREFILL_SMEM_BLOCK = 232448   # shared memory an H100 block may use
WIDE_PREFILL_ROWS = 128    # the wide mode: rows of x a block
WIDE_PREFILL_KSTEP = 64    # W rows a stage (two parts of 32)
WIDE_PREFILL_MAX_STAGES = 8


@dataclass(frozen=True)
class PrefillPlan:
    """A prefill launch (``csrc/qmm_prefill.cu``): ``rows`` x ``cols``
    outputs a block over ``grid`` (column tiles, row tiles, splits);
    ``kstep`` W rows a stage (K1p: packed rows) in a ring of ``stages``
    slots of ``stage_bytes``, ``smem`` bytes of dynamic shared memory and
    ``static_smem`` of barriers; the TMA boxes (inner, outer elements) of W
    (int8, 128-byte swizzle; one a stage), x (bf16, 64-byte swizzle;
    ``x_boxes`` a stage, from ``x_planes`` bf16 planes of x) and the scales
    (one row a nibble plane), ``tx_bytes`` a stage; the split-K count and
    the W rows a split."""
    rows: int
    cols: int
    grid: tuple
    splits: int
    k_per_split: int
    kstep: int
    stages: int
    stage_bytes: int
    smem: int
    static_smem: int
    w_box: tuple
    x_box: tuple
    s_box: tuple
    tx_bytes: int
    x_planes: int = 1
    x_boxes: int = 2
    w_boxes: int = 1


def prefill_plan(T: int, I: int, O: int, packed: bool,
                 scale_bytes: int = 4, splits=None,
                 n_sm: int = 132, g32: bool = False) -> PrefillPlan:
    """The prefill launch of a (T, I) x (I, O) product, T > 128, with
    ``scale_bytes`` (4 f32, 2 bf16) scales; ``g32``: the G32 kernel (a
    scale row a 32-row part of a stage, in the slot K1p's second plane
    takes).  ``splits=None``: one split when
    the output tiles alone give the ``n_sm`` SMs a block each; else as many
    splits as leave a block an SM, rounded down, each at least 4 stages, up
    to 16 (the narrow projections at T = 256).  An explicit count must
    leave no split empty (as :func:`split_plan`).  Mirrors the constants of
    ``csrc/qmm_prefill.cu``."""
    if T <= PIPE_MAX_T:
        raise ValueError(f"the prefill mode takes T > {PIPE_MAX_T}, not {T}")
    kstep = 32 if packed else 64
    k_rows = I // 2 if packed else I
    tiles = -(-O // PREFILL_COLS) * -(-T // PREFILL_ROWS)
    splits, kps = _prefill_splits(tiles, k_rows, kstep, splits, n_sm)
    stages = PREFILL_STAGES[packed]
    w_box = (PREFILL_COLS, kstep)
    x_box = (PREFILL_XK, PREFILL_ROWS)
    s_box = (PREFILL_COLS, 1)
    # the W box and two x planes a stage, and its scale row(s) in two 1 KB
    # slots
    boxes = w_box[0] * w_box[1] + 2 * x_box[0] * x_box[1] * 2
    stage_bytes = boxes + 2 * 1024
    tx = boxes + (2 if packed or g32 else 1) * s_box[0] * scale_bytes
    return PrefillPlan(
        rows=PREFILL_ROWS, cols=PREFILL_COLS,
        grid=(-(-O // PREFILL_COLS), -(-T // PREFILL_ROWS), splits),
        splits=splits, k_per_split=kps, kstep=kstep, stages=stages,
        stage_bytes=stage_bytes, smem=stages * stage_bytes + 1024,
        static_smem=16 * stages, w_box=w_box, x_box=x_box,
        s_box=s_box, tx_bytes=tx)


def _prefill_splits(tiles: int, k_rows: int, kstep: int, splits,
                    n_sm: int):
    """(splits, k_per_split) of a prefill launch of ``tiles`` output
    tiles: ``splits=None`` one split when the tiles give the ``n_sm`` SMs a
    block each, else as many as leave a block an SM (rounded down), each
    at least 4 stages of ``kstep`` rows, up to 16; an explicit count as
    :func:`split_plan`'s."""
    if splits is not None:
        return _explicit_split(k_rows, kstep, splits)
    most = max(1, min(k_rows // (4 * kstep), 16))
    splits = max(1, min(n_sm // tiles, most))
    kps = -(-(-(-k_rows // splits)) // kstep) * kstep
    return -(-k_rows // kps), kps


def wide_prefill_plan(T: int, I: int, O: int, x_f32: bool = True,
                      scale_bytes: int = 4, splits=None,
                      n_sm: int = 132, w_bytes: int = 1,
                      g32: bool = False) -> PrefillPlan:
    """The launch of the wide mode's prefill kernel
    (``qmm_wgmma_wide_kernel``) on a (T, I) x (I, O) int8-held product
    (``w_bytes=2``: int16), T > 128: 128 columns x 128 rows a block; a
    stage of 64 W rows holds the W box (int16: two boxes of 64 columns, one
    a consumer warpgroup; 128-byte rows either way), two 32-column x boxes
    a plane of x (three planes for f32 x, ``x_f32``; one for bf16) and the
    group's scale row (``scale_bytes`` 4 f32, 2 bf16; ``g32``, the G32
    kernel: a scale row a 32-row part, in a second 1 KB slot); as many
    stages as fit a block's shared memory, up to 8; the split rule of
    :func:`prefill_plan`.  Mirrors the constants of
    ``csrc/qmm_prefill.cu``."""
    if T <= PIPE_MAX_T:
        raise ValueError(f"the prefill mode takes T > {PIPE_MAX_T}, not {T}")
    kstep, planes = WIDE_PREFILL_KSTEP, 3 if x_f32 else 1
    tiles = -(-O // PREFILL_COLS) * -(-T // WIDE_PREFILL_ROWS)
    splits, kps = _prefill_splits(tiles, I, kstep, splits, n_sm)
    w_box = (PREFILL_COLS // w_bytes, kstep)
    x_box = (PREFILL_XK, WIDE_PREFILL_ROWS)
    s_box = (PREFILL_COLS, 1)
    x_boxes = kstep // PREFILL_XK * planes
    boxes = w_bytes * PREFILL_COLS * kstep + x_boxes * x_box[0] * x_box[1] * 2
    srows = 2 if g32 else 1
    stage_bytes = boxes + srows * 1024    # the scale row(s), 1 KB slots
    stages = min(WIDE_PREFILL_MAX_STAGES,
                 (PREFILL_SMEM_BLOCK - 1024) // (stage_bytes + 16))
    return PrefillPlan(
        rows=WIDE_PREFILL_ROWS, cols=PREFILL_COLS,
        grid=(-(-O // PREFILL_COLS), -(-T // WIDE_PREFILL_ROWS), splits),
        splits=splits, k_per_split=kps, kstep=kstep, stages=stages,
        stage_bytes=stage_bytes, smem=stages * stage_bytes + 1024,
        static_smem=16 * stages, w_box=w_box, x_box=x_box, s_box=s_box,
        tx_bytes=boxes + srows * s_box[0] * scale_bytes, x_planes=planes,
        x_boxes=x_boxes, w_boxes=w_bytes)


def _vec_ok(x: torch.Tensor, w: QArray) -> bool:
    """The vector path's 16-byte loads need 16-byte aligned rows of x, W
    and the scales; K1p reads x's high half at column I/2 too."""
    T, I = x.shape
    O = w.data.shape[1]
    return (O % 16 == 0 and I % (16 if w.packed else 8) == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w.data, w.scales)))


def _check_args(x: torch.Tensor, w: QArray) -> None:
    if w.group_axis != -2 or w.data.ndim != 2 or x.ndim != 2:
        raise ValueError("qmm kernel takes x (T, I) and a (I, O) QArray "
                         "with groups along I")
    T, I = x.shape
    rows = 2 * w.data.shape[0] if w.packed else w.data.shape[0]
    if rows != I or I % w.group_size:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.data.shape)}"
                         f" gs {w.group_size} packed {w.packed} do not match")
    if w.packed and (w.qtype != QuantType.INT4 or (I // 2) % w.group_size):
        raise ValueError(f"a packed weight is INT4 with (I/2) % gs == 0: "
                         f"{w.qtype} I {I} gs {w.group_size}")
    if w.scales.shape != (I // w.group_size, w.data.shape[1]):
        raise ValueError(f"scales {tuple(w.scales.shape)} do not match")
    for t in (x, w.data, w.scales):
        if t.device != x.device:
            raise ValueError("qmm operands on different devices")
        if not t.is_contiguous():
            raise ValueError("qmm operands must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or w.data.dtype not in (torch.int8, torch.int16) \
            or (w.packed and w.data.dtype != torch.int8) \
            or w.scales.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtypes x {x.dtype} w {w.data.dtype} "
                         f"s {w.scales.dtype}")


_RESIDENT = {}              # (library, device, launch kind) -> blocks an SM
# the ring's instantiations (qmm_pipe_launch's mode codes): standard,
# groupdot, wide on an int8-held weight, wide on an int16 weight; PIPE_G32
# or'ed into the standard or a wide code: its G32 instantiation (:func:`g32`)
PIPE_STD, PIPE_GD, PIPE_WIDE, PIPE_WIDE16 = 0, 1, 2, 3
PIPE_G32 = 4


def wide_pipe_mode(w: QArray) -> int:
    """The wide ring's instantiation for ``w``: ``PIPE_WIDE16`` on an
    int16 weight, else ``PIPE_WIDE``."""
    return PIPE_WIDE16 if w.data.dtype == torch.int16 else PIPE_WIDE


def _pipe_resident(x: torch.Tensor, w: QArray, rows: int, warps: int,
                   conv: bool, pmode: int = PIPE_STD, lib=None) -> int:
    """Blocks of the pipelined instantiation (``pmode``: standard, groupdot,
    wide or wide on int16) an SM of x's card holds at once, asked of the
    CUDA runtime once a library, device and kind of launch (``lib``:
    another build of ``qmm.cu``, for the design tools; None the
    package's)."""
    lib = lib or _build.load("qmm")
    key = (lib._name, x.device.index, w.packed, rows, warps, pmode, x.dtype,
           w.scales.dtype, conv)
    if key not in _RESIDENT:
        fn = lib.qmm_pipe_resident
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        blocks = ctypes.c_int(0)
        with torch.cuda.device(x.device):
            rc = fn(int(w.packed), rows, warps, pmode, _DT[x.dtype],
                    _DT[w.scales.dtype], int(conv), ctypes.byref(blocks))
        _build.check(rc, "qmm_pipe_resident")
        _RESIDENT[key] = blocks.value
    return _RESIDENT[key]


def _launch_pipe(x: torch.Tensor, w: QArray, gain, residual, eps: float,
                 splits, pmode: int = PIPE_STD, lib=None) -> torch.Tensor:
    """The pipelined mode (``pmode``: ``PIPE_GD`` its groupdot
    instantiation, plain form only: no gain, no residual; ``PIPE_WIDE`` its
    wide one, glue and all, not packed; ``PIPE_WIDE16`` the wide one on an
    int16 weight; the standard and wide ones take their G32 instantiation,
    ``PIPE_G32``, where :func:`g32` says so), from ``lib`` (another build
    of ``qmm.cu``; None the package's)."""
    lib = lib or _build.load("qmm")
    T, I = x.shape
    O = w.data.shape[1]
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    gd_body = pmode != PIPE_STD      # the groupdot or the wide body
    rows, warps = pipe_shape(T, I, O, gd_body)
    if pmode != PIPE_GD and g32(w):
        pmode |= PIPE_G32
    resident = _pipe_resident(x, w, rows, warps,
                              x.dtype == torch.float32 or gain is not None,
                              pmode, lib)
    plan = pipe_plan(T, I, O, w.packed, resident=resident, splits=splits,
                     n_sm=n_sm, groupdot=gd_body)
    out = torch.empty((T, O), dtype=x.dtype, device=x.device)
    partial = (torch.empty((plan.splits, T, O), dtype=torch.float32,
                           device=x.device) if plan.splits > 1 else None)
    fn = lib.qmm_pipe_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float] \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(x), _build.ptr(w.data), _build.ptr(w.scales),
            _build.ptr(gain), _build.ptr(residual), eps, _build.ptr(out),
            _build.ptr(partial), T, I, O, w.group_size, plan.splits,
            plan.k_per_split, _DT[x.dtype], _DT[w.scales.dtype],
            int(w.packed), plan.rows, plan.warps, pmode,
            _build.stream_of(x))
    _build.check(rc, "qmm_pipe_launch")
    return out


def _launch_prefill(x: torch.Tensor, w: QArray, gain, residual,
                    eps: float, splits=None, lib=None,
                    wide: bool = False) -> torch.Tensor:
    """The prefill mode (``qmm_wgmma_kernel``; ``wide``: the wide mode's
    ``qmm_wgmma_wide_kernel``, f32 compute), glue and all, from ``lib``
    (another build of ``qmm_prefill.cu``; None the package's)."""
    lib = lib or _build.load("qmm_prefill")
    T, I = x.shape
    O = w.data.shape[1]
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    ssz = w.scales.element_size()
    plan = (wide_prefill_plan(T, I, O, x.dtype == torch.float32, ssz,
                              splits, n_sm, w.data.element_size(), g32(w))
            if wide else
            prefill_plan(T, I, O, w.packed, ssz, splits, n_sm, g32(w)))
    out = torch.empty((T, O), dtype=x.dtype, device=x.device)
    partial = (torch.empty((plan.splits, T, O), dtype=torch.float32,
                           device=x.device) if plan.splits > 1 else None)
    xb = (torch.empty((T, plan.x_planes * I), dtype=torch.bfloat16,
                      device=x.device)
          if x.dtype == torch.float32 or gain is not None else None)
    name = "qmm_prefill_wide_launch" if wide else "qmm_prefill_launch"
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float] \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(x), _build.ptr(w.data), _build.ptr(w.scales),
            _build.ptr(gain), _build.ptr(residual), eps, _build.ptr(out),
            _build.ptr(partial), _build.ptr(xb), T, I, O, w.group_size,
            plan.splits, plan.k_per_split, _DT[x.dtype],
            _DT[w.scales.dtype],
            _DT[w.data.dtype] if wide else int(w.packed),
            _build.stream_of(x))
    _build.check(rc, name)
    return out


def _launch_prepass(x: torch.Tensor, gain=None, eps: float = 1e-5,
                    planes: int = 3) -> torch.Tensor:
    """The prefill modes' pre-pass (``prefill_x_kernel``) alone, for timing
    it apart from the kernel it feeds: (T, planes * I) bf16, x's bf16 planes
    (3, f32 x only: hi, mid, lo) after the norm when ``gain`` is given.
    Counts nothing."""
    T, I = x.shape
    xb = torch.empty((T, planes * I), dtype=torch.bfloat16, device=x.device)
    fn = _build.load("qmm_prefill").qmm_prefill_x_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p] \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(x), _build.ptr(gain), eps, _build.ptr(xb), T, I,
            planes, _DT[x.dtype], _build.stream_of(x))
    _build.check(rc, "qmm_prefill_x_launch")
    return xb


def _launch(x: torch.Tensor, w: QArray, compute_dtype, gain=None,
            residual=None, eps: float = 1e-5, gd: bool = False,
            splits=None, mode=None) -> torch.Tensor:
    """Launch the kernel of ``mode`` (None: :func:`_kernel`'s choice;
    ``"loop"`` forces ``qmm_bf16_kernel``'s loop on a call the pipelined or
    the prefill mode would take, standard or groupdot, and ``"wide"`` (or
    ``"loop"``) ``qmm_f32_kernel`` on a call the wide ring or the wide
    prefill kernel would take, for timing them side by side)."""
    mode = mode or _kernel(x, w, compute_dtype, gd, residual)
    if mode == "prefill":
        return _launch_prefill(x, w, gain, residual, eps, splits)
    if mode == "wide_prefill":
        return _launch_prefill(x, w, gain, residual, eps, splits, wide=True)
    if mode == "pipe":
        return _launch_pipe(x, w, gain, residual, eps, splits,
                            PIPE_GD if gd else PIPE_STD)
    if mode == "wide_pipe":
        return _launch_pipe(x, w, gain, residual, eps, splits,
                            wide_pipe_mode(w))
    T, I = x.shape
    O = w.data.shape[1]
    wide = is_wide(w, compute_dtype)
    if gd and w.group_size % 16:
        raise ValueError(f"the groupdot kernel takes group sizes that are a "
                         f"multiple of 16, not {w.group_size}")
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, kps = split_plan(T, I, O, w, compute_dtype, splits, n_sm)
    out = torch.empty((T, O), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, T, O), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    lib = _build.load("qmm")
    fn = lib.qmm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float] \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(x), _build.ptr(w.data), _build.ptr(w.scales),
            _build.ptr(gain), _build.ptr(residual), eps,
            _build.ptr(out), _build.ptr(partial), T, I, O, w.group_size,
            splits, kps, _DT[x.dtype], _DT[w.data.dtype], _DT[w.scales.dtype],
            int(wide), int(not wide and _vec_ok(x, w)), int(w.packed),
            int(gd), _build.stream_of(x))
    _build.check(rc, "qmm_launch")
    return out


def _run(wrapper, x: torch.Tensor, w: QArray, compute_dtype, gain=None,
         eps: float = 1e-5, residual=None, groupdot: bool = False,
         splits=None) -> torch.Tensor:
    """The plain version for a CPU tensor; else the kernel, counted on
    ``wrapper.launches`` (K1, K1f) or ``wrapper.launches_p4`` (K1p), or
    for the groupdot mode ``.launches_groupdot`` / ``_groupdot_p4``; a
    launch of the pipelined mode also on ``.launches_pipe``, or in the
    groupdot mode on ``.launches_groupdot_pipe``, one of the prefill mode on
    ``.launches_prefill``, one of the wide ring on
    ``.launches_wide_pipe``, one of the wide prefill kernel on
    ``.launches_wide_prefill``."""
    # the wide path has no groupdot body (qmm.py:111); K1p's has one
    gd = groupdot and (w.packed or not is_wide(w, compute_dtype))
    if x.device.type == "cpu":
        if splits is not None:          # refused as the kernel refuses it
            split_plan(*x.shape, w.data.shape[1], w, compute_dtype, splits)
        if gd:
            return qmm_groupdot_plain(x, w, compute_dtype)
        return qmm_fused_plain(x, w, compute_dtype, gain, eps, residual)
    if x.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {x.device}")
    mode = _kernel(x, w, compute_dtype, gd, residual)
    out = _launch(x, w, compute_dtype, gain, residual, eps, gd, splits, mode)
    attr = "launches" + ("_groupdot" if gd else "") + \
        ("_p4" if w.packed else "")
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)
    if mode == "pipe":
        if gd:
            wrapper.launches_groupdot_pipe += 1
        else:
            wrapper.launches_pipe += 1
    elif mode == "prefill":
        wrapper.launches_prefill += 1
    elif mode == "wide_pipe":
        wrapper.launches_wide_pipe += 1
    elif mode == "wide_prefill":
        wrapper.launches_wide_prefill += 1
    return out


def _layer(w: QArray, layer: int) -> QArray:
    if not 0 <= layer < w.data.shape[0]:
        raise IndexError(f"layer {layer} out of range")
    return w[layer]


def _glue(x: torch.Tensor, wl: QArray, norm_gain, residual):
    """Checks the K1f operands; returns the gain as contiguous f32."""
    T, I = x.shape
    gain = None
    if norm_gain is not None:
        if norm_gain.shape != (I,) or norm_gain.device != x.device:
            raise ValueError(f"norm_gain {tuple(norm_gain.shape)} must be "
                             f"({I},) on x's device")
        gain = norm_gain.to(torch.float32).contiguous()
    if residual is not None and (
            residual.shape != (T, wl.data.shape[1])
            or residual.dtype != x.dtype or residual.device != x.device
            or not residual.is_contiguous()):
        raise ValueError(f"residual {tuple(residual.shape)} "
                         f"{residual.dtype} must be a contiguous "
                         f"({T}, {wl.data.shape[1]}) {x.dtype} on x's device")
    return gain


def qmatmul_pallas(x: torch.Tensor, w: QArray,
                   compute_dtype=torch.bfloat16, groupdot: bool = False,
                   splits=None) -> torch.Tensor:
    """``x @ w``: x (T, I) f32/bf16, w a (I, O) QArray with scales
    (I/gs, O), or a packed (I/2, O) INT4 one (K1p, see
    :func:`qmm_p4_plain`).  Returns (T, O) in x.dtype.  ``groupdot``:
    the scale-after-dot mode (:func:`qmm_groupdot_plain`) where it applies;
    ``splits``: a fixed split-K count (:func:`split_plan`)."""
    _check_args(x, w)
    return _run(qmatmul_pallas, x, w, compute_dtype, groupdot=groupdot,
                splits=splits)


def qmatmul_pallas_indexed(x: torch.Tensor, w: QArray, layer: int,
                           compute_dtype=torch.bfloat16, norm_gain=None,
                           eps: float = 1e-5,
                           residual=None) -> torch.Tensor:
    """``x @ w[layer]`` on the layer-stacked (L, I, O) QArray (or packed
    (L, I/2, O)), read in place (``w[layer]`` is a view).  ``norm_gain``
    (I,) and/or ``residual`` (T, O) select K1f
    (:func:`qmatmul_pallas_indexed_fused`)."""
    if norm_gain is not None or residual is not None:
        return qmatmul_pallas_indexed_fused(x, w, layer, compute_dtype,
                                            norm_gain, eps, residual)
    wl = _layer(w, layer)
    _check_args(x, wl)
    return _run(qmatmul_pallas_indexed, x, wl, compute_dtype)


def qmatmul_pallas_indexed_fused(x: torch.Tensor, w: QArray, layer: int,
                                 compute_dtype=torch.bfloat16,
                                 norm_gain=None, eps: float = 1e-5,
                                 residual=None) -> torch.Tensor:
    """K1f: ``to_x_dtype(residual + norm(x) @ w[layer])`` with the rmsnorm
    prologue when ``norm_gain`` (I,) is given and the residual epilogue
    when ``residual`` (T, O) in x's dtype is given (see
    :func:`qmm_fused_plain`).  On a packed weight this is K1p with the same
    glue; the JAX packed branch drops ``residual`` (qmm.py:571-612), this
    one adds it."""
    wl = _layer(w, layer)
    _check_args(x, wl)
    gain = _glue(x, wl, norm_gain, residual)
    return _run(qmatmul_pallas_indexed_fused, x, wl, compute_dtype, gain,
                eps, residual)


qmatmul_pallas.launches = qmatmul_pallas.launches_p4 = 0
qmatmul_pallas.launches_groupdot = qmatmul_pallas.launches_groupdot_p4 = 0
qmatmul_pallas.launches_groupdot_pipe = 0
qmatmul_pallas_indexed.launches = qmatmul_pallas_indexed.launches_p4 = 0
qmatmul_pallas_indexed_fused.launches = 0
qmatmul_pallas_indexed_fused.launches_p4 = 0
qmatmul_pallas.launches_pipe = qmatmul_pallas_indexed.launches_pipe = 0
qmatmul_pallas_indexed_fused.launches_pipe = 0
qmatmul_pallas.launches_prefill = qmatmul_pallas_indexed.launches_prefill = 0
qmatmul_pallas_indexed_fused.launches_prefill = 0
qmatmul_pallas.launches_wide_pipe = 0
qmatmul_pallas_indexed.launches_wide_pipe = 0
qmatmul_pallas_indexed_fused.launches_wide_pipe = 0
qmatmul_pallas.launches_wide_prefill = 0
qmatmul_pallas_indexed.launches_wide_prefill = 0
qmatmul_pallas_indexed_fused.launches_wide_prefill = 0


def _unfused_glue(x, w, layer, compute_dtype, norm_gain, eps, residual):
    """A plain (unquantized) stacked weight: no kernel exists for it, so
    the glue runs as separate ops, as the JAX fallback does
    (qmm.py:714-719)."""
    from fastllama_tpu_torch.ops.norms import rmsnorm
    from fastllama_tpu_torch.ops.qmatmul import qmatmul
    if norm_gain is not None:
        x = rmsnorm(x, norm_gain, eps)
    out = qmatmul(x, w[layer], compute_dtype)
    return out if residual is None else residual + out


def make_mm(compute_dtype=torch.bfloat16):
    """mm(x, w) for the engines: the kernel wrapper for QArrays (K1, or K1p
    for a packed one), the plain ``qmatmul`` for unquantized weights (no
    kernel exists for those)."""
    from fastllama_tpu_torch.ops.qmatmul import qmatmul

    def mm(x, w):
        if isinstance(w, QArray):
            return qmatmul_pallas(x, w, compute_dtype)
        return qmatmul(x, w, compute_dtype)

    return mm


def make_mm_indexed(compute_dtype=torch.bfloat16):
    """mm_idx(x, w_stacked, layer, norm_gain=None, eps=1e-5,
    residual=None) for the engines.  ``mm_idx.supports_fusion`` tells
    ``models.llama.forward`` to fold the layer glue into K1f (K1p for a
    packed weight, which adds the residual too)."""
    def mm_idx(x, w, layer, norm_gain=None, eps: float = 1e-5,
               residual=None):
        if isinstance(w, QArray):
            return qmatmul_pallas_indexed(x, w, layer, compute_dtype,
                                          norm_gain, eps, residual)
        return _unfused_glue(x, w, layer, compute_dtype, norm_gain, eps,
                             residual)

    mm_idx.supports_fusion = True
    return mm_idx


def make_mm_plain(compute_dtype=torch.bfloat16):
    """The plain versions with the same interface as :func:`make_mm`."""
    from fastllama_tpu_torch.ops.qmatmul import qmatmul

    def mm(x, w):
        if isinstance(w, QArray):
            return qmm_plain(x, w, compute_dtype)
        return qmatmul(x, w, compute_dtype)

    return mm


def make_mm_indexed_plain(compute_dtype=torch.bfloat16):
    """The plain versions behind :func:`make_mm_indexed`'s interface."""
    def mm_idx(x, w, layer, norm_gain=None, eps: float = 1e-5,
               residual=None):
        if isinstance(w, QArray):
            return qmm_fused_plain(x, w[layer], compute_dtype, norm_gain,
                                   eps, residual)
        return _unfused_glue(x, w, layer, compute_dtype, norm_gain, eps,
                             residual)

    mm_idx.supports_fusion = True
    return mm_idx
