"""K1: group-dequant matmul (``csrc/qmm.cu``) and its plain version.

Replaces ``qmatmul_pallas`` (fastllama_tpu/ops/pallas/qmm.py:251) and
``qmatmul_pallas_indexed`` (qmm.py:551).  The indexed form is the same
kernel on ``w[layer]``, a free view of the contiguous stacked weight.

K1f, the same kernel with an rmsnorm prologue and/or a residual epilogue,
replaces ``_qmm_kernel_idx_fused`` (qmm.py:470, launched at :656): the
per-layer glue of ``models/llama.forward``.  The JAX package applies the
norm outside its kernel when its TPU tiling splits K (qmm.py:618-623) or
the shape is unsupported (:714-719); the port always fuses.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  Each wrapper counts its launches in ``.launches``.
Packed INT4 weights are not ported yet and raise.
"""
from __future__ import annotations

import ctypes

import torch

from fastllama_tpu_torch.config import QuantType
from fastllama_tpu_torch.ops.kernels import _build
from fastllama_tpu_torch.quant.groupquant import QArray, dequantize

_DT = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int16: 3}
BM, BN = 64, 64            # output tile of both kernel paths


def is_wide(w: QArray, compute_dtype) -> bool:
    """INT16 values overflow bf16's mantissa, and an f32 compute dtype asks
    for full precision: both take the f32 dequant + f32 dot path."""
    return w.qtype == QuantType.INT16 or compute_dtype == torch.float32


def _dot_f32(x: torch.Tensor, w: QArray, compute_dtype) -> torch.Tensor:
    """x @ dequant(w) in f32, rounded as the kernel rounds (see qmm_plain)."""
    if is_wide(w, compute_dtype):
        return torch.matmul(x.to(torch.float32), dequantize(w, torch.float32))
    wf = dequantize(w, torch.bfloat16).to(torch.float32)
    return torch.matmul(x.to(torch.bfloat16).to(torch.float32), wf)


def qmm_plain(x: torch.Tensor, w: QArray,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: INT8 non-wide dequantizes
    to bf16(bf16(w) * bf16(s)) and multiplies bf16-rounded x in f32 (bf16
    products are exact in f32); the wide path dequantizes and multiplies in
    f32.  Returns x.dtype."""
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


def _vec_ok(x: torch.Tensor, w: QArray) -> bool:
    """The INT8 path's 16-byte loads need 16-byte aligned rows of x, W and
    the scales."""
    T, I = x.shape
    O = w.data.shape[1]
    return (O % 16 == 0 and I % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w.data, w.scales)))


def _check_args(x: torch.Tensor, w: QArray) -> None:
    if w.packed or w.qtype == QuantType.INT4:
        raise NotImplementedError("packed INT4 weights are not ported yet")
    if w.group_axis != -2 or w.data.ndim != 2 or x.ndim != 2:
        raise ValueError("qmm kernel takes x (T, I) and a (I, O) QArray "
                         "with groups along I")
    T, I = x.shape
    if w.data.shape[0] != I or I % w.group_size:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.data.shape)}"
                         f" gs {w.group_size} do not match")
    if w.scales.shape != (I // w.group_size, w.data.shape[1]):
        raise ValueError(f"scales {tuple(w.scales.shape)} do not match")
    for t in (x, w.data, w.scales):
        if t.device != x.device:
            raise ValueError("qmm operands on different devices")
        if not t.is_contiguous():
            raise ValueError("qmm operands must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or w.data.dtype not in (torch.int8, torch.int16) \
            or w.scales.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtypes x {x.dtype} w {w.data.dtype} "
                         f"s {w.scales.dtype}")


def _launch(x: torch.Tensor, w: QArray, compute_dtype, gain=None,
            residual=None, eps: float = 1e-5) -> torch.Tensor:
    T, I = x.shape
    O = w.data.shape[1]
    wide = is_wide(w, compute_dtype)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, kps = _split_k(T, I, O, 16 if wide else 64, n_sm)
    out = torch.empty((T, O), dtype=x.dtype, device=x.device)
    partial = (torch.empty((splits, T, O), dtype=torch.float32,
                           device=x.device) if splits > 1 else None)
    lib = _build.load("qmm")
    fn = lib.qmm_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float] \
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(_build.ptr(x), _build.ptr(w.data), _build.ptr(w.scales),
            _build.ptr(gain), _build.ptr(residual), eps,
            _build.ptr(out), _build.ptr(partial), T, I, O, w.group_size,
            splits, kps, _DT[x.dtype], _DT[w.data.dtype], _DT[w.scales.dtype],
            int(wide), int(not wide and _vec_ok(x, w)), _build.stream_of(x))
    _build.check(rc, "qmm_launch")
    return out


def qmatmul_pallas(x: torch.Tensor, w: QArray,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w``: x (T, I) f32/bf16, w a (I, O) QArray with scales
    (I/gs, O).  Returns (T, O) in x.dtype."""
    _check_args(x, w)
    if x.device.type == "cpu":
        return qmm_plain(x, w, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"qmatmul_pallas: unsupported device {x.device}")
    out = _launch(x, w, compute_dtype)
    qmatmul_pallas.launches += 1
    return out


def qmatmul_pallas_indexed(x: torch.Tensor, w: QArray, layer: int,
                           compute_dtype=torch.bfloat16, norm_gain=None,
                           eps: float = 1e-5,
                           residual=None) -> torch.Tensor:
    """``x @ w[layer]`` on the layer-stacked (L, I, O) QArray, read in
    place (``w[layer]`` is a view).  ``norm_gain`` (I,) and/or
    ``residual`` (T, O) select K1f (:func:`qmatmul_pallas_indexed_fused`)."""
    if norm_gain is not None or residual is not None:
        return qmatmul_pallas_indexed_fused(x, w, layer, compute_dtype,
                                            norm_gain, eps, residual)
    if not 0 <= layer < w.data.shape[0]:
        raise IndexError(f"layer {layer} out of range")
    _check_args(x, w[layer])
    if x.device.type == "cpu":
        return qmm_plain(x, w[layer], compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(
            f"qmatmul_pallas_indexed: unsupported device {x.device}")
    out = _launch(x, w[layer], compute_dtype)
    qmatmul_pallas_indexed.launches += 1
    return out


def qmatmul_pallas_indexed_fused(x: torch.Tensor, w: QArray, layer: int,
                                 compute_dtype=torch.bfloat16,
                                 norm_gain=None, eps: float = 1e-5,
                                 residual=None) -> torch.Tensor:
    """K1f: ``to_x_dtype(residual + norm(x) @ w[layer])`` with the rmsnorm
    prologue when ``norm_gain`` (I,) is given and the residual epilogue
    when ``residual`` (T, O) in x's dtype is given (see
    :func:`qmm_fused_plain`)."""
    if not 0 <= layer < w.data.shape[0]:
        raise IndexError(f"layer {layer} out of range")
    wl = w[layer]
    _check_args(x, wl)
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
    if x.device.type == "cpu":
        return qmm_fused_plain(x, wl, compute_dtype, gain, eps, residual)
    if x.device.type != "cuda":
        raise ValueError(
            f"qmatmul_pallas_indexed_fused: unsupported device {x.device}")
    out = _launch(x, wl, compute_dtype, gain, residual, eps)
    qmatmul_pallas_indexed_fused.launches += 1
    return out


qmatmul_pallas.launches = 0
qmatmul_pallas_indexed.launches = 0
qmatmul_pallas_indexed_fused.launches = 0


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
    """mm(x, w) for the engines: the kernel wrapper for QArrays, the plain
    ``qmatmul`` for unquantized weights (no kernel exists for those)."""
    from fastllama_tpu_torch.ops.qmatmul import qmatmul

    def mm(x, w):
        if isinstance(w, QArray):
            return qmatmul_pallas(x, w, compute_dtype)
        return qmatmul(x, w, compute_dtype)

    return mm


def make_mm_indexed(compute_dtype=torch.bfloat16):
    """mm_idx(x, w_stacked, layer, norm_gain=None, eps=1e-5,
    residual=None) for the engines.  ``mm_idx.supports_fusion`` tells
    ``models.llama.forward`` to fold the layer glue into K1f."""
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
