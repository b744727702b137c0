"""K1's INT16 weights on the wide mode's tensor-core kernels: the wide ring
(``qmm_pipe_wide_kernel`` at two weight bytes, T <= 128) and the wide
prefill kernel (``qmm_wgmma_wide_kernel`` on int16, T > 128).

On the CPU: the two planes of every int16 value (``w = 256 * (w >> 8) +
(w & 0xFF)``, both exact in bf16) and the kernels' magic-float
conversion of them mirrored in numpy bit for bit; a torch emulation of the
kernels' arithmetic (:func:`int16_emulated`: per group, the products of
x's bf16 planes with the lo and the hi weight plane in one f32 partial,
times the group's scale as an exact f32 value) held against the JAX
package's Pallas wide kernel in interpret mode (``qmatmul_pallas``,
``qmatmul_pallas_indexed`` and the fused glue with the norm and the
residual), x bf16 and f32, f32 and bf16 scales, at 1e-5 of max|ref|;
which kernel an INT16 call takes; the int16 plans within an H100 block's
227 KB of shared memory.

On the card (``gpu``): both kernels against ``qmm_fused_plain`` at the
phase-2 shapes of ``chip_smoke.py`` (1e-4 of max|ref| for f32 outputs,
1e-2 for bf16), one launch a call on the wrapper's ``launches_wide_pipe``
or ``launches_wide_prefill``."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fastllama_tpu.ops.pallas.qmm import (make_mm_indexed as j_make_mm_idx,
                                          qmatmul_pallas as j_qmm,
                                          qmatmul_pallas_indexed as j_qmm_idx)
from fastllama_tpu_torch.ops.kernels import qmm as tqmm
from tests.test_torch_qmm import _weights
from tests.test_torch_wide_pipe import split_planes


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast when the suite's
    workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32, BF16 = torch.float32, torch.bfloat16
TOL_EMU = 1e-5             # x max|ref|: the emulation against Pallas
QF16 = 5792                # INT16's quantization factor


# -- the two planes ----------------------------------------------------------

def test_planes_of_every_int16_value():
    """Every int16 value is 256 hi + lo with hi the arithmetic shift and lo
    the low byte; lo and 256 hi are exact in bf16; INT16's values (|w| <=
    5792) have hi in [-23, 22]."""
    v = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    hi, lo = tqmm.int16_planes(v)
    assert torch.equal(256 * hi.to(torch.int32) + lo.to(torch.int32),
                       v.to(torch.int32))
    assert int(hi.min()) == -128 and int(hi.max()) == 127
    assert int(lo.min()) == 0 and int(lo.max()) == 255
    for p in (lo.to(F32), 256 * hi.to(F32)):
        assert torch.equal(p.to(BF16).to(F32), p)
    q = (v.to(torch.int32).abs() <= QF16)
    assert int(hi[q].min()) == -23 and int(hi[q].max()) == 22


def _magic(words: np.ndarray, byte: int, exponent_word: int) -> np.ndarray:
    """``__byte_perm(v, exponent_word, 0x7650 | byte)`` as a float: byte
    ``byte`` of each word in the low mantissa byte of the float whose top
    byte is ``exponent_word``'s."""
    b = (words >> np.uint32(8 * byte)) & np.uint32(0xFF)
    return (b | np.uint32(exponent_word)).view(np.float32)


def test_magic_float_conversion_mirrors_the_planes():
    """The kernels' conversion (``lo16_f`` / ``hi16_f`` in ``csrc/qmm.cu``
    and ``csrc/qmm_prefill.cu``) in numpy on every pair of int16 values
    packed in a little-endian word: the low byte of half h (byte 2 h) into
    2^23's mantissa less 2^23 is lo; the high byte (byte 2 h + 1), its sign
    bit flipped, into 2^31's mantissa (unit 256) less 2^31 + 2^15 is 256 hi;
    each exact, and their bf16 pair (the floats' high halves) the planes."""
    rng = np.random.default_rng(0)
    vals = np.arange(-32768, 32768, dtype=np.int32).astype(np.int16)
    other = rng.permutation(vals)
    words = (vals.view(np.uint16).astype(np.uint32)
             | (other.view(np.uint16).astype(np.uint32) << np.uint32(16)))
    for h, half in ((0, vals), (1, other)):
        lo = _magic(words, 2 * h, 0x4B000000) - np.float32(8388608.0)
        hi = _magic(words ^ np.uint32(0x80008000), 2 * h + 1,
                    0x4F000000) - np.float32(2147516416.0)
        want_hi, want_lo = (t.numpy() for t in tqmm.int16_planes(
            torch.tensor(half)))
        np.testing.assert_array_equal(lo, want_lo.astype(np.float32))
        np.testing.assert_array_equal(hi, 256 * want_hi.astype(np.float32))
        # exact_pair keeps each float's high 16 bits: the bf16 values
        for f in (lo, hi):
            top = (f.view(np.uint32) >> np.uint32(16)).astype(np.uint16)
            np.testing.assert_array_equal(top.view(ml_dtypes.bfloat16)
                                          .astype(np.float32), f)


# -- the kernels' arithmetic, emulated ---------------------------------------

def int16_emulated(x: torch.Tensor, w, norm_gain=None, eps: float = 1e-5,
                   residual=None, splits: int = 1,
                   out_dtype=None) -> torch.Tensor:
    """The INT16 wide kernels' arithmetic on the CPU: the K1f prologue as
    ``qmm_fused_plain``'s (normalized in f32, rounded to x's dtype); x's
    bf16 planes (three for f32 x, one for bf16); each split walks its
    k16 steps, each step's x planes (lo, mid, hi) times the lo then the hi
    weight plane into one f32 partial a group, folded times the group's
    scale (an exact f32 value) where the group or the split ends; the
    splits summed in order after the residual; ``out_dtype`` (default x's)
    out.  Only the f32 sum order inside a tensor-core step differs."""
    T, I = x.shape
    if norm_gain is not None:
        xf = x.to(F32)
        r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        x = (xf * r * norm_gain.to(F32)).to(x.dtype)
    planes = split_planes(x)[::-1]                 # lo, mid, hi
    hi, lo = tqmm.int16_planes(w.data)
    wplanes = (lo.to(F32), 256 * hi.to(F32))
    sc, gs = w.scales.to(F32), w.group_size
    _, kps = tqmm._explicit_split(I, 64, splits)
    out = (torch.zeros((T, w.data.shape[1]), dtype=F32) if residual is None
           else residual.to(F32))
    for kbeg in range(0, I, kps):
        kend = min(I, kbeg + kps)
        acc, part = 0.0, 0.0
        for k in range(kbeg, kend, 16):
            for p in planes:
                for wp in wplanes:
                    part = part + p[:, k:k + 16] @ wp[k:k + 16]
            if (k + 16) % gs == 0 or k + 16 == kend:
                acc, part = acc + part * sc[k // gs], 0.0
        out = out + acc
    return out.to(out_dtype or x.dtype)


def _close(got: torch.Tensor, want, tol: float):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _x(rng, T, I, xdt):
    """(numpy f32 values, torch x): bf16 x's values are bf16-rounded, so
    that the f32 reference on them is the product of the same numbers."""
    x = rng.standard_normal((T, I)).astype(np.float32)
    if xdt == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        return x, torch.tensor(x).to(BF16)
    return x, torch.tensor(x)


@pytest.mark.parametrize("T", [1, 48, 128, 129, 256])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
def test_emulation_vs_pallas(T, xdt, sdt):
    """``qmatmul_pallas`` on an INT16 weight (I = 512, O = 256, gs 64):
    the emulation at one split and at three against
    the Pallas wide kernel in interpret mode at f32 compute on the same
    values, at 1e-5 of max|ref|; the kernel the port's wrapper picks, and
    its plain twin within the same."""
    I, O = 512, 256
    scale_dt = np.float32 if sdt == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(T + len(xdt) + 7 * len(sdt))
    jw, tw = _weights(rng, (I, O), "INT16", scale_dtype=scale_dt)
    x, tx = _x(rng, T, I, xdt)
    assert tqmm._kernel(tx, tw, BF16, False, None) == (
        "wide_pipe" if T <= 128 else "wide_prefill")
    want = j_qmm(jnp.asarray(x), jw, jnp.float32, interpret=True)
    for splits in (1, 3):
        _close(int16_emulated(tx, tw, splits=splits, out_dtype=F32), want,
               TOL_EMU)
    _close(tqmm.qmm_fused_plain(tx.float(), tw, F32), want, TOL_EMU)


def test_emulation_bf16_output_at_bf16_compute():
    """The engines' INT16 call: bf16 x at bf16 compute, a bf16 output.  The
    emulation's bf16 output equals the Pallas wide kernel's (bf16 x, bf16
    compute) within one bf16 ulp of each output, on the unindexed and the
    layer-indexed wrapper."""
    rng = np.random.default_rng(3)
    jw, tw = _weights(rng, (2, 512, 256), "INT16")
    x, tx = _x(rng, 40, 512, "bfloat16")
    for want, got in (
            (j_qmm(jnp.asarray(x).astype(jnp.bfloat16), jw[0], jnp.bfloat16,
                   interpret=True), int16_emulated(tx, tw[0])),
            (j_qmm_idx(jnp.asarray(x).astype(jnp.bfloat16), jw, 1,
                       jnp.bfloat16, interpret=True),
             int16_emulated(tx, tw[1]))):
        assert got.dtype == BF16
        big = np.asarray(want.astype(jnp.float32))
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(big), 1e-30))) - 7)
        assert np.all(np.abs(got.float().numpy() - big) <= ulp)


@pytest.mark.parametrize("T", [5, 160])
@pytest.mark.parametrize("norm,res", [(True, False), (False, True),
                                      (True, True)])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_glue_vs_forward_mm(T, norm, res, cdt):
    """K1f's glue on layer 1 of a stacked INT16 weight (f32 x), against the
    JAX ``make_mm_indexed`` that ``forward`` calls at that compute dtype
    (INT16 takes the wide kernel at both), at 1e-5 of max|ref|, at one
    split and at two; the port's wrapper (its plain twin on the CPU) the
    same."""
    I, O = 512, 256
    rng = np.random.default_rng(T + 2 * norm + res + len(cdt))
    jw, tw = _weights(rng, (2, I, O), "INT16")
    x = rng.standard_normal((T, I)).astype(np.float32)
    g = (rng.standard_normal(I) * 0.1 + 1.0).astype(np.float32)
    r = rng.standard_normal((T, O)).astype(np.float32)
    kw = dict(norm_gain=jnp.asarray(g) if norm else None, eps=1e-5,
              residual=jnp.asarray(r) if res else None)
    jd = getattr(jnp, cdt)
    want = j_make_mm_idx(jd, interpret=True)(jnp.asarray(x), jw, 1, **kw)
    tkw = dict(norm_gain=torch.tensor(g) if norm else None, eps=1e-5,
               residual=torch.tensor(r) if res else None)
    tx, td = torch.tensor(x), getattr(torch, cdt)
    assert tqmm._kernel(tx, tw[1], td, False, tkw["residual"]) == (
        "wide_pipe" if T <= 128 else "wide_prefill")
    for splits in (1, 2):
        _close(int16_emulated(tx, tw[1], splits=splits, **tkw), want,
               TOL_EMU)
    _close(tqmm.qmatmul_pallas_indexed(tx, tw, 1, td, **tkw), want, TOL_EMU)


def test_one_weight_plane_misses():
    """Both weight planes are needed: the product with the lo plane alone,
    or the hi plane alone, is off the Pallas reference by far more than
    1e-5 of max|ref|, the two together are within it."""
    rng = np.random.default_rng(9)
    jw, tw = _weights(rng, (512, 256), "INT16")
    x, tx = _x(rng, 16, 512, "float32")
    want = np.asarray(j_qmm(jnp.asarray(x), jw, jnp.float32, interpret=True))
    hi, lo = tqmm.int16_planes(tw.data)
    sc = tw.scales.to(F32).repeat_interleave(64, dim=0)
    for plane in (lo.to(F32), 256 * hi.to(F32)):
        one = (tx @ (plane * sc)).numpy()
        assert np.abs(one - want).max() > 1e-3 * np.abs(want).max()
    both = int16_emulated(tx, tw).numpy()
    assert np.abs(both - want).max() <= TOL_EMU * np.abs(want).max()


# -- which kernel an INT16 call takes ----------------------------------------

# (T, O, gs, residual at an offset) -> qmm._kernel at bf16 and f32 compute
KERNEL_CASES = [
    (1, 256, 64, False, "wide_pipe"),
    (128, 256, 64, False, "wide_pipe"),
    (129, 256, 64, False, "wide_prefill"),
    (2048, 256, 64, False, "wide_prefill"),
    (1, 256, 128, False, "wide_pipe"),
    (128, 256, 128, False, "wide_pipe"),
    (129, 256, 128, False, "wide_prefill"),
    (2048, 256, 128, False, "wide_prefill"),
    (1, 256, 16, False, "wide"),
    (2048, 256, 16, False, "wide"),
    (1, 256, 32, False, "wide_pipe"),
    (2048, 256, 32, False, "wide_prefill"),
    (48, 200, 64, False, "wide"),
    (2048, 200, 64, False, "wide"),
    (48, 256, 64, True, "wide"),
    (129, 256, 64, True, "wide"),
]


@pytest.mark.parametrize("T,O,gs,offset,want", KERNEL_CASES)
def test_kernel_table(T, O, gs, offset, want):
    """INT16 is wide at any compute dtype: gs 32, 64 and 128 with aligned
    rows and residual take the wide ring up to 128 rows and the wide
    prefill kernel above; gs 16, O off 16 columns (200) and an offset
    residual keep
    ``qmm_f32_kernel`` (``"wide"``); groupdot takes the same kernel."""
    _, w = _weights(np.random.default_rng(T + O + gs), (512, O), "INT16",
                    gs=gs)
    for cdt in (BF16, F32):
        for xdt in (F32, BF16):
            x = torch.zeros((T, 512), dtype=xdt)
            res = (torch.zeros(T * O + 1, dtype=xdt)[1:].view(T, O)
                   if offset else None)
            assert tqmm.qmm_mode(x, w, cdt, False, res) == "wide"
            assert tqmm._kernel(x, w, cdt, False, res) == want
            assert tqmm._kernel(x, w, cdt, True, res) == want
            assert tqmm.wide_pipe_mode(w) == tqmm.PIPE_WIDE16


# -- the int16 plans ---------------------------------------------------------

PROJ_7B = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
           "w2": (11008, 4096), "classifier": (4096, 32000)}


@pytest.mark.parametrize("x_f32", [True, False])
@pytest.mark.parametrize("s_f32", [True, False])
@pytest.mark.parametrize("conv", [True, False])
def test_ring_plans_fit(x_f32, s_f32, conv):
    """Every row tile of the INT16 ring (T from 1 to 128): its slots of
    64 W rows at 2 x 128 + 16 bytes, the x tile, the scale row and the x
    planes within a block's 227 KB beside the static arrays; at least two
    stages; more bytes a stage than the int8-held ring's."""
    for T in range(1, 129):
        rows, warps = tqmm.pipe_shape(T, 4096, 4096, True)
        p = tqmm.pipe_smem(rows, warps, x_f32, s_f32, conv or x_f32,
                           wide=True, w_bytes=2)
        p8 = tqmm.pipe_smem(rows, warps, x_f32, s_f32, conv or x_f32,
                            wide=True)
        assert p["smem"] + p["static"] <= tqmm.PREFILL_SMEM_BLOCK, (T, p)
        assert p["stages"] >= 2
        assert p["stage_bytes"] - p8["stage_bytes"] == 64 * tqmm.PIPE_COLS


@pytest.mark.parametrize("x_f32", [True, False])
@pytest.mark.parametrize("ssz", [4, 2])
@pytest.mark.parametrize("T", [129, 256, 1000, 2048])
def test_prefill_plans_fit(T, ssz, x_f32):
    """The INT16 wide prefill plan at every 7B projection: the ring and its
    barriers within 227 KB, two W boxes of 64 columns (128-byte rows at the
    128-byte swizzle), a stage's bytes consistent and 1 KB aligned, three
    stages on f32 x and six on bf16 x; the grid and splits as the int8
    plan's."""
    for name, (I, O) in PROJ_7B.items():
        p = tqmm.wide_prefill_plan(T, I, O, x_f32, ssz, w_bytes=2)
        p8 = tqmm.wide_prefill_plan(T, I, O, x_f32, ssz)
        assert p.smem + p.static_smem <= tqmm.PREFILL_SMEM_BLOCK, name
        assert p.w_boxes == 2 and p.w_box == (64, 64)
        assert p.w_box[0] * 2 == 128
        boxes = 2 * 2 * 64 * 64 + p.x_boxes * p.x_box[0] * p.x_box[1] * 2
        assert p.stage_bytes == boxes + 1024 and p.stage_bytes % 1024 == 0
        assert p.tx_bytes == boxes + p.s_box[0] * ssz
        assert p.stages == (3 if x_f32 else 6)
        assert (p.grid, p.splits, p.k_per_split) == (p8.grid, p8.splits,
                                                     p8.k_per_split)


def test_cpu_int16_counts_nothing():
    """A CPU tensor runs the plain twin on an INT16 weight and moves no
    count of the wide kernels."""
    _, w = _weights(np.random.default_rng(5), (2, 512, 256), "INT16")
    fns = (tqmm.qmatmul_pallas, tqmm.qmatmul_pallas_indexed,
           tqmm.qmatmul_pallas_indexed_fused)
    before = [(f.launches, f.launches_wide_pipe, f.launches_wide_prefill)
              for f in fns]
    for T in (4, 200):
        x = torch.randn(T, 512).to(BF16)
        assert torch.equal(tqmm.qmatmul_pallas(x, w[0], BF16),
                           tqmm.qmm_plain(x, w[0], BF16))
        tqmm.qmatmul_pallas_indexed(x, w, 1, BF16,
                                    residual=torch.randn(T, 256).to(BF16))
    assert before == [(f.launches, f.launches_wide_pipe,
                       f.launches_wide_prefill) for f in fns]


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand16(gen, shape, sdt, dev, edge=False):
    """An INT16 weight of values in [-5792, 5792] and random positive
    scales, 64 rows a group; ``edge``: rows of 5792, -5792, -1 (hi -1, lo
    255), 255, -256, 32767 and -32768, and a group all at 5792."""
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.quant.groupquant import QArray
    d = torch.empty(shape, dtype=torch.int16, device=dev)
    d.random_(-QF16, QF16 + 1, generator=gen)
    if edge:
        for r, v in enumerate((QF16, -QF16, -1, 255, -256, 32767, -32768)):
            d[..., r, :] = v
        d[..., 64:128, :] = QF16
    s = (torch.rand((*shape[:-2], shape[-2] // 64, shape[-1]), generator=gen,
                    device=dev) + 0.5) * (0.02 / QF16)
    return QArray(d, s.to(sdt), QuantType.INT16, 64, group_axis=-2)


@pytest.mark.gpu
@pytest.mark.parametrize("I,O", [(1024, 1040), (4096, 12288), (11008, 4096)])
@pytest.mark.parametrize("T", [1, 16, 48, 64, 128, 129, 512, 2048])
@pytest.mark.parametrize("xdt,sdt", [("float32", "float32"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16")])
def test_int16_kernels_vs_plain_on_card(cuda, T, xdt, sdt, I, O):
    """Phase 2p's shapes (wqkv, w2) and a ragged column tile (O = 1040:
    the last 128-column tile's second int16 box lies past O) with the
    edge values: K1 indexed and K1f with the norm, the residual and both,
    at the auto split and one split, against ``qmm_fused_plain`` (1e-4 of
    max|ref| for f32 x, 1e-2 for bf16); one launch a wrapper call on the
    mode's count."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(T + I)
    xd, sd = getattr(torch, xdt), getattr(torch, sdt)
    w = _rand16(gen, (2, I, O), sd, cuda, edge=True)
    g = torch.rand((I,), generator=gen, device=cuda) + 0.5
    x = torch.randn((T, I), generator=gen, device=cuda).to(xd)
    r = torch.randn((T, O), generator=gen, device=cuda).to(xd)
    attr = "launches_wide_pipe" if T <= 128 else "launches_wide_prefill"
    tol = 1e-4 if xdt == "float32" else 1e-2
    for kw in ({}, {"norm_gain": g}, {"residual": r},
               {"norm_gain": g, "residual": r}):
        f = (tqmm.qmatmul_pallas_indexed_fused if kw
             else tqmm.qmatmul_pallas_indexed)
        n0 = getattr(f, attr)
        got = f(x, w, 1, BF16, **kw)
        assert getattr(f, attr) == n0 + 1
        one = tqmm._launch(x, w[1], BF16, kw.get("norm_gain"),
                           kw.get("residual"), splits=1)
        want = tqmm.qmm_fused_plain(x, w[1], BF16, **kw).float()
        torch.cuda.synchronize()
        lim = tol * want.abs().max().item()
        assert (got.float() - want).abs().max().item() <= lim, kw.keys()
        assert (one.float() - want).abs().max().item() <= lim, kw.keys()
