"""The pipelined mode of K1 and K1p (``qmm_pipe_kernel``): which calls take
it (:func:`qmm_mode`), its host plan (:func:`pipe_plan`: row tile, warps,
split-K count, k rows a split), the exactness of the kernel's
magic-exponent dequant (mirrored here in numpy float32), and the plain
versions that hold the kernel against the JAX Pallas kernels in interpret
mode at T = 17 and T = 128 (tolerances: 1e-5 of max|ref| at f32 output,
1e-2 at bf16, as ``tests/test_torch_int4_qmm.py``: the two sum in another
order).  The card-only cases hold the CUDA kernel against the plain
version and against ``qmm_bf16_kernel``'s loop on the same inputs, and
count ``.launches_pipe``."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.ops.pallas import qmm as jqmm
from fastllama_tpu.quant import groupquant as jq
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.ops.kernels import qmm as tqmm
from fastllama_tpu_torch.quant import groupquant as tq


def _weight(rng, shape, kind, sdt="float32", gs=64):
    """(JAX QArray, port QArray) of random values and random positive group
    scales: ``kind`` INT8, INT16, INT4 (int8-held) or INT4P (packed)."""
    qt = "INT4" if kind == "INT4P" else kind
    qmax = tcfg.QuantType[qt].factor
    data = rng.integers(-qmax - (kind == "INT4P"), qmax + 1,
                        size=shape).astype(np.int16 if qt == "INT16"
                                           else np.int8)
    sshape = (*shape[:-2], shape[-2] // gs, shape[-1])
    scales = ((rng.random(sshape) + 0.5) * 0.02 / qmax).astype(np.float32)
    if sdt == "bfloat16":
        scales = scales.astype(ml_dtypes.bfloat16).astype(np.float32)
    packed = kind == "INT4P"
    if packed:
        data = jq.pack_int4_rows_np(data)
    jw = jq.QArray(jnp.asarray(data), jnp.asarray(scales).astype(sdt),
                   jcfg.QuantType[qt], gs, group_axis=-2, packed=packed)
    tw = tq.QArray(torch.tensor(data),
                   torch.tensor(scales).to(getattr(torch, sdt)),
                   tcfg.QuantType[qt], gs, group_axis=-2, packed=packed)
    return jw, tw


def _close(got: torch.Tensor, want, xdt: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = 1e-5 if xdt == "float32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# -- which calls take the mode ----------------------------------------------

# (kind, compute dtype, groupdot, T, O, gs) -> mode
MODE_CASES = [
    ("INT8", "bfloat16", False, 1, 256, 64, "pipe"),
    ("INT8", "bfloat16", False, 16, 256, 64, "pipe"),
    ("INT8", "bfloat16", False, 17, 256, 64, "pipe"),
    ("INT8", "bfloat16", False, 64, 256, 64, "pipe"),
    ("INT8", "bfloat16", False, 65, 256, 64, "pipe"),
    ("INT8", "bfloat16", False, 128, 256, 64, "pipe"),
    ("INT8", "bfloat16", False, 129, 256, 64, "loop"),
    ("INT8", "bfloat16", False, 48, 256, 128, "pipe"),
    ("INT8", "bfloat16", False, 48, 256, 16, "loop"),
    ("INT8", "bfloat16", False, 48, 256, 32, "pipe"),
    ("INT8", "bfloat16", False, 1, 256, 16, "loop"),
    ("INT8", "bfloat16", False, 48, 200, 64, "scalar"),
    ("INT8", "bfloat16", True, 48, 256, 64, "groupdot"),
    ("INT8", "float32", False, 1, 256, 64, "wide"),
    ("INT8", "float32", True, 1, 256, 64, "wide"),
    ("INT16", "bfloat16", False, 1, 256, 64, "wide"),
    ("INT4", "bfloat16", False, 48, 256, 64, "pipe"),
    ("INT4P", "bfloat16", False, 1, 256, 64, "pipe"),
    ("INT4P", "float32", False, 17, 256, 64, "pipe"),
    ("INT4P", "float32", False, 128, 256, 64, "pipe"),
    ("INT4P", "bfloat16", False, 129, 256, 64, "loop"),
    ("INT4P", "bfloat16", True, 1, 256, 64, "groupdot"),
    ("INT4P", "float32", True, 1, 256, 64, "groupdot"),
    ("INT4P", "bfloat16", False, 48, 200, 64, "scalar"),
    ("INT4P", "bfloat16", False, 48, 256, 32, "loop"),
]


@pytest.mark.parametrize("kind,cdt,gd,T,O,gs,mode", MODE_CASES)
def test_qmm_mode_table(kind, cdt, gd, T, O, gs, mode):
    _, w = _weight(np.random.default_rng(T), (512, O), kind, gs=gs)
    x = torch.zeros((T, 512), dtype=torch.bfloat16)
    assert tqmm.qmm_mode(x, w, getattr(torch, cdt), gd) == mode


def test_qmm_mode_unaligned_rows():
    """A view whose rows start off a 16-byte boundary takes the element
    path: the mode reads alignment, not values."""
    _, w = _weight(np.random.default_rng(0), (512, 256), "INT8")
    xc = torch.zeros(513, dtype=torch.bfloat16)[1:].view(1, 512)
    assert tqmm.qmm_mode(xc, w) == "scalar"
    assert tqmm.qmm_mode(xc.clone(), w) == "pipe"


@pytest.mark.parametrize("kind", ["INT8", "INT4P"])
@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
def test_qmm_mode_offset_residual(kind, xdt):
    """The pipelined epilogue reads the residual by 16-byte vectors: a
    contiguous residual view that starts off a 16-byte boundary keeps the
    loop, which reads it an element at a time."""
    _, w = _weight(np.random.default_rng(1), (512, 256), kind)
    xd = getattr(torch, xdt)
    x = torch.zeros((4, 512), dtype=xd)
    res = torch.zeros(4 * 256 + 1, dtype=xd)
    assert tqmm.qmm_mode(x, w, residual=res[:-1].view(4, 256)) == "pipe"
    assert tqmm.qmm_mode(x, w, residual=res[1:].view(4, 256)) == "loop"


# -- the host plan -----------------------------------------------------------

# (rows, warps) that qmm_pipe_launch is built for
BUILT_SHAPES = {(16, 4), (48, 4), (64, 4), (128, 4), (128, 8)}


def _covered(plan, T, k_rows, O):
    """Each k row and each output tile of the plan counted by a plain
    enumeration of its splits, stages and column tiles."""
    rows = np.zeros(k_rows, dtype=np.int64)
    for z in range(plan.splits):
        kbeg = z * plan.k_per_split
        kend = min(k_rows, kbeg + plan.k_per_split)
        assert kend > kbeg, "an empty split"
        for k0 in range(kbeg, kend, plan.kstep):
            rows[k0:min(kend, k0 + plan.kstep)] += 1
    cols = np.zeros(O, dtype=np.int64)
    for n0 in range(0, O, plan.cols):
        cols[n0:n0 + plan.cols] += 1
    return rows, cols


@pytest.mark.parametrize("T", [1, 2, 15, 16, 17, 47, 48, 64, 65, 127, 128])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("I,O", [(4096, 4096), (4096, 12288),
                                 (4096, 22016), (11008, 4096),
                                 (11264, 4096), (4096, 32000), (1056, 1040),
                                 (96, 128)])
def test_pipe_plan_covers_every_row_once(T, packed, I, O):
    if packed and (I % 32 or (I // 2) % 16):
        pytest.skip("not a packable width")
    k_rows = I // 2 if packed else I
    for splits, resident in ((None, 1), (None, 3), (None, 16), (1, 1),
                             (2, 1), (3, 1), (5, 1), (16, 1)):
        try:
            plan = tqmm.pipe_plan(T, I, O, packed, resident=resident,
                                  splits=splits)
        except ValueError:
            # an explicit count that leaves a split empty, as split_plan
            with pytest.raises(ValueError):
                tqmm.split_plan(T, I, O, _packed_stub(packed), torch.bfloat16,
                                splits)
            continue
        assert plan.rows in (16, 48, 64, 128) and plan.rows >= T
        assert plan.rows == min(r for r in (16, 48, 64, 128) if r >= T)
        assert (plan.rows, plan.warps) in BUILT_SHAPES
        assert (plan.rows, plan.warps) == tqmm.pipe_shape(T, I, O)
        assert plan.cols == tqmm.PIPE_COLS
        assert plan.kstep == (32 if packed else 64)
        assert plan.k_per_split % plan.kstep == 0
        assert 1 <= plan.splits <= 16
        if splits is not None:
            assert plan.splits == splits
            assert (plan.splits, plan.k_per_split) == tqmm.split_plan(
                T, I, O, _packed_stub(packed), torch.bfloat16, splits)
        rows, cols = _covered(plan, T, k_rows, O)
        assert (rows == 1).all() and (cols == 1).all()


def _packed_stub(packed):
    """A QArray that only answers split_plan's questions."""
    data = torch.zeros((2, 16), dtype=torch.int8)
    return tq.QArray(data, torch.zeros((1, 16)), tcfg.QuantType.INT4
                     if packed else tcfg.QuantType.INT8, 64,
                     group_axis=-2, packed=packed)


def test_pipe_plan_rule():
    """The auto rule: at 16 rows as many splits as keep 4 stages each (up
    to 16); above, as many blocks as the SMs hold at once (``resident`` an
    SM, the card's occupancy count), in whole splits; 8 warps only at 128
    rows on I <= 4096, O <= 12288."""
    p = tqmm.pipe_plan(1, 4096, 4096, False, resident=5)
    assert (p.rows, p.warps, p.cols) == (16, 4, 128)
    assert (p.splits, p.k_per_split) == (16, 256)
    assert tqmm.pipe_plan(1, 11264, 4096, True, resident=5).splits == 16
    for resident in (1, 3, 5):
        q = tqmm.pipe_plan(48, 4096, 12288, False, resident=resident,
                           n_sm=132)
        assert q.rows == 48
        assert q.splits == min(resident * 132 // 96, 16)
    assert tqmm.pipe_plan(48, 4096, 32000, False, resident=5).splits == 2
    assert tqmm.pipe_plan(48, 4096, 32000, False, resident=1).splits == 1
    assert tqmm.pipe_shape(128, 4096, 22016) == (128, 4)
    assert tqmm.pipe_shape(128, 4096, 12288) == (128, 8)
    assert tqmm.pipe_shape(128, 11008, 4096) == (128, 4)
    assert tqmm.pipe_shape(64, 4096, 4096) == (64, 4)
    assert tqmm.pipe_shape(33, 4096, 4096) == (48, 4)
    with pytest.raises(ValueError):
        tqmm.pipe_plan(129, 4096, 4096, False, resident=1)
    with pytest.raises(ValueError):
        tqmm.pipe_shape(0, 4096, 4096)
    with pytest.raises(ValueError):
        tqmm.pipe_plan(1, 4096, 4096, False, resident=1, splits=0)


# -- the kernel's dequant arithmetic, mirrored in float32 ---------------------

def _field_f(v, bits, pos):
    """csrc/qmm.cu:field_f in numpy: the signed field as an exact float
    from the magic exponent 2^(23 - pos)."""
    mask = np.uint32(((1 << bits) - 1) << pos)
    magic = np.uint32((1 << (bits - 1 + pos)) | ((150 - pos) << 23))
    f = ((v & mask) ^ magic).view(np.float32)
    return f - np.float32((1 << (23 - pos)) + (1 << (bits - 1)))


def test_magic_exponent_dequant_is_exact():
    """Every byte value at each of the four byte places of a word (INT8)
    and every nibble at each of the eight (K1p, the high three read from
    the word shifted right by 12) becomes its signed value exactly; the
    INT8 pair times the bf16 scale then rounds once, and K1p's nibble times
    the f32 scale once in f32, as the plain versions compute."""
    b = np.arange(256, dtype=np.uint32)
    signed = b.astype(np.uint8).view(np.int8).astype(np.float32)
    for j in range(4):
        v = b << np.uint32(8 * j)
        got = _field_f(v >> np.uint32(16) if j >= 2 else v, 8, 8 * (j & 1))
        assert np.array_equal(got, signed)
    n = np.arange(16, dtype=np.uint32)
    nsigned = np.where(n >= 8, n.astype(np.int64) - 16, n).astype(np.float32)
    for p in range(2):
        for j in range(4):
            pos = 8 * j + 4 * p
            v = n << np.uint32(pos)
            got = (_field_f(v, 4, pos) if pos < 20 else
                   _field_f(v >> np.uint32(12), 4, pos - 12))
            assert np.array_equal(got, nsigned), (p, j)
    # the exact floats hold in bf16: the pair is their top halves
    assert np.array_equal(signed.astype(ml_dtypes.bfloat16).astype(
        np.float32), signed)


# -- the plain versions against the Pallas kernels ---------------------------

@pytest.mark.parametrize("T", [17, 128])
@pytest.mark.parametrize("kind,I", [("INT8", 256), ("INT4P", 1024)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_plain_vs_pallas(T, kind, I, xdt):
    """What the wrappers compute for a CPU tensor (the kernel's twin) at the
    mode's row counts, against ``qmatmul_pallas`` in interpret mode at bf16
    compute (INT8's pipelined path)."""
    rng = np.random.default_rng(T + I + len(xdt))
    jw, tw = _weight(rng, (I, 256), kind)
    x = rng.standard_normal((T, I)).astype(np.float32)
    tx = torch.tensor(x).to(getattr(torch, xdt))
    want = jqmm.qmatmul_pallas(jnp.asarray(x).astype(xdt), jw, jnp.bfloat16,
                               interpret=True)
    got = tqmm.qmatmul_pallas(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (T, 256)
    _close(got, want, xdt)


@pytest.mark.parametrize("T", [17, 128])
@pytest.mark.parametrize("kind,I", [("INT8", 256), ("INT4P", 2048)])
def test_plain_indexed_vs_pallas(T, kind, I):
    rng = np.random.default_rng(3 * T + I)
    jw, tw = _weight(rng, (2, I, 384), kind)
    x = rng.standard_normal((T, I)).astype(np.float32)
    for layer in (0, 1):
        want = jqmm.qmatmul_pallas_indexed(
            jnp.asarray(x).astype(jnp.bfloat16), jw, layer, jnp.bfloat16,
            interpret=True)
        got = tqmm.qmatmul_pallas_indexed(torch.tensor(x).to(torch.bfloat16),
                                          tw, layer)
        _close(got, want, "bfloat16")


def test_cpu_tensors_count_nothing():
    _, w = _weight(np.random.default_rng(1), (256, 128), "INT8")
    before = [f.launches_pipe for f in (tqmm.qmatmul_pallas,
                                        tqmm.qmatmul_pallas_indexed,
                                        tqmm.qmatmul_pallas_indexed_fused)]
    tqmm.qmatmul_pallas(torch.randn(4, 256), w)
    assert before == [f.launches_pipe for f in (
        tqmm.qmatmul_pallas, tqmm.qmatmul_pallas_indexed,
        tqmm.qmatmul_pallas_indexed_fused)]


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_case(cuda, rng, T, I, O, kind, xdt, sdt, norm, res, gs=64):
    _, tw = _weight(rng, (2, I, O), kind, sdt, gs)
    tw = tw.to(cuda)
    xd = getattr(torch, xdt)
    x = torch.tensor(rng.standard_normal((T, I)).astype(np.float32),
                     device=cuda).to(xd)
    kw = {}
    if norm:
        kw["norm_gain"] = torch.rand(I, device=cuda) + 0.5
    if res:
        kw["residual"] = torch.randn((T, O), device=cuda).to(xd)
    return x, tw, kw


def _tol(xdt, kind, norm):
    # f32 x through the norm prologue rounds the normalized row to bf16
    # for the tensor cores: a one-ulp difference in the row's inverse RMS
    # flips some roundings (chip_smoke's TOL_P4_NORM)
    if xdt == "bfloat16":
        return 1e-2
    return 1e-3 if norm else 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2, 15, 16, 17, 47, 48, 64, 65, 127, 128])
@pytest.mark.parametrize("kind", ["INT8", "INT4P"])
@pytest.mark.parametrize("xdt,sdt", [("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("float32", "float32")])
def test_pipe_kernel_vs_plain_and_loop_on_card(cuda, T, kind, xdt, sdt):
    """Layer 1 of a stacked weight at O = 1040 (not a multiple of any
    column tile) and I = 1152 (18 stages; with gs a multiple of 64 no
    stage of the mode is ever cut short, so the last stage of each split
    ends on the split), bare and with the norm and residual operands: the
    pipelined kernel against the plain version and against the loop on
    the same inputs, every launch counted on ``.launches_pipe``."""
    rng = np.random.default_rng(T + len(kind) + len(xdt) + len(sdt))
    for norm, res in ((False, False), (True, False), (False, True),
                      (True, True)):
        x, tw, kw = _card_case(cuda, rng, T, 1152, 1040, kind, xdt, sdt,
                               norm, res)
        fn = (tqmm.qmatmul_pallas_indexed_fused if kw
              else tqmm.qmatmul_pallas_indexed)
        n0 = fn.launches_pipe
        got = tqmm.qmatmul_pallas_indexed(x, tw, 1, torch.bfloat16, **kw)
        assert fn.launches_pipe == n0 + 1
        want = tqmm.qmm_fused_plain(x, tw[1], torch.bfloat16,
                                    kw.get("norm_gain"), 1e-5,
                                    kw.get("residual"))
        loop = tqmm._launch(x, tw[1], torch.bfloat16, kw.get("norm_gain"),
                            kw.get("residual"), mode="loop")
        torch.cuda.synchronize()
        ref = want.float().abs().max().item()
        tol = _tol(xdt, kind, norm) * ref
        assert (got.float() - want.float()).abs().max().item() <= tol
        assert (got.float() - loop.float()).abs().max().item() <= 2 * tol


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["INT8", "INT4P"])
@pytest.mark.parametrize("T", [1, 48, 128])
def test_pipe_kernel_splits_on_card(cuda, kind, T):
    """Every split count that leaves no split empty, at I = 4096 and 4352
    (at 128 rows the 8- and the 4-warp block): the same sums in another
    order."""
    rng = np.random.default_rng(7 * T + len(kind))
    for I in (4096, 4352):
        _, tw = _weight(rng, (I, 2048), kind)
        tw = tw.to(cuda)
        x = torch.randn((T, I), device=cuda).to(torch.bfloat16)
        want = tqmm.qmm_plain(x, tw).float()
        tol = 1e-2 * want.abs().max().item()
        k_rows, kstep = (I // 2, 32) if kind == "INT4P" else (I, 64)
        for splits in (None, 1, 2, 3, 7, 14, 16):
            if splits is not None:
                try:
                    tqmm._explicit_split(k_rows, kstep, splits)
                except ValueError:      # a count that leaves a split empty
                    continue
            got = tqmm._launch(x, tw, torch.bfloat16, splits=splits,
                               mode="pipe")
            torch.cuda.synchronize()
            assert (got.float() - want).abs().max().item() <= tol, \
                (I, splits)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["INT8", "INT4P"])
@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
def test_offset_residual_keeps_the_loop_on_card(cuda, kind, xdt):
    """A contiguous residual view at an odd element offset: the call takes
    the loop, uncounted on ``.launches_pipe``, and adds the residual right
    (the pipelined epilogue's vector loads would fault there, so a forced
    pipelined launch is refused)."""
    rng = np.random.default_rng(11 + len(kind) + len(xdt))
    T, I, O = 48, 1152, 1040
    x, tw, _ = _card_case(cuda, rng, T, I, O, kind, xdt, "float32", False,
                          False)
    buf = torch.randn(T * O + 1, device=cuda).to(x.dtype)
    res = buf[1:].view(T, O)
    assert res.data_ptr() % 16 != 0
    f = tqmm.qmatmul_pallas_indexed_fused
    n0, m0 = f.launches_pipe, f.launches + f.launches_p4
    got = tqmm.qmatmul_pallas_indexed(x, tw, 1, torch.bfloat16,
                                      residual=res)
    torch.cuda.synchronize()
    assert f.launches_pipe == n0 and f.launches + f.launches_p4 == m0 + 1
    want = tqmm.qmm_fused_plain(x, tw[1], torch.bfloat16, residual=res)
    tol = _tol(xdt, kind, False) * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    with pytest.raises(RuntimeError):
        tqmm._launch(x, tw[1], torch.bfloat16, residual=res, mode="pipe")


@pytest.mark.gpu
def test_prefill_and_other_modes_keep_the_loop_on_card(cuda):
    """T > 128, groupdot, the wide path, unaligned rows and a group size
    off a multiple of 32 leave ``.launches_pipe`` unmoved."""
    rng = np.random.default_rng(3)
    _, tw = _weight(rng, (1024, 512), "INT8")
    tw = tw.to(cuda)
    f = tqmm.qmatmul_pallas
    n0 = f.launches_pipe
    for T, kw in ((129, {}), (48, dict(groupdot=True)),
                  (48, dict(compute_dtype=torch.float32))):
        x = torch.randn((T, 1024), device=cuda).to(torch.bfloat16)
        f(x, tw, **kw)
    xs = torch.randn(1025, device=cuda).to(torch.bfloat16)[1:].view(1, 1024)
    f(xs, tw)
    _, t32 = _weight(rng, (1024, 512), "INT8", gs=16)
    f(xs.clone(), t32.to(cuda))
    torch.cuda.synchronize()
    assert f.launches_pipe == n0
    f(torch.randn((128, 1024), device=cuda).to(torch.bfloat16), tw)
    assert f.launches_pipe == n0 + 1
