"""K1's wide mode (f32 compute) above 128 rows: the wide prefill kernel
(``qmm_wgmma_wide_kernel`` in ``csrc/qmm_prefill.cu``).

On the CPU: which kernel a wide call takes (``qmm._kernel``: the wide
prefill kernel for an int8-held or INT16 weight above 128 rows with gs %
64 == 0,
aligned rows and residual), its host plan (:func:`wide_prefill_plan`:
shared memory, TMA boxes, bytes a stage, grid and split-K coverage at the
7B projections), and a torch emulation of its arithmetic
(:func:`wide_prefill_emulated`: the pre-pass's planes, the exact integers
of the A operand, one f32 partial a group in the kernel's K and plane
order times the group's scale, split partials after the residual) held
against JAX's ``qmatmul_pallas`` at ``compute_dtype=float32`` in
interpret mode (f32 dequant and a ``Precision.HIGHEST`` dot) at 1e-5 of
max|ref| (the wide ring's limit), the glue against the JAX
``make_mm_indexed(float32)`` that ``forward`` calls; the plane probe
(:func:`plane_probe`) passed by the emulation and missed without x's lo
plane; CPU calls count nothing.

On the card (``gpu``): the kernel against ``qmm_fused_plain`` at 1e-4 of
max|plain|, bare and with the glue, at ragged T and every 7B projection,
one ``.launches_wide_prefill`` a call on the calling wrapper; the wide
ring and the wide prefill kernel on the plane probe within 2^-21 of the
exact product."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fastllama_tpu.ops.pallas.qmm import (make_mm_indexed as j_make_mm_idx,
                                          qmatmul_pallas as j_qmm)
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
TOL_CARD = 1e-4            # x max|plain|: the kernel against its plain twin
TOL_PLANES = 2.0 ** -21    # x max|exact|: the plane probe (chip_smoke)


def wide_prefill_emulated(x: torch.Tensor, w, norm_gain=None,
                          eps: float = 1e-5, residual=None,
                          splits=None) -> torch.Tensor:
    """``qmm_wgmma_wide_kernel``'s arithmetic on the CPU.  The pre-pass:
    xn = to_x_dtype(x * rsqrt(mean(x^2) + eps) * gain) in f32 when a gain
    is given, then x's bf16 planes (three for f32 x, one for bf16).  Each
    split walks its stages of 64 W rows, each in k16 steps, each step's
    planes' products against the exact integers in turn (lo, mid, hi) into
    one f32 partial, folded into the split's accumulator times the group's
    scale (an exact f32 value) where the group or the split ends.  One
    split adds the residual to its sum, more are summed in order after
    it.  Only the f32 sum order inside a wgmma differs from the kernel."""
    T, I = x.shape
    O = w.data.shape[1]
    if norm_gain is not None:
        xf = x.to(F32)
        r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        x = (xf * r * norm_gain.to(F32)).to(x.dtype)
    planes = split_planes(x)[::-1]                 # lo, mid, hi
    wq = w.data.to(F32)
    sc = w.scales.to(F32)
    gs = w.group_size
    plan = tqmm.wide_prefill_plan(T, I, O, x.dtype == F32,
                                  w.scales.element_size(), splits)
    out = (torch.zeros((T, O), dtype=F32) if residual is None
           else residual.to(F32))
    for z in range(plan.splits):
        kbeg = z * plan.k_per_split
        kend = min(I, kbeg + plan.k_per_split)
        acc = torch.zeros((T, O), dtype=F32)
        part = None
        for kr in range(kbeg, kend, plan.kstep):
            for k in range(kr, kr + plan.kstep, 16):
                for p in planes:
                    prod = p[:, k:k + 16] @ wq[k:k + 16]
                    part = prod if part is None else part + prod
            if (kr + plan.kstep) % gs == 0 or kr + plan.kstep == kend:
                acc = acc + part * sc[kr // gs]
                part = None
        out = out + acc
    return out.to(x.dtype)


def plane_probe(T: int, I: int, sdt, device=None, gs: int = 64, seed=0):
    """Inputs on which the wide product shows whether each of x's three
    bf16 planes was multiplied: an f32 x of full 24-bit significands (its
    lo plane about 2^-17 of |x|), an INT8 identity weight (I, I) with
    power-of-two group scales (1/2, 1, 2 by group), so that the product is
    x times its column's scale exactly.  Returns (x, weight, the exact
    product, the same product without the lo plane)."""
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.quant.groupquant import QArray
    rng = np.random.default_rng(seed + T + I)
    x = torch.tensor(rng.standard_normal((T, I)).astype(np.float32))
    e = torch.arange(I // gs) % 3 - 1
    s = torch.exp2(e.float())[:, None].expand(I // gs, I).contiguous()
    w = QArray(torch.eye(I, dtype=torch.int8), s.to(sdt), QuantType.INT8, gs,
               group_axis=-2)
    col = torch.exp2((torch.arange(I) // gs % 3 - 1).float())
    hi, mid, _ = split_planes(x)
    if device is not None:
        x, w, col = x.to(device), w.to(device), col.to(device)
        hi, mid = hi.to(device), mid.to(device)
    return x, w, x * col, (hi + mid) * col


def _close(got: torch.Tensor, want, tol: float):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# -- which kernel a wide call takes ------------------------------------------

# (qtype, T, O, gs, residual at an offset) -> qmm._kernel at f32 compute
KERNEL_CASES = [
    ("INT8", 129, 256, 64, False, "wide_prefill"),
    ("INT8", 2048, 256, 64, False, "wide_prefill"),
    ("INT8", 129, 256, 128, False, "wide_prefill"),
    ("INT8", 2048, 256, 128, False, "wide_prefill"),
    ("INT4", 129, 256, 64, False, "wide_prefill"),
    ("INT4", 2048, 256, 128, False, "wide_prefill"),
    ("INT8", 129, 256, 16, False, "wide"),
    ("INT8", 129, 256, 32, False, "wide_prefill"),
    ("INT8", 2048, 1000, 64, False, "wide"),
    ("INT16", 129, 256, 64, False, "wide_prefill"),
    ("INT16", 129, 256, 16, False, "wide"),
    ("INT16", 129, 256, 32, False, "wide_prefill"),
    ("INT16", 2048, 1000, 64, False, "wide"),
    ("INT8", 256, 256, 64, True, "wide"),
    ("INT8", 128, 256, 64, False, "wide_pipe"),
    ("INT4", 1, 256, 128, False, "wide_pipe"),
]


@pytest.mark.parametrize("qname,T,O,gs,offset,want", KERNEL_CASES)
def test_kernel_table(qname, T, O, gs, offset, want):
    """``qmm._kernel`` at f32 compute from dtypes, shapes and alignment,
    on f32 and bf16 x: ``qmm_mode`` says ``"wide"``, :func:`wide_kernel`
    ``"prefill"`` for the wide prefill kernel, and a groupdot call takes
    the same kernel."""
    _, w = _weights(np.random.default_rng(T + O + gs), (512, O), qname,
                    gs=gs)
    for xdt in (F32, BF16):
        x = torch.zeros((T, 512), dtype=xdt)
        res = None
        if offset:
            res = torch.zeros(T * O + 1, dtype=xdt)[1:].view(T, O)
        assert tqmm.qmm_mode(x, w, F32, False, res) == "wide"
        assert tqmm._kernel(x, w, F32, False, res) == want
        assert tqmm._kernel(x, w, F32, True, res) == want
        wk = tqmm.wide_kernel(x, w, F32, res)
        assert wk == {"wide_prefill": "prefill", "wide_pipe": "pipe"}.get(
            want, "f32")


def test_unaligned_x_keeps_the_f32_kernel():
    """x's rows off a 16-byte boundary take ``qmm_f32_kernel`` above 128
    rows too; the same x copied takes the wide prefill kernel."""
    _, w = _weights(np.random.default_rng(0), (512, 256), "INT8")
    xs = torch.zeros(200 * 512 + 1)[1:].view(200, 512)
    assert tqmm._kernel(xs, w, F32, False, None) == "wide"
    assert tqmm._kernel(xs.clone(), w, F32, False, None) == "wide_prefill"


# -- the host plan -----------------------------------------------------------

PROJ_7B = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
           "w2": (11008, 4096)}


@pytest.mark.parametrize("x_f32", [True, False])
@pytest.mark.parametrize("ssz", [4, 2])
@pytest.mark.parametrize("T", [129, 256, 1000, 2048])
def test_plan_fits_and_covers(T, ssz, x_f32):
    """Every 7B projection: the ring and its barriers within the H100's
    227 KB; TMA boxes within their limits (W's inner box 128 bytes at the
    128-byte swizzle, x's 64 at the 64-byte one, no dimension above 256);
    a stage's bytes, its expected bytes and its boxes consistent, each
    piece 1 KB aligned; a grid whose tiles cover T and O once; splits of
    whole stages that cover K once, none empty."""
    for name, (I, O) in PROJ_7B.items():
        p = tqmm.wide_prefill_plan(T, I, O, x_f32, ssz)
        assert p.smem + p.static_smem <= tqmm.PREFILL_SMEM_BLOCK
        assert p.stages >= 2
        assert p.x_planes == (3 if x_f32 else 1)
        assert p.x_boxes == p.kstep // p.x_box[0] * p.x_planes
        assert p.w_box[0] <= 128 and p.x_box[0] * 2 <= 64
        assert max(p.w_box + p.x_box + p.s_box) <= 256
        assert p.x_box[1] == p.rows == 128 and p.w_box == (p.cols, p.kstep)
        boxes = p.w_box[0] * p.w_box[1] + p.x_boxes * p.x_box[0] * \
            p.x_box[1] * 2
        assert p.tx_bytes == boxes + p.s_box[0] * ssz
        assert p.stage_bytes == boxes + 1024 and p.stage_bytes % 1024 == 0
        gx, gy, gz = p.grid
        assert (gx - 1) * p.cols < O <= gx * p.cols
        assert (gy - 1) * p.rows < T <= gy * p.rows
        assert gz == p.splits and p.k_per_split % p.kstep == 0
        assert (p.splits - 1) * p.k_per_split < I <= (
            p.splits * p.k_per_split), name


def test_plan_rule():
    """Three stages on f32 x (three planes), eight on bf16 x; one split
    when the output tiles give every SM a block, else as many as leave a
    block an SM (wo and w2 at T = 256: 64 tiles, 2 splits); an explicit
    count as ``split_plan``'s; T <= 128 refused."""
    assert tqmm.wide_prefill_plan(2048, 4096, 4096).stages == 3
    assert tqmm.wide_prefill_plan(2048, 4096, 4096, False).stages == 8
    assert tqmm.wide_prefill_plan(2048, 4096, 4096).splits == 1
    assert tqmm.wide_prefill_plan(512, 4096, 12288).splits == 1
    p = tqmm.wide_prefill_plan(256, 4096, 4096)
    assert p.grid[:2] == (32, 2) and p.splits == 2
    assert p.k_per_split == 2048
    assert tqmm.wide_prefill_plan(256, 11008, 4096).splits == 2
    assert tqmm.wide_prefill_plan(129, 256, 256).splits == 1
    assert tqmm.wide_prefill_plan(2048, 4096, 4096, splits=3).splits == 3
    for bad in (dict(T=128), dict(splits=0), dict(splits=100)):
        kw = dict(T=2048, I=4096, O=4096)
        kw.update(bad)
        with pytest.raises(ValueError):
            tqmm.wide_prefill_plan(**kw)


# -- the kernel's arithmetic, emulated ---------------------------------------

@pytest.mark.parametrize("T", [129, 256])
@pytest.mark.parametrize("sdt,gs,I", [("float32", 64, 512),
                                      ("bfloat16", 64, 512),
                                      ("float32", 128, 512),
                                      ("bfloat16", 128, 256)])
def test_emulation_vs_pallas(T, sdt, gs, I):
    """The emulation at the auto split and at 2 and 3 splits where they
    leave no split empty (at I = 512 three splits cut groups of 128 rows),
    against the Pallas wide kernel in
    interpret mode at 1e-5 of max|ref|, O = 256, f32 x; the port's plain
    twin within the same; INT4 held in int8 lanes the same way at
    T = 129."""
    O = 256
    scale_dt = np.float32 if sdt == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(T + I + gs + len(sdt))
    for qname in (("INT8", "INT4") if T == 129 else ("INT8",)):
        jw, tw = _weights(rng, (I, O), qname, gs=gs, scale_dtype=scale_dt)
        x = rng.standard_normal((T, I)).astype(np.float32)
        tx = torch.tensor(x)
        assert tqmm._kernel(tx, tw, F32, False, None) == "wide_prefill"
        want = j_qmm(jnp.asarray(x), jw, jnp.float32, interpret=True)
        for splits in (None, 2, 3):
            try:
                tqmm.wide_prefill_plan(T, I, O, splits=splits)
            except ValueError:               # a split would be empty
                continue
            got = wide_prefill_emulated(tx, tw, splits=splits)
            assert got.dtype == F32 and got.shape == (T, O)
            _close(got, want, TOL_EMU)
        _close(tqmm.qmm_fused_plain(tx, tw, F32), want, TOL_EMU)


def test_emulation_bf16_x_is_one_plane():
    """A bf16 x is exact in one plane: the emulation equals the Pallas
    wide kernel on it within one bf16 ulp of each output (both round the
    f32 result to bf16)."""
    rng = np.random.default_rng(7)
    jw, tw = _weights(rng, (512, 256), "INT8")
    x = rng.standard_normal((200, 512)).astype(np.float32)
    xb = torch.tensor(x).to(BF16)
    assert len(split_planes(xb)) == 1
    assert tqmm.wide_prefill_plan(200, 512, 256, False).x_planes == 1
    want = j_qmm(jnp.asarray(x).astype(jnp.bfloat16), jw, jnp.float32,
                 interpret=True)
    got = wide_prefill_emulated(xb, tw)
    assert got.dtype == BF16
    big = np.asarray(want.astype(jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(big), 1e-30))) - 7)
    assert np.all(np.abs(got.float().numpy() - big) <= ulp)


@pytest.mark.parametrize("norm,res", [(True, False), (False, True),
                                      (True, True)])
@pytest.mark.parametrize("splits", [None, 2])
def test_glue_vs_forward_mm(norm, res, splits):
    """K1f's glue (the norm in f32 before the planes, the residual added
    once: to the one split's sum, or before the splits' partials) on
    layer 1 of a stacked weight at T = 160, against the JAX
    ``make_mm_indexed(float32)`` that ``forward`` calls, at 1e-5 of
    max|ref|; the port's wrapper (its plain twin on the CPU) the same."""
    T, I, O = 160, 512, 384
    rng = np.random.default_rng(T + 2 * norm + res + (splits or 0))
    jw, tw = _weights(rng, (2, I, O), "INT8")
    x = rng.standard_normal((T, I)).astype(np.float32)
    g = (rng.standard_normal(I) * 0.1 + 1.0).astype(np.float32)
    r = rng.standard_normal((T, O)).astype(np.float32)
    kw = dict(norm_gain=jnp.asarray(g) if norm else None, eps=1e-5,
              residual=jnp.asarray(r) if res else None)
    want = j_make_mm_idx(jnp.float32, interpret=True)(jnp.asarray(x), jw, 1,
                                                      **kw)
    tkw = dict(norm_gain=torch.tensor(g) if norm else None, eps=1e-5,
               residual=torch.tensor(r) if res else None)
    tx = torch.tensor(x)
    assert tqmm._kernel(tx, tw[1], F32, False,
                        tkw["residual"]) == "wide_prefill"
    _close(wide_prefill_emulated(tx, tw[1], splits=splits, **tkw), want,
           TOL_EMU)
    _close(tqmm.qmatmul_pallas_indexed(tx, tw, 1, F32, **tkw), want, TOL_EMU)


@pytest.mark.parametrize("sdt", [F32, BF16])
@pytest.mark.parametrize("splits", [None, 3])
def test_plane_probe_needs_every_plane(sdt, splits):
    """The plane probe that ``chip_smoke.py`` holds the wide kernels to: the
    emulation of all three planes is within 2^-21 of max|exact| at
    T = 129, I = 512, while the product without the lo plane is more than
    four times that off, so a kernel that drops the lo plane fails it."""
    x, w, exact, two = plane_probe(129, 512, sdt)
    assert tqmm._kernel(x, w, F32, False, None) == "wide_prefill"
    ref = exact.abs().max().item()
    got = wide_prefill_emulated(x, w, splits=splits)
    assert (got - exact).abs().max().item() <= TOL_PLANES * ref
    assert (two - exact).abs().max().item() > 4 * TOL_PLANES * ref


def test_cpu_calls_count_nothing():
    """A CPU tensor above 128 rows at f32 compute runs the plain twin and
    moves no count."""
    _, w = _weights(np.random.default_rng(3), (2, 512, 256), "INT8")
    fns = (tqmm.qmatmul_pallas, tqmm.qmatmul_pallas_indexed,
           tqmm.qmatmul_pallas_indexed_fused)

    def counts():
        return [(f.launches, f.launches_wide_pipe, f.launches_wide_prefill,
                 f.launches_prefill) for f in fns]
    before = counts()
    x = torch.randn(200, 512)
    assert torch.equal(tqmm.qmatmul_pallas(x, w[0], F32),
                       tqmm.qmm_plain(x, w[0], F32))
    tqmm.qmatmul_pallas_indexed(x, w, 1, F32)
    tqmm.qmatmul_pallas_indexed(x, w, 1, F32, residual=torch.randn(200, 256))
    assert counts() == before


def test_design_tool_reads_the_wide_kernel():
    """``tools/prefill_design.py``: the wide instantiations' registers and
    spill line from a ``-Xptxas -v`` log, keyed apart from the bf16
    mode's; the wide variants' base is the source's defaults; a wide
    variant's flags set only the wide macros."""
    from fastllama_tpu_torch.tools import prefill_design as pd
    name = ("_ZN47_GLOBAL__N__313c5b33_14_qmm_prefill_cu_ff3e4b9621qmm_wgmma"
            "_wide_kernelIffEEv14CUtensorMap_stS1_S1_PKT_PS2_Pfiiiii")
    text = (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\nptxas info    : Used 168 registers, used 1 barriers\n")
    got = pd.ptxas_report(text)
    assert got["wide:ff"][0] == 168 and got["notes"] == []
    assert "0 bytes spill stores" in got["wide:ff"][1]
    assert pd.WIDE_VARIANTS["wbase"] == (8,)
    assert pd.macros("wns2") == ["-DPF_WIDE_STAGES=2"]
    nan = torch.tensor([1.0, float("nan")])
    assert pd.rel(nan, torch.ones(2)) == float("inf")
    assert pd.rel(torch.ones(2), torch.ones(2)) == 0.0
    assert pd.macros("base")[0] == "-DPF_STAGES=5"
    assert pd.WIDE_READINGS["wide_T512"] == (512, 64)
    assert pd.WIDE_READINGS["wide_T2048_gs128"] == (2048, 128)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _counts(f):
    return (f.launches, f.launches_wide_pipe, f.launches_wide_prefill,
            f.launches_prefill)


GLUE = (("bare", False, False), ("norm", True, False),
        ("residual", False, True), ("norm+residual", True, True))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [129, 130, 255, 256, 257, 383, 512, 1000,
                               2048])
@pytest.mark.parametrize("xdt,sdt,gs", [("float32", "float32", 64),
                                        ("float32", "bfloat16", 64),
                                        ("bfloat16", "float32", 64),
                                        ("float32", "float32", 128)])
def test_wide_prefill_vs_plain_on_card(cuda, T, xdt, sdt, gs):
    """I = 1152 (18 stages), O = 1040 (not a multiple of the 128-column
    block), layer 1 of a stacked INT8 weight, gs 64 (a group a stage) and
    128 (a group over two stages; 5 splits cut groups), bare and with the
    glue:
    within 1e-4 of max|plain| (bf16 x: 1e-2, the output's rounding), each
    call one ``launches_wide_prefill`` on its wrapper and no other mode's
    count moved, a repeat equal bit for bit; the bare call at 1, 2 and 5
    splits too."""
    I, O = 1152, 1040
    rng = np.random.default_rng(T + len(xdt + sdt) + gs)
    scale_dt = np.float32 if sdt == "float32" else ml_dtypes.bfloat16
    _, tw = _weights(rng, (2, I, O), "INT8", gs=gs, scale_dtype=scale_dt)
    tw = tw.to(cuda)
    xd = getattr(torch, xdt)
    x = torch.tensor(rng.standard_normal((T, I)).astype(np.float32),
                     device=cuda).to(xd)
    g = torch.rand((I,), device=cuda) + 0.5
    r = torch.randn((T, O), device=cuda).to(xd)
    tol = TOL_CARD if xdt == "float32" else 1e-2
    assert tqmm._kernel(x, tw[1], F32, False, r) == "wide_prefill"
    for label, norm, res in GLUE:
        kw = dict(norm_gain=g if norm else None, residual=r if res else None)
        f = (tqmm.qmatmul_pallas_indexed if label == "bare"
             else tqmm.qmatmul_pallas_indexed_fused)
        want = tqmm.qmm_fused_plain(x, tw[1], F32, **kw).float()
        before = list(_counts(f))
        got = tqmm.qmatmul_pallas_indexed(x, tw, 1, F32, **kw)
        again = tqmm.qmatmul_pallas_indexed(x, tw, 1, F32, **kw)
        before[0] += 2
        before[2] += 2
        assert list(_counts(f)) == before, label
        torch.cuda.synchronize()
        assert torch.equal(got, again), label
        err = (got.float() - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), (label, err)
    want = tqmm.qmm_plain(x, tw[1], F32).float()
    for splits in (1, 2, 5):
        got = tqmm._launch_prefill(x, tw[1], None, None, 1e-5, splits,
                                   wide=True)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), (splits, err)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(PROJ_7B))
def test_wide_prefill_7b_widths_on_card(cuda, name):
    """A 7B projection at T = 2048 and 300, f32 x and scales, through the
    plain wrapper: against the plain version at 1e-4 of max|plain|, one
    launch on ``launches_wide_prefill``."""
    I, O = PROJ_7B[name]
    rng = np.random.default_rng(len(name))
    _, tw = _weights(rng, (I, O), "INT8")
    tw = tw.to(cuda)
    f = tqmm.qmatmul_pallas
    for T in (2048, 300):
        x = torch.randn((T, I), device=cuda)
        n0 = f.launches_wide_prefill
        got = f(x, tw, F32)
        torch.cuda.synchronize()
        assert f.launches_wide_prefill == n0 + 1
        want = tqmm.qmm_plain(x, tw, F32)
        err = (got - want).abs().max().item()
        assert err <= TOL_CARD * want.abs().max().item(), (T, err)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [48, 129, 256, 2048])
@pytest.mark.parametrize("sdt", [F32, BF16])
def test_plane_probe_on_card(cuda, T, sdt):
    """The wide ring (T = 48) and the wide prefill kernel (auto, 1 and 3
    splits) on the plane probe at I = 4096: within 2^-21 of the exact
    product, which the product without the lo plane misses by more than
    four times that."""
    x, w, exact, two = plane_probe(T, 4096, sdt, cuda)
    ref = exact.abs().max().item()
    assert (two - exact).abs().max().item() > 4 * TOL_PLANES * ref
    got = [tqmm.qmatmul_pallas(x, w, F32)]
    if T > 128:
        got += [tqmm._launch(x, w, F32, splits=z) for z in (1, 3)]
    torch.cuda.synchronize()
    for i, g in enumerate(got):
        err = (g - exact).abs().max().item()
        assert err <= TOL_PLANES * ref, (i, err)


@pytest.mark.gpu
def test_other_wide_calls_leave_the_count_on_card(cuda):
    """T = 128 (the wide ring), gs 16, O = 1000, INT16 at gs 16 and an
    offset residual leave ``launches_wide_prefill`` unmoved; ``mode="wide"``
    forces ``qmm_f32_kernel`` on a wide prefill call, uncounted, and
    agrees within 1e-4."""
    rng = np.random.default_rng(5)
    f = tqmm.qmatmul_pallas
    n0 = f.launches_wide_prefill
    for qname, T, O, gs in (("INT8", 128, 1040, 64), ("INT8", 300, 1040, 16),
                            ("INT8", 300, 1000, 64),
                            ("INT16", 300, 1040, 16)):
        _, tw = _weights(rng, (1024, O), qname, gs=gs)
        f(torch.randn((T, 1024), device=cuda), tw.to(cuda), F32)
    _, ws = _weights(rng, (2, 1024, 512), "INT8")
    ws = ws.to(cuda)
    x = torch.randn((300, 1024), device=cuda)
    fi = tqmm.qmatmul_pallas_indexed_fused
    m0 = fi.launches_wide_prefill
    buf = torch.randn(300 * 512 + 1, device=cuda)
    tqmm.qmatmul_pallas_indexed(x, ws, 1, F32, residual=buf[1:].view(300, 512))
    torch.cuda.synchronize()
    assert f.launches_wide_prefill == n0 and fi.launches_wide_prefill == m0
    forced = tqmm._launch(x, ws[1], F32, mode="wide")
    got = f(x, ws[1], F32)
    torch.cuda.synchronize()
    assert f.launches_wide_prefill == n0 + 1
    err = (got - forced).abs().max().item()
    assert err <= TOL_CARD * forced.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("T,I", [(129, 1152), (2048, 11008)])
@pytest.mark.parametrize("norm", [False, True])
def test_prepass_alone_on_card(cuda, T, I, norm):
    """The pre-pass alone (``_launch_prepass``, which phase 5 times apart
    from the kernel): f32 x's three planes equal ``split_planes`` of x bit
    for bit, bare, and sum to the normalized x within 1e-5 of its max with
    the gain; a bf16 x's one plane is x; no count moves."""
    rng = np.random.default_rng(T + norm)
    x = torch.tensor(rng.standard_normal((T, I)).astype(np.float32),
                     device=cuda)
    g = torch.rand((I,), device=cuda) + 0.5 if norm else None
    fs = (tqmm.qmatmul_pallas, tqmm.qmatmul_pallas_indexed,
          tqmm.qmatmul_pallas_indexed_fused)
    before = [_counts(f) for f in fs]
    xb = tqmm._launch_prepass(x, g)
    one = tqmm._launch_prepass(x.to(BF16), planes=1)
    torch.cuda.synchronize()
    assert [_counts(f) for f in fs] == before
    assert torch.equal(one, x.to(BF16))
    got = [xb[:, q * I:(q + 1) * I].float() for q in range(3)]
    if not norm:
        for p, want in zip(got, split_planes(x)):
            assert torch.equal(p, want)
        return
    r = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + 1e-5)
    want = x * r * g
    err = (sum(got) - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
