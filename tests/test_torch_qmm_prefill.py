"""The prefill mode of K1 and K1p (``qmm_wgmma_kernel`` in
``csrc/qmm_prefill.cu``): which calls take it (``qmm._kernel``'s table),
its host plan (:func:`prefill_plan`: shared memory, TMA boxes, grid and
split-K coverage at the 7B projections), an emulation of its arithmetic
(the pre-pass rounding, each stage's dequant rounding, f32 sums in its K
order, split partials after the residual) against the JAX Pallas kernels
in interpret mode at small widths (1e-2 of max|ref| at bf16 output,
``TOL_P4_NORM`` 1e-3 at K1p's f32 output through the norm, 1e-4 without
it: the two sum in another order), and that CPU calls count nothing.  The
card-only cases hold the CUDA kernel against its plain version at ragged
T and 7B widths, and check its counts."""
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast when the suite's
    workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16, F32 = torch.bfloat16, torch.float32
TOL_P4_NORM = 1e-3


def _weight(rng, shape, kind, sdt="float32", gs=64):
    """(JAX QArray, port QArray) of random values and random positive group
    scales: ``kind`` INT8 or INT4P (packed)."""
    packed = kind == "INT4P"
    qt = "INT4" if packed else kind
    qmax = tcfg.QuantType[qt].factor
    data = rng.integers(-qmax - packed, qmax + 1, size=shape).astype(np.int8)
    sshape = (*shape[:-2], shape[-2] // gs, shape[-1])
    scales = ((rng.random(sshape) + 0.5) * 0.02 / qmax).astype(np.float32)
    if sdt == "bfloat16":
        scales = scales.astype(ml_dtypes.bfloat16).astype(np.float32)
    if packed:
        data = jq.pack_int4_rows_np(data)
    jw = jq.QArray(jnp.asarray(data), jnp.asarray(scales).astype(sdt),
                   jcfg.QuantType[qt], gs, group_axis=-2, packed=packed)
    tw = tq.QArray(torch.tensor(data),
                   torch.tensor(scales).to(getattr(torch, sdt)),
                   tcfg.QuantType[qt], gs, group_axis=-2, packed=packed)
    return jw, tw


def _close(got: torch.Tensor, want, tol: float):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# -- which calls take the mode ------------------------------------------------

def _expected(kind: str, T: int, gs: int) -> str:
    """The kernel the table expects: the ring up to 128 rows, the prefill
    mode above (at f32 compute the wide ring and the wide prefill kernel),
    both for gs a multiple of 64 and aligned operands, and on an unpacked
    weight for gs a multiple of 32 (the G32 instantiations)."""
    big, g64, g32 = T > tqmm.PIPE_MAX_T, gs % 64 == 0, gs % 32 == 0
    if kind in ("int8", "int4p"):
        ok = g32 if kind == "int8" else g64
        return ("prefill" if big else "pipe") if ok else "loop"
    if kind == "wide":
        return ("wide_prefill" if big else "wide_pipe") if g32 else "wide"
    if kind == "groupdot":
        return "pipe" if g64 and not big else "loop"
    if kind == "o1000":
        return "scalar"
    return "loop"                      # an offset residual


@pytest.mark.parametrize("kind", ["int8", "int4p", "wide", "groupdot",
                                  "o1000", "offset_residual"])
@pytest.mark.parametrize("gs", [16, 32, 64, 128])
@pytest.mark.parametrize("T", [128, 129, 2048])
def test_kernel_table(T, gs, kind):
    """``qmm._kernel``'s choice (the mode a wrapper launches) from dtypes,
    shapes and alignment only: ``qmm_mode`` keeps ``"loop"`` for every
    call above 128 rows that is not wide, groupdot or unaligned, and
    :func:`prefill_kernel` sends those with gs % 64 == 0 (unpacked: gs %
    32 == 0) and an aligned residual to the prefill mode."""
    O = 1000 if kind == "o1000" else 256
    _, w = _weight(np.random.default_rng(T + gs), (512, O),
                   "INT4P" if kind == "int4p" else "INT8", gs=gs)
    x = torch.zeros((T, 512), dtype=BF16)
    cdt = F32 if kind == "wide" else BF16
    res = None
    if kind == "offset_residual":
        res = torch.zeros(T * O + 1, dtype=BF16)[1:].view(T, O)
        assert res.data_ptr() % 16 != 0
    got = tqmm._kernel(x, w, cdt, kind == "groupdot", res)
    assert got == _expected(kind, T, gs)
    if got == "prefill":
        assert tqmm.qmm_mode(x, w, cdt, False, res) == "loop"
        assert tqmm.prefill_kernel(x, w, cdt, res) == "prefill"


def test_prefill_kernel_refuses_calls_that_are_not_loop_calls():
    """:func:`prefill_kernel` resolves only what ``qmm_mode`` calls
    ``"loop"``: a ring call, a wide call and an unaligned one raise."""
    _, w = _weight(np.random.default_rng(4), (512, 256), "INT8")
    for x, cdt in ((torch.zeros((128, 512), dtype=BF16), BF16),
                   (torch.zeros((256, 512), dtype=BF16), F32),
                   (torch.zeros(256 * 512 + 1, dtype=BF16)[1:].view(256, 512),
                    BF16)):
        with pytest.raises(ValueError):
            tqmm.prefill_kernel(x, w, cdt)
    assert tqmm.prefill_kernel(torch.zeros((256, 512), dtype=BF16),
                               w) == "prefill"


# -- the host plan ----------------------------------------------------------

PROJ_7B = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
           "w2": (11008, 4096), "classifier": (4096, 32000)}
PROJ_7B_INT4 = dict(PROJ_7B, w13=(4096, 22528), w2=(11264, 4096))
SMEM_BLOCK = 232448        # shared memory an H100 block may use


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("ssz", [4, 2])
@pytest.mark.parametrize("T", [129, 256, 1000, 2048])
def test_prefill_plan_fits_and_covers(T, ssz, packed):
    """Every 7B (INT4: hidden 11264) projection: the block's shared memory
    within the H100's 227 KB; the TMA boxes within their limits (W's inner
    box 128 bytes at the 128-byte swizzle, x's 64 at the 64-byte one, no
    box dimension above 256); the bytes a stage expects equal to its
    boxes'; a grid whose tiles cover T and O once; splits of whole stages
    that cover the K rows once, none empty."""
    for name, (I, O) in (PROJ_7B_INT4 if packed else PROJ_7B).items():
        p = tqmm.prefill_plan(T, I, O, packed, ssz)
        assert p.smem + p.static_smem <= SMEM_BLOCK
        assert p.w_box[0] * 1 <= 128 and p.x_box[0] * 2 <= 64
        assert max(p.w_box + p.x_box + p.s_box) <= 256
        assert p.s_box[0] * ssz % 16 == 0
        assert p.tx_bytes == (p.w_box[0] * p.w_box[1]
                              + 2 * p.x_box[0] * p.x_box[1] * 2
                              + (2 if packed else 1) * p.s_box[0] * ssz)
        assert p.stage_bytes % 1024 == 0
        assert p.kstep == (32 if packed else 64)
        gx, gy, gz = p.grid
        assert (gx - 1) * p.cols < O <= gx * p.cols
        assert (gy - 1) * p.rows < T <= gy * p.rows
        k_rows = I // 2 if packed else I
        assert gz == p.splits and p.k_per_split % p.kstep == 0
        assert (p.splits - 1) * p.k_per_split < k_rows <= (
            p.splits * p.k_per_split), name


def test_prefill_plan_rule():
    """One split when the output tiles alone give every SM a block; else
    as many splits as leave a block an SM (rounded down), each of at least
    4 stages; an explicit count as ``split_plan``'s; T <= 128 refused."""
    assert tqmm.prefill_plan(2048, 4096, 4096, False).splits == 1
    assert tqmm.prefill_plan(1024, 4096, 12288, False).splits == 1
    p = tqmm.prefill_plan(256, 4096, 4096, False, n_sm=132)
    assert p.grid[:2] == (32, 1) and p.splits == 4
    assert p.k_per_split == 1024
    assert tqmm.prefill_plan(256, 11264, 4096, True).splits == 4
    assert tqmm.prefill_plan(512, 4096, 4096, False).splits == 2
    assert tqmm.prefill_plan(256, 256, 256, False).splits == 1
    assert tqmm.prefill_plan(2048, 4096, 4096, False, splits=3).splits == 3
    for bad in (dict(T=128), dict(splits=0), dict(splits=100)):
        kw = dict(T=2048, I=4096, O=4096, packed=False)
        kw.update(bad)
        with pytest.raises(ValueError):
            tqmm.prefill_plan(**kw)


# -- the kernel's arithmetic, emulated ---------------------------------------

def prefill_emulated(x: torch.Tensor, w, norm_gain=None, eps: float = 1e-5,
                     residual=None, splits=None) -> torch.Tensor:
    """``qmm_wgmma_kernel``'s arithmetic on the CPU.  The pre-pass: x, or
    xn = to_x_dtype(x * rsqrt(mean(x^2) + eps) * gain) in f32, rounded to
    bf16.  The dequant: INT8 bf16(b * bf16(s)), K1p bf16(f32(nibble) *
    f32(s)).  Each split's f32 partial sums its stages' planes in order
    (K1: rows k0..k0+31, then k0+32..k0+63; K1p: the low plane's 32 rows
    k0.., then the high plane's I/2 + k0..); one split adds the residual
    to its partial, more splits are summed in order after it."""
    T, I = x.shape
    O = w.data.shape[1]
    if norm_gain is not None:
        xf = x.to(F32)
        r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        x = (xf * r * norm_gain.to(F32)).to(x.dtype)
    xb = x.to(BF16).to(F32)
    u = w.unpacked()
    sc = u.scales.to(F32).repeat_interleave(w.group_size, dim=0)
    if not w.packed:
        sc = sc.to(BF16).to(F32)
    wd = (u.data.to(F32) * sc).to(BF16).to(F32)
    plan = tqmm.prefill_plan(T, I, O, w.packed, w.scales.element_size(),
                             splits)
    k_rows = I // 2 if w.packed else I
    parts = []
    for z in range(plan.splits):
        acc = torch.zeros((T, O), dtype=F32)
        kbeg = z * plan.k_per_split
        for k0 in range(kbeg, min(k_rows, kbeg + plan.k_per_split),
                        plan.kstep):
            planes = ((k0, I // 2 + k0) if w.packed else (k0, k0 + 32))
            for r0 in planes:
                acc = acc + xb[:, r0:r0 + 32] @ wd[r0:r0 + 32]
        parts.append(acc)
    if plan.splits == 1:
        out = parts[0] if residual is None else residual.to(F32) + parts[0]
    else:
        out = (torch.zeros((T, O), dtype=F32) if residual is None
               else residual.to(F32))
        for part in parts:
            out = out + part
    return out.to(x.dtype)


@pytest.mark.parametrize("T,sdt", [(256, "float32"), (512, "float32"),
                                   (256, "bfloat16")])
def test_int8_emulation_vs_pallas(T, sdt):
    """INT8 at bf16 compute: the emulation at the auto split and at two
    and four splits, and the wrapper's plain twin, against
    ``qmatmul_pallas`` in interpret mode."""
    rng = np.random.default_rng(T + len(sdt))
    jw, tw = _weight(rng, (256, 256), "INT8", sdt)
    x = rng.standard_normal((T, 256)).astype(np.float32)
    tx = torch.tensor(x).to(BF16)
    want = jqmm.qmatmul_pallas(jnp.asarray(x).astype(jnp.bfloat16), jw,
                               jnp.bfloat16, interpret=True)
    for splits in (None, 2, 4):
        _close(prefill_emulated(tx, tw, splits=splits), want, 1e-2)
    _close(tqmm.qmatmul_pallas(tx, tw), want, 1e-2)


@pytest.mark.parametrize("norm,res", [(True, False), (False, True),
                                      (True, True)])
def test_int8_glue_emulation_vs_pallas(norm, res):
    """K1f's glue (the norm in f32 with one rounding before the bf16
    pre-pass, the residual added to the f32 sum) on layer 1 of a stacked
    INT8 weight, against the fused ``qmatmul_pallas_indexed`` in interpret
    mode, also with the residual through two splits."""
    rng = np.random.default_rng(7 + 2 * norm + res)
    jw, tw = _weight(rng, (2, 256, 256), "INT8")
    T = 256
    x = rng.standard_normal((T, 256)).astype(np.float32)
    g = (rng.standard_normal(256) * 0.1 + 1.0).astype(np.float32)
    r = rng.standard_normal((T, 256)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = jqmm.qmatmul_pallas_indexed(
        jx, jw, 1, jnp.bfloat16, interpret=True,
        norm_gain=jnp.asarray(g) if norm else None, eps=1e-5,
        residual=jnp.asarray(r).astype(jnp.bfloat16) if res else None)
    tkw = dict(norm_gain=torch.tensor(g) if norm else None, eps=1e-5,
               residual=torch.tensor(r).to(BF16) if res else None)
    tx = torch.tensor(x).to(BF16)
    for splits in (None, 2):
        _close(prefill_emulated(tx, tw[1], splits=splits, **tkw), want, 1e-2)
    _close(tqmm.qmatmul_pallas_indexed(tx, tw, 1, **tkw), want, 1e-2)


@pytest.mark.parametrize("T,xdt", [(256, "bfloat16"), (512, "float32")])
def test_int4_emulation_vs_pallas(T, xdt):
    """K1p on a packed (I/2, O) weight: x rounded to bf16 at any compute
    dtype, each nibble times its f32 scale rounded once, the planes of a
    stage in turn; against the packed ``qmatmul_pallas`` in interpret mode
    (f32 output: 1e-4 of max|ref|)."""
    rng = np.random.default_rng(T + len(xdt) + 3)
    jw, tw = _weight(rng, (1024, 256), "INT4P")
    x = rng.standard_normal((T, 1024)).astype(np.float32)
    tx = torch.tensor(x).to(getattr(torch, xdt))
    want = jqmm.qmatmul_pallas(jnp.asarray(x).astype(xdt), jw, jnp.bfloat16,
                               interpret=True)
    tol = 1e-2 if xdt == "bfloat16" else 1e-4
    for splits in (None, 2):
        _close(prefill_emulated(tx, tw, splits=splits), want, tol)
    _close(tqmm.qmatmul_pallas(tx, tw), want, tol)


def test_int4_norm_emulation_vs_pallas():
    """K1p with the norm on f32 x, layer 1 of a stacked packed weight: the
    JAX packed indexed form normalizes outside its kernel and drops the
    residual, so the norm alone is held, at ``TOL_P4_NORM``."""
    rng = np.random.default_rng(11)
    jw, tw = _weight(rng, (2, 1024, 256), "INT4P")
    x = rng.standard_normal((256, 1024)).astype(np.float32)
    g = (rng.standard_normal(1024) * 0.1 + 1.0).astype(np.float32)
    want = jqmm.qmatmul_pallas_indexed(jnp.asarray(x), jw, 1, jnp.bfloat16,
                                       interpret=True,
                                       norm_gain=jnp.asarray(g), eps=1e-5)
    tx, tg = torch.tensor(x), torch.tensor(g)
    _close(prefill_emulated(tx, tw[1], norm_gain=tg), want, TOL_P4_NORM)
    _close(tqmm.qmatmul_pallas_indexed(tx, tw, 1, norm_gain=tg), want,
           TOL_P4_NORM)


def test_ffma_dequant_is_the_rounded_product():
    """INT8's dequant in the kernel: the byte, its sign flipped, as the
    float 2^23 + b + 128 (a PRMT into 0x4B000000), and one FFMA with the
    offset -(2^23 + 128) * s, which is exact in f32 for every bf16 s, so the
    FFMA returns b * s exactly; rounded to bf16 once it is bf16(b *
    bf16(s)), the plain version's product, for every byte and a sweep of
    scales."""
    b = np.arange(-128, 128, dtype=np.float32)
    magic = ((b.astype(np.int32) + 128) | 0x4B000000).astype(
        np.uint32).view(np.float32)
    assert np.array_equal(magic.astype(np.float64) - 8388736.0, b)
    rng = np.random.default_rng(5)
    s = np.concatenate([rng.random(2000) * 0.02 / 127 + 1e-6,
                        rng.random(500) * 4.0]).astype(np.float32)
    sb = s.astype(ml_dtypes.bfloat16).astype(np.float64)
    c = (-8388736.0 * sb).astype(np.float32)
    assert np.array_equal(c.astype(np.float64), -8388736.0 * sb)
    exact = magic[None, :].astype(np.float64) * sb[:, None] + c[:, None]
    assert np.array_equal(exact, b[None, :] * sb[:, None])
    got = exact.astype(np.float32).astype(ml_dtypes.bfloat16)
    want = (b[None, :] * sb[:, None]).astype(ml_dtypes.bfloat16)
    assert np.array_equal(got.view(np.uint16), want.view(np.uint16))


def test_cpu_calls_count_nothing():
    """A CPU tensor above 128 rows runs the plain twin and moves no
    count."""
    _, w = _weight(np.random.default_rng(9), (2, 512, 256), "INT8")
    fns = (tqmm.qmatmul_pallas, tqmm.qmatmul_pallas_indexed,
           tqmm.qmatmul_pallas_indexed_fused)
    before = [(f.launches, f.launches_pipe, f.launches_prefill) for f in fns]
    x = torch.randn(200, 512).to(BF16)
    assert torch.equal(tqmm.qmatmul_pallas(x, w[0]),
                       tqmm.qmm_plain(x, w[0]))
    tqmm.qmatmul_pallas_indexed(x, w, 1)
    tqmm.qmatmul_pallas_indexed(x, w, 1, residual=torch.randn(200, 256)
                                .to(BF16))
    assert before == [(f.launches, f.launches_pipe, f.launches_prefill)
                      for f in fns]


def test_design_tool_reads_ptxas_and_needs_a_card(monkeypatch):
    """``tools/prefill_design.py``: the registers and spill line of each
    prefill instantiation and ptxas's performance notes from a ``-Xptxas
    -v`` log, and no run without a card (exit 2, nothing built)."""
    from fastllama_tpu_torch.tools import prefill_design as pd
    name = ("_ZN47_GLOBAL__N__313c5b33_14_qmm_prefill_cu_ff3e4b9616qmm_wgmma"
            "_kernelILb0E13__nv_bfloat16fEEv14CUtensorMap_stS2_S2_PKT0_PS3_"
            "Pfiiiii")
    text = (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\nptxas info    : Used 168 registers, used 1 barriers\n"
            "ptxas info    : (C7512) Potential Performance Loss: "
            "wgmma.mma_async instructions are serialized\n")
    got = pd.ptxas_report(text)
    assert got["Lb0E13__nv_bfloat16f"][0] == 168
    assert "0 bytes spill stores" in got["Lb0E13__nv_bfloat16f"][1]
    assert len(got["notes"]) == 1 and "C7512" in got["notes"][0]
    assert pd.VARIANTS["base"] == (5, 4, 0, 1)    # the source's defaults
    assert [n for n in pd.VARIANTS if pd.diagnostic(n)] == ["diag"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pd, "build_variants", lambda names: 1 / 0)
    assert pd.main([]) == 2


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _counts(f):
    return f.launches + f.launches_p4, f.launches_pipe, f.launches_prefill


def _card_weight(rng, shape, kind, sdt, dev):
    _, tw = _weight(rng, shape, kind, sdt)
    return tw.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [129, 130, 200, 255, 256, 257, 383, 512,
                               1000])
@pytest.mark.parametrize("kind,xdt,sdt", [
    ("INT8", "bfloat16", "float32"), ("INT8", "bfloat16", "bfloat16"),
    ("INT8", "float32", "float32"), ("INT4P", "bfloat16", "float32"),
    ("INT4P", "float32", "float32")])
def test_prefill_vs_plain_on_card(cuda, T, kind, xdt, sdt):
    """I = 2304 (INT8 36 stages, K1p 36 packed), O = 1040 (not a multiple of
    the 256-column block), layer 1 of a stacked weight, bare and with the
    norm, the residual and both, against the plain version (bf16 x 1e-2,
    f32 x 1e-4 of max|plain|, 1e-3 through the norm); each wrapper call one
    launch on its ``launches_prefill`` and none on ``launches_pipe``; the
    bare call at 1, 2 and 5 splits (``_launch_prefill``) too."""
    rng = np.random.default_rng(T + len(kind) + len(xdt) + len(sdt))
    I, O = 2304, 1040
    tw = _card_weight(rng, (2, I, O), kind, sdt, cuda)
    xd = getattr(torch, xdt)
    x = torch.tensor(rng.standard_normal((T, I)).astype(np.float32),
                     device=cuda).to(xd)
    g = torch.tensor((rng.random(I) + 0.5).astype(np.float32), device=cuda)
    r = torch.tensor(rng.standard_normal((T, O)).astype(np.float32),
                     device=cuda).to(xd)
    for norm, res in ((False, False), (True, False), (False, True),
                      (True, True)):
        kw = dict(norm_gain=g if norm else None,
                  residual=r if res else None)
        f = (tqmm.qmatmul_pallas_indexed_fused if norm or res
             else tqmm.qmatmul_pallas_indexed)
        n0 = _counts(f)
        got = tqmm.qmatmul_pallas_indexed(x, tw, 1, BF16, **kw)
        torch.cuda.synchronize()
        assert _counts(f) == (n0[0] + 1, n0[1], n0[2] + 1)
        want = tqmm.qmm_fused_plain(x, tw[1], BF16, **kw)
        tol = 1e-2 if xdt == "bfloat16" else 1e-3 if norm else 1e-4
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), (norm, res)
    want = tqmm.qmm_plain(x, tw[1])
    for splits in (1, 2, 5):
        got = tqmm._launch_prefill(x, tw[1], None, None, 1e-5, splits)
        torch.cuda.synchronize()
        tol = 1e-2 if xdt == "bfloat16" else 1e-4
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), splits


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["wqkv", "wo", "w13", "w2"])
@pytest.mark.parametrize("kind", ["INT8", "INT4P"])
def test_prefill_7b_widths_on_card(cuda, name, kind):
    """A 7B projection (INT4: hidden 11264) at T = 2048 and 300 through the
    plain wrapper: against the plain version at 1e-2 of max|plain|, one
    launch on ``launches_prefill``."""
    I, O = PROJ_7B_INT4[name] if kind == "INT4P" else PROJ_7B[name]
    rng = np.random.default_rng(len(name) + len(kind))
    tw = _card_weight(rng, (I, O), kind, "float32", cuda)
    f = tqmm.qmatmul_pallas
    for T in (2048, 300):
        x = torch.randn((T, I), device=cuda).to(BF16)
        n0 = f.launches_prefill
        got = f(x, tw)
        torch.cuda.synchronize()
        assert f.launches_prefill == n0 + 1
        want = tqmm.qmm_plain(x, tw)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 1e-2 * want.float().abs().max().item()


@pytest.mark.gpu
def test_other_calls_leave_the_prefill_count_on_card(cuda):
    """T = 128 (the ring), gs = 16, groupdot, the wide path, unaligned rows
    and an offset residual leave ``launches_prefill`` unmoved; the loop
    forced on a prefill call (``mode="loop"``) is uncounted and agrees."""
    rng = np.random.default_rng(21)
    tw = _card_weight(rng, (1024, 512), "INT8", "float32", cuda)
    _, t32 = _weight(rng, (1024, 512), "INT8", gs=16)
    t32 = t32.to(cuda)
    f = tqmm.qmatmul_pallas
    n0 = f.launches_prefill
    x = torch.randn((300, 1024), device=cuda).to(BF16)
    f(torch.randn((128, 1024), device=cuda).to(BF16), tw)
    f(x, t32)
    f(x, tw, groupdot=True)
    f(x, tw, compute_dtype=F32)
    xs = torch.randn(300 * 1024 + 1, device=cuda).to(BF16)[1:].view(300, 1024)
    f(xs, tw)
    fi = tqmm.qmatmul_pallas_indexed_fused
    m0 = fi.launches_prefill
    ws = _card_weight(rng, (2, 1024, 512), "INT8", "float32", cuda)
    buf = torch.randn(300 * 512 + 1, device=cuda).to(BF16)
    tqmm.qmatmul_pallas_indexed(x, ws, 1, residual=buf[1:].view(300, 512))
    torch.cuda.synchronize()
    assert f.launches_prefill == n0 and fi.launches_prefill == m0
    loop = tqmm._launch(x, tw, BF16, mode="loop")
    got = f(x, tw)
    torch.cuda.synchronize()
    assert f.launches_prefill == n0 + 1
    err = (got.float() - loop.float()).abs().max().item()
    assert err <= 1e-2 * loop.float().abs().max().item()
