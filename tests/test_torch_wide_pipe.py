"""K1's wide mode (f32 compute) on the pipelined ring: the wide
instantiation of ``qmm_pipe_kernel`` (``qmm_pipe_wide_kernel``).

On the CPU: which kernel a wide call takes (:func:`wide_kernel`: for an
int8-held or INT16 weight, gs % 64 == 0 and aligned rows the ring at
T <= 128 and the wide prefill kernel above, else ``qmm_f32_kernel``), the
three-plane split of f32 x (hi + mid + lo == x exactly; one plane for bf16
x), and a torch emulation of the ring's
arithmetic (:func:`wide_emulated`: the planes' products against the
exact integers in one f32 partial a group, times the group's f32 scale)
held against JAX's ``qmatmul_pallas`` at ``compute_dtype=float32`` in
interpret mode (f32 dequant and a ``Precision.HIGHEST`` dot) at 1e-5 of
max|ref|, beside one bf16 plane, which misses it; the fused glue against
the JAX ``make_mm_indexed`` that ``forward`` calls at f32.

On the card (``gpu``): the ring against ``qmm_fused_plain`` at 1e-4 of
max|ref| (``TOL_F32``), one ``.launches_wide_pipe`` a call on the calling
wrapper and ``.launches_pipe`` unmoved, repeats equal bit for bit, and the
calls it does not take leave its count unmoved."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fastllama_tpu.ops.pallas.qmm import (make_mm_indexed as j_make_mm_idx,
                                          qmatmul_pallas as j_qmm)
from fastllama_tpu_torch.ops.kernels import qmm as tqmm
from tests.test_torch_qmm import _weights

F32 = torch.float32


def split_planes(x: torch.Tensor) -> list:
    """The wide ring's bf16 planes of x, as f32 tensors: for f32 x hi =
    bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each rounded to
    nearest, so that hi + mid + lo == x exactly (each difference is exact
    in f32); a bf16 x is one plane."""
    if x.dtype == torch.bfloat16:
        return [x.to(F32)]
    rest, planes = x.to(F32), []
    for _ in range(3):
        p = rest.to(torch.bfloat16).to(F32)
        planes.append(p)
        rest = rest - p
    return planes


def wide_emulated(x: torch.Tensor, w, norm_gain=None, eps: float = 1e-5,
                  residual=None) -> torch.Tensor:
    """The wide ring's arithmetic (``qmm_pipe_wide_kernel``): the K1f
    prologue as ``qmm_fused_plain``'s (normalized in f32, rounded to x's
    dtype); x's planes; each gs-row group contracted in f32 against the
    exact integers, the planes' products (the smallest first) summed into
    one partial; the partial times the group's scale as an exact f32 value;
    the groups and the residual summed in f32; x's dtype out.  Only the
    f32 sum order differs from the kernel."""
    if norm_gain is not None:
        xf = x.to(F32)
        r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        x = (xf * r * norm_gain.to(F32)).to(x.dtype)
    I, O = w.data.shape
    G = I // w.group_size
    wq = w.data.to(F32).reshape(G, -1, O)
    part = sum(torch.bmm(p.reshape(x.shape[0], G, -1).transpose(0, 1), wq)
               for p in reversed(split_planes(x)))      # (G, T, O)
    out = (part * w.scales.to(F32)[:, None, :]).sum(dim=0)
    if residual is not None:
        out = residual.to(F32) + out
    return out.to(x.dtype)


def _close(got: torch.Tensor, want, tol: float):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# -- which kernel a wide call takes ------------------------------------------

# (qtype, compute dtype, T, I, O, gs) -> wide_kernel's choice
KERNEL_CASES = [
    ("INT8", "float32", 1, 512, 256, 64, "pipe"),
    ("INT8", "float32", 48, 512, 256, 64, "pipe"),
    ("INT8", "float32", 128, 512, 256, 64, "pipe"),
    ("INT4", "float32", 1, 512, 256, 64, "pipe"),
    ("INT4", "float32", 48, 512, 256, 64, "pipe"),
    ("INT4", "float32", 128, 512, 256, 64, "pipe"),
    ("INT8", "float32", 48, 512, 256, 128, "pipe"),
    ("INT8", "float32", 129, 512, 256, 64, "prefill"),
    ("INT8", "float32", 48, 512, 256, 16, "f32"),
    ("INT8", "float32", 48, 512, 256, 32, "pipe"),
    ("INT8", "float32", 48, 512, 1000, 64, "f32"),
    ("INT16", "float32", 48, 512, 256, 64, "pipe"),
    ("INT16", "bfloat16", 1, 512, 256, 64, "pipe"),
    ("INT16", "bfloat16", 48, 512, 256, 16, "f32"),
    ("INT16", "bfloat16", 48, 512, 256, 32, "pipe"),
    ("INT16", "float32", 1, 512, 1000, 64, "f32"),
]


@pytest.mark.parametrize("qname,cdt,T,I,O,gs,want", KERNEL_CASES)
def test_wide_kernel_table(qname, cdt, T, I, O, gs, want):
    _, w = _weights(np.random.default_rng(T + O), (I, O), qname, gs=gs)
    cd = getattr(torch, cdt)
    for xdt in (F32, torch.bfloat16):
        x = torch.zeros((T, I), dtype=xdt)
        assert tqmm.qmm_mode(x, w, cd) == "wide"
        assert tqmm.qmm_mode(x, w, cd, groupdot=True) == "wide"
        assert tqmm.wide_kernel(x, w, cd) == want
        kernel = {"pipe": "wide_pipe", "prefill": "wide_prefill"}.get(
            want, "wide")
        assert tqmm._kernel(x, w, cd, False, None) == kernel
        assert tqmm._kernel(x, w, cd, True, None) == kernel


def test_wide_kernel_refuses_calls_that_are_not_wide():
    """A packed weight has no wide path, and bf16 compute on INT8 takes the
    standard modes: both raise, as ``groupdot_kernel`` raises on a wide
    call."""
    from fastllama_tpu_torch.quant.groupquant import pack_int4_rows
    _, w = _weights(np.random.default_rng(1), (512, 256), "INT4")
    packed = tqmm.QArray(pack_int4_rows(w.data), w.scales, w.qtype,
                         w.group_size, group_axis=-2, packed=True)
    x = torch.zeros((4, 512))
    with pytest.raises(ValueError, match="not a wide call"):
        tqmm.wide_kernel(x, packed, F32)
    _, w8 = _weights(np.random.default_rng(2), (512, 256), "INT8")
    with pytest.raises(ValueError, match="not a wide call"):
        tqmm.wide_kernel(x, w8, torch.bfloat16)


def test_wide_kernel_alignment():
    """x's rows off a 16-byte boundary, or an offset residual (the epilogue
    reads it by vectors), keep ``qmm_f32_kernel``."""
    _, w = _weights(np.random.default_rng(0), (512, 256), "INT8")
    xs = torch.zeros(513)[1:].view(1, 512)
    assert tqmm.wide_kernel(xs, w) == "f32"
    assert tqmm.wide_kernel(xs.clone(), w) == "pipe"
    x = torch.zeros((4, 512))
    res = torch.zeros(4 * 256 + 4)
    assert tqmm.wide_kernel(x, w, F32, res[:-4].view(4, 256)) == "pipe"
    assert tqmm.wide_kernel(x, w, F32, res[1:-3].view(4, 256)) == "f32"


# -- the three planes --------------------------------------------------------

def test_split_planes_are_exact():
    """Seeded f32 values over exponents -60..60: every plane is a bf16
    value, hi + mid + lo equals x exactly, and hi + mid alone does not for
    most values (the third plane carries the significand's last 8 bits)."""
    rng = np.random.default_rng(11)
    v = (rng.standard_normal(4096) * np.exp2(
        rng.integers(-60, 61, 4096))).astype(np.float32)
    x = torch.tensor(v)
    hi, mid, lo = split_planes(x)
    for p in (hi, mid, lo):
        assert torch.equal(p.to(torch.bfloat16).to(F32), p)
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())
    assert (hi.double() + mid.double() != x.double()).float().mean() > 0.5
    xb = x.to(torch.bfloat16)
    (one,) = split_planes(xb)
    assert torch.equal(one, xb.to(F32))


# -- the ring's arithmetic, emulated -----------------------------------------

@pytest.mark.parametrize("T", [1, 5, 48, 128])
@pytest.mark.parametrize("sdt,gs,I", [("float32", 64, 512),
                                      ("bfloat16", 64, 512),
                                      ("float32", 128, 1024),
                                      ("bfloat16", 128, 1024)])
def test_wide_emulation_vs_pallas(T, sdt, gs, I):
    """The emulation against the Pallas wide kernel (interpret mode) at
    1e-5 of max|ref|, at O = 256, f32 x; the port's plain twin within the
    same; INT4 held in int8 lanes the same way at T = 5."""
    O = 256
    scale_dt = np.float32 if sdt == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(T + I + gs + len(sdt))
    for qname in (("INT8", "INT4") if T == 5 else ("INT8",)):
        jw, tw = _weights(rng, (I, O), qname, gs=gs, scale_dtype=scale_dt)
        x = rng.standard_normal((T, I)).astype(np.float32)
        tx = torch.tensor(x)
        assert tqmm.wide_kernel(tx, tw) == "pipe"
        want = j_qmm(jnp.asarray(x), jw, jnp.float32, interpret=True)
        got = wide_emulated(tx, tw)
        assert got.dtype == F32 and got.shape == (T, O)
        _close(got, want, 1e-5)
        _close(tqmm.qmm_fused_plain(tx, tw, F32), want, 1e-5)


def test_wide_emulation_bf16_x_and_one_plane():
    """A bf16 x is exact in one plane: the emulation equals the Pallas
    wide kernel on it within 1e-5 of max|ref| (then rounded to bf16 by
    both).  On f32 x one bf16 plane alone misses 1e-5, the three do not."""
    rng = np.random.default_rng(7)
    jw, tw = _weights(rng, (512, 256), "INT8")
    x = rng.standard_normal((16, 512)).astype(np.float32)
    xb = torch.tensor(x).to(torch.bfloat16)
    want = j_qmm(jnp.asarray(x).astype(jnp.bfloat16), jw, jnp.float32,
                 interpret=True)
    got = wide_emulated(xb, tw)
    assert got.dtype == torch.bfloat16
    big = np.asarray(want.astype(jnp.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(big), 1e-30))) - 7)
    assert np.all(np.abs(got.float().numpy() - big) <= ulp)
    want32 = np.asarray(j_qmm(jnp.asarray(x), jw, jnp.float32,
                              interpret=True))
    one = wide_emulated(torch.tensor(x).to(torch.bfloat16).to(F32),
                                 tw).numpy()
    assert np.abs(one - want32).max() > 1e-5 * np.abs(want32).max()
    three = wide_emulated(torch.tensor(x), tw).numpy()
    assert np.abs(three - want32).max() <= 1e-5 * np.abs(want32).max()


@pytest.mark.parametrize("norm,res", [(True, False), (False, True),
                                      (True, True)])
@pytest.mark.parametrize("T,I,O", [(1, 768, 256), (5, 512, 384)])
def test_wide_glue_vs_forward_mm(T, I, O, norm, res):
    """The fused glue (rmsnorm prologue in f32 before the split, residual
    in the f32 epilogue) against the JAX ``make_mm_indexed(float32)`` that
    ``forward`` calls, on layer 1 of a stacked weight, at 1e-5 of
    max|ref|; the port's wrapper (its plain twin on the CPU) the same."""
    rng = np.random.default_rng(T * 3 + I + O + 2 * norm + res)
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
    assert tqmm.wide_kernel(tx, tw[1], F32, tkw["residual"]) == "pipe"
    _close(wide_emulated(tx, tw[1], **tkw), want, 1e-5)
    _close(tqmm.qmatmul_pallas_indexed(tx, tw, 1, F32, **tkw), want, 1e-5)


def test_cpu_wide_counts_nothing():
    """A CPU tensor runs the plain twin and moves no count."""
    _, w = _weights(np.random.default_rng(3), (2, 512, 256), "INT8")
    fns = (tqmm.qmatmul_pallas, tqmm.qmatmul_pallas_indexed,
           tqmm.qmatmul_pallas_indexed_fused)
    before = [(f.launches, f.launches_pipe, f.launches_wide_pipe)
              for f in fns]
    x = torch.randn(4, 512)
    assert torch.equal(tqmm.qmatmul_pallas(x, w[0], F32),
                       tqmm.qmm_plain(x, w[0], F32))
    tqmm.qmatmul_pallas_indexed(x, w, 1, F32, residual=torch.randn(4, 256))
    assert before == [(f.launches, f.launches_pipe, f.launches_wide_pipe)
                      for f in fns]


def test_design_tool_reads_ptxas_and_needs_a_card(monkeypatch):
    """``tools/wide_pipe_design.py``: the registers and spill line of each
    wide instantiation from a ``-Xptxas -v`` log, and no run without a
    card (exit 2, nothing built)."""
    from fastllama_tpu_torch.tools import wide_pipe_design as wd
    name = ("_ZN38_GLOBAL__N__9817ad15_6_qmm_cu_012b3a4120qmm_pipe_wide_"
            "kernelILi3ELi4ELi4EEEvPKvPKaPKhPKfS2_PvPfiiiiiiif")
    text = (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            "loads\nptxas info    : Used 180 registers, used 1 barriers\n")
    got = wd.ptxas_wide(text)
    assert list(got) == ["Li3ELi4ELi4E"]
    assert got["Li3ELi4ELi4E"][0] == 180
    assert "0 bytes spill stores" in got["Li3ELi4ELi4E"][1]
    assert wd.VARIANTS["base"] == (2, 3, 3)      # the source's defaults
    assert [n for n in wd.VARIANTS if wd.diagnostic(n)] == ["planes2",
                                                            "planes1"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(wd, "build_variants", lambda names: 1 / 0)
    assert wd.main([]) == 2


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _counts(f):
    return f.launches, f.launches_pipe, f.launches_wide_pipe


GLUE = (("bare", False, False), ("norm", True, False),
        ("residual", False, True), ("norm+residual", True, True))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2, 5, 16, 17, 47, 48, 64, 65, 127, 128])
@pytest.mark.parametrize("xdt,sdt", [("float32", "float32"),
                                     ("float32", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_wide_ring_vs_plain_on_card(cuda, T, xdt, sdt):
    """I = 1152 (18 stages), O = 1040 (not a multiple of the 128-column
    block), layer 1 of a stacked INT8 weight, bare and with the glue, the
    auto split and every split count that leaves no split empty (bare):
    within 1e-4 of max|plain| (``TOL_F32``; bf16 x: 1e-2, the output
    rounding), each call one ``launches_wide_pipe`` on its wrapper and
    ``launches_pipe`` unmoved, a repeat equal bit for bit."""
    I, O = 1152, 1040
    rng = np.random.default_rng(T + len(xdt + sdt))
    scale_dt = np.float32 if sdt == "float32" else ml_dtypes.bfloat16
    _, tw = _weights(rng, (2, I, O), "INT8", scale_dtype=scale_dt)
    tw = tw.to(cuda)
    xd = getattr(torch, xdt)
    x = torch.tensor(rng.standard_normal((T, I)).astype(np.float32),
                     device=cuda).to(xd)
    g = torch.rand((I,), device=cuda) + 0.5
    r = torch.randn((T, O), device=cuda).to(xd)
    assert tqmm.wide_kernel(x, tw[1]) == "pipe"
    for label, norm, res in GLUE:
        kw = dict(norm_gain=g if norm else None, residual=r if res else None)
        f = (tqmm.qmatmul_pallas_indexed if label == "bare"
             else tqmm.qmatmul_pallas_indexed_fused)
        want = tqmm.qmm_fused_plain(x, tw[1], F32, **kw).float()
        tol = (1e-4 if xdt == "float32" else 1e-2) * want.abs().max().item()
        before = list(_counts(f))
        got = tqmm.qmatmul_pallas_indexed(x, tw, 1, F32, **kw)
        again = tqmm.qmatmul_pallas_indexed(x, tw, 1, F32, **kw)
        before[0] += 2
        before[2] += 2
        assert list(_counts(f)) == before, label
        torch.cuda.synchronize()
        assert torch.equal(got, again), label
        assert (got.float() - want).abs().max().item() <= tol, label
    w1 = tw[1]
    want = tqmm.qmm_plain(x, w1, F32).float()
    tol = (1e-4 if xdt == "float32" else 1e-2) * want.abs().max().item()
    for splits in range(1, 17):
        try:
            tqmm._explicit_split(I, 64, splits)
        except ValueError:
            continue
        got = tqmm.qmatmul_pallas(x, w1, F32, splits=splits)
        torch.cuda.synchronize()
        assert (got.float() - want).abs().max().item() <= tol, splits
    # a groupdot call that is wide takes the same kernel: bit for bit
    assert torch.equal(tqmm.qmatmul_pallas(x, w1, F32, groupdot=True),
                       tqmm.qmatmul_pallas(x, w1, F32))


@pytest.mark.gpu
def test_wide_f32_kernel_cases_leave_the_ring_count_on_card(cuda):
    """T = 129 at gs 16, gs 16, O = 1000 and INT16 at gs 16 keep
    ``qmm_f32_kernel``: one ``.launches`` each, ``launches_wide_pipe``
    unmoved, each within 1e-4 of its plain twin."""
    rng = np.random.default_rng(21)
    f = tqmm.qmatmul_pallas
    for qname, T, O, gs in (("INT8", 129, 1040, 16), ("INT8", 48, 1040, 16),
                            ("INT8", 48, 1000, 64), ("INT16", 48, 1040, 16)):
        _, tw = _weights(rng, (1024, O), qname, gs=gs)
        tw = tw.to(cuda)
        x = torch.randn((T, 1024), device=cuda)
        assert tqmm.wide_kernel(x, tw) == "f32"
        before = _counts(f)
        got = f(x, tw, F32)
        after = _counts(f)
        assert after == (before[0] + 1, before[1], before[2])
        want = tqmm.qmm_plain(x, tw, F32)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= \
            1e-4 * want.abs().max().item()
