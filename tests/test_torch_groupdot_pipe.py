"""The groupdot (scale-after-dot) mode of K1 and K1p on the pipelined ring
(the groupdot instantiation of ``qmm_pipe_kernel``).

On the CPU: which kernel a groupdot call takes (:func:`groupdot_kernel`:
the ring or ``qmm_bf16_kernel``'s loop, by T, group size and alignment;
wide calls stay on the standard path), the ring's launch shape and plan,
and a torch emulation of the ring's flush order (one f32 partial a stage,
a packed stage's two planes each flushed with its own group scale, one
partial sum a split, the splits summed in order as the reduce pass sums
them) held against JAX's ``qmatmul_pallas(..., groupdot=True)`` in
interpret mode.  Tolerances as ``tests/test_torch_groupdot.py``: f32
outputs within 1e-5 of max|ref| (another f32 sum order); bf16 outputs
within one bf16 ulp of the larger value plus 1e-6 of max|ref|.  Packed
shapes use I = 1024 at gs 64 and 2048 at gs 128, the least the Pallas
packed tiling takes.

On the card (``gpu``): the ring against ``qmm_groupdot_plain`` and the
forced loop at O = 1040, T from 1 to 128 and every split count, each call
one ``launches_groupdot_pipe``; loop calls leave that count unmoved."""
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


def _weight(rng, I, O, kind, sdt="float32", gs=64):
    """(JAX QArray, port QArray) of random values and random positive group
    scales: ``kind`` INT8, INT16, INT4 (int8-held) or INT4P (packed)."""
    qt = "INT4" if kind == "INT4P" else kind
    qmax = tcfg.QuantType[qt].factor
    data = rng.integers(-qmax - (kind == "INT4P"), qmax + 1,
                        size=(I, O)).astype(np.int16 if qt == "INT16"
                                            else np.int8)
    scales = ((rng.random((I // gs, O)) + 0.5) * 0.02 / qmax).astype(
        np.float32)
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
    if xdt == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        return
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    slack = 1e-6 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= ulp + slack), \
        np.abs(got - want).max()


# -- which kernel a groupdot call takes --------------------------------------

# (kind, compute dtype, T, I, O, gs) -> kernel ("wide": qmm_mode's wide
# path, never a groupdot kernel)
KERNEL_CASES = [
    ("INT8", "bfloat16", 1, 512, 256, 64, "pipe"),
    ("INT8", "bfloat16", 17, 512, 256, 64, "pipe"),
    ("INT8", "bfloat16", 48, 512, 256, 64, "pipe"),
    ("INT8", "bfloat16", 128, 512, 256, 64, "pipe"),
    ("INT8", "bfloat16", 129, 512, 256, 64, "loop"),
    ("INT8", "bfloat16", 48, 512, 256, 128, "pipe"),
    ("INT8", "bfloat16", 48, 512, 256, 32, "loop"),
    ("INT8", "bfloat16", 1, 512, 256, 16, "loop"),
    ("INT8", "bfloat16", 1, 480, 256, 80, "loop"),
    ("INT8", "bfloat16", 48, 512, 1000, 64, "loop"),
    ("INT8", "bfloat16", 48, 512, 1040, 64, "pipe"),
    ("INT4", "bfloat16", 48, 512, 256, 64, "pipe"),
    ("INT4P", "bfloat16", 1, 512, 256, 64, "pipe"),
    ("INT4P", "float32", 128, 512, 256, 64, "pipe"),
    ("INT4P", "float32", 129, 512, 256, 64, "loop"),
    ("INT4P", "bfloat16", 48, 512, 256, 32, "loop"),
    ("INT4P", "bfloat16", 48, 512, 1000, 64, "loop"),
    ("INT8", "float32", 1, 512, 256, 64, "wide"),
    ("INT16", "bfloat16", 48, 512, 256, 64, "wide"),
    ("INT16", "float32", 48, 512, 256, 64, "wide"),
]


@pytest.mark.parametrize("kind,cdt,T,I,O,gs,want", KERNEL_CASES)
def test_groupdot_kernel_table(kind, cdt, T, I, O, gs, want):
    _, w = _weight(np.random.default_rng(T + O), I, O, kind, gs=gs)
    x = torch.zeros((T, I), dtype=torch.bfloat16)
    cd = getattr(torch, cdt)
    mode = tqmm.qmm_mode(x, w, cd, True)
    if want == "wide":
        assert mode == "wide"
        with pytest.raises(ValueError, match="wide"):
            tqmm.groupdot_kernel(x, w, cd)
        return
    assert mode == "groupdot"
    assert tqmm.groupdot_kernel(x, w, cd) == want
    # the standard mode of the same call is unchanged by the flag (the
    # ring takes gs a multiple of 64, or of 32 on an unpacked weight)
    std = ("scalar" if O % 16 else
           "pipe" if T <= 128 and gs % (64 if w.packed else 32) == 0
           else "loop")
    assert tqmm.qmm_mode(x, w, cd) == std


def test_groupdot_kernel_unaligned_rows():
    """x's rows off a 16-byte boundary keep the loop: the ring copies by
    16-byte cp.async."""
    _, w = _weight(np.random.default_rng(0), 512, 256, "INT8")
    xs = torch.zeros(513, dtype=torch.bfloat16)[1:].view(1, 512)
    assert tqmm.groupdot_kernel(xs, w) == "loop"
    assert tqmm.groupdot_kernel(xs.clone(), w) == "pipe"


@pytest.mark.parametrize("T", [1, 16, 17, 48, 64, 65, 128])
@pytest.mark.parametrize("I,O", [(4096, 4096), (4096, 32000),
                                 (11008, 4096), (4096, 22016)])
def test_groupdot_pipe_shape(T, I, O):
    """The groupdot ring's row tile is the standard mode's; at 128 rows it
    always takes 8 warps of 2 n-tiles (4 warps of 4 have no registers for
    the partial beside the accumulators)."""
    rows, warps = tqmm.pipe_shape(T, I, O, groupdot=True)
    assert rows == tqmm.pipe_shape(T, I, O)[0]
    assert warps == (8 if rows == 128 else 4)
    assert (rows, warps) in {(16, 4), (48, 4), (64, 4), (128, 8)}


# -- the ring's flush order, emulated --------------------------------------

def _plan_of(T, I, O, packed, splits):
    return tqmm.pipe_plan(T, I, O, packed, resident=2, splits=splits,
                          groupdot=True)


def ring_emulation(x: torch.Tensor, w: tq.QArray, splits=None):
    """The groupdot ring's sums in f32: for each split of the plan, for each
    stage (64 W rows; K1p: 32 packed rows), for each plane (K1p: the low
    nibbles' logical rows k0.., then the high ones' I/2 + k0..), the
    partial of the stage's rows (exact integers times bf16 x) scaled by
    the scale row the kernel copies for it, ``(plane * I/2 + k0) // gs``,
    and added to the split's sum; the splits' sums added in order (the
    reduce pass); x's dtype out."""
    T, I = x.shape
    O = w.data.shape[1]
    gs = w.group_size
    u = w.unpacked().data.to(torch.float32)                    # (I, O)
    xb = x.to(torch.bfloat16).to(torch.float32)
    s = w.scales.to(torch.float32)
    plan = _plan_of(T, I, O, w.packed, splits)
    k_rows = I // 2 if w.packed else I
    planes = 2 if w.packed else 1
    sums = []
    for z in range(plan.splits):
        kbeg = z * plan.k_per_split
        kend = min(k_rows, kbeg + plan.k_per_split)
        acc = torch.zeros((T, O), dtype=torch.float32)
        for k0 in range(kbeg, kend, plan.kstep):
            for p in range(planes):
                rows = p * (I // 2) + torch.arange(k0, min(k0 + plan.kstep,
                                                           kend))
                row = (p * (I // 2) + k0) // gs
                # the stage's plane lies in one group (gs % 64 == 0)
                assert bool((rows // gs == row).all())
                part = xb[:, rows] @ u[rows]
                acc = acc + part * s[row]
        sums.append(acc)
    out = sums[0]
    for acc in sums[1:]:
        out = out + acc
    return out.to(x.dtype)


RING_CASES = [
    ("INT8", "float32", 256, 64),
    ("INT8", "bfloat16", 512, 64),
    ("INT8", "float32", 512, 128),
    ("INT4P", "float32", 1024, 64),
    ("INT4P", "bfloat16", 2048, 128),
]


@pytest.mark.parametrize("T", [1, 17, 48, 128])
@pytest.mark.parametrize("kind,sdt,I,gs", RING_CASES)
@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
def test_ring_emulation_vs_pallas(T, kind, sdt, I, gs, xdt):
    """The ring's flush order, at the auto split and every explicit split
    count its plan takes, against the Pallas groupdot kernel (interpret
    mode) and against the port's plain twin, at O = 256."""
    O = 256
    rng = np.random.default_rng(T + I + gs + len(kind + sdt + xdt))
    jw, tw = _weight(rng, I, O, kind, sdt, gs)
    x = rng.standard_normal((T, I)).astype(np.float32)
    tx = torch.tensor(x).to(getattr(torch, xdt))
    assert tqmm.groupdot_kernel(tx, tw) == "pipe"
    want = jqmm.qmatmul_pallas(jnp.asarray(x).astype(xdt), jw,
                               interpret=True, groupdot=True)
    plain = tqmm.qmm_groupdot_plain(tx, tw)
    _close(plain, want, xdt)
    k_rows, kstep = (I // 2, 32) if tw.packed else (I, 64)
    counts = [None] + [n for n in range(1, 17)
                       if -(-k_rows // kstep) >= n]
    seen = 0
    for splits in counts:
        try:
            plan = _plan_of(T, I, O, tw.packed, splits)
        except ValueError:              # a count that leaves a split empty
            continue
        assert splits is None or plan.splits == splits
        got = ring_emulation(tx, tw, splits)
        assert got.dtype == tx.dtype and got.shape == (T, O)
        _close(got, want, xdt)
        seen += 1
    assert seen >= 3


def test_ring_emulation_scales_each_plane_by_its_own_group():
    """A packed stage's two planes lie in different groups: scaling the
    high plane by the low plane's scale row moves the result far outside
    the tolerance, so the emulation's per-plane flush is what agrees."""
    rng = np.random.default_rng(5)
    jw, tw = _weight(rng, 1024, 256, "INT4P")
    x = rng.standard_normal((4, 1024)).astype(np.float32)
    tx = torch.tensor(x)
    want = np.asarray(jqmm.qmatmul_pallas(jnp.asarray(x), jw, interpret=True,
                                          groupdot=True))
    got = ring_emulation(tx, tw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the same sums with the high plane taking the low plane's scales
    u = tw.unpacked().data.to(torch.float32)
    s = tw.scales.to(torch.float32)
    Ih, gs = 512, 64
    wrong = torch.zeros((4, 256))
    for k0 in range(0, Ih, 32):
        for p in range(2):
            rows = p * Ih + torch.arange(k0, k0 + 32)
            wrong += (tx[:, rows] @ u[rows]) * s[k0 // gs]
    assert np.abs(wrong.numpy() - want).max() > 1e-2 * np.abs(want).max()


def test_cpu_groupdot_counts_nothing():
    """A CPU tensor runs the plain twin and moves no count."""
    _, w = _weight(np.random.default_rng(2), 512, 256, "INT8")
    f = tqmm.qmatmul_pallas
    before = (f.launches_groupdot, f.launches_groupdot_p4,
              f.launches_groupdot_pipe, f.launches_pipe)
    x = torch.randn(4, 512)
    assert torch.equal(f(x, w, groupdot=True), tqmm.qmm_groupdot_plain(x, w))
    assert before == (f.launches_groupdot, f.launches_groupdot_p4,
                      f.launches_groupdot_pipe, f.launches_pipe)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _counts():
    f = tqmm.qmatmul_pallas
    return (f.launches_groupdot, f.launches_groupdot_p4,
            f.launches_groupdot_pipe, f.launches_pipe)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2, 16, 17, 47, 48, 64, 65, 127, 128])
@pytest.mark.parametrize("kind", ["INT8", "INT4P"])
@pytest.mark.parametrize("xdt,sdt", [("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("float32", "float32"),
                                     ("float32", "bfloat16")])
def test_groupdot_ring_vs_plain_and_loop_on_card(cuda, T, kind, xdt, sdt):
    """I = 1152 (18 INT8 stages, 18 packed ones) and O = 1040 (not a
    multiple of the 128-column block), every split count that leaves no
    split empty: the ring against ``qmm_groupdot_plain`` and the forced
    loop, each ring call one ``launches_groupdot_pipe`` and one
    ``launches_groupdot`` (``_p4``), the loop calls neither on the ring's
    count."""
    I, O = 1152, 1040
    rng = np.random.default_rng(T + len(kind + xdt + sdt))
    _, tw = _weight(rng, I, O, kind, sdt)
    tw = tw.to(cuda)
    x = torch.tensor(rng.standard_normal((T, I)).astype(np.float32),
                     device=cuda).to(getattr(torch, xdt))
    assert tqmm.groupdot_kernel(x, tw) == "pipe"
    want = tqmm.qmm_groupdot_plain(x, tw).float()
    tol = (1e-4 if xdt == "float32" else 1e-2) * want.abs().max().item()
    k_rows, kstep = (I // 2, 32) if kind == "INT4P" else (I, 64)
    slot = 1 if kind == "INT4P" else 0
    for splits in [None] + list(range(1, 17)):
        if splits is not None:
            try:
                tqmm._explicit_split(k_rows, kstep, splits)
            except ValueError:
                continue
        before = list(_counts())
        got = tqmm.qmatmul_pallas(x, tw, groupdot=True, splits=splits)
        before[slot] += 1
        before[2] += 1
        assert list(_counts()) == before, splits
        mid = _counts()
        loop = tqmm._launch(x, tw, torch.bfloat16, gd=True, splits=splits,
                            mode="loop")
        torch.cuda.synchronize()
        assert _counts() == mid
        assert (got.float() - want).abs().max().item() <= tol, splits
        assert (got.float() - loop.float()).abs().max().item() <= 2 * tol


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["INT8", "INT4P"])
def test_groupdot_loop_cases_leave_the_ring_count_on_card(cuda, kind):
    """T > 128, gs 32, O = 1000: the loop, counted on ``launches_groupdot``
    (``_p4``) and not on ``launches_groupdot_pipe`` or ``launches_pipe``;
    each against the plain twin."""
    rng = np.random.default_rng(9 + len(kind))
    f = tqmm.qmatmul_pallas
    for T, O, gs in ((129, 1040, 64), (48, 1040, 32), (48, 1000, 64)):
        _, tw = _weight(rng, 1024, O, kind, gs=gs)
        tw = tw.to(cuda)
        x = torch.randn((T, 1024), device=cuda).to(torch.bfloat16)
        assert tqmm.groupdot_kernel(x, tw) == "loop"
        before = _counts()
        got = f(x, tw, groupdot=True)
        after = _counts()
        assert after[2:] == before[2:]
        assert sum(after[:2]) == sum(before[:2]) + 1
        want = tqmm.qmm_groupdot_plain(x, tw).float()
        torch.cuda.synchronize()
        assert (got.float() - want).abs().max().item() <= \
            1e-2 * want.abs().max().item()
