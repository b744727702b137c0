"""The groupdot (scale-after-dot) mode of K1 and K1p:
``qmatmul_pallas(..., groupdot=True)`` on the CPU (its plain version,
``qmm_groupdot_plain``) against the JAX Pallas kernel with
``groupdot=True`` in interpret mode, at ``tests/test_pallas_qmm.py:43-59``'s
shapes (O = 512; I = 256 at INT8, I = 1024 at packed INT4).  Tolerances:
f32 outputs within 1e-5 of max|ref| (the two sum the group partials in
another order), bf16 outputs within one bf16 ulp of each element (the same
sums rounded once) plus 1e-6 of max|ref| (an element whose sum cancels to
near zero has an ulp below the f32 sums' order difference).  Also: the
wide cases equal the standard path exactly, groupdot stays within JAX's
own 1e-2 of the standard path, ``splits`` is checked, and nothing is
counted on the CPU.  The card-only tests hold
the CUDA kernel against the plain version."""
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


O = 512


def _weight(rng, I, kind, sdt="float32", gs=64, O=O):
    """(JAX QArray, port QArray) of random values and random positive
    group scales: ``kind`` INT8, INT16, INT4 (int8-held) or INT4P
    (split-half packed)."""
    qt = "INT4" if kind == "INT4P" else kind
    qmax = tcfg.QuantType[qt].factor
    data = rng.integers(-qmax, qmax + 1, size=(I, O)).astype(
        np.int16 if qt == "INT16" else np.int8)
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


def _x(rng, T, I, xdt):
    x = rng.standard_normal((T, I)).astype(np.float32)
    return jnp.asarray(x).astype(xdt), torch.tensor(x).to(getattr(torch,
                                                                  xdt))


def _close(got: torch.Tensor, want, xdt: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if xdt == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        return
    # one bf16 ulp (8 significant bits) of the larger of the two values,
    # plus the f32 sums' own order difference (1e-6 of max|ref|), which
    # is all that separates the two where the sum cancels to near zero
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    slack = 1e-6 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= ulp + slack), \
        np.abs(got - want).max()


def _counts():
    f = tqmm.qmatmul_pallas
    return (f.launches, f.launches_p4, f.launches_groupdot,
            f.launches_groupdot_p4)


@pytest.mark.parametrize("T", [1, 8])
@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["INT8", "INT4P", "INT4"])
def test_groupdot_vs_pallas(T, xdt, sdt, kind):
    """The wrapper on a CPU tensor is ``qmm_groupdot_plain``, bit for bit,
    and agrees with the Pallas groupdot kernel; a packed weight takes the
    groupdot body at f32 compute too."""
    I = 1024 if kind == "INT4P" else 256
    rng = np.random.default_rng(T + 10 * len(xdt) + 100 * len(sdt)
                                + len(kind))
    jw, tw = _weight(rng, I, kind, sdt)
    jx, tx = _x(rng, T, I, xdt)
    before = _counts()
    want = jqmm.qmatmul_pallas(jx, jw, interpret=True, groupdot=True)
    got = tqmm.qmatmul_pallas(tx, tw, groupdot=True)
    assert got.dtype == tx.dtype and got.shape == (T, O)
    assert torch.equal(got, tqmm.qmm_groupdot_plain(tx, tw))
    _close(got, want, xdt)
    if kind == "INT4P":
        got32 = tqmm.qmatmul_pallas(tx, tw, torch.float32, groupdot=True)
        assert torch.equal(got32, got)
        _close(got32, jqmm.qmatmul_pallas(jx, jw, jnp.float32,
                                          interpret=True, groupdot=True),
               xdt)
    assert _counts() == before


@pytest.mark.parametrize("gs", [32, 128])
def test_groupdot_group_sizes_vs_pallas(gs):
    """Other group sizes the kernel takes (a packed I of 2048, which the
    Pallas packed tiling needs at gs 128)."""
    rng = np.random.default_rng(gs)
    for kind, I in (("INT8", 512), ("INT4P", 2048)):
        jw, tw = _weight(rng, I, kind, gs=gs)
        jx, tx = _x(rng, 8, I, "float32")
        _close(tqmm.qmatmul_pallas(tx, tw, groupdot=True),
               jqmm.qmatmul_pallas(jx, jw, interpret=True, groupdot=True),
               "float32")


@pytest.mark.parametrize("kind,cdt", [("INT16", torch.bfloat16),
                                      ("INT16", torch.float32),
                                      ("INT8", torch.float32)])
@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
def test_wide_cases_take_the_standard_path(kind, cdt, xdt):
    """INT16, or INT8 at f32 compute: groupdot equals the standard path
    exactly (both wrappers and both plain versions), as the Pallas kernel
    takes its standard wide body (qmm.py:111)."""
    rng = np.random.default_rng(len(kind) + len(xdt))
    jw, tw = _weight(rng, 256, kind)
    jx, tx = _x(rng, 8, 256, xdt)
    std = tqmm.qmatmul_pallas(tx, tw, cdt)
    assert torch.equal(tqmm.qmatmul_pallas(tx, tw, cdt, groupdot=True), std)
    assert torch.equal(tqmm.qmm_groupdot_plain(tx, tw, cdt),
                       tqmm.qmm_plain(tx, tw, cdt))
    jcdt = jnp.float32 if cdt == torch.float32 else jnp.bfloat16
    want = jqmm.qmatmul_pallas(jx, jw, jcdt, interpret=True, groupdot=True)
    got = std.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if xdt == "float32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("T,kind", [(1, "INT8"), (8, "INT8"),
                                    (1, "INT4P")])
def test_groupdot_near_standard(T, kind):
    """JAX's own property (``test_qmm_groupdot_variant``): groupdot within
    1e-2 of max|standard| (it keeps the scales in f32 where the standard
    INT8 path rounds them to bf16)."""
    I = 1024 if kind == "INT4P" else 256
    rng = np.random.default_rng(3 + T)
    _, tw = _weight(rng, I, kind)
    _, tx = _x(rng, T, I, "bfloat16")
    ref = tqmm.qmatmul_pallas(tx, tw).float()
    got = tqmm.qmatmul_pallas(tx, tw, groupdot=True).float()
    assert float((got - ref).abs().max()) / float(ref.abs().max()) < 0.01


def test_splits_are_checked():
    """An explicit split count must be an int that leaves no split empty;
    the plain version ignores a legal one (it has no split)."""
    rng = np.random.default_rng(7)
    _, tw = _weight(rng, 256, "INT8")             # 4 stages of 64 rows
    _, tx = _x(rng, 4, 256, "bfloat16")
    ref = tqmm.qmatmul_pallas(tx, tw)
    for s in (1, 2, 4):
        assert torch.equal(tqmm.qmatmul_pallas(tx, tw, splits=s), ref)
        assert torch.equal(tqmm.qmatmul_pallas(tx, tw, groupdot=True,
                                               splits=s),
                           tqmm.qmm_groupdot_plain(tx, tw))
    for bad in (0, 3, 5, -1, 2.0, "2"):
        with pytest.raises(ValueError, match="splits"):
            tqmm.qmatmul_pallas(tx, tw, groupdot=True, splits=bad)
    # f32 compute walks 16-row stages: 16 of them, so 16 splits fit
    assert tqmm.split_plan(4, 256, O, tw, torch.float32, 16) == (16, 16)
    with pytest.raises(ValueError):
        tqmm.split_plan(4, 256, O, tw, torch.bfloat16, 16)
    # a packed weight walks I/2 packed rows, 32 a stage
    _, tp = _weight(rng, 1024, "INT4P")
    assert tqmm.split_plan(1, 1024, O, tp, torch.bfloat16, 16) == (16, 32)
    assert tqmm.split_plan(1, 1024, O, tp, torch.bfloat16, 3) == (3, 192)
    with pytest.raises(ValueError):
        tqmm.split_plan(1, 1024, O, tp, torch.bfloat16, 17)
    # None keeps the auto rule
    assert tqmm.split_plan(1, 4096, 4096, tw, torch.bfloat16, None,
                           n_sm=132) == tqmm._split_k(1, 4096, 4096, 64, 132)


def test_groupdot_only_on_the_plain_form():
    """The indexed forms take no groupdot, as in JAX."""
    import inspect
    for fn in (tqmm.qmatmul_pallas_indexed,
               tqmm.qmatmul_pallas_indexed_fused):
        assert "groupdot" not in inspect.signature(fn).parameters


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind,sdt", [("INT8", "float32"),
                                      ("INT8", "bfloat16"),
                                      ("INT4P", "float32"),
                                      ("INT4P", "bfloat16")])
@pytest.mark.parametrize("T,I,Oc,gs", [(1, 2048, 1000, 64),
                                       (48, 1024, 384, 32),
                                       (130, 4096, 4096, 128),
                                       (3, 192, 128, 16)])
@pytest.mark.parametrize("xdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_groupdot_kernel_vs_plain_on_card(cuda, kind, sdt, T, I, Oc, gs,
                                          xdt, splits):
    """A ragged O (the element path), group sizes 16 to 128, a split K
    that cuts a group (K1p: 32 packed rows a stage), a last stage cut
    short (I = 192 at gs 16), a prefill-sized T."""
    if kind == "INT4P" and (I // 2) % gs:
        pytest.skip("(I/2) % gs != 0 does not pack")
    rng = np.random.default_rng(T + I + Oc + gs)
    _, tw = _weight(rng, I, kind, sdt, gs=gs, O=Oc)
    tw = tw.to(cuda)
    x = torch.tensor(rng.standard_normal((T, I)).astype(np.float32),
                     device=cuda).to(getattr(torch, xdt))
    f = tqmm.qmatmul_pallas
    before = _counts()
    got = f(x, tw, groupdot=True, splits=splits)
    after = list(before)
    after[3 if kind == "INT4P" else 2] += 1
    assert _counts() == tuple(after)
    want = tqmm.qmm_groupdot_plain(x, tw)
    torch.cuda.synchronize()
    tol = 1e-4 if xdt == "float32" else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.gpu
def test_groupdot_kernel_refusals_and_wide_on_card(cuda):
    """gs = 8 raises on a CUDA tensor (never the plain version); the wide
    cases launch the standard kernel, counted as K1, bit for bit."""
    rng = np.random.default_rng(1)
    _, w8 = _weight(rng, 256, "INT8", gs=8)
    x = torch.randn((4, 256), device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        tqmm.qmatmul_pallas(x, w8.to(cuda), groupdot=True)
    for kind, cdt in (("INT16", torch.bfloat16), ("INT8", torch.float32)):
        _, w = _weight(rng, 256, kind)
        w = w.to(cuda)
        before = _counts()
        got = tqmm.qmatmul_pallas(x, w, cdt, groupdot=True)
        assert _counts() == (before[0] + 1,) + before[1:]
        assert torch.equal(got, tqmm.qmatmul_pallas(x, w, cdt))
