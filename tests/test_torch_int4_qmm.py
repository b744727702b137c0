"""Packed INT4, the quantization layer and K1p: the port's split-half
packing, ``dequantize``, ``pack_supported`` and ``random_params_int``
flags bit for bit against the JAX package's; K1p's plain version (what the
wrappers run for CPU tensors) against the JAX Pallas packed kernels in
interpret mode.  Tolerances: 1e-5 of max|ref| at f32 output, 1e-2 at bf16
(the two sides sum the half-K planes in another order before the output
rounding).  The card-only test holds the CUDA kernel against the plain
version."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.models import llama as jl
from fastllama_tpu.ops.norms import rmsnorm as j_rmsnorm
from fastllama_tpu.ops.pallas import qmm as jqmm
from fastllama_tpu.quant import groupquant as jq
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.ops.kernels import qmm as tqmm
from fastllama_tpu_torch.ops.qmatmul import qmatmul, qmatmul_parity
from fastllama_tpu_torch.quant import groupquant as tq


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast when the suite's
    workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int4(rng, shape):
    return rng.integers(-8, 8, size=shape).astype(np.int8)


def _packed(rng, shape, scale_dtype="float32", gs=64):
    """A random (…, I, O) INT4 weight, packed, as both frameworks' QArrays
    (random positive group scales, f32 or bf16)."""
    data = jq.pack_int4_rows_np(_int4(rng, shape))
    sshape = (*shape[:-2], shape[-2] // gs, shape[-1])
    scales = ((rng.random(sshape) + 0.5) * 0.02 / 7).astype(np.float32)
    if scale_dtype == "bfloat16":
        scales = scales.astype(ml_dtypes.bfloat16).astype(np.float32)
    jw = jq.QArray(jnp.asarray(data), jnp.asarray(scales).astype(scale_dtype),
                   jcfg.QuantType.INT4, gs, group_axis=-2, packed=True)
    tw = tq.QArray(torch.tensor(data),
                   torch.tensor(scales).to(getattr(torch, scale_dtype)),
                   tcfg.QuantType.INT4, gs, group_axis=-2, packed=True)
    return jw, tw


def _close(got: torch.Tensor, want, xdt: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = 1e-5 if xdt == "float32" else 1e-2
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# -- (a) the layout, bit for bit --------------------------------------------

@pytest.mark.parametrize("shape", [(2, 6), (64, 5), (3, 128, 256)])
def test_pack_unpack_bit_exact(shape):
    q = _int4(np.random.default_rng(len(shape)), shape)
    want = jq.pack_int4_rows_np(q)
    assert np.array_equal(tq.pack_int4_rows(torch.tensor(q)).numpy(), want)
    got = tq.unpack_int4_rows(torch.tensor(want)).numpy()
    assert np.array_equal(got, np.asarray(jq.unpack_int4_rows(
        jnp.asarray(want))))
    assert np.array_equal(got, jq.unpack_int4_rows_np(want))
    assert np.array_equal(got, q)


@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
def test_dequantize_packed_bit_exact(sdt):
    jw, tw = _packed(np.random.default_rng(1), (2, 256, 384), sdt)
    u = tw.unpacked()
    assert u.data.shape == (2, 256, 384) and not u.packed
    assert u.unpacked() is u
    for dt in ("float32", "bfloat16"):
        want = np.asarray(jq.dequantize(jw, jnp.dtype(dt)).astype(jnp.float32))
        got = tq.dequantize(tw, getattr(torch, dt)).float().numpy()
        assert np.array_equal(got, want), dt


def test_pack_supported_matches_jax():
    Is = [64, 128, 512, 1000, 1024, 1536, 2048, 3072, 4096, 8192, 11008,
          11264, 14336]
    Os = [64, 100, 128, 192, 384, 640, 1000, 1024, 4096, 11008, 12288,
          32000]
    for gs in (32, 64, 128):
        for I in Is:
            for O in Os:
                assert tq.pack_supported(I, O, gs) == \
                    jqmm.pack_supported(I, O, gs), (I, O, gs)
    assert tq.pack_supported(11264, 4096, 64)
    assert not tq.pack_supported(11008, 4096, 64)


@pytest.mark.parametrize("hidden,n_kv,hs", [(1024, 4, 128), (1536, 8, 128),
                                            (1024, 1, 64)])
def test_random_params_int_packs_like_jax(hidden, n_kv, hs):
    """Which projections pack, their shapes and dtypes: the port's
    ``random_params_int`` against the JAX package's at INT4."""
    kw = dict(dim=1024, hidden_dim=hidden, n_layers=2, n_heads=1024 // hs,
              n_kv_heads=n_kv, vocab_size=512, max_seq_len=64)
    jp = jl.random_params_int(jcfg.ModelConfig(
        **kw, quant_type=jcfg.QuantType.INT4), seed=0)
    tp = tl.random_params_int(tcfg.ModelConfig(
        **kw, quant_type=tcfg.QuantType.INT4), seed=0, device="cpu")
    for name, tw in tp.quantized().items():
        jw = getattr(jp, name)
        assert tw.packed == jw.packed, name
        assert tuple(tw.data.shape) == tuple(jw.data.shape), name
        assert tuple(tw.scales.shape) == tuple(jw.scales.shape), name
        assert tw.data.dtype == torch.int8 and tw.qtype == tcfg.QuantType.INT4
        vals = tw.unpacked().data
        assert int(vals.min()) >= -7 and int(vals.max()) <= 7, name
    assert tp.wq.packed and (tp.w2.packed == (hidden % 1024 == 0))
    assert tp.wk.packed == (n_kv * hs % 128 == 0)


# -- (b) K1p's plain version and the wrappers against the Pallas kernels ----

@pytest.mark.parametrize("T", [1, 8, 48])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
def test_qmm_p4_vs_pallas(T, xdt, sdt):
    rng = np.random.default_rng(T * 3 + len(xdt) + len(sdt))
    jw, tw = _packed(rng, (1024, 256), sdt)
    x = rng.standard_normal((T, 1024)).astype(np.float32)
    want = jqmm.qmatmul_pallas(jnp.asarray(x).astype(xdt), jw,
                               interpret=True)
    tx = torch.tensor(x).to(getattr(torch, xdt))
    # no wide path: the compute dtype does not change K1p's arithmetic
    for cdt in (torch.bfloat16, torch.float32):
        got = tqmm.qmatmul_pallas(tx, tw, cdt)
        assert got.dtype == tx.dtype
        _close(got, want, xdt)
        assert torch.equal(got, tqmm.qmm_p4_plain(tx, tw, cdt))


@pytest.mark.parametrize("xdt,sdt", [("float32", "float32"),
                                     ("bfloat16", "float32"),
                                     ("float32", "bfloat16")])
def test_qmm_p4_indexed_vs_pallas(xdt, sdt):
    rng = np.random.default_rng(5 + len(xdt) + len(sdt))
    jw, tw = _packed(rng, (3, 2048, 384), sdt)
    x = rng.standard_normal((48, 2048)).astype(np.float32)
    for layer in (0, 2):
        want = jqmm.qmatmul_pallas_indexed(jnp.asarray(x).astype(xdt), jw,
                                           layer, interpret=True)
        got = tqmm.qmatmul_pallas_indexed(
            torch.tensor(x).to(getattr(torch, xdt)), tw, layer)
        _close(got, want, xdt)


def test_qmatmul_plain_paths_on_packed_weights():
    """The jnp fallback ``qmatmul`` and ``qmatmul_parity`` unpack first, as
    the JAX package's do."""
    from fastllama_tpu.ops.qmatmul import qmatmul as j_qmatmul
    from fastllama_tpu.ops.qmatmul import qmatmul_parity as j_parity
    rng = np.random.default_rng(8)
    jw, tw = _packed(rng, (512, 256))
    x = rng.standard_normal((4, 512)).astype(np.float32)
    np.testing.assert_allclose(
        qmatmul(torch.tensor(x), tw).numpy(),
        np.asarray(j_qmatmul(jnp.asarray(x), jw)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        qmatmul_parity(torch.tensor(x), tw).numpy(),
        np.asarray(j_parity(jnp.asarray(x), jw)), rtol=2e-5, atol=2e-6)


# -- (c) the reference fault: the JAX packed indexed kernel drops residual --

def test_reference_drops_the_residual_the_port_adds_it():
    """``qmatmul_pallas_indexed`` on a packed weight never reads
    ``residual`` (qmm.py:571-612): its output with ``r`` equals its output
    without.  The port's equals the JAX call without ``r``, plus ``r``; the
    norm, which JAX applies outside its kernel, the port fuses."""
    rng = np.random.default_rng(9)
    jw, tw = _packed(rng, (2, 1024, 256))
    x = rng.standard_normal((8, 1024)).astype(np.float32)
    r = (rng.standard_normal((8, 256)) * 100).astype(np.float32)
    g = (rng.random(1024) + 0.5).astype(np.float32)
    jx = jnp.asarray(x)
    bare = np.asarray(jqmm.qmatmul_pallas_indexed(jx, jw, 1, interpret=True))
    dropped = np.asarray(jqmm.qmatmul_pallas_indexed(
        jx, jw, 1, interpret=True, residual=jnp.asarray(r)))
    assert np.array_equal(dropped, bare)           # the fault, pinned
    got = tqmm.qmatmul_pallas_indexed(torch.tensor(x), tw, 1,
                                      residual=torch.tensor(r))
    np.testing.assert_allclose(got.numpy(), bare + r, rtol=0,
                               atol=1e-5 * np.abs(bare + r).max())
    # norm and residual together: JAX's norm outside, plus r outside
    want = np.asarray(jqmm.qmatmul_pallas_indexed(
        jnp.asarray(j_rmsnorm(jx, jnp.asarray(g), 1e-5)), jw, 1,
        interpret=True)) + r
    got = tqmm.qmatmul_pallas_indexed(torch.tensor(x), tw, 1,
                                      norm_gain=torch.tensor(g),
                                      residual=torch.tensor(r))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_p4_wrappers_check_their_operands():
    rng = np.random.default_rng(10)
    _, tw = _packed(rng, (2, 512, 128))
    x = torch.zeros(4, 512)
    with pytest.raises(ValueError):
        tqmm.qmatmul_pallas(torch.zeros(4, 256), tw[0])        # I mismatch
    with pytest.raises(ValueError):
        tqmm.qmm_p4_plain(x, tw[0].unpacked())                 # not packed
    with pytest.raises(IndexError):
        tqmm.qmatmul_pallas_indexed(x, tw, 2)
    with pytest.raises(ValueError):
        tqmm.qmatmul_pallas_indexed(x, tw, 0, residual=torch.zeros(4, 64))
    odd = tq.QArray(tw.data[0, :96], tw.scales[0, :3], tcfg.QuantType.INT4,
                    64, -2, packed=True)                    # (I/2) % gs != 0
    with pytest.raises(ValueError):
        tqmm.qmatmul_pallas(torch.zeros(4, 192), odd)
    assert not tqmm.is_wide(tw, torch.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("xdt,sdt", [("bfloat16", "float32"),
                                     ("float32", "float32"),
                                     ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("T,I,O", [(1, 2048, 1000), (48, 1024, 384),
                                   (130, 4096, 4096), (3, 96, 128)])
@pytest.mark.parametrize("glue", ["none", "norm", "residual"])
def test_qmm_p4_kernel_vs_plain_on_card(cuda, xdt, sdt, T, I, O, glue):
    """K1p on layer 1 of a packed (2, I/2, O) weight: a ragged O (the
    element path), a split K, a prefill-sized T, and a last stage cut
    short (I/2 = 48, gs 16), with each glue operand."""
    rng = np.random.default_rng(T + I + O)
    _, tw = _packed(rng, (2, I, O), sdt, gs=16 if I == 96 else 64)
    tw = tw.to(cuda)
    xd = getattr(torch, xdt)
    x = torch.tensor(rng.standard_normal((T, I)).astype(np.float32),
                     device=cuda).to(xd)
    kw = {}
    if glue == "norm":
        kw["norm_gain"] = torch.rand(I, device=cuda) + 0.5
    elif glue == "residual":
        kw["residual"] = torch.randn((T, O), device=cuda).to(xd)
    counter = (tqmm.qmatmul_pallas_indexed if glue == "none"
               else tqmm.qmatmul_pallas_indexed_fused)
    before = counter.launches, counter.launches_p4
    got = tqmm.qmatmul_pallas_indexed(x, tw, 1, torch.bfloat16, **kw)
    assert (counter.launches, counter.launches_p4) == (before[0],
                                                       before[1] + 1)
    want = tqmm.qmm_p4_plain(x, tw[1], torch.bfloat16, **kw)
    torch.cuda.synchronize()
    # the prologue's normalized row is rounded to bf16 for the tensor cores
    # (no wide path): a one-ulp difference in the row's f32 inverse RMS
    # (another summation order) flips some of those roundings, by at most
    # 1.3e-4 of max|ref| on the card, so f32 x with the norm is held to 1e-3
    tol = {("float32", False): 1e-4, ("float32", True): 1e-3}.get(
        (xdt, glue == "norm"), 1e-2)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()
