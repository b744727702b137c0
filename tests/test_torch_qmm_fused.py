"""K1f, the group-dequant matmul with the rmsnorm prologue and the residual
epilogue: the port's plain version (what the wrapper runs for CPU tensors)
against the JAX ``qmatmul_pallas_indexed(..., norm_gain=, residual=)`` in
interpret mode, at shapes where the JAX package fuses (its TPU tiling takes
the whole contraction in one block, so the norm runs inside its kernel).
Tolerances: f32 2e-5; bf16 1e-2 of max|ref| (another summation order before
the bf16 output rounding).  The card-only test holds the CUDA kernel
against the plain version."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fastllama_tpu.ops.pallas.qmm import (make_mm_indexed as j_make_mm_idx,
                                          qmatmul_pallas_indexed as j_qmm_idx)
from fastllama_tpu_torch.ops.kernels import qmm as tqmm
from tests.test_torch_qmm import _check, _weights


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast when the suite's
    workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (T, I, O): I = 256, 512 and 768 take one full-K block in the JAX tiling
SHAPES = [(1, 768, 256), (4, 512, 384), (16, 256, 512)]
GLUE = [(True, False), (False, True), (True, True)]


def _operands(rng, T, I, O, xdt):
    x = rng.standard_normal((T, I)).astype(np.float32)
    g = (rng.standard_normal(I) * 0.1 + 1.0).astype(np.float32)
    r = rng.standard_normal((T, O)).astype(np.float32)
    tx = torch.tensor(x).to(getattr(torch, xdt))
    tr = torch.tensor(r).to(getattr(torch, xdt))
    return (jnp.asarray(x).astype(xdt), jnp.asarray(g),
            jnp.asarray(r).astype(xdt), tx, torch.tensor(g), tr)


@pytest.mark.parametrize("norm,res", GLUE)
@pytest.mark.parametrize("cdt,scale_dt", [("float32", np.float32),
                                          ("bfloat16", np.float32),
                                          ("bfloat16", ml_dtypes.bfloat16),
                                          ("float32", ml_dtypes.bfloat16)])
@pytest.mark.parametrize("T,I,O", SHAPES)
def test_fused_plain_vs_pallas(T, I, O, cdt, scale_dt, norm, res):
    rng = np.random.default_rng(T * 31 + I + O)
    jw, tw = _weights(rng, (3, I, O), "INT8", scale_dtype=scale_dt)
    jx, jg, jr, tx, tg, tr = _operands(rng, T, I, O, cdt)
    for layer in (0, 2):
        want = j_qmm_idx(jx, jw, layer, jnp.dtype(cdt), interpret=True,
                         norm_gain=jg if norm else None, eps=1e-5,
                         residual=jr if res else None)
        got = tqmm.qmatmul_pallas_indexed(
            tx, tw, layer, getattr(torch, cdt),
            norm_gain=tg if norm else None, eps=1e-5,
            residual=tr if res else None)
        assert got.dtype == tx.dtype and got.shape == (T, O)
        _check(got, want, cdt, cdt)


def test_fused_norm_rounds_once():
    """The prologue rounds x*r*gain once; ops.norms.rmsnorm rounds x*r
    first.  At bf16 the two differ on some elements, and the plain version
    follows the kernel, not rmsnorm."""
    from fastllama_tpu_torch.ops.norms import rmsnorm
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((4, 512)).astype(np.float32)).to(
        torch.bfloat16)
    g = torch.tensor((rng.standard_normal(512) * 0.3 + 1.0).astype(
        np.float32))
    xf = x.float()
    once = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5)
            * g).to(torch.bfloat16)
    assert not torch.equal(once, rmsnorm(x, g, 1e-5))
    _, tw = _weights(rng, (1, 512, 128), "INT8")
    got = tqmm.qmm_fused_plain(x, tw[0], torch.bfloat16, g, 1e-5)
    assert torch.equal(got, tqmm.qmm_plain(once, tw[0], torch.bfloat16))


def test_make_mm_indexed_fusion_and_plain_weights():
    """mm_idx advertises fusion; a plain (unquantized) stacked weight takes
    the separate-ops glue, as the JAX fallback does."""
    rng = np.random.default_rng(4)
    assert tqmm.make_mm_indexed().supports_fusion
    assert tqmm.make_mm_indexed_plain().supports_fusion
    w = rng.standard_normal((2, 256, 128)).astype(np.float32) * 0.05
    x = rng.standard_normal((3, 256)).astype(np.float32)
    g = (rng.standard_normal(256) * 0.1 + 1.0).astype(np.float32)
    r = rng.standard_normal((3, 128)).astype(np.float32)
    want = j_make_mm_idx(jnp.float32, interpret=True)(
        jnp.asarray(x), jnp.asarray(w), 1, norm_gain=jnp.asarray(g),
        residual=jnp.asarray(r))
    for make in (tqmm.make_mm_indexed, tqmm.make_mm_indexed_plain):
        got = make(torch.float32)(torch.tensor(x), torch.tensor(w), 1,
                                  norm_gain=torch.tensor(g),
                                  residual=torch.tensor(r))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_fused_rejects_bad_operands():
    rng = np.random.default_rng(5)
    _, tw = _weights(rng, (2, 256, 128), "INT8")
    x = torch.zeros(4, 256)
    with pytest.raises(ValueError):
        tqmm.qmatmul_pallas_indexed(x, tw, 0, norm_gain=torch.ones(128))
    with pytest.raises(ValueError):
        tqmm.qmatmul_pallas_indexed(x, tw, 0, residual=torch.zeros(4, 64))
    with pytest.raises(ValueError):
        tqmm.qmatmul_pallas_indexed(
            x, tw, 0, residual=torch.zeros(4, 128, dtype=torch.bfloat16))
    with pytest.raises(IndexError):
        tqmm.qmatmul_pallas_indexed(x, tw, 2, norm_gain=torch.ones(256))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("norm,res", GLUE)
@pytest.mark.parametrize("qname,cdt,scale_dt", [
    ("INT8", "bfloat16", ml_dtypes.bfloat16), ("INT8", "bfloat16", np.float32),
    ("INT8", "float32", np.float32), ("INT16", "float32", np.float32)])
@pytest.mark.parametrize("T,I,O", [(1, 4096, 4096), (1, 11008, 1024),
                                   (64, 4096, 4096), (3, 264, 1000)])
def test_fused_kernel_vs_plain_on_card(cuda, T, I, O, qname, cdt, scale_dt,
                                       norm, res):
    """Split K (T=1), one pass (T=64) and the element-by-element staging
    (unaligned shapes)."""
    rng = np.random.default_rng(T + I + O)
    _, tw = _weights(rng, (2, I, O), qname, gs=8 if I == 264 else 64,
                     scale_dtype=scale_dt)
    tw = tw.to(cuda)
    cd = getattr(torch, cdt)
    x = torch.tensor(rng.standard_normal((T, I)).astype(np.float32),
                     device=cuda).to(cd)
    g = torch.tensor((rng.standard_normal(I) * 0.1 + 1.0).astype(np.float32),
                     device=cuda)
    r = torch.tensor(rng.standard_normal((T, O)).astype(np.float32),
                     device=cuda).to(cd)
    kw = dict(norm_gain=g if norm else None, eps=1e-5,
              residual=r if res else None)
    before = tqmm.qmatmul_pallas_indexed_fused.launches
    got = tqmm.qmatmul_pallas_indexed(x, tw, 1, cd, **kw)
    assert tqmm.qmatmul_pallas_indexed_fused.launches == before + 1
    want = tqmm.qmm_fused_plain(x, tw[1], cd, kw["norm_gain"], 1e-5,
                                kw["residual"])
    torch.cuda.synchronize()
    tol = 1e-4 if cdt == "float32" else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()
