"""K1, the group-dequant matmul: the port's plain version (what the kernel
wrapper runs for CPU tensors) against the JAX Pallas kernels in interpret
mode, called directly so the jnp fallback cannot stand in for them.
Tolerances: f32 2e-5; bf16 1e-2 of max|ref| (the two sides accumulate in
a different order before the bf16 output rounding).  The card-only test
holds the CUDA kernel against the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.ops.pallas.qmm import (qmatmul_pallas as j_qmm,
                                          qmatmul_pallas_indexed as j_qmm_idx)
from fastllama_tpu.quant import groupquant as jq
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.ops.kernels import qmm as tqmm
from fastllama_tpu_torch.quant import groupquant as tq


def _weights(rng, shape, qname, gs=64, scale_dtype=np.float32):
    """Random integer weights and random positive group scales, (…, I, O)
    with groups along I, as both frameworks' QArrays."""
    qt = jcfg.QuantType[qname]
    data = rng.integers(-qt.factor, qt.factor + 1, size=shape).astype(
        np.int16 if qname == "INT16" else np.int8)
    sshape = (*shape[:-2], shape[-2] // gs, shape[-1])
    scales = ((rng.random(sshape) + 0.5) * 0.02 / qt.factor).astype(
        np.float32)
    jw = jq.QArray(jnp.asarray(data), jnp.asarray(scales).astype(scale_dtype),
                   qt, gs, group_axis=-2)
    ts = torch.tensor(scales)
    if scale_dtype != np.float32:
        ts = ts.to(torch.bfloat16)
    tw = tq.QArray(torch.tensor(data), ts, tcfg.QuantType[qname], gs,
                   group_axis=-2)
    return jw, tw


CASES = [  # (qtype, compute dtype, x dtype, T, I, O)
    ("INT8", "float32", "float32", 4, 256, 256),
    ("INT8", "float32", "float32", 16, 512, 384),
    ("INT8", "bfloat16", "bfloat16", 4, 256, 512),
    ("INT8", "bfloat16", "bfloat16", 64, 512, 384),
    ("INT8", "bfloat16", "float32", 8, 256, 256),
    ("INT16", "float32", "float32", 4, 256, 256),
    ("INT16", "bfloat16", "bfloat16", 8, 512, 256),
]


def _check(got: torch.Tensor, want, cdt: str, xdt: str):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if xdt == "float32" and (cdt == "float32"):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-2 * np.abs(want).max())


@pytest.mark.parametrize("qname,cdt,xdt,T,I,O", CASES)
def test_qmm_plain_vs_pallas(qname, cdt, xdt, T, I, O):
    rng = np.random.default_rng(T * 7 + O)
    jw, tw = _weights(rng, (I, O), qname)
    x = rng.standard_normal((T, I)).astype(np.float32)
    want = j_qmm(jnp.asarray(x).astype(xdt), jw, jnp.dtype(cdt),
                 interpret=True)
    got = tqmm.qmatmul_pallas(torch.tensor(x).to(getattr(torch, xdt)), tw,
                              getattr(torch, cdt))
    assert got.dtype == getattr(torch, xdt)
    _check(got, want, cdt, xdt)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_qmm_bf16_scales(cdt):
    """compress_scales' bf16-stored scales."""
    import ml_dtypes
    rng = np.random.default_rng(11)
    jw, tw = _weights(rng, (256, 256), "INT8",
                      scale_dtype=ml_dtypes.bfloat16)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    want = j_qmm(jnp.asarray(x).astype(cdt), jw, jnp.dtype(cdt),
                 interpret=True)
    got = tqmm.qmatmul_pallas(torch.tensor(x).to(getattr(torch, cdt)), tw,
                              getattr(torch, cdt))
    _check(got, want, cdt, cdt)


@pytest.mark.parametrize("qname,cdt", [("INT8", "float32"),
                                       ("INT8", "bfloat16"),
                                       ("INT16", "float32")])
def test_qmm_indexed_plain_vs_pallas(qname, cdt):
    rng = np.random.default_rng(12)
    jw, tw = _weights(rng, (3, 512, 256), qname)
    x = rng.standard_normal((8, 512)).astype(np.float32)
    for layer in (0, 2):
        want = j_qmm_idx(jnp.asarray(x).astype(cdt), jw, layer,
                         jnp.dtype(cdt), interpret=True)
        got = tqmm.qmatmul_pallas_indexed(
            torch.tensor(x).to(getattr(torch, cdt)), tw, layer,
            getattr(torch, cdt))
        _check(got, want, cdt, cdt)


def test_qmm_rejects_bad_operands():
    rng = np.random.default_rng(13)
    _, tw = _weights(rng, (256, 128), "INT8")
    with pytest.raises(ValueError):
        tqmm.qmatmul_pallas(torch.zeros(4, 128), tw)          # I mismatch
    with pytest.raises(ValueError):
        tqmm.qmatmul_pallas(torch.zeros(256, 4).t(), tw)      # not contiguous
    # a packed INT4 weight of the same bytes now computes: (128, 128)
    # packed rows are 256 logical ones
    w4 = tq.QArray(tw.data[:128], tw.scales[:4], tcfg.QuantType.INT4, 64,
                   -2, packed=True)
    out = tqmm.qmatmul_pallas(torch.ones(4, 256), w4)
    assert out.shape == (4, 128) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError):
        tqmm.qmatmul_pallas(torch.zeros(4, 128), w4)          # I mismatch


def test_split_k_covers_the_contraction():
    for T, I, O in ((1, 4096, 4096), (48, 11008, 4096), (2048, 4096, 22016),
                    (48, 4096, 32000), (3, 256, 1000)):
        splits, kps = tqmm._split_k(T, I, O, 32, 132)
        assert kps % 32 == 0 or splits == 1
        assert (splits - 1) * kps < I <= splits * kps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("qname,cdt,xdt", [
    ("INT8", "bfloat16", "bfloat16"), ("INT8", "float32", "float32"),
    ("INT16", "float32", "float32"), ("INT8", "bfloat16", "float32")])
@pytest.mark.parametrize("T,I,O", [(1, 256, 1000), (48, 512, 384),
                                   (130, 4096, 4096)])
def test_qmm_kernel_vs_plain_on_card(cuda, qname, cdt, xdt, T, I, O):
    rng = np.random.default_rng(T + I + O)
    _, tw = _weights(rng, (2, I, O), qname)
    tw = tw.to(cuda)
    x = torch.tensor(rng.standard_normal((T, I)).astype(np.float32),
                     device=cuda).to(getattr(torch, xdt))
    cd = getattr(torch, cdt)
    before = tqmm.qmatmul_pallas_indexed.launches
    got = tqmm.qmatmul_pallas_indexed(x, tw, 1, cd)
    assert tqmm.qmatmul_pallas_indexed.launches == before + 1
    want = tqmm.qmm_plain(x, tw[1], cd)
    torch.cuda.synchronize()
    tol = 1e-4 if xdt == "float32" and tqmm.is_wide(tw, cd) else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()
