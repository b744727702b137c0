"""K2, bounded flash-decode attention: the port's plain version (what the
kernel wrapper runs for CPU tensors) against the JAX Pallas kernel
``flash_decode_batched`` in interpret mode with fresh rows, on the same
numpy inputs.  Tolerance f32 2e-5 (the two sides sum in another order).
The card-only test holds the CUDA kernel against the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu.ops.pallas.flash_decode import \
    flash_decode_batched as j_flash
from fastllama_tpu.quant.groupquant import quantize_rows as j_quantize_rows
from fastllama_tpu_torch.ops.kernels import flash_decode as tfd

F32 = dict(rtol=2e-5, atol=2e-5)
BLOCK = 16           # the Pallas kernel's cache block: pos 16 and 32 are edges


def _inputs(seed, B, L, n_kv, hgs, S, hs):
    rng = np.random.default_rng(seed)
    H = n_kv * hgs
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, H, 1, hs), f(L, B, n_kv, S, hs), f(L, B, n_kv, S, hs),
            f(B, n_kv, hs), f(B, n_kv, hs))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("n_kv,hgs", [(4, 1), (2, 2)])
def test_flash_plain_vs_pallas(quant, n_kv, hgs):
    B, L, S, hs = 6, 2, 64, 32
    q, ck, cv, kn, vn = _inputs(n_kv * 10 + hgs, B, L, n_kv, hgs, S, hs)
    # idle slot, one row, block edges on both sides, the last row
    pos = np.array([0, 1, BLOCK - 1, BLOCK, 2 * BLOCK, S - 1], np.int32)
    if quant:
        jk, jks = j_quantize_rows(jnp.asarray(ck))
        jv, jvs = j_quantize_rows(jnp.asarray(cv))
        jks, jvs = jks[..., 0], jvs[..., 0]
    else:
        jk, jv, jks, jvs = jnp.asarray(ck), jnp.asarray(cv), None, None
    for layer in (0, 1):
        want = j_flash(jnp.asarray(q), jk, jv, jnp.asarray(pos), layer,
                       block_s=BLOCK, interpret=True, k_scale=jks,
                       v_scale=jvs, k_new=jnp.asarray(kn),
                       v_new=jnp.asarray(vn))
        got = tfd.flash_decode_batched(
            _t(q), _t(jk), _t(jv), _t(pos), layer,
            None if jks is None else _t(jks),
            None if jvs is None else _t(jvs), _t(kn), _t(vn))
        assert got.shape == (B, n_kv * hgs, 1, hs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        # the parked slot (pos 0) is exactly its fresh value row
        np.testing.assert_array_equal(
            got[0, :, 0].numpy(), np.repeat(vn[0], hgs, axis=0))


def test_flash_rejects_bad_operands():
    q, ck, cv, kn, vn = map(_t, _inputs(0, 2, 1, 2, 2, 16, 8))
    pos = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError):                           # half a pair
        tfd.flash_decode_batched(q, ck, cv, pos, 0, k_new=kn)
    with pytest.raises(ValueError):
        tfd.flash_decode_batched(q, ck, cv, pos.long(), 0, k_new=kn,
                                 v_new=vn)                    # pos not int32
    with pytest.raises(ValueError):                           # int8, no scales
        tfd.flash_decode_batched(q, ck.to(torch.int8), cv.to(torch.int8),
                                 pos, 0, k_new=kn, v_new=vn)
    with pytest.raises(ValueError):                           # not cpu/cuda
        tfd.flash_decode_batched(q.to("meta"), ck.to("meta"), cv.to("meta"),
                                 pos.to("meta"), 0, k_new=kn.to("meta"),
                                 v_new=vn.to("meta"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dt", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_kv,hgs,hs", [(8, 1, 128), (4, 2, 64),
                                         (2, 8, 64)])
def test_flash_kernel_vs_plain_on_card(cuda, cache_dt, qdt, n_kv, hgs, hs):
    B, L, S = 8, 2, 160
    q, ck, cv, kn, vn = _inputs(hs + hgs, B, L, n_kv, hgs, S, hs)
    pos = torch.tensor([0, 1, 63, 64, 65, 127, 128, S - 1],
                       dtype=torch.int32, device=cuda)
    qt = getattr(torch, qdt)
    q, kn, vn = (_t(a).to(cuda, qt) for a in (q, kn, vn))
    ck, cv = _t(ck).to(cuda), _t(cv).to(cuda)
    if cache_dt == "int8":
        from fastllama_tpu_torch.quant.groupquant import quantize_rows
        (ck, ks), (cv, vs) = quantize_rows(ck), quantize_rows(cv)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    else:
        ck, cv = ck.to(getattr(torch, cache_dt)), cv.to(getattr(torch,
                                                               cache_dt))
        ks = vs = None
    before = tfd.flash_decode_batched.launches
    got = tfd.flash_decode_batched(q, ck, cv, pos, 1, ks, vs, kn, vn)
    assert tfd.flash_decode_batched.launches == before + 1
    want = tfd.flash_decode_plain(q, ck, cv, pos, 1, ks, vs, kn, vn)
    torch.cuda.synchronize()
    tol = 1e-4 if qdt == "float32" else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()
    assert torch.equal(got[0, :, 0].float(),
                       vn[0].float().repeat_interleave(hgs, dim=0))
