"""K2's non-fresh mode and the functions it serves: the port's plain
versions (what the wrappers run for CPU tensors) against the JAX Pallas
kernels in interpret mode on the same numpy inputs —
``flash_decode_batched`` without fresh rows, ``flash_decode_single``,
``decode_attention_pallas`` and ``decode_attention_pallas_indexed``
(rows [0, pos], f32 and bf16 caches).  Tolerance f32 2e-5 (another
summation order); bf16 caches are compared in f32 arithmetic, so the same.
Also ``update_kv_cache``.  The card-only test holds the CUDA kernel
against the plain version."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fastllama_tpu.ops import attention as jatt
from fastllama_tpu.ops.pallas import attention as jpatt
from fastllama_tpu.ops.pallas import flash_decode as jfd
from fastllama_tpu.quant.groupquant import quantize_rows as j_quantize_rows
from fastllama_tpu_torch.ops import attention as tatt
from fastllama_tpu_torch.ops.kernels import attention as tkatt
from fastllama_tpu_torch.ops.kernels import flash_decode as tfd


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast when the suite's
    workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(rtol=2e-5, atol=2e-5)
S, HS = 64, 32
POSITIONS = (0, 17, S - 1)


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _caches(rng, shape, cache_dt):
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    if cache_dt == "bfloat16":
        ck, cv = ck.astype(ml_dtypes.bfloat16), cv.astype(ml_dtypes.bfloat16)
    return ck, cv


@pytest.mark.parametrize("cache_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_kv,hgs", [(4, 1), (2, 4)])
def test_flash_non_fresh_vs_pallas(cache_dt, n_kv, hgs):
    """Batched, no fresh rows: slot b attends rows [0, pos[b]]."""
    B, L = 4, 2
    rng = np.random.default_rng(n_kv * 3 + hgs)
    q = rng.standard_normal((B, n_kv * hgs, 1, HS)).astype(np.float32)
    ck, cv = _caches(rng, (L, B, n_kv, S, HS), cache_dt)
    pos = np.array([0, 15, 16, S - 1], np.int32)    # block edges at 16
    for layer in (0, 1):
        want = jfd.flash_decode_batched(jnp.asarray(q), jnp.asarray(ck),
                                        jnp.asarray(cv), jnp.asarray(pos),
                                        layer, block_s=16, interpret=True)
        got = tfd.flash_decode_batched(_t(q), _t(ck), _t(cv), _t(pos), layer)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_non_fresh_int8_vs_pallas():
    """The int8 cache with row scales, non-fresh (the kernel takes it too)."""
    B, L, n_kv, hgs = 3, 1, 2, 2
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, n_kv * hgs, 1, HS)).astype(np.float32)
    ck, cv = _caches(rng, (L, B, n_kv, S, HS), "float32")
    jk, jks = j_quantize_rows(jnp.asarray(ck))
    jv, jvs = j_quantize_rows(jnp.asarray(cv))
    pos = np.array([0, 31, S - 1], np.int32)
    want = jfd.flash_decode_batched(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                                    0, block_s=16, interpret=True,
                                    k_scale=jks[..., 0], v_scale=jvs[..., 0])
    got = tfd.flash_decode_batched(_t(q), _t(jk), _t(jv), _t(pos), 0,
                                   _t(jks[..., 0]), _t(jvs[..., 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("cache_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", POSITIONS)
def test_single_and_indexed_vs_pallas(cache_dt, pos):
    """flash_decode_single and decode_attention_pallas_indexed on the
    stacked (L, n_kv, S, hs) cache; decode_attention_pallas on one layer."""
    L, n_kv, hgs = 3, 2, 4
    rng = np.random.default_rng(pos + 1)
    q = rng.standard_normal((n_kv * hgs, 1, HS)).astype(np.float32)
    ck, cv = _caches(rng, (L, n_kv, S, HS), cache_dt)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv)
    tq, tk, tv = _t(q), _t(ck), _t(cv)
    for layer in (0, 2):
        want = jfd.flash_decode_single(jq, jk, jv, pos, layer, block_s=16,
                                       interpret=True)
        np.testing.assert_allclose(
            tfd.flash_decode_single(tq, tk, tv, pos, layer).numpy(),
            np.asarray(want), **F32)
        want = jpatt.decode_attention_pallas_indexed(jq, jk, jv, pos, layer,
                                                     interpret=True)
        got = tkatt.decode_attention_pallas_indexed(
            tq, tk, tv, torch.tensor([pos], dtype=torch.int32), layer)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        want = jpatt.decode_attention_pallas(jq, jk[layer], jv[layer], pos,
                                             interpret=True)
        got = tkatt.decode_attention_pallas(tq, tk[layer], tv[layer], pos)
        assert got.shape == (n_kv * hgs, 1, HS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_stale_rows_masked():
    """Rows past pos never reach the result, whatever they hold."""
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.standard_normal((4, 1, 64)).astype(np.float32))
    kc = torch.tensor(rng.standard_normal((2, 32, 64)).astype(np.float32))
    vc = torch.tensor(rng.standard_normal((2, 32, 64)).astype(np.float32))
    pos = 5
    out1 = tkatt.decode_attention_pallas(q, kc, vc, pos)
    kc[:, pos + 1:] = 1e9
    vc[:, pos + 1:] = -1e9
    np.testing.assert_allclose(tkatt.decode_attention_pallas(q, kc, vc,
                                                             pos).numpy(),
                               out1.numpy(), rtol=1e-6, atol=1e-6)


def test_make_attn_hooks_match_jax():
    """make_attn / make_attn_indexed / make_attn_indexed_flash and their
    plain versions: the kernel for T = 1, the masked attention for a block
    of rows (the prefill fallback), as the JAX hooks."""
    rng = np.random.default_rng(2)
    L, n_kv, hgs = 2, 2, 2
    ck, cv = _caches(rng, (L, n_kv, S, HS), "float32")
    jk, jv, tk, tv = jnp.asarray(ck), jnp.asarray(cv), _t(ck), _t(cv)
    for T, pos in ((1, 9), (8, 20)):
        q = rng.standard_normal((n_kv * hgs, T, HS)).astype(np.float32)
        jq, tq = jnp.asarray(q), _t(q)
        tpos = torch.tensor([pos], dtype=torch.int32)
        want = jpatt.make_attn(interpret=True)(jq, jk[1], jv[1], pos)
        for make in (tkatt.make_attn, tkatt.make_attn_plain):
            np.testing.assert_allclose(
                make()(tq, tk[1], tv[1], tpos).numpy(), np.asarray(want),
                **F32)
        want = jpatt.make_attn_indexed(interpret=True)(jq, jk, jv, pos, 1)
        for make in (tkatt.make_attn_indexed, tfd.make_attn_indexed_flash,
                     tfd.make_attn_indexed_plain):
            np.testing.assert_allclose(
                make()(tq, tk, tv, tpos, 1).numpy(), np.asarray(want), **F32)


def test_update_kv_cache_matches_jax_and_refuses_overflow():
    rng = np.random.default_rng(3)
    kc = rng.standard_normal((2, 16, 8)).astype(np.float32)
    vc = rng.standard_normal((2, 16, 8)).astype(np.float32)
    kn = rng.standard_normal((2, 3, 8)).astype(np.float32)
    vn = rng.standard_normal((2, 3, 8)).astype(np.float32)
    jk, jv = jatt.update_kv_cache(jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(kn), jnp.asarray(vn), 13)
    tk, tv = _t(kc), _t(vc)
    rk, rv = tatt.update_kv_cache(tk, tv, _t(kn), _t(vn), 13)
    assert rk is tk and rv is tv                      # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError):                   # JAX would clamp to 13
        tatt.update_kv_cache(tk, tv, _t(kn), _t(vn), 14)


def test_non_fresh_rejects_bad_operands():
    q = torch.zeros(4, 1, 8)
    ck = torch.zeros(2, 2, 16, 8)
    with pytest.raises(ValueError):                   # hgs 3 is not served
        tkatt.decode_attention_pallas_indexed(torch.zeros(6, 1, 8), ck, ck,
                                              3, 0)
    with pytest.raises(ValueError):                   # layer out of range
        tfd.flash_decode_single(q, ck, ck, 3, 2)
    with pytest.raises(ValueError):                   # neither cpu nor cuda
        tkatt.decode_attention_pallas(q.to("meta"), ck[0].to("meta"),
                                      ck[0].to("meta"),
                                      torch.zeros(1, dtype=torch.int32,
                                                  device="meta"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_kv,hgs,hs", [(32, 1, 128), (4, 8, 64)])
def test_non_fresh_kernel_vs_plain_on_card(cuda, cache_dt, qdt, n_kv, hgs,
                                           hs):
    L, S2 = 2, 160
    rng = np.random.default_rng(hs + hgs)
    qt, ct = getattr(torch, qdt), getattr(torch, cache_dt)
    q = torch.tensor(rng.standard_normal((n_kv * hgs, 1, hs)).astype(
        np.float32), device=cuda).to(qt)
    ck = torch.tensor(rng.standard_normal((L, n_kv, S2, hs)).astype(
        np.float32), device=cuda).to(ct)
    cv = torch.tensor(rng.standard_normal((L, n_kv, S2, hs)).astype(
        np.float32), device=cuda).to(ct)
    tol = 1e-4 if qdt == "float32" else 1e-2
    for pos in (0, 1, 63, 64, S2 - 1):
        p = torch.tensor([pos], dtype=torch.int32, device=cuda)
        for fn, args, plain in (
                (tfd.flash_decode_single, (q, ck, cv, p, 1),
                 tfd.flash_decode_single_plain),
                (tkatt.decode_attention_pallas_indexed, (q, ck, cv, p, 1),
                 tfd.flash_decode_single_plain),
                (tkatt.decode_attention_pallas, (q, ck[1], cv[1], p),
                 tkatt.decode_attention_plain)):
            before = fn.launches
            got = fn(*args)
            assert fn.launches == before + 1
            want = plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * want.float().abs().max().item()
