"""The batched speculative verify's kernels and reference attention: the
port's plain versions (what the wrappers run for CPU tensors) against the
JAX functions on the same numpy inputs.

* ``gqa_attention_spec_batched`` against JAX's jnp function, f32 2e-5;
* K2s's plain version ``flash_spec_plain`` against the Pallas
  ``flash_spec_batched`` in interpret mode, f32 2e-5 (the two sum in
  another order), with scales far from 1 and the exact diagonal;
* ``spec_write_plain`` against the Pallas ``spec_write`` in interpret
  mode, whole caches bit-equal;
* ``decode_attention_pallas_batched`` (on K2 non-fresh) against its Pallas
  kernel in interpret mode.

The card-only tests hold each CUDA kernel against its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu.models.batched import BatchedKVCache as JCache
from fastllama_tpu.ops import attention as jatt
from fastllama_tpu.ops.pallas import attention as jpa
from fastllama_tpu.ops.pallas import kv_write as jkw
from fastllama_tpu.ops.pallas.flash_decode import \
    flash_spec_batched as j_flash_spec
from fastllama_tpu.quant.groupquant import quantize_rows as j_quantize_rows
from fastllama_tpu_torch.models.batched import BatchedKVCache as TCache
from fastllama_tpu_torch.ops import attention as tatt
from fastllama_tpu_torch.ops.kernels import attention as tka
from fastllama_tpu_torch.ops.kernels import flash_decode as tfd
from fastllama_tpu_torch.ops.kernels import kv_write as tkw


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast when the suite's
    workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(rtol=2e-5, atol=2e-5)
BLOCK = 16          # the Pallas kernel's cache block: pos 16 and 32 are edges


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _spec_inputs(seed, B, L, n_kv, hgs, S, T, hs, quant):
    """q, a cache (int8 with row scales far from 1, or f32), fresh rows
    and exact diagonal rows, all from one seed."""
    rng = np.random.default_rng(seed)
    H = n_kv * hgs
    q = _normal(rng, B, H, T, hs)
    ck, cv = (_normal(rng, L, B, n_kv, S, hs, scale=3.0) for _ in range(2))
    kn, vn, ke, ve = (_normal(rng, B, n_kv, T, hs, scale=2.0)
                      for _ in range(4))
    if quant:
        (ck, ks), (cv, vs) = (j_quantize_rows(jnp.asarray(c))
                              for c in (ck, cv))
        ks, vs = ks[..., 0], vs[..., 0]
    else:
        ks = vs = None
    return q, ck, cv, ks, vs, kn, vn, ke, ve


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("n_kv,hgs,T", [(4, 1, 4), (2, 2, 4), (4, 2, 2)])
def test_flash_spec_plain_vs_pallas(quant, n_kv, hgs, T):
    """pos 0 (an idle slot: no cache row), one row, block edges, and the
    last full block S - T; the exact diagonal given with the int8 cache."""
    B, L, S, hs = 6, 2, 64, 32
    q, ck, cv, ks, vs, kn, vn, ke, ve = _spec_inputs(
        10 * n_kv + hgs + T, B, L, n_kv, hgs, S, T, hs, quant)
    pos = np.array([0, 1, BLOCK - 1, BLOCK, 2 * BLOCK + 3, S - T], np.int32)
    if not quant:
        ke = ve = None
    for layer in (0, 1):
        want = j_flash_spec(_j(q), _j(ck), _j(cv), _j(pos), layer,
                            block_s=BLOCK, interpret=True, k_scale=_j(ks),
                            v_scale=_j(vs), k_new=_j(kn), v_new=_j(vn),
                            k_self=_j(ke), v_self=_j(ve))
        got = tfd.flash_spec_batched(
            _t(q), _t(ck), _t(cv), _t(pos), layer, _t(ks), _t(vs), _t(kn),
            _t(vn), _t(ke), _t(ve))
        assert got.shape == (B, n_kv * hgs, T, hs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_attention_spec_batched_vs_jax(exact, dtype):
    B, n_kv, hgs, S, T, hs = 3, 4, 2, 48, 4, 16
    q, ck, cv, _, _, kn, vn, ke, ve = _spec_inputs(
        7, B, 1, n_kv, hgs, S, T, hs, False)
    pos = np.array([0, 17, S - T], np.int32)
    if not exact:
        ke = ve = None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    args = (q, ck[0], cv[0], kn, vn)
    want = jatt.gqa_attention_spec_batched(
        *(_j(a).astype(jd) for a in args), _j(pos),
        k_self=None if ke is None else _j(ke).astype(jd),
        v_self=None if ve is None else _j(ve).astype(jd))
    got = tatt.gqa_attention_spec_batched(
        *(_t(a).to(td) for a in args), _t(pos),
        k_self=None if ke is None else _t(ke).to(td),
        v_self=None if ve is None else _t(ve).to(td))
    assert got.dtype == td
    tol = F32 if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_flash_spec_plain_is_the_reference_on_f32_caches():
    """On an f32 cache the K2s arithmetic and the jnp verify attention are
    the same function: the plain version agrees with both."""
    B, n_kv, hgs, S, T, hs = 4, 2, 2, 40, 3, 16
    q, ck, cv, _, _, kn, vn, ke, ve = _spec_inputs(
        3, B, 2, n_kv, hgs, S, T, hs, False)
    pos = torch.tensor([0, 5, 20, S - T], dtype=torch.int32)
    got = tfd.flash_spec_plain(_t(q), _t(ck), _t(cv), pos, 1, k_new=_t(kn),
                               v_new=_t(vn), k_self=_t(ke), v_self=_t(ve))
    want = tatt.gqa_attention_spec_batched(
        _t(q), _t(ck)[1], _t(cv)[1], _t(kn), _t(vn), pos, k_self=_t(ke),
        v_self=_t(ve))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


def test_flash_spec_rejects_bad_operands():
    q, ck, cv, _, _, kn, vn, ke, _ = map(_t, _spec_inputs(
        0, 2, 1, 2, 2, 16, 4, 8, False))
    pos = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError):                        # no fresh rows
        tfd.flash_spec_batched(q, ck, cv, pos, 0)
    with pytest.raises(ValueError):                        # half a pair
        tfd.flash_spec_batched(q, ck, cv, pos, 0, k_new=kn, v_new=vn,
                               k_self=ke)
    with pytest.raises(ValueError):                        # pos not int32
        tfd.flash_spec_batched(q, ck, cv, pos.long(), 0, k_new=kn, v_new=vn)
    with pytest.raises(ValueError):                        # > 64 query rows
        tfd.flash_spec_batched(q.repeat(1, 1, 20, 1), ck, cv, pos, 0,
                               k_new=kn.repeat(1, 1, 20, 1),
                               v_new=vn.repeat(1, 1, 20, 1))
    with pytest.raises(ValueError):                        # not cpu/cuda
        tfd.flash_spec_batched(*(t.to("meta") for t in (q, ck, cv, pos)), 0,
                               k_new=kn.to("meta"), v_new=vn.to("meta"))


L, B, N_KV, S, HS = 2, 4, 2, 64, 32


def _caches(rng, quant):
    """The same random (not zero) cache for both sides, so rows the writer
    must leave alone are checked too."""
    def rows(*shape):
        if quant:
            return rng.integers(-127, 128, size=shape).astype(np.int8)
        return rng.standard_normal(shape).astype(np.float32)
    arrs = (rows(L, B, N_KV, S, HS), rows(L, B, N_KV, S, HS),
            rng.random((L, B, N_KV, S)).astype(np.float32) if quant else None,
            rng.random((L, B, N_KV, S)).astype(np.float32) if quant else None)
    return JCache(*map(_j, arrs)), TCache(*map(_t, arrs)), rows


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("D", [2, 3, 4])
def test_spec_write_plain_vs_pallas(quant, D):
    """D rows per slot at pos 0, across the writer's slab boundary (8 f32
    rows, 32 int8 rows), mid-cache and at S - D: whole caches bit-equal."""
    rng = np.random.default_rng(10 * D + quant)
    jc, tc, rows = _caches(rng, quant)
    kq, vq = rows(L, B, N_KV, D, HS), rows(L, B, N_KV, D, HS)
    ks, vs = ((rng.random((L, B, N_KV, D)).astype(np.float32)
               for _ in range(2)) if quant else (None, None))
    edge = 32 if quant else 8
    pos = np.array([0, edge - 1, edge + 5, S - D], np.int32)
    jc = jkw.spec_write(jc, _j(kq), _j(vq), _j(ks), _j(vs), _j(pos),
                        interpret=True)
    out = tkw.spec_write(tc, _t(kq), _t(vq), _t(ks), _t(vs), _t(pos))
    assert out is tc                                       # in place
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(jc, name), getattr(tc, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)


def test_spec_write_drops_rows_past_the_cache():
    """Rows at or past S are dropped, never clamped onto earlier rows (the
    kernel's rule; JAX's writer requires pos + D <= S)."""
    rng = np.random.default_rng(5)
    _, tc, rows = _caches(rng, False)
    before = tc.k.clone()
    kq, vq = _t(rows(L, B, N_KV, 4, HS)), _t(rows(L, B, N_KV, 4, HS))
    pos = torch.tensor([S - 2, S, 3, 0], dtype=torch.int32)
    tkw.spec_write_plain(tc, kq, vq, None, None, pos)
    assert torch.equal(tc.k[:, 0, :, S - 2:], kq[:, 0, :, :2])
    assert torch.equal(tc.k[:, 0, :, :S - 2], before[:, 0, :, :S - 2])
    assert torch.equal(tc.k[:, 1], before[:, 1])
    assert torch.equal(tc.k[:, 2, :, 3:7], kq[:, 2])


@pytest.mark.parametrize("n_kv,hgs", [(4, 1), (2, 4)])
def test_decode_attention_batched_plain_vs_pallas(n_kv, hgs):
    rng = np.random.default_rng(n_kv + hgs)
    Bs, Ls, Ss, hs = 4, 2, 32, 16
    q = _normal(rng, Bs, n_kv * hgs, 1, hs)
    ck, cv = (_normal(rng, Ls, Bs, n_kv, Ss, hs) for _ in range(2))
    pos = np.array([0, 1, 17, Ss - 1], np.int32)
    for layer in (0, 1):
        want = jpa.decode_attention_pallas_batched(
            _j(q), _j(ck), _j(cv), _j(pos), layer, interpret=True)
        got = tka.decode_attention_pallas_batched(_t(q), _t(ck), _t(cv),
                                                  _t(pos), layer)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel_err(got, want):
    g, w = got.float(), want.float()
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dt", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_kv,hgs,T,hs", [(8, 1, 4, 128), (8, 1, 8, 128),
                                           (4, 2, 2, 64), (2, 8, 8, 64),
                                           (2, 4, 8, 256)])
def test_flash_spec_kernel_vs_plain_on_card(cuda, cache_dt, qdt, n_kv, hgs,
                                            T, hs):
    Bs, Ls, Ss = 6, 2, 160
    quant = cache_dt == "int8"
    q, ck, cv, ks, vs, kn, vn, ke, ve = _spec_inputs(
        hs + T + hgs, Bs, Ls, n_kv, hgs, Ss, T, hs, quant)
    qt = getattr(torch, qdt)
    q, kn, vn, ke, ve = (_t(a).to(cuda, qt) for a in (q, kn, vn, ke, ve))
    ck, cv = (_t(a).to(cuda) for a in (ck, cv))
    if quant:
        ks, vs = _t(ks).to(cuda), _t(vs).to(cuda)
    else:
        ck, cv = ck.to(getattr(torch, cache_dt)), cv.to(getattr(torch,
                                                               cache_dt))
        ke = ve = None
    pos = torch.tensor([0, 1, 63, 64, 127, Ss - T], dtype=torch.int32,
                       device=cuda)
    before = tfd.flash_spec_batched.launches
    got = tfd.flash_spec_batched(q, ck, cv, pos, 1, ks, vs, kn, vn, ke, ve)
    assert tfd.flash_spec_batched.launches == before + 1
    want = tfd.flash_spec_plain(q, ck, cv, pos, 1, ks, vs, kn, vn, ke, ve)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    assert _rel_err(got, want) <= (1e-4 if qdt == "float32" else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("D", [2, 3, 4, 8])
def test_spec_write_kernel_vs_plain_on_card(cuda, quant, D):
    rng = np.random.default_rng(D)
    _, base, rows = _caches(rng, quant)
    kq, vq = (_t(rows(L, B, N_KV, D, HS)).to(cuda) for _ in range(2))
    ks, vs = ((torch.rand((L, B, N_KV, D), device=cuda) for _ in range(2))
              if quant else (None, None))
    pos = torch.tensor([0, 31, 37, S - D], dtype=torch.int32, device=cuda)
    a, b = (TCache(*(None if t is None else t.to(cuda) for t in
                     (base.k, base.v, base.k_scale, base.v_scale)))
            for _ in range(2))
    before = tkw.spec_write.launches
    tkw.spec_write(a, kq, vq, ks, vs, pos)
    assert tkw.spec_write.launches == before + 1
    tkw.spec_write_plain(b, kq, vq, ks, vs, pos)
    torch.cuda.synchronize()
    for name in ("k", "v", "k_scale", "v_scale"):
        x, y = getattr(a, name), getattr(b, name)
        assert x is None or torch.equal(x, y), name


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dt", ["bfloat16", "float32"])
def test_decode_attention_batched_kernel_vs_plain_on_card(cuda, cache_dt):
    rng = np.random.default_rng(2)
    Bs, Ls, n_kv, Ss, hs = 4, 2, 32, 512, 128
    dt = getattr(torch, cache_dt)
    q = _t(_normal(rng, Bs, n_kv, 1, hs)).to(cuda, dt)
    ck, cv = (_t(_normal(rng, Ls, Bs, n_kv, Ss, hs)).to(cuda, dt)
              for _ in range(2))
    pos = torch.tensor([0, 1, 107, Ss - 1], dtype=torch.int32, device=cuda)
    got = tka.decode_attention_pallas_batched(q, ck, cv, pos, 1)
    want = tka.decode_attention_batched_plain(q, ck, cv, pos, 1)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= (1e-4 if cache_dt == "float32" else 1e-2)
