"""The prefix cache of the port: K2b's plain version (what
``flash_block_attend`` runs for CPU tensors) against the JAX Pallas kernel
``flash_block_attend`` in interpret mode and, past that kernel's
``T * n_heads <= 4096`` limit, against JAX's copy-and-mask path;
``prefill_into_slot_at`` and ``copy_slot_prefix`` against JAX's; and the
engines' prefix-cache admissions against the JAX engines
(``tests/test_batching.py:486-592``) on the same weights.  Inputs are made
with numpy from a seed and handed to both sides.  f32 compute; tolerance
f32 2e-5 (the two sides sum in another order), int8 caches within one
quantum (an f32 row whose last bits differ may round one element the other
way).  The card-only test holds the CUDA kernel against the plain
version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
from fastllama_tpu.models import batched as jb
from fastllama_tpu.models import llama as jl
from fastllama_tpu.ops.attention import gqa_attention as j_gqa_attention
from fastllama_tpu.ops.pallas.flash_decode import \
    flash_block_attend as j_block
from fastllama_tpu.ops.pallas.flash_decode import \
    make_attn_tail as j_make_attn_tail
from fastllama_tpu.quant.groupquant import quantize_rows as j_quantize_rows
from fastllama_tpu.runtime.batching import BatchedEngine as JEngine
from fastllama_tpu.runtime.spec_batching import SpecBatchedEngine as JSpec
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer as TTokenizer
from fastllama_tpu_torch.models import batched as tb
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.ops.kernels import flash_decode as tfd
from fastllama_tpu_torch.ops.kernels import kv_write as tkw
from fastllama_tpu_torch.runtime.batching import BatchedEngine as TEngine
from fastllama_tpu_torch.runtime.spec_batching import \
    SpecBatchedEngine as TSpec


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here run many tiny ops: one intra-op thread keeps them
    fast when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(rtol=2e-5, atol=2e-5)
BLOCK = 16           # the Pallas kernel's cache block
CFG = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
           vocab_size=512, max_seq_len=128, group_size=16)


def _t(a):
    """A JAX array as a CPU tensor of the same dtype (bf16 through f32,
    which holds it exactly)."""
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.tensor(np.asarray(a))


def _cache_arrays(rng, L, B, n_kv, S, hs, cache_dt):
    """K/V caches (and int8 row scales) as JAX arrays of ``cache_dt``."""
    ck = rng.standard_normal((L, B, n_kv, S, hs)).astype(np.float32)
    cv = rng.standard_normal((L, B, n_kv, S, hs)).astype(np.float32)
    if cache_dt == "int8":
        (k, ks), (v, vs) = j_quantize_rows(jnp.asarray(ck)), \
            j_quantize_rows(jnp.asarray(cv))
        return k, v, ks[..., 0], vs[..., 0]
    dt = jnp.dtype(cache_dt)
    return jnp.asarray(ck, dt), jnp.asarray(cv, dt), None, None


@pytest.mark.parametrize("cache_dt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n_kv,hgs", [(4, 1), (2, 2)])
@pytest.mark.parametrize("start", [0, 24])
def test_block_plain_vs_pallas(cache_dt, n_kv, hgs, start):
    """K2b's plain version against the Pallas kernel: cache rows [0, start)
    of slot 2 / layer 1 (start 0 reads none, 24 ends inside a block) and
    the causal fresh block of T = 20 rows (T * n_heads <= 4096)."""
    rng = np.random.default_rng(start + 10 * hgs)
    L, B, S, hs, T = 2, 3, 64, 32, 20
    H = n_kv * hgs
    k, v, ks, vs = _cache_arrays(rng, L, B, n_kv, S, hs, cache_dt)
    q, kn, vn = (rng.standard_normal(s).astype(np.float32)
                 for s in ((H, T, hs), (n_kv, T, hs), (n_kv, T, hs)))
    want = j_block(jnp.asarray(q), k, v, 2, 1, start, block_s=BLOCK,
                   interpret=True, k_scale=ks, v_scale=vs,
                   k_new=jnp.asarray(kn), v_new=jnp.asarray(vn))
    got = tfd.flash_block_attend(_t(q), _t(k), _t(v), 2, 1, start, _t(ks),
                                 _t(vs), _t(kn), _t(vn))
    assert got.shape == (H, T, hs) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_block_plain_vs_copy_and_mask_past_the_pallas_limit():
    """T * n_heads = 8 * 520 > 4096: JAX's ``make_attn_tail`` gives way to
    its copy-and-mask path (the slot's layer rows with the block placed at
    [start, start+T), masked attention at pos = start); K2b covers the
    shape, and its plain version equals that path at an f32 cache."""
    rng = np.random.default_rng(7)
    L, B, n_kv, hgs, S, hs, T, start = 2, 2, 4, 2, 576, 16, 520, 48
    H = n_kv * hgs
    k, v, _, _ = _cache_arrays(rng, L, B, n_kv, S, hs, "float32")
    q, kn, vn = (jnp.asarray(rng.standard_normal(s).astype(np.float32))
                 for s in ((H, T, hs), (n_kv, T, hs), (n_kv, T, hs)))
    cache = jb.BatchedKVCache(k, v)
    assert j_make_attn_tail(interpret=True)(q, cache, 1, 0, start, kn,
                                            vn) is None
    kk = jax.lax.dynamic_update_slice(k[0, 1], kn, (0, start, 0))
    vv = jax.lax.dynamic_update_slice(v[0, 1], vn, (0, start, 0))
    want = j_gqa_attention(q, kk, vv, start)
    got = tfd.flash_block_attend(_t(q), _t(k), _t(v), 1, 0, start,
                                 k_new=_t(kn), v_new=_t(vn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_block_rejects_bad_operands():
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((4, 5, 16)).astype(np.float32))
    kn = torch.zeros((2, 5, 16))
    ck = torch.zeros((1, 2, 2, 32, 16))
    with pytest.raises(ValueError):                       # slot out of range
        tfd.flash_block_attend(q, ck, ck, 2, 0, 4, k_new=kn, v_new=kn)
    with pytest.raises(ValueError):                       # start past S
        tfd.flash_block_attend(q, ck, ck, 0, 0, 33, k_new=kn, v_new=kn)
    with pytest.raises(ValueError):                       # no fresh block
        tfd.flash_block_attend(q, ck, ck, 0, 0, 4)
    with pytest.raises(ValueError):                       # int8, no scales
        tfd.flash_block_attend(q, ck.to(torch.int8), ck.to(torch.int8), 0,
                               0, 4, k_new=kn, v_new=kn)
    with pytest.raises(ValueError):                       # not cpu/cuda
        tfd.flash_block_attend(q.to("meta"), ck.to("meta"), ck.to("meta"),
                               0, 0, 4, k_new=kn.to("meta"),
                               v_new=kn.to("meta"))


@pytest.fixture(scope="module")
def models():
    jc = jcfg.ModelConfig(**CFG, quant_type=jcfg.QuantType.INT8)
    tc = tcfg.ModelConfig(**CFG, quant_type=tcfg.QuantType.INT8)
    jp = jl.random_params(jc, seed=9, qtype=jcfg.QuantType.INT8)
    arrays, flags = {}, {}
    for f in dataclasses.fields(jp):
        v = getattr(jp, f.name)
        if hasattr(v, "scales"):
            arrays[f.name] = (np.asarray(v.data), np.asarray(v.scales))
            flags[f.name] = dict(qtype=v.qtype.name, group_size=v.group_size,
                                 group_axis=v.group_axis, packed=v.packed)
        else:
            arrays[f.name] = None if v is None else np.asarray(v)
    return jc, jp, tc, tl.params_from_numpy(tc, arrays, flags, device="cpu")


def _check_cache(jcache, tcache, label):
    """The port's cache against JAX's: int8 within one quantum in a small
    share of elements, float within f32 2e-5."""
    for name in ("k", "v", "k_scale", "v_scale"):
        a, t = getattr(jcache, name), getattr(tcache, name)
        if a is None:
            assert t is None
            continue
        a = np.asarray(a)
        if a.dtype == np.int8:
            d = np.abs(t.numpy().astype(np.int32) - a.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (label, name)
        else:
            np.testing.assert_allclose(t.numpy(), a, err_msg=f"{label} {name}",
                                       **F32)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("tail", [True, False])
def test_prefill_into_slot_at_matches_jax(models, kv_dtype, tail):
    """A 16-token tail (13 valid) at start 24 of slot 1 over a 24-token
    prefix (``tests/test_pallas_attention.py:55-93``): logits and the whole
    cache, with K2b (JAX: ``make_attn_tail(interpret=True)``) and with the
    copy-and-mask fallback on both sides."""
    jc, jp, tc, tp = models
    rng = np.random.default_rng(1)
    pref = rng.integers(1, 250, 24).astype(np.int32)
    tail_toks = rng.integers(1, 250, 16).astype(np.int32)
    jcache = jb.BatchedKVCache.create(jc, 3, dtype=jnp.dtype(kv_dtype))
    _, jcache = jb.prefill_into_slot(jc, jp, jnp.asarray(pref), 24, 1,
                                     jcache, compute_dtype=jnp.float32)
    tcache = tb.BatchedKVCache.create(tc, 3, dtype=kv_dtype, device="cpu")
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(tcache, name) is not None:
            getattr(tcache, name).copy_(
                torch.from_numpy(np.asarray(getattr(jcache, name)).copy()))
    want_lg, jcache = jb.prefill_into_slot_at(
        jc, jp, jnp.asarray(tail_toks), 13, 1, 24, jcache,
        attn_tail=j_make_attn_tail(interpret=True) if tail else None,
        compute_dtype=jnp.float32)
    got_lg, tcache = tb.prefill_into_slot_at(
        tc, tp, torch.tensor(tail_toks), 13, 1, 24, tcache,
        attn_tail=tfd.make_attn_tail() if tail else None,
        slot_writer=tkw.prefill_write if tail else None,
        compute_dtype=torch.float32)
    assert got_lg.shape == (CFG["vocab_size"],)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg), **F32)
    _check_cache(jcache, tcache, f"tail={tail}")


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_copy_slot_prefix_bit_equal(kv_dtype):
    rng = np.random.default_rng(4)
    k, v, ks, vs = _cache_arrays(rng, 2, 4, 2, 48, 8, kv_dtype)
    want = jb.copy_slot_prefix(jb.BatchedKVCache(k, v, ks, vs), 3, 1, 21)
    tcache = tb.BatchedKVCache(_t(k), _t(v), _t(ks), _t(vs))
    got = tb.copy_slot_prefix(tcache, 3, 1, 21)
    assert got is tcache
    for name in ("k", "v", "k_scale", "v_scale"):
        a = getattr(want, name)
        if a is not None:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(a))


_COMMON = dict(max_seq_len=128, compute_dtype="float32")


def _engines(models, spec=False, **ec_kw):
    """(port, JAX) engines on the same weights.  The JAX engine runs its
    jnp path (the copy-and-mask tail); the port's wrappers take their
    plain versions on the CPU (K2b's for the tail)."""
    jc, jp, tc, tp = models
    tec = tcfg.EngineConfig(**_COMMON, **ec_kw)
    jec = jcfg.EngineConfig(**_COMMON, **ec_kw)
    if spec:
        kw = dict(decode_chunk=4, width=3, rounds_per_chunk=2,
                  spec_auto=False)
        return (TSpec(tc, tp, TTokenizer().finalize(), tec, device="cpu",
                      **kw),
                JSpec(jc, jp, JTokenizer().finalize(), jec, **kw))
    return (TEngine(tc, tp, TTokenizer().finalize(), tec, decode_chunk=4,
                    device="cpu"),
            JEngine(jc, jp, JTokenizer().finalize(), jec, decode_chunk=4))


SYSTEM = [(i * 5) % 400 + 2 for i in range(40)]      # a shared 40-token prefix


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_engine_hit_matches_jax_and_full_prefill(models, kv_dtype):
    """A second request sharing a live donor's prefix copies 32 rows and
    prefills only its tail: tokens and prefix stats equal the JAX
    engine's; at an f32 cache the tokens equal the engine without the
    prefix cache (at int8 a hit attends the prefix rows as quantized in
    the cache, where a whole prefill attends its own exact rows)."""
    p1, p2 = SYSTEM + [7, 9], SYSTEM + [11, 13, 15]

    def run(eng):
        r1 = eng.submit(p1, max_new_tokens=40, temperature=0.0,
                        stop_tokens=())
        eng.step()                      # admit and register r1 (stays live)
        assert not r1.done
        r2 = eng.submit(p2, max_new_tokens=6, temperature=0.0,
                        stop_tokens=())
        eng.run()
        return ([r1.output_tokens, r2.output_tokens],
                (eng.stats.prefix_hits, eng.stats.prefix_rows_reused))

    out = {}
    for pc in (True, False):
        port, jax_eng = _engines(models, max_batch_size=3, kv_dtype=kv_dtype,
                                 prefix_cache=pc)
        out["port", pc], out["jax", pc] = run(port), run(jax_eng)
    assert out["port", True] == out["jax", True]
    assert out["port", True][1] == (1, 32)
    assert out["port", False] == out["jax", False]
    assert out["port", False][1] == (0, 0)
    if kv_dtype == "float32":
        assert out["port", True][0] == out["port", False][0]


def test_engine_entries_released_on_completion(models):
    """A finished donor's entries go (an idle slot's decode writes its row
    0): the same prompt again prefills fully and decodes the same."""
    prompt = SYSTEM + [7]
    got = {}
    for side, eng in zip(("port", "jax"), _engines(
            models, max_batch_size=2, prefix_cache=True)):
        r1 = eng.submit(prompt, max_new_tokens=4, temperature=0.0,
                        stop_tokens=())
        eng.run()
        assert r1.done and not eng._prefix_index
        r2 = eng.submit(prompt, max_new_tokens=4, temperature=0.0,
                        stop_tokens=())
        eng.run()
        assert eng.stats.prefix_hits == 0
        assert r2.output_tokens == r1.output_tokens
        got[side] = r2.output_tokens
    assert got["port"] == got["jax"]


def test_engine_hit_refused_when_tail_bucket_overflows(models):
    """A hit whose plen + bucket(tail) passes the context (16 + 128 > 128)
    is refused and the request prefills fully, on both sides."""
    shared = [(i * 5) % 400 + 2 for i in range(16)]
    donor_p = shared + [(i * 7) % 400 + 3 for i in range(104)]
    hit_p = shared + [(i * 11) % 400 + 5 for i in range(104)]
    got = {}
    for side, eng in zip(("port", "jax"), _engines(
            models, max_batch_size=2, prefix_cache=True)):
        eng.submit(donor_p, max_new_tokens=7, temperature=0.0,
                   stop_tokens=())
        eng.step()
        r2 = eng.submit(hit_p, max_new_tokens=4, temperature=0.0,
                        stop_tokens=())
        eng.run()
        assert eng.stats.prefix_hits == 0
        got[side] = r2.output_tokens
    assert got["port"] == got["jax"]


def test_spec_engine_hit_matches_jax(models):
    """``SpecBatchedEngine`` with the prefix cache: two hits on a live
    donor, the hit slots' histories seeded like any admission; greedy
    tokens, prefix stats and draft counts equal the JAX spec engine's, and
    the tokens equal the port's plain engine with the prefix cache."""
    prompts = [SYSTEM + [7, 9], SYSTEM + [11, 13, 15], SYSTEM[:33] + [4]]

    def run(eng):
        r1 = eng.submit(prompts[0], max_new_tokens=30, temperature=0.0,
                        stop_tokens=())
        eng.step()
        rest = [eng.submit(p, max_new_tokens=10, temperature=0.0,
                           stop_tokens=()) for p in prompts[1:]]
        eng.run()
        return ([r.output_tokens for r in [r1] + rest],
                (eng.stats.prefix_hits, eng.stats.prefix_rows_reused))

    spec, jspec = _engines(models, spec=True, max_batch_size=3,
                           kv_dtype="int8", prefix_cache=True)
    got = run(spec)
    assert got == run(jspec)
    assert got[1] == (2, 64)
    assert spec.spec_drafted == jspec.spec_drafted > 0
    assert spec.spec_accepted == jspec.spec_accepted
    plain, _ = _engines(models, max_batch_size=3, kv_dtype="int8",
                        prefix_cache=True)
    assert run(plain) == got


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
@pytest.mark.parametrize("T,start", [(1, 0), (37, 64), (150, 100)])
def test_block_kernel_vs_plain_on_card(cuda, cache_dt, qdt, n_kv, hgs, hs,
                                       T, start):
    rng = np.random.default_rng(T + hs + hgs)
    L, B, S = 2, 3, 256
    k, v, ks, vs = _cache_arrays(rng, L, B, n_kv, S, hs, cache_dt)
    qt = getattr(torch, qdt)
    q, kn, vn = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                              device=cuda).to(qt)
                 for s in ((n_kv * hgs, T, hs), (n_kv, T, hs),
                           (n_kv, T, hs)))
    ck, cv, ks, vs = (None if a is None else _t(a).to(cuda)
                      for a in (k, v, ks, vs))
    before = tfd.flash_block_attend.launches
    got = tfd.flash_block_attend(q, ck, cv, 2, 1, start, ks, vs, kn, vn)
    assert tfd.flash_block_attend.launches == before + 1
    want = tfd.flash_block_plain(q, ck, cv, 2, 1, start, ks, vs, kn, vn)
    torch.cuda.synchronize()
    tol = 1e-4 if qdt == "float32" else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()
