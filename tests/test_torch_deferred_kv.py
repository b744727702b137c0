"""Deferred staged-KV decode in the port: K2's softmax-stats outputs (the
plain version, what ``flash_decode_batched(stats=True)`` runs for CPU
tensors) against the JAX Pallas kernel in interpret mode; teacher-forced
``decode_step_deferred`` + ``land_staged`` against JAX's
(``tests/test_deferred_kv.py:33-90``); the deferred engine against the
JAX deferred engine and the port's plain chunks; and the gate that keeps
deferred chunks to 2 <= K <= 32 on the kernel path.  Inputs are made with
numpy from a seed and handed to both sides.  f32 compute; tolerance f32
2e-5, int8 caches within one quantum.  The card-only test holds the CUDA
kernel's stats against the plain version."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
from fastllama_tpu.models import batched as jb
from fastllama_tpu.models import llama as jl
from fastllama_tpu.ops.pallas.flash_decode import \
    flash_decode_batched as j_flash
from fastllama_tpu.ops.pallas.flash_decode import \
    make_attn_batched_flash_stats as j_make_attn_stats
from fastllama_tpu.ops.pallas.kv_write import \
    make_spec_writer as j_make_spec_writer
from fastllama_tpu.quant.groupquant import quantize_rows as j_quantize_rows
from fastllama_tpu.runtime.batching import BatchedEngine as JEngine
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer as TTokenizer
from fastllama_tpu_torch.models import batched as tb
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.ops.kernels import flash_decode as tfd
from fastllama_tpu_torch.ops.kernels import kv_write as tkw
from fastllama_tpu_torch.runtime.batching import BatchedEngine as TEngine


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
# S = 64 divides every kv sublane, so JAX's spec_write landing engages
CFG = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
           vocab_size=96, max_seq_len=64, group_size=16)


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("n_kv,hgs", [(4, 1), (2, 2)])
@pytest.mark.parametrize("fresh", [True, False])
def test_stats_plain_vs_pallas(quant, n_kv, hgs, fresh):
    """o, m and l of every query row: an idle slot (pos 0), block edges and
    the last row; with the fresh row (the deferred path) and without."""
    rng = np.random.default_rng(n_kv + 10 * hgs + 100 * quant)
    B, L, S, hs = 6, 2, 64, 32
    H = n_kv * hgs
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, ck, cv, kn, vn = (f(B, H, 1, hs), f(L, B, n_kv, S, hs),
                         f(L, B, n_kv, S, hs), f(B, n_kv, hs), f(B, n_kv, hs))
    pos = np.array([0, 1, BLOCK - 1, BLOCK, 2 * BLOCK, S - 1], np.int32)
    if quant:
        (jk, jks), (jv, jvs) = (j_quantize_rows(jnp.asarray(a))
                                for a in (ck, cv))
        jks, jvs = jks[..., 0], jvs[..., 0]
    else:
        jk, jv, jks, jvs = jnp.asarray(ck), jnp.asarray(cv), None, None
    fr = dict(k_new=kn, v_new=vn) if fresh else {}
    want = j_flash(jnp.asarray(q), jk, jv, jnp.asarray(pos), 1,
                   block_s=BLOCK, interpret=True, k_scale=jks, v_scale=jvs,
                   stats=True, **{k: jnp.asarray(a) for k, a in fr.items()})
    got = tfd.flash_decode_batched(_t(q), _t(jk), _t(jv), _t(pos), 1,
                                   _t(jks), _t(jvs), stats=True,
                                   **{k: _t(a) for k, a in fr.items()})
    assert got[1].shape == got[2].shape == (B, n_kv, hgs)
    for name, g, w in zip("oml", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **F32)


@pytest.fixture(scope="module")
def models():
    jc = jcfg.ModelConfig(**CFG, quant_type=jcfg.QuantType.INT8)
    tc = tcfg.ModelConfig(**CFG, quant_type=tcfg.QuantType.INT8)
    jp = jl.random_params(jc, seed=3, qtype=jcfg.QuantType.INT8)
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


def _same_cache(jcache, tcache, label):
    for name in ("k", "v", "k_scale", "v_scale"):
        a, t = getattr(jcache, name), getattr(tcache, name)
        if a is None:
            continue
        a = np.asarray(a)
        if a.dtype == np.int8:
            d = np.abs(t.numpy().astype(np.int32) - a.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (label, name)
        else:
            np.testing.assert_allclose(t.numpy(), a, err_msg=f"{label} {name}",
                                       **F32)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_deferred_steps_match_jax(models, kv_dtype):
    """K = 4 teacher-forced deferred steps from the same prefilled cache:
    per-step logits equal JAX's deferred steps and the port's own plain
    decode steps, and the landed cache equals both (rows outside
    [pos0, pos0 + K) untouched)."""
    jc, jp, tc, tp = models
    B, K = 3, 4
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, CFG["vocab_size"], size=n).tolist()
               for n in (3, 5, 2)]
    tokens = rng.integers(1, CFG["vocab_size"], size=(K, B)).astype(np.int32)
    pos0 = np.array([len(p) for p in prompts], np.int32)

    jcache = jb.BatchedKVCache.create(jc, B, dtype=jnp.dtype(kv_dtype))
    for b, p in enumerate(prompts):
        _, jcache = jb.prefill_into_slot(jc, jp, jnp.asarray(p, jnp.int32),
                                         len(p), b, jcache,
                                         compute_dtype=jnp.float32)

    def port_cache():
        c = tb.BatchedKVCache.create(tc, B, dtype=kv_dtype, device="cpu")
        for name in ("k", "v", "k_scale", "v_scale"):
            if getattr(c, name) is not None:
                getattr(c, name).copy_(torch.from_numpy(
                    np.asarray(getattr(jcache, name)).copy()))
        return c

    staged = jb.make_staged(jc, jcache, B, K)
    j_stats = j_make_attn_stats(interpret=True)
    want = []
    for s in range(K):
        lg, staged = jb.decode_step_deferred(
            jc, jp, jnp.asarray(tokens[s]), jnp.asarray(pos0), jnp.int32(s),
            staged, jcache, attn_stats=j_stats, compute_dtype=jnp.float32)
        want.append(np.asarray(lg))
    j_landed = jb.land_staged(jcache, staged, jnp.asarray(pos0),
                              j_make_spec_writer(interpret=True))

    tcache = port_cache()
    t_staged = tb.make_staged(tc, tcache, B, K)
    t_stats = tfd.make_attn_batched_flash_stats()
    for s in range(K):
        lg, t_staged = tb.decode_step_deferred(
            tc, tp, torch.tensor(tokens[s]), torch.tensor(pos0), s,
            t_staged, tcache, attn_stats=t_stats, compute_dtype=torch.float32)
        np.testing.assert_allclose(lg.numpy(), want[s], err_msg=f"step {s}",
                                   **F32)
    landed = tb.land_staged(tcache, t_staged, torch.tensor(pos0),
                            tkw.spec_write)
    _same_cache(j_landed, landed, "deferred")

    plain = port_cache()
    pos = torch.tensor(pos0)
    for s in range(K):
        lg, plain = tb.decode_step(
            tc, tp, torch.tensor(tokens[s]), pos, plain,
            attn_bidx=tfd.make_attn_batched_flash(),
            kv_writer=tkw.decode_write, compute_dtype=torch.float32)
        np.testing.assert_allclose(lg.numpy(), want[s],
                                   err_msg=f"plain step {s}", **F32)
        pos = pos + 1
    _same_cache(j_landed, plain, "plain")


_COMMON = dict(max_seq_len=64, max_batch_size=2, compute_dtype="float32",
               kv_dtype="int8")
PROMPTS = [[5, 17, 3], [60, 2, 33, 41, 8], [9, 9, 14]]


def _port(models, **kw):
    _, _, tc, tp = models
    return TEngine(tc, tp, TTokenizer().finalize(),
                   tcfg.EngineConfig(**{**_COMMON, **kw}), decode_chunk=4,
                   device="cpu")


def test_deferred_engine_matches_jax_and_plain(models):
    """Greedy tokens of the port's deferred engine equal the JAX deferred
    engine's (its kernels in interpret mode); its sampled tokens equal the
    port's plain engine's (the chunks draw from the slots' generators in
    the same order)."""
    jc, jp, _, _ = models
    jeng = JEngine(jc, jp, JTokenizer().finalize(),
                   jcfg.EngineConfig(**_COMMON, pallas_interpret=True,
                                     deferred_kv=True), decode_chunk=4)
    assert jeng._deferred_ok
    want = [r.output_tokens for r in jeng.generate_all(
        PROMPTS, max_new_tokens=12, temperature=0.0, stop_tokens=())]
    eng = _port(models, deferred_kv=True)
    got = [r.output_tokens for r in eng.generate_all(
        PROMPTS, max_new_tokens=12, temperature=0.0, stop_tokens=())]
    assert got == want
    assert eng.deferred_chunks > 0
    sampled = {}
    for deferred in (True, False):
        e = _port(models, deferred_kv=deferred)
        sampled[deferred] = [r.output_tokens for r in e.generate_all(
            PROMPTS, max_new_tokens=10, temperature=0.8, seed=7,
            stop_tokens=())]
        assert (e.deferred_chunks > 0) == deferred
    assert sampled[True] == sampled[False]


def test_spec_engine_plain_chunks_take_the_deferred_path(models):
    """Near the context limit ``SpecBatchedEngine`` gives way to its
    parent's plain chunks, and with ``deferred_kv`` those run deferred:
    greedy tokens still equal the plain ``BatchedEngine``'s."""
    from fastllama_tpu_torch.runtime.spec_batching import SpecBatchedEngine
    _, _, tc, tp = models
    prompt = [(7 * i) % 90 + 3 for i in range(46)]
    spec = SpecBatchedEngine(
        tc, tp, TTokenizer().finalize(),
        tcfg.EngineConfig(**_COMMON, deferred_kv=True), decode_chunk=4,
        width=4, rounds_per_chunk=2, spec_auto=False, device="cpu")
    got = [r.output_tokens for r in spec.generate_all(
        [prompt, PROMPTS[0]], max_new_tokens=17, temperature=0.0,
        stop_tokens=())]
    want = [r.output_tokens for r in _port(models).generate_all(
        [prompt, PROMPTS[0]], max_new_tokens=17, temperature=0.0,
        stop_tokens=())]
    assert got == want
    assert spec.arm_chunks[0] > 0 and spec.arm_chunks[4] > 0
    assert spec.deferred_chunks > 0


def test_deferred_gate(models):
    """Deferred chunks run only for 2 <= K <= 32 on the kernel path with
    flash attention (JAX's gate, ``batching.py:193-209``, ``:794``)."""
    def chunks(decode_chunk, n_new, **kw):
        e = _port(models, deferred_kv=True, **kw)
        e.decode_chunk = decode_chunk
        e.generate_all([PROMPTS[0]], max_new_tokens=n_new, temperature=0.0,
                       stop_tokens=())
        return e.deferred_chunks

    assert chunks(1, 4) == 0                # K = 1 every chunk
    assert chunks(40, 41) == 0              # one chunk of K = 40 > 32
    assert chunks(32, 33) == 1              # one chunk of K = 32
    assert chunks(4, 9) == 2
    assert chunks(4, 9, use_pallas=False) == 0
    assert chunks(4, 9, flash_attention=False) == 0
    assert not _port(models)._deferred_ok


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dt", ["int8", "bfloat16"])
@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_kv,hgs,hs", [(8, 1, 128), (2, 8, 64)])
def test_stats_kernel_vs_plain_on_card(cuda, cache_dt, qdt, n_kv, hgs, hs):
    B, L, S = 8, 2, 160
    rng = np.random.default_rng(hs + hgs)
    f = lambda *s: torch.tensor(  # noqa: E731
        rng.standard_normal(s).astype(np.float32), device=cuda)
    qt = getattr(torch, qdt)
    q, kn, vn = (f(B, n_kv * hgs, 1, hs).to(qt), f(B, n_kv, hs).to(qt),
                 f(B, n_kv, hs).to(qt))
    ck, cv = f(L, B, n_kv, S, hs), f(L, B, n_kv, S, hs)
    if cache_dt == "int8":
        from fastllama_tpu_torch.quant.groupquant import quantize_rows
        (ck, ks), (cv, vs) = quantize_rows(ck), quantize_rows(cv)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    else:
        ck, cv, ks, vs = ck.to(torch.bfloat16), cv.to(torch.bfloat16), \
            None, None
    pos = torch.tensor([0, 1, 63, 64, 65, 127, 128, S - 1],
                       dtype=torch.int32, device=cuda)
    fd = tfd.flash_decode_batched
    n, n_stats = fd.launches, fd.launches_stats
    got = fd(q, ck, cv, pos, 1, ks, vs, kn, vn, stats=True)
    assert fd.launches_stats == n_stats + 1 and fd.launches == n
    want = tfd.flash_decode_plain(q, ck, cv, pos, 1, ks, vs, kn, vn,
                                  stats=True)
    torch.cuda.synchronize()
    for name, g, w, tol in zip("oml", got, want,
                               (1e-4 if qdt == "float32" else 1e-2, 1e-4,
                                1e-4)):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * w.float().abs().max().item(), name
