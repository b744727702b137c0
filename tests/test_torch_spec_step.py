"""The batched speculative verify and the spec engine's round logic: the
port's ``spec_decode_step`` against the JAX package's (its Pallas kernels
in interpret mode, and the jnp path) and against D sequential decode
steps; ``ngram_draft_batched`` bit for bit; ``SpecAutoTuner``'s arm
sequence; the sampled rounds' accept rule.  f32 compute: logits within
2e-5; int8 caches within one quantum (``test_torch_batched._sync_caches``
says why)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.models import batched as jb
from fastllama_tpu.models import llama as jl
from fastllama_tpu.ops.pallas.flash_decode import make_attn_spec_batched
from fastllama_tpu.ops.pallas.kv_write import make_spec_writer
from fastllama_tpu.runtime import spec_batching as jsb
from fastllama_tpu.runtime.kernels import select_kernels as j_select
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer as TTokenizer
from fastllama_tpu_torch.models import batched as tb
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.runtime import spec_batching as tsb
from fastllama_tpu_torch.runtime.batching import BatchedEngine as TEngine
from fastllama_tpu_torch.runtime.kernels import select_kernels as t_select


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here run many tiny ops: one intra-op thread keeps them
    fast when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(rtol=2e-5, atol=2e-5)
CFG = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
           vocab_size=512, max_seq_len=128, group_size=16)


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
    tp = tl.params_from_numpy(tc, arrays, flags, device="cpu")
    return jc, jp, tc, tp


@pytest.fixture(scope="module")
def fused(models):
    """The same weights with QKV and gate|up fused, as the engines serve
    them."""
    jc, jp, tc, tp = models
    return jc, jl.fuse_params(jc, jp), tc, tl.fuse_params(tc, tp)


def _check_caches(jcache, tcache):
    """The port's cache against the JAX one: int8 rows within one quantum,
    float rows and scales within the f32 tolerance."""
    for name in ("k", "v", "k_scale", "v_scale"):
        a, t = getattr(jcache, name), getattr(tcache, name)
        assert (a is None) == (t is None)
        if a is None:
            continue
        a = np.asarray(a)
        if a.dtype == np.int8:
            d = np.abs(t.numpy().astype(np.int32) - a.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, name
        else:
            np.testing.assert_allclose(t.numpy(), a, err_msg=name, **F32)


def _prefilled(models, kv_dtype, B, prompt):
    """The same prompt prefilled into every slot of a JAX and a port cache
    (the port then takes the JAX bytes, so both verify from one state)."""
    jc, jp, tc, tp = models
    jcache = jb.BatchedKVCache.create(jc, B, dtype=jnp.dtype(kv_dtype))
    toks = jnp.asarray(prompt, jnp.int32)
    for b in range(B):
        _, jcache = jb.prefill_into_slot(jc, jp, toks, len(prompt), b, jcache,
                                         compute_dtype=jnp.float32)
    tcache = tb.BatchedKVCache(*(None if a is None else
                                 torch.tensor(np.asarray(a))
                                 for a in (jcache.k, jcache.v,
                                           jcache.k_scale, jcache.v_scale)))
    return jcache, tcache


@pytest.mark.parametrize("kv_dtype,kernels", [("int8", True),
                                              ("float32", True),
                                              ("int8", False)])
def test_spec_decode_step_matches_jax(fused, kv_dtype, kernels):
    """One verify of D=4 rows in 3 slots at different positions (one
    parked at 0), with the kernel bundles (JAX: Pallas in interpret mode,
    the port: the plain versions on the CPU) and without them."""
    jc, jp, tc, tp = fused
    B, D = 3, 4
    jcache, tcache = _prefilled(fused, kv_dtype, B, [3, 9, 100, 17, 5, 44])
    batch = np.array([[7, 11, 13, 2], [5, 19, 23, 29], [1, 2, 3, 4]],
                     np.int32)
    pos = np.array([6, 4, 0], np.int32)

    jkw = {}
    if kernels:
        jkb = j_select(jcfg.EngineConfig(compute_dtype="float32",
                                         kv_dtype=kv_dtype,
                                         pallas_interpret=True),
                       jnp.float32, jc.max_seq_len, jnp.dtype(kv_dtype),
                       n_layers=jc.n_layers,
                       n_kv_bytes=jc.kv_dim * jnp.dtype(kv_dtype).itemsize)
        jkw = dict(mm=jkb.mm, mm_idx=jkb.mm_idx,
                   attn_sbidx=make_attn_spec_batched(interpret=True),
                   spec_writer=make_spec_writer(interpret=True))
    want, jcache = jb.spec_decode_step(jc, jp, jnp.asarray(batch),
                                       jnp.asarray(pos), jcache,
                                       compute_dtype=jnp.float32, **jkw)
    tkw = {}
    if kernels:
        tkb = t_select("cpu", tcfg.EngineConfig(compute_dtype="float32",
                                                kv_dtype=kv_dtype),
                       torch.float32)
        assert tkb.attn_sbidx is not None and tkb.spec_writer is not None
        tkw = dict(mm=tkb.mm, mm_idx=tkb.mm_idx, attn_sbidx=tkb.attn_sbidx,
                   spec_writer=tkb.spec_writer)
    got, tcache = tb.spec_decode_step(tc, tp, torch.tensor(batch),
                                      torch.tensor(pos), tcache,
                                      compute_dtype=torch.float32, **tkw)
    assert got.shape == (B, D, CFG["vocab_size"])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    _check_caches(jcache, tcache)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_spec_decode_step_matches_sequential(fused, kv_dtype):
    """Verify row d equals the d-th of D sequential decode steps fed the
    same tokens (``test_spec_batching.py:22-52`` on the port), through the
    port's kernel bundle; the caches end equal."""
    _, _, tc, tp = fused
    B, D = 2, 4
    _, cache_a = _prefilled(fused, kv_dtype, B, [3, 9, 100, 17])
    cache_b = tb.BatchedKVCache(*(None if t is None else t.clone() for t in
                                  (cache_a.k, cache_a.v, cache_a.k_scale,
                                   cache_a.v_scale)))
    kb = t_select("cpu", tcfg.EngineConfig(compute_dtype="float32",
                                           kv_dtype=kv_dtype), torch.float32)
    batch = torch.tensor([[7, 11, 13, 2], [5, 19, 23, 29]], dtype=torch.int32)
    pos0 = torch.tensor([4, 4], dtype=torch.int32)
    spec, _ = tb.spec_decode_step(tc, tp, batch, pos0, cache_a, mm=kb.mm,
                                  mm_idx=kb.mm_idx, attn_sbidx=kb.attn_sbidx,
                                  spec_writer=kb.spec_writer,
                                  compute_dtype=torch.float32)
    seq = []
    for d in range(D):
        lg, _ = tb.decode_step(tc, tp, batch[:, d], pos0 + d, cache_b,
                               mm=kb.mm, mm_idx=kb.mm_idx,
                               attn_bidx=kb.attn_bidx, kv_writer=kb.kv_writer,
                               compute_dtype=torch.float32)
        seq.append(lg)
    np.testing.assert_allclose(spec.numpy(), torch.stack(seq, 1).numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(cache_a.k.float().numpy(),
                               cache_b.k.float().numpy(), rtol=1e-5,
                               atol=1e-5)


def test_ngram_draft_matches_jax():
    """Random histories over a small vocabulary (so n-grams recur), every
    length from below n to the full row: drafts equal bit for bit."""
    rng = np.random.default_rng(0)
    for n, D in ((3, 4), (2, 2), (3, 8)):
        B, H = 16, 40
        hist = rng.integers(0, 4, size=(B, H)).astype(np.int32)
        hlen = rng.integers(1, H + 1, size=B).astype(np.int32)
        hlen[:3] = (1, n, H)
        want = jsb.ngram_draft_batched(jnp.asarray(hist), jnp.asarray(hlen),
                                       n, D)
        got = tsb.ngram_draft_batched(torch.tensor(hist), torch.tensor(hlen),
                                      n, D)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("widths", [None, (4, 2), (2, 4, 8)])
def test_tuner_arm_sequence_matches_jax(widths):
    """Both tuners fed the same throughput for every chunk they choose
    (a drifting, then flipping workload) choose the same arms."""
    rng = np.random.default_rng(1)
    tj = jsb.SpecAutoTuner(probe_every=4, widths=widths)
    tt = tsb.SpecAutoTuner(probe_every=4, widths=widths)
    assert tt.arms == tj.arms
    speed = {a: 100.0 + 40 * a for a in tj.arms}
    arms = []
    for i in range(300):
        a = tt.choose()
        assert a == tj.choose()
        arms.append(a)
        if i == 150:
            speed = {a: 300.0 - 40 * a for a in tj.arms}
        tps = speed[a] * (1 + 0.2 * rng.random())
        for t in (tj, tt):
            t.record(a, int(tps), 1.0)
    assert len(set(arms)) == len(tj.arms)
    assert tt.ema == tj.ema


def test_onehot_accept_preserves_target():
    """The sampled round as the engine runs it (``build_spec_chunk``): many
    slots, one round of D=2 over fixed logits and drafts drawn from an
    arbitrary distribution.  The first emitted token's marginal equals the
    target p (``test_spec_batching.py:293-315``); a greedy slot emits the
    argmax."""
    V, N = 6, 40000
    rng = np.random.default_rng(0)
    p = rng.random(V)
    p /= p.sum()
    d = rng.random(V)
    d /= d.sum()
    ys = torch.tensor(rng.choice(V, size=N, p=d), dtype=torch.int32)
    lg = torch.log(torch.tensor(p, dtype=torch.float32))

    def verify(pending, pos, hist):
        logits = lg.expand(N, 2, V).clone()
        logits[0, 0] = torch.tensor([0.0, 0, 5.0, 0, 0, 0])  # greedy slot
        return torch.stack([ys, ys], dim=1), logits

    gens = []
    for b in range(N):
        g = torch.Generator()
        g.manual_seed(b)
        gens.append(g)
    temps = torch.ones(N)
    temps[0] = 0.0
    chunk = tsb.build_spec_chunk(verify, 2, greedy=False)
    gs, accs, pending, pos = chunk(
        torch.zeros(N, dtype=torch.int32), torch.zeros(N, dtype=torch.int32),
        torch.zeros((N, 8), dtype=torch.int32), gens, temps, torch.ones(N), 1)
    assert int(gs[0, 0, 0]) == 2
    emp = np.bincount(gs[0, 1:, 0].numpy(), minlength=V) / (N - 1)
    np.testing.assert_allclose(emp, p, atol=1e-2)
    a = accs[0].numpy()
    np.testing.assert_array_equal(pos.numpy(), a + 1)
    np.testing.assert_array_equal(
        pending.numpy(), gs[0].numpy()[np.arange(N), a])


def test_mixed_sampling(models):
    """Greedy and sampled slots in one batch run the sampled rounds: the
    greedy request equals plain serving bit for bit, the sampled one
    completes in range and repeats for fixed seeds (``spec_auto=False``:
    the chunk kinds, and so the noise stream, do not depend on timing)."""
    _, _, tc, tp = models
    ec = tcfg.EngineConfig(max_seq_len=128, max_batch_size=3,
                           compute_dtype="float32")
    base = TEngine(tc, tp, TTokenizer().finalize(), ec, decode_chunk=8,
                   device="cpu")
    g1 = base.submit([1, 5, 9, 13], max_new_tokens=14, temperature=0.0,
                     stop_tokens=())
    base.run()

    def run_spec():
        spec = tsb.SpecBatchedEngine(tc, tp, TTokenizer().finalize(), ec,
                                     decode_chunk=8, width=4,
                                     rounds_per_chunk=2, spec_auto=False,
                                     device="cpu")
        a = spec.submit([1, 5, 9, 13], max_new_tokens=14, temperature=0.0,
                        stop_tokens=())
        b = spec.submit([2, 4, 6], max_new_tokens=10, temperature=0.8,
                        topp=0.9, seed=7, stop_tokens=())
        spec.run()
        return a.output_tokens, b.output_tokens, spec.spec_drafted

    a1, b1, drafted = run_spec()
    a2, b2, _ = run_spec()
    assert a1 == g1.output_tokens
    assert (a1, b1) == (a2, b2)
    assert len(b1) == 10 and all(0 <= t < CFG["vocab_size"] for t in b1)
    assert drafted > 0
