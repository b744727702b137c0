"""The slice as a whole: the port's ``prefill_many`` + ``decode_step`` and
its ``BatchedEngine`` against the JAX package's, on the same weights (the
JAX ``random_params`` leaves handed over as numpy through
``params_from_numpy``).  The JAX side runs its Pallas kernels in interpret
mode; the port runs on the CPU, where every kernel wrapper takes its plain
version.  f32 compute: logits within 2e-5, greedy tokens equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
from fastllama_tpu.models import batched as jb
from fastllama_tpu.models import llama as jl
from fastllama_tpu.runtime.batching import BatchedEngine as JEngine
from fastllama_tpu.runtime.kernels import select_kernels as j_select
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer as TTokenizer
from fastllama_tpu_torch.models import batched as tb
from fastllama_tpu_torch.models import llama as tl
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
CFG = dict(dim=256, hidden_dim=512, n_layers=4, n_heads=8, n_kv_heads=4,
           vocab_size=1024, max_seq_len=128)


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


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, CFG["vocab_size"], size=n).tolist()
            for n in lengths]


@pytest.mark.parametrize("kv_dtype,kernels", [("int8", True),
                                              ("float32", True),
                                              ("int8", False)])
def test_prefill_decode_logits_match(models, kv_dtype, kernels):
    """Per-step logits of one prefill wave (duplicate slot padding
    included) and teacher-forced decode steps through every slot, with
    the kernel bundles, and without them (plain matmul, dequantized
    layer slices, per-slot cache writes) on both sides."""
    jc, jp, tc, tp = models
    jpf, tpf = jl.fuse_params(jc, jp), tl.fuse_params(tc, tp)
    B, T = 4, 32
    lens = np.array([20, 7, 32, 7], np.int32)
    toks = np.zeros((B, T), np.int32)
    for i, p in enumerate(_prompts(0, lens[:3])):
        toks[i, :len(p)] = p
    toks[3] = toks[1]                                  # padding duplicate
    slots = np.array([2, 0, 3, 0], np.int32)
    steps = np.random.default_rng(1).integers(3, CFG["vocab_size"],
                                              size=(3, B)).astype(np.int32)
    pos0 = np.zeros(B, np.int32)
    pos0[slots] = lens                                 # slot 1 stays idle

    jec = jcfg.EngineConfig(compute_dtype="float32", kv_dtype=kv_dtype,
                            pallas_interpret=True)
    jkb = j_select(jec, jnp.float32, jc.max_seq_len, jnp.dtype(kv_dtype),
                   n_layers=jc.n_layers,
                   n_kv_bytes=jc.kv_dim * jnp.dtype(kv_dtype).itemsize)
    assert jkb.attn_bidx is not None and jkb.kv_writer is not None
    jkw = (dict(mm=jkb.mm, mm_idx=jkb.mm_idx) if kernels else {})
    cache = jb.BatchedKVCache.create(jc, B, dtype=jnp.dtype(kv_dtype))
    lg, cache = jb.prefill_many(jc, jpf, jnp.asarray(toks), jnp.asarray(lens),
                                jnp.asarray(slots), cache,
                                slot_writer=jkb.slot_writer if kernels
                                else None, compute_dtype=jnp.float32, **jkw)
    want, caches = [np.asarray(lg)], [cache]
    pos = jnp.asarray(pos0)
    for s in range(len(steps)):
        lg, cache = jb.decode_step(
            jc, jpf, jnp.asarray(steps[s]), pos, cache,
            attn_bidx=jkb.attn_bidx if kernels else None,
            kv_writer=jkb.kv_writer if kernels else None,
            compute_dtype=jnp.float32, **jkw)
        want.append(np.asarray(lg))
        caches.append(cache)
        pos = pos + 1

    tec = tcfg.EngineConfig(compute_dtype="float32", kv_dtype=kv_dtype)
    tkb = t_select("cpu", tec, torch.float32)
    tkw = (dict(mm=tkb.mm, mm_idx=tkb.mm_idx) if kernels else {})
    tcache = tb.BatchedKVCache.create(tc, B, dtype=kv_dtype, device="cpu")
    lg, tcache = tb.prefill_many(tc, tpf, torch.tensor(toks),
                                 torch.tensor(lens), torch.tensor(slots),
                                 tcache, slot_writer=tkb.slot_writer
                                 if kernels else None,
                                 compute_dtype=torch.float32, **tkw)
    got = [lg.numpy()]
    _sync_caches(caches[0], tcache)
    pos = torch.tensor(pos0)
    for s in range(len(steps)):
        lg, tcache = tb.decode_step(
            tc, tpf, torch.tensor(steps[s]), pos, tcache,
            attn_bidx=tkb.attn_bidx if kernels else None,
            kv_writer=tkb.kv_writer if kernels else None,
            compute_dtype=torch.float32, **tkw)
        got.append(lg.numpy())
        _sync_caches(caches[s + 1], tcache)
        pos = pos + 1
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, err_msg=f"step {s}", **F32)


def _sync_caches(jcache, tcache):
    """Check the port's cache against the JAX one, then give the port the
    JAX bytes, so that every step starts from the same state.  An int8 row
    may round one element the other way: its f32 input differs in the last
    bits (a different summation order), and one quantum moves the logits
    by more than the f32 tolerance."""
    for name in ("k", "v", "k_scale", "v_scale"):
        a, t = getattr(jcache, name), getattr(tcache, name)
        if a is None:
            continue
        a = np.asarray(a)
        if a.dtype == np.int8:
            d = np.abs(t.numpy().astype(np.int32) - a.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-4, name
        else:
            np.testing.assert_allclose(t.numpy(), a, err_msg=name, **F32)
        t.copy_(torch.from_numpy(a.copy()))


_COMMON = dict(max_batch_size=3, compute_dtype="float32")


def _jax_engine(models, kv_dtype, **ec_kw):
    jc, jp, _, _ = models
    return JEngine(jc, jp, JTokenizer().finalize(),
                   jcfg.EngineConfig(pallas_interpret=True, kv_dtype=kv_dtype,
                                     **_COMMON, **ec_kw), decode_chunk=4)


def _port_engine(models, kv_dtype, **ec_kw):
    _, _, tc, tp = models
    return TEngine(tc, tp, TTokenizer().finalize(),
                   tcfg.EngineConfig(kv_dtype=kv_dtype, **_COMMON, **ec_kw),
                   decode_chunk=4, device="cpu")


@pytest.mark.parametrize("kv_dtype", ["int8", "float32"])
def test_engine_greedy_tokens_match(models, kv_dtype):
    """Five requests of mixed prompt and output lengths through three
    slots (staggered admission), one stopped early by a stop token."""
    prompts = _prompts(2, (3, 10, 40, 7, 20))
    budgets = (6, 12, 9, 15, 5)
    # a stop token that request 1 meets early, found on the port alone
    probe = _port_engine(models, kv_dtype)
    first = [probe.submit(p, max_new_tokens=n, stop_tokens=())
             for p, n in zip(prompts, budgets)]
    probe.run()
    stop = first[1].output_tokens[3]
    assert stop not in first[1].output_tokens[:3]

    out = {}
    for side, make in (("jax", _jax_engine), ("port", _port_engine)):
        eng = make(models, kv_dtype)
        reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0,
                           stop_tokens=(stop,))
                for p, n in zip(prompts, budgets)]
        eng.run()
        assert all(r.done for r in reqs)
        out[side] = [r.output_tokens for r in reqs]
    assert out["port"] == out["jax"]
    assert out["port"][1][-1] == stop and len(out["port"][1]) == 4


@pytest.mark.parametrize("kv_dtype", ["int8", "float32"])
def test_engine_unfused_greedy_tokens_match(models, kv_dtype):
    """``fuse_weights=False``, the weights ``bench.py`` serves its
    speculative and long-context metrics with (separate Q, K, V, gate and
    up projections): staggered requests through three slots, token for
    token against the JAX engine."""
    prompts = _prompts(3, (9, 30, 4, 17))
    budgets = (10, 6, 12, 8)
    out = {}
    for side, make in (("jax", _jax_engine), ("port", _port_engine)):
        eng = make(models, kv_dtype, fuse_weights=False)
        assert eng.params.wk is not None and eng.params.w3 is not None
        reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0,
                           stop_tokens=())
                for p, n in zip(prompts, budgets)]
        eng.run()
        out[side] = [r.output_tokens for r in reqs]
    assert out["port"] == out["jax"]
    assert [len(t) for t in out["port"]] == list(budgets)
