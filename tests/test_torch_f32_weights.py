"""Unquantized (``QuantType.NONE``) f32 weights in the port, held against
the JAX package: ``random_params`` (layout and recipe against JAX's), the
batched model steps on ``tests/test_batching.py:128-180``'s cases, the
deferred steps on ``tests/test_deferred_kv.py:30-90``'s, and the
``BatchedEngine`` (plain and deferred chunks) and single-stream
``Engine`` against the JAX engines (their Pallas kernels in interpret
mode).  The JAX weights are handed over as numpy.  On such weights both
packages route every matmul to the plain product; the attention and
KV-write kernels still run (their plain versions here, on the CPU).  f32
compute: logits within 1e-4 of max|ref| (another summation order), greedy
tokens equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
from fastllama_tpu.loaders.tokenizer import \
    build_byte_fallback_vocab as j_vocab
from fastllama_tpu.models import batched as jb
from fastllama_tpu.models import llama as jl
from fastllama_tpu.ops.pallas.flash_decode import \
    make_attn_batched_flash_stats as j_make_attn_stats
from fastllama_tpu.ops.pallas.kv_write import \
    make_spec_writer as j_make_spec_writer
from fastllama_tpu.runtime.batching import BatchedEngine as JBatched
from fastllama_tpu.runtime.engine import Engine as JEngine
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer as TTokenizer
from fastllama_tpu_torch.loaders.tokenizer import \
    build_byte_fallback_vocab as t_vocab
from fastllama_tpu_torch.models import batched as tb
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.quant.groupquant import QArray, dequantize
from fastllama_tpu_torch.runtime.batching import BatchedEngine as TBatched
from fastllama_tpu_torch.runtime.engine import Engine as TEngine
from fastllama_tpu_torch.runtime.kernels import select_kernels
from tests.test_torch_model import to_port


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here run many tiny ops: one intra-op thread keeps them
    fast when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-4
# tests/test_batching.py:_tiny_cfg; S = 64 as tests/test_deferred_kv.py:_cfg
TINY = dict(dim=32, hidden_dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            vocab_size=96, max_seq_len=24, group_size=8)
DEFER = dict(TINY, max_seq_len=64)


def _models(kw, seed=3):
    jc = jcfg.ModelConfig(**kw, quant_type=jcfg.QuantType.NONE)
    tc = tcfg.ModelConfig(**kw, quant_type=tcfg.QuantType.NONE)
    jp = jl.random_params(jc, seed=seed, qtype=jcfg.QuantType.NONE)
    return jc, jp, tc, to_port(tc, jp)


def _close(got, want, label=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=label)


# -- random_params ------------------------------------------------------------

@pytest.mark.parametrize("qtype", ["NONE", "INT8", "INT16", "INT4"])
def test_random_params_layout_matches_jax(qtype):
    """Every field's kind, shape, dtype and quant flags equal JAX's
    ``random_params``; plain f32 at NONE, unpacked at INT4."""
    kw = dict(TINY, dim=128, hidden_dim=256, group_size=64)
    jp = jl.random_params(jcfg.ModelConfig(**kw), seed=1,
                          qtype=jcfg.QuantType[qtype])
    tp = tl.random_params(tcfg.ModelConfig(**kw), seed=1,
                          qtype=tcfg.QuantType[qtype], device="cpu")
    for f in dataclasses.fields(jp):
        jv, tv = getattr(jp, f.name), getattr(tp, f.name)
        if hasattr(jv, "scales"):
            assert isinstance(tv, QArray), f.name
            assert (tv.qtype.name, tv.group_size, tv.group_axis,
                    tv.packed) == (jv.qtype.name, jv.group_size,
                                   jv.group_axis, jv.packed), f.name
            pairs = ((tv.data, jv.data), (tv.scales, jv.scales))
        else:
            assert isinstance(tv, torch.Tensor), f.name
            pairs = ((tv, jv),)
        for t, j in pairs:
            assert tuple(t.shape) == tuple(j.shape), f.name
            assert str(t.dtype)[6:] == str(np.asarray(j).dtype), f.name
            assert t.is_contiguous(), f.name


def test_random_params_recipe():
    """NONE: normal x scale, and ``random_params_int(NONE)`` is the same
    call.  Quantized from the same seed, each weight dequantizes to the
    f32 one within its group's truncation step (scale = max|group| / QF),
    along the contraction axis for the projections."""
    cfg = tcfg.ModelConfig(**dict(TINY, dim=128, hidden_dim=256,
                                  group_size=64))
    f = tl.random_params(cfg, seed=4, qtype=tcfg.QuantType.NONE,
                         scale=0.05, device="cpu")
    again = tl.random_params_int(cfg, seed=4, qtype=tcfg.QuantType.NONE,
                                 scale=0.05, device="cpu")
    for fld in dataclasses.fields(f):
        assert torch.equal(getattr(f, fld.name), getattr(again, fld.name))
    assert abs(float(f.w1.std()) - 0.05) < 0.005
    assert torch.equal(f.attn_norm, torch.ones_like(f.attn_norm))
    for qt in (tcfg.QuantType.INT8, tcfg.QuantType.INT4):
        q = tl.random_params(cfg, seed=4, qtype=qt, scale=0.05,
                             device="cpu")
        for name, w in q.quantized().items():
            ref = getattr(f, name)
            step = w.scales.float().abs().amax()
            err = (dequantize(w) - ref).abs().max()
            assert float(err) <= float(step) * (1 + 1e-6), (qt, name)


# -- the batched model steps (tests/test_batching.py:128-180) ---------------

def _port_bundle(**ec):
    return select_kernels("cpu", tcfg.EngineConfig(compute_dtype="float32",
                                                   **ec), torch.float32)


def test_decode_step_matches_jax():
    """Each prompt prefilled into its slot, then four joint greedy decode
    steps: logits of every step against JAX's, tokens equal; the port
    through its kernel bundle (K2 and K3, plain versions here)."""
    jc, jp, tc, tp = _models(TINY)
    kb = _port_bundle()
    B = 3
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, TINY["vocab_size"], size=n).tolist()
               for n in (3, 5, 2)]
    jcache = jb.BatchedKVCache.create(jc, B)
    tcache = tb.BatchedKVCache.create(tc, B, device="cpu")
    jpend, tpend = [], []
    for b, p in enumerate(prompts):
        want, jcache = jb.prefill_into_slot(jc, jp, jnp.asarray(p, jnp.int32),
                                            len(p), b, jcache,
                                            compute_dtype=jnp.float32)
        got, tcache = tb.prefill_into_slot(
            tc, tp, torch.tensor(p), len(p), b, tcache, mm=kb.mm,
            mm_idx=kb.mm_idx, compute_dtype=torch.float32)
        _close(got, want, f"prefill slot {b}")
        jpend.append(int(jnp.argmax(want)))
        tpend.append(int(torch.argmax(got)))
    assert tpend == jpend
    pos = np.array([len(p) for p in prompts], np.int32)
    for step in range(4):
        want, jcache = jb.decode_step(jc, jp, jnp.asarray(jpend, jnp.int32),
                                      jnp.asarray(pos), jcache,
                                      compute_dtype=jnp.float32)
        got, tcache = tb.decode_step(
            tc, tp, torch.tensor(tpend), torch.tensor(pos), tcache,
            mm=kb.mm, mm_idx=kb.mm_idx, attn_bidx=kb.attn_bidx,
            kv_writer=kb.kv_writer, compute_dtype=torch.float32)
        _close(got, want, f"decode step {step}")
        jpend = np.asarray(jnp.argmax(want, axis=-1)).tolist()
        tpend = torch.argmax(got, dim=-1).tolist()
        assert tpend == jpend
        pos += 1
    _close(tcache.k, jcache.k, "cache k")


def test_prefill_pads_are_harmless():
    """A prompt padded past its length (bucket 8) gives the unpadded last
    logits, and JAX's."""
    jc, jp, tc, tp = _models(TINY, seed=5)
    toks = [5, 9, 2]
    want, _ = jb.prefill_into_slot(jc, jp, jnp.asarray(toks, jnp.int32), 3,
                                   0, jb.BatchedKVCache.create(jc, 2),
                                   compute_dtype=jnp.float32)
    for padded in (toks, toks + [7] * 5):
        got, _ = tb.prefill_into_slot(
            tc, tp, torch.tensor(padded), 3, 0,
            tb.BatchedKVCache.create(tc, 2, device="cpu"),
            compute_dtype=torch.float32)
        _close(got, want, f"T={len(padded)}")


# -- deferred steps (tests/test_deferred_kv.py:30-90) ------------------------

@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_deferred_steps_match_jax(kv_dtype):
    """K = 4 teacher-forced deferred steps from the same prefilled cache:
    logits of each step against JAX's deferred steps, and the landed cache
    against JAX's (an int8 element within one quantum)."""
    jc, jp, tc, tp = _models(DEFER)
    B, K = 3, 4
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, DEFER["vocab_size"], size=n).tolist()
               for n in (3, 5, 2)]
    tokens = rng.integers(1, DEFER["vocab_size"], size=(K, B)).astype(
        np.int32)
    pos0 = np.array([len(p) for p in prompts], np.int32)
    jcache = jb.BatchedKVCache.create(jc, B, dtype=jnp.dtype(kv_dtype))
    for b, p in enumerate(prompts):
        _, jcache = jb.prefill_into_slot(jc, jp, jnp.asarray(p, jnp.int32),
                                         len(p), b, jcache,
                                         compute_dtype=jnp.float32)
    tcache = tb.BatchedKVCache.create(tc, B, dtype=kv_dtype, device="cpu")
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(tcache, name) is not None:
            getattr(tcache, name).copy_(torch.from_numpy(
                np.asarray(getattr(jcache, name)).copy()))

    staged = jb.make_staged(jc, jcache, B, K)
    j_stats = j_make_attn_stats(interpret=True)
    kb = _port_bundle(kv_dtype=kv_dtype)
    t_staged = tb.make_staged(tc, tcache, B, K)
    for s in range(K):
        want, staged = jb.decode_step_deferred(
            jc, jp, jnp.asarray(tokens[s]), jnp.asarray(pos0), jnp.int32(s),
            staged, jcache, attn_stats=j_stats, compute_dtype=jnp.float32)
        got, t_staged = tb.decode_step_deferred(
            tc, tp, torch.tensor(tokens[s]), torch.tensor(pos0), s, t_staged,
            tcache, attn_stats=kb.attn_stats, compute_dtype=torch.float32)
        _close(got, want, f"step {s}")
    j_landed = jb.land_staged(jcache, staged, jnp.asarray(pos0),
                              j_make_spec_writer(interpret=True))
    landed = tb.land_staged(tcache, t_staged, torch.tensor(pos0),
                            kb.spec_writer)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, t = getattr(j_landed, name), getattr(landed, name)
        if a is None:
            continue
        a = np.asarray(a)
        if a.dtype == np.int8:
            d = np.abs(t.numpy().astype(np.int32) - a.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, name
        else:
            _close(t, a, name)


# -- the engines --------------------------------------------------------------

ENG = dict(max_seq_len=64, max_batch_size=2, compute_dtype="float32")
PROMPTS = [[5, 17, 3], [60, 2, 33, 41, 8], [9, 9, 14]]


@pytest.fixture(scope="module")
def defer_models():
    return _models(DEFER)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("deferred", [False, True])
def test_batched_engine_matches_jax(defer_models, kv_dtype, deferred):
    """Three requests through two slots, 12 greedy tokens each: the port's
    ``BatchedEngine`` equals the JAX engine, with plain or deferred
    chunks on both sides."""
    jc, jp, tc, tp = defer_models
    ec = dict(ENG, kv_dtype=kv_dtype, deferred_kv=deferred)
    jeng = JBatched(jc, jp, JTokenizer().finalize(),
                    jcfg.EngineConfig(**ec, pallas_interpret=True),
                    decode_chunk=4)
    assert jeng._deferred_ok == deferred
    want = [r.output_tokens for r in jeng.generate_all(
        PROMPTS, max_new_tokens=12, temperature=0.0, stop_tokens=())]
    eng = TBatched(tc, tp, TTokenizer().finalize(), tcfg.EngineConfig(**ec),
                   decode_chunk=4, device="cpu")
    got = [r.output_tokens for r in eng.generate_all(
        PROMPTS, max_new_tokens=12, temperature=0.0, stop_tokens=())]
    assert got == want and all(len(t) == 12 for t in got)
    assert (eng.deferred_chunks > 0) == deferred


V = 512
SINGLE = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=V, max_seq_len=64, group_size=16)
EXTRA = [f"w{i}" for i in range(V - 259)]


def test_engine_matches_jax():
    """The single-stream ``Engine``: forward logits of a prefill and two
    decode steps through each engine's kernel hooks, then 20 greedy tokens
    in chunks of 8 (a tail of 4) and a two-turn ``ChatSession``, against
    the JAX engine."""
    from fastllama_tpu.runtime.engine import ChatSession as JChat
    from fastllama_tpu_torch import ChatSession as TChat
    jc, jp, tc, tp = _models(SINGLE, seed=11)
    ec = dict(compute_dtype="float32", kv_dtype="float32")
    je = JEngine(jc, jp, j_vocab(EXTRA),
                 jcfg.EngineConfig(pallas_interpret=True, **ec))
    te = TEngine(tc, tp, t_vocab(EXTRA), tcfg.EngineConfig(**ec),
                 device="cpu")
    toks = np.random.default_rng(0).integers(3, V, size=15).astype(np.int32)
    tk = te.kernels
    jh = dict(mm=je._mm, mm_idx=je._mm_idx, attn=je._attn,
              attn_idx=je._attn_idx, compute_dtype=jnp.float32)
    th = dict(mm=tk.mm, mm_idx=tk.mm_idx, attn=tk.attn,
              attn_idx=tk.attn_idx, compute_dtype=torch.float32)
    jcache, tcache = jl.KVCache.create(jc), tl.KVCache.create(tc,
                                                              device="cpu")
    for p0, p1 in ((0, 13), (13, 14), (14, 15)):
        want, jcache = jl.forward(jc, je.params, jnp.asarray(toks[p0:p1]),
                                  p0, jcache, **{k: v for k, v in jh.items()
                                                 if v is not None})
        got, tcache = tl.forward(tc, te.params, torch.tensor(toks[p0:p1]),
                                 p0, tcache, **{k: v for k, v in th.items()
                                                if v is not None})
        _close(got, want, f"forward at {p0}")
    p = toks.tolist()[:11]
    want, _ = je.generate(p, max_new_tokens=20, decode_chunk=8,
                          stop_tokens=())
    got, _ = te.generate(p, max_new_tokens=20, decode_chunk=8,
                         stop_tokens=())
    assert got == want and len(got) == 20
    replies = {}
    for name, sess in (("jax", JChat(je, "w5 w9")), ("port", TChat(te,
                                                                   "w5 w9"))):
        replies[name] = [(sess.generate(turn, max_new_tokens=8,
                                        temperature=0.0), sess.pos)
                         for turn in ("w3w17 w40", "w100w2")]
    assert replies["port"] == replies["jax"]
