"""The single-stream model and its satellites against the JAX package:
``models.llama.forward`` (f32 logits within 2e-5 of the JAX ``forward`` on
the same weights, handed over as numpy through ``params_from_numpy``),
``KVCache``, ``qmatmul_parity``, the samplers and ``resolve_scale_dtype``.
The JAX side runs its Pallas hooks in interpret mode; the port runs on the
CPU, where every kernel wrapper takes its plain version."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.models import llama as jl
from fastllama_tpu.ops import qmatmul as jqm
from fastllama_tpu.ops import sampling as jsamp
from fastllama_tpu.ops.pallas.flash_decode import make_attn_indexed_flash
from fastllama_tpu.ops.pallas.qmm import make_mm, make_mm_indexed
from fastllama_tpu.quant import groupquant as jq
from fastllama_tpu.runtime import sampler as jsampler
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.ops import qmatmul as tqm
from fastllama_tpu_torch.ops import sampling as tsamp
from fastllama_tpu_torch.quant import groupquant as tq
from fastllama_tpu_torch.runtime import sampler as tsampler
from fastllama_tpu_torch.runtime.kernels import select_kernels


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast when the suite's
    workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(rtol=2e-5, atol=2e-5)
CFG = dict(dim=256, hidden_dim=512, n_layers=4, n_heads=8, n_kv_heads=4,
           vocab_size=1024, max_seq_len=128)


def to_port(tc, jp):
    """The JAX package's parameters as the port's (numpy in between)."""
    arrays, flags = {}, {}
    for f in dataclasses.fields(jp):
        v = getattr(jp, f.name)
        if hasattr(v, "scales"):
            arrays[f.name] = (np.asarray(v.data), np.asarray(v.scales))
            flags[f.name] = dict(qtype=v.qtype.name, group_size=v.group_size,
                                 group_axis=v.group_axis, packed=v.packed)
        else:
            arrays[f.name] = None if v is None else np.asarray(v)
    return tl.params_from_numpy(tc, arrays, flags, device="cpu")


@pytest.fixture(scope="module")
def models():
    jc = jcfg.ModelConfig(**CFG, quant_type=jcfg.QuantType.INT8)
    tc = tcfg.ModelConfig(**CFG, quant_type=tcfg.QuantType.INT8)
    jp = jl.fuse_params(jc, jl.random_params(jc, seed=5,
                                             qtype=jcfg.QuantType.INT8))
    return jc, jp, tc, to_port(tc, jp)


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(
        3, CFG["vocab_size"], size=n).astype(np.int32)


def _jax_hooks():
    return dict(mm=make_mm(jnp.float32, interpret=True),
                mm_idx=make_mm_indexed(jnp.float32, interpret=True),
                attn_idx=make_attn_indexed_flash(interpret=True),
                compute_dtype=jnp.float32)


def _port_hooks(**ec):
    kb = select_kernels("cpu", tcfg.EngineConfig(compute_dtype="float32",
                                                 **ec), torch.float32)
    return dict(mm=kb.mm, attn=kb.attn, mm_idx=kb.mm_idx,
                attn_idx=kb.attn_idx, compute_dtype=torch.float32)


def test_forward_prefill_and_decode_match_jax(models):
    """A 12-token prefill at pos 0, then three decode steps, each through
    the layer-indexed hooks (K1f glue, K2 non-fresh) on both sides."""
    jc, jp, tc, tp = models
    toks = _tokens(0, 15)
    jcache = jl.KVCache.create(jc)
    tcache = tl.KVCache.create(tc, device="cpu")
    jh, th = _jax_hooks(), _port_hooks()
    want, jcache = jl.forward(jc, jp, jnp.asarray(toks[:12]), 0, jcache, **jh)
    got, tcache = tl.forward(tc, tp, torch.tensor(toks[:12]), 0, tcache, **th)
    assert got.shape == (12, CFG["vocab_size"]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **F32)
    for p in range(12, 15):
        want, jcache = jl.forward(jc, jp, jnp.asarray(toks[p:p + 1]), p,
                                  jcache, **jh)
        got, tcache = tl.forward(tc, tp, torch.tensor(toks[p:p + 1]), p,
                                 tcache, **th)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"pos {p}", **F32)


def test_incremental_decode_equals_prefill(models):
    """Prefill 5 tokens then decode 5 one by one (positions passed as a
    device tensor, as the decode chunk does) = one 10-token prefill."""
    _, _, tc, tp = models
    toks = torch.tensor(_tokens(1, 10))
    th = _port_hooks()
    full, _ = tl.forward(tc, tp, toks, 0, tl.KVCache.create(tc, device="cpu"),
                         **th)
    cache = tl.KVCache.create(tc, device="cpu")
    tl.forward(tc, tp, toks[:5], 0, cache, **th)
    positions = torch.arange(5, 10, dtype=torch.int32)
    for p in range(5, 10):
        step, _ = tl.forward(tc, tp, toks[p:p + 1], p, cache,
                             positions=positions[p - 5:p - 4], **th)
        np.testing.assert_allclose(step[0].numpy(), full[p].numpy(),
                                   err_msg=f"pos {p}", **F32)


def test_fused_equals_unfused_and_hooks_equal_plain(models):
    """Unfused weights (separate QKV and gate/up: the glue runs outside
    the matmul but for the residual) and the plain default hooks (qmatmul
    on w[l], gqa_attention on the layer's cache) give the fused kernel
    bundle's logits; so does the flash_attention=False bundle."""
    jc, _, tc, tp = models
    unf = to_port(tc, jl.random_params(jc, seed=5,
                                       qtype=jcfg.QuantType.INT8))
    toks = torch.tensor(_tokens(2, 9))
    ref, _ = tl.forward(tc, tp, toks, 0, tl.KVCache.create(tc, device="cpu"),
                        **_port_hooks())
    runs = [(unf, _port_hooks()), (tp, dict(compute_dtype=torch.float32)),
            (tp, _port_hooks(flash_attention=False)),
            (tp, _port_hooks(use_pallas=False))]
    for params, hooks in runs:
        got, _ = tl.forward(tc, params, toks, 0,
                            tl.KVCache.create(tc, device="cpu"), **hooks)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **F32)
    # one decode step after a prefill, the same way
    for params, hooks in runs:
        cache = tl.KVCache.create(tc, device="cpu")
        tl.forward(tc, params, toks[:8], 0, cache, **hooks)
        got, _ = tl.forward(tc, params, toks[8:], 8, cache, **hooks)
        np.testing.assert_allclose(got[0].numpy(), ref[8].numpy(), **F32)


def test_forward_last_index_and_logits_at(models):
    jc, jp, tc, tp = models
    toks = _tokens(3, 16)
    want, _ = jl.forward(jc, jp, jnp.asarray(toks), 0, jl.KVCache.create(jc),
                         last_index=10)
    got, _ = tl.forward(tc, tp, torch.tensor(toks), 0,
                        tl.KVCache.create(tc, device="cpu"), last_index=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    full, _ = tl.forward(tc, tp, torch.tensor(toks), 0,
                         tl.KVCache.create(tc, device="cpu"))
    np.testing.assert_allclose(tl.logits_at(full, 11).numpy(),
                               got[0].numpy(), **F32)


def test_kv_cache_rules(models):
    _, _, tc, tp = models
    with pytest.raises(ValueError):
        tl.KVCache.create(tc, dtype="int8", device="cpu")
    c = tl.KVCache.create(tc, max_seq_len=16, dtype="bfloat16", device="cpu")
    assert c.k.shape == (4, 4, 16, 32) and c.k.dtype == torch.bfloat16
    with pytest.raises(ValueError):               # rows [10, 19) past 16
        tl.forward(tc, tp, torch.tensor(_tokens(4, 9)), 10, c)


@pytest.mark.parametrize("qname", ["INT8", "INT16"])
def test_qmatmul_parity_matches_jax(qname):
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((128, 256)) * 0.05).astype(np.float32)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    jw = jq.quantize(jnp.asarray(w), jcfg.QuantType[qname], 64)
    jw = jq.QArray(jnp.swapaxes(jw.data, 0, 1), jnp.swapaxes(jw.scales, 0, 1),
                   jw.qtype, 64, group_axis=-2)
    tw = tq.QArray(torch.tensor(np.asarray(jw.data)),
                   torch.tensor(np.asarray(jw.scales)),
                   tcfg.QuantType[qname], 64, group_axis=-2)
    want = jqm.qmatmul_parity(jnp.asarray(x), jw)
    got = tqm.qmatmul_parity(torch.tensor(x), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("temperature,top_p", [(0.8, 0.9), (1.3, 0.5),
                                               (0.7, 1.0), (1.0, 0.0)])
def test_nucleus_dist_matches_jax(temperature, top_p):
    logits = np.random.default_rng(7).standard_normal((3, 200)).astype(
        np.float32) * 3
    want = jsamp.nucleus_dist(jnp.asarray(logits), temperature, top_p)
    got = tsamp.nucleus_dist(torch.tensor(logits), temperature, top_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_sample_draws_follow_nucleus_dist():
    """4,000 draws of ``sample`` against ``nucleus_dist``: every draw
    inside the nucleus, frequencies within 5 standard errors; temperature
    0 is the argmax."""
    logits = torch.tensor(np.random.default_rng(8).standard_normal(
        40).astype(np.float32) * 2)
    p = tsamp.nucleus_dist(logits, 0.9, 0.8).numpy()
    gen = torch.Generator()
    gen.manual_seed(0)
    n = 4000
    draws = np.array([int(tsamp.sample(logits, gen, 0.9, 0.8))
                      for _ in range(n)])
    assert (p[draws] > 0).all()
    freq = np.bincount(draws, minlength=40) / n
    se = np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p) <= 5 * se + 1e-3).all()
    assert int(tsamp.sample(logits, gen, 0.0, 0.8)) == int(logits.argmax())


def test_host_sampler_bit_equal_to_jax():
    """xorshift64* and the top-p host sampler draw exactly the JAX
    package's tokens (the constants of the JAX test included)."""
    a, b = jsampler.XorshiftRng(128391297), tsampler.XorshiftRng(128391297)
    assert [a.random_u32() for _ in range(5)] == \
        [b.random_u32() for _ in range(5)]
    s, M, ref = 128391297, (1 << 64) - 1, []
    for _ in range(3):
        s ^= s >> 12
        s = (s ^ (s << 25)) & M
        s ^= s >> 27
        ref.append(((s * 0x2545F4914F6CDD1D) & M) >> 32)
    rng = tsampler.XorshiftRng(128391297)
    assert [rng.random_u32() for _ in range(3)] == ref
    logits = np.random.default_rng(9).standard_normal((30, 64)).astype(
        np.float32) * 2
    for temperature, topp in ((0.8, 0.9), (1.0, 1.0), (0.0, 0.9)):
        js = jsampler.HostSampler(64, seed=42)
        ts = tsampler.HostSampler(64, seed=42)
        assert [js.sample(r, temperature, topp) for r in logits] == \
            [ts.sample(r, temperature, topp) for r in logits]


def test_resolve_scale_dtype_matches_jax():
    """Every (scale_dtype, batched, kernels live, parity, compute dtype,
    quant type): the port's rule is the JAX package's."""
    for sdt, batched, live, parity, cdt, qt in itertools.product(
            ("auto", "float32", "bfloat16"), (False, True), (False, True),
            (False, True), ("float32", "bfloat16"),
            ("INT8", "INT16", "INT4")):
        kw = dict(scale_dtype=sdt, parity_mode=parity, compute_dtype=cdt)
        jc = jcfg.ModelConfig(**CFG, quant_type=jcfg.QuantType[qt])
        tc = tcfg.ModelConfig(**CFG, quant_type=tcfg.QuantType[qt])
        assert tcfg.resolve_scale_dtype(tcfg.EngineConfig(**kw), tc, batched,
                                        live) == \
            jcfg.resolve_scale_dtype(jcfg.EngineConfig(**kw), jc, batched,
                                     live)


def test_engine_scale_dtype_on_the_cpu_matches_jax(models):
    """On the CPU neither engine runs kernels (JAX: no interpret mode; the
    port: plain versions), so "auto" keeps f32 scales on both; the port on
    a card and JAX on a TPU both narrow INT8 to bf16 (the rule above)."""
    from fastllama_tpu.loaders.tokenizer import Tokenizer as JTok
    from fastllama_tpu.runtime.engine import Engine as JEngine
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer as TTok
    from fastllama_tpu_torch.runtime.engine import Engine as TEngine
    jc, _, tc, _ = models
    jp = jl.random_params(jc, seed=1, qtype=jcfg.QuantType.INT8)
    assert jax.default_backend() == "cpu"
    for use in (True, False):
        je = JEngine(jc, jp, JTok().finalize(),
                     jcfg.EngineConfig(use_pallas=use))
        te = TEngine(tc, to_port(tc, jp), TTok().finalize(),
                     tcfg.EngineConfig(use_pallas=use), device="cpu")
        assert str(te.params.wq.scales.dtype)[6:] == \
            str(je.params.wq.scales.dtype)
