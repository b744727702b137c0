"""The slice as a whole at packed INT4: the port's ``BatchedEngine``,
single-stream ``Engine`` and ``SpecBatchedEngine`` on the same weights as
the JAX package (its ``random_params`` at INT4, split-half packed with its
``pack_int4_rows_np`` where its ``pack_supported`` says, handed over as
numpy through ``params_from_numpy``).  The JAX side runs its Pallas
kernels in interpret mode; the port runs on the CPU, where every kernel
wrapper takes its plain version.  f32 compute, f32 scales, greedy tokens
equal.  Logits agree within 1e-2 of max|ref|, not 2e-5: K1p rounds its
activations to bf16 at any compute dtype (the JAX kernel's contract), so
one f32 ulp of difference upstream (another summation order) can flip
some of those roundings (on the CPU, one ulp on the norm gains moved the
port's own prefill logits by 3.9e-3 where max|ref| was 2.0).  For the same
reason the single-stream prompt is one whose greedy margins exceed that
tolerance.

The JAX single-stream ``Engine`` is not the reference at INT4: its packed
indexed kernel drops the residual ``forward`` folds into it
(``tests/test_torch_int4_qmm.py``).  The single-stream test holds the port
against JAX ``forward`` with a test-side ``mm_idx`` that adds the residual
outside the JAX kernel."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
from fastllama_tpu.models import llama as jl
from fastllama_tpu.ops.pallas import qmm as jqmm
from fastllama_tpu.quant import groupquant as jq
from fastllama_tpu.runtime.batching import BatchedEngine as JEngine
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer as TTokenizer
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.runtime.batching import BatchedEngine as TEngine
from fastllama_tpu_torch.runtime.engine import Engine as TSingle
from fastllama_tpu_torch.runtime.spec_batching import \
    SpecBatchedEngine as TSpec
from tests.test_torch_model import to_port


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here run many tiny ops: one intra-op thread keeps them
    fast when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V = 512
BASE = dict(dim=1024, n_layers=2, vocab_size=V, max_seq_len=128)
# hidden 1024: every projection packs; 1536: w2 stays int8-held (K1) while
# the rest pack; kv_dim 64: wk and wv stay int8-held, fuse_params refuses
# and the engines keep the weights unfused (16 query heads a kv head, more
# than the port's flash-decode kernel takes, so that case serves with
# flash_attention=False, the plain attention, on both sides)
CFGS = {"packed": dict(BASE, hidden_dim=1024, n_heads=8, n_kv_heads=4),
        "w2_int8": dict(BASE, hidden_dim=1536, n_heads=8, n_kv_heads=4),
        "kv64": dict(BASE, hidden_dim=1024, n_heads=16, n_kv_heads=1)}


def _packed_params(jc, seed):
    """JAX ``random_params`` at INT4, packed as the JAX loaders pack."""
    jp = jl.random_params(jc, seed=seed, qtype=jcfg.QuantType.INT4)
    out = {}
    for f in dataclasses.fields(jp):
        w = getattr(jp, f.name)
        if (isinstance(w, jq.QArray) and w.group_axis == -2
                and jqmm.pack_supported(*w.data.shape[-2:], w.group_size)):
            w = jq.QArray(jnp.asarray(jq.pack_int4_rows_np(
                np.asarray(w.data))), w.scales, w.qtype, w.group_size,
                -2, packed=True)
        out[f.name] = w
    return jl.LlamaParams(**out)


_CACHE = {}


def _models(name):
    if name not in _CACHE:
        jc = jcfg.ModelConfig(**CFGS[name], quant_type=jcfg.QuantType.INT4)
        tc = tcfg.ModelConfig(**CFGS[name], quant_type=tcfg.QuantType.INT4)
        jp = _packed_params(jc, seed=7)
        _CACHE[name] = (jc, jp, tc, to_port(tc, jp))
    return _CACHE[name]


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, V, size=n).tolist() for n in lengths]


def test_layouts():
    _, jp, _, tp = _models("packed")
    assert all(w.packed for n, w in tp.quantized().items()
               if n != "embedding")
    _, jp, _, tp = _models("w2_int8")
    assert tp.wq.packed and tp.w1.packed and not tp.w2.packed
    _, jp, tc, tp = _models("kv64")
    assert tp.wq.packed and not tp.wk.packed and not tp.wv.packed
    with pytest.raises(ValueError, match="mixed quant layouts"):
        tl.fuse_params(tc, tp)


# -- (d) BatchedEngine against the JAX BatchedEngine ------------------------

@pytest.mark.parametrize("name,kv_dtype,fuse", [
    ("packed", "int8", True), ("packed", "float32", True),
    ("packed", "int8", False), ("w2_int8", "int8", True),
    ("kv64", "int8", True)])
def test_batched_engine_greedy_tokens_match_jax(name, kv_dtype, fuse):
    """Four requests of mixed lengths through three slots (staggered
    admission), token for token against the JAX engine."""
    jc, jp, tc, tp = _models(name)
    common = dict(max_batch_size=3, compute_dtype="float32",
                  kv_dtype=kv_dtype, fuse_weights=fuse,
                  flash_attention=name != "kv64")
    prompts = _prompts(len(name) + len(kv_dtype), (9, 30, 4, 17))
    budgets = (6, 4, 8, 5)
    engines = {
        "jax": JEngine(jc, jp, JTokenizer().finalize(), jcfg.EngineConfig(
            pallas_interpret=True, **common), decode_chunk=4),
        "port": TEngine(tc, tp, TTokenizer().finalize(),
                        tcfg.EngineConfig(**common), decode_chunk=4,
                        device="cpu")}
    out = {}
    for side, eng in engines.items():
        assert (eng.params.wk is None) == (fuse and name != "kv64")
        reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0,
                           stop_tokens=()) for p, n in zip(prompts, budgets)]
        eng.run()
        out[side] = [r.output_tokens for r in reqs]
    assert out["port"] == out["jax"]
    assert [len(t) for t in out["port"]] == list(budgets)


# -- (e) the single-stream Engine against JAX forward ------------------------

def _jax_mm_idx(x, w, layer, norm_gain=None, eps=1e-5, residual=None):
    """JAX's indexed kernel (interpret mode) with the residual added
    outside it on a packed weight, where the kernel drops it."""
    if isinstance(w, jq.QArray) and w.packed:
        out = jqmm.qmatmul_pallas_indexed(x, w, layer, jnp.float32, True,
                                          norm_gain=norm_gain, eps=eps)
        return out if residual is None else residual + out
    return jqmm.make_mm_indexed(jnp.float32, interpret=True)(
        x, w, layer, norm_gain=norm_gain, eps=eps, residual=residual)


_jax_mm_idx.supports_fusion = True


def _jax_greedy(jc, jp, prompt, n):
    """Greedy decode through JAX ``forward`` (jitted, the position traced):
    the prompt in one block at pos 0, then one token a step.  Returns
    (tokens, per-step logits)."""
    step = jax.jit(functools.partial(
        jl.forward, jc, mm=jqmm.make_mm(jnp.float32, interpret=True),
        mm_idx=_jax_mm_idx, compute_dtype=jnp.float32))
    lg, cache = step(jp, jnp.asarray(prompt, jnp.int32), 0,
                     jl.KVCache.create(jc))
    logits, toks = [np.asarray(lg[-1])], []
    for i in range(n):
        toks.append(int(np.argmax(logits[-1])))
        if i == n - 1:
            break
        lg, cache = step(jp, jnp.asarray([toks[-1]], jnp.int32),
                         len(prompt) + i, cache)
        logits.append(np.asarray(lg[0]))
    return toks, logits


def test_single_stream_engine_matches_jax_forward():
    """Fused weights (the norm and both residual adds inside K1p's glue):
    the port's ``forward`` logits through the engine's kernel bundle at
    the prompt and at each decode step, and ``Engine.generate``'s greedy
    tokens (bucketed fresh prefill, chunks of 4 and a tail of 2).  The
    prompt's greedy margins on the JAX side exceed the logit tolerance at
    every step, so no argmax tie can flip a token."""
    jc, jp, tc, tp = _models("packed")
    jpf = jl.fuse_params(jc, jp)
    n, prompt = 10, _prompts(15, (13,))[0]
    want_toks, want_logits = _jax_greedy(jc, jpf, prompt, n)
    assert len(set(want_toks)) > 3
    for lg in want_logits:
        top = np.sort(lg)[-2:]
        assert top[1] - top[0] > 1e-2 * np.abs(lg).max()
    eng = TSingle(tc, tp, TTokenizer().finalize(), tcfg.EngineConfig(
        compute_dtype="float32", scale_dtype="float32"), device="cpu")
    assert eng.params.wk is None and eng.params.wq.packed
    kb = eng.kernels
    hooks = dict(mm=kb.mm, mm_idx=kb.mm_idx, attn=kb.attn,
                 attn_idx=kb.attn_idx, compute_dtype=torch.float32)
    cache = tl.KVCache.create(tc, device="cpu")
    lg, _ = tl.forward(tc, eng.params, torch.tensor(prompt), 0, cache,
                       **hooks)
    _close(lg[-1].numpy(), want_logits[0], "prefill")
    for i, tok in enumerate(want_toks[:-1]):
        lg, _ = tl.forward(tc, eng.params, torch.tensor([tok]),
                           len(prompt) + i, cache, **hooks)
        _close(lg[0].numpy(), want_logits[i + 1], f"step {i}")
    got, st = eng.generate(prompt, max_new_tokens=n, decode_chunk=4,
                           stop_tokens=())
    assert got == want_toks and st.output_tokens == n


def _close(got, want, label):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max(), err_msg=label)


# -- (f) SpecBatchedEngine against plain serving ----------------------------

@pytest.mark.parametrize("name", ["packed", "w2_int8"])
def test_spec_engine_matches_plain_serving(name):
    """Greedy tokens of the speculative engine equal the plain engine's at
    f32 (width 4, 3 rounds a chunk, the tuner off); drafts are accepted on
    a repetitive prompt."""
    _, _, tc, tp = _models(name)
    ec = tcfg.EngineConfig(max_batch_size=3, compute_dtype="float32",
                           kv_dtype="int8")
    prompts = [[1, 5, 9, 13, 80, 200, 31], [7, 7, 7, 7],
               ([4, 40, 400] * 5)[:14]]
    out = {}
    for side, cls, kw in (("plain", TEngine, {}),
                          ("spec", TSpec, dict(width=4, rounds_per_chunk=3,
                                               spec_auto=False))):
        eng = cls(tc, tp, TTokenizer().finalize(), ec, decode_chunk=8,
                  device="cpu", **kw)
        out[side] = [r.output_tokens for r in eng.generate_all(
            prompts, max_new_tokens=14, temperature=0.0, stop_tokens=())]
        if side == "spec":
            assert eng.spec_drafted > 0 and eng.arm_chunks[4] > 0
    assert out["spec"] == out["plain"]
