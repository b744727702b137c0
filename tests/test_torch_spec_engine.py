"""The port's ``SpecBatchedEngine`` against the JAX package's on the same
weights and traffic (``tests/test_spec_batching.py:71-131`` and ``:350``),
and against the port's plain ``BatchedEngine``: greedy tokens equal, and,
with the tuner off, the same drafted and accepted counts.  The JAX engines
run on their jnp path, as the JAX package's own tests run them; the port
runs on the CPU, where every kernel wrapper takes its plain version.  f32
compute."""
import dataclasses

import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
from fastllama_tpu.models import llama as jl
from fastllama_tpu.runtime.spec_batching import SpecBatchedEngine as JSpec
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer as TTokenizer
from fastllama_tpu_torch.models import llama as tl
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


CFG = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
           vocab_size=512, max_seq_len=128, group_size=16)
PROMPTS = [[1, 5, 9, 13, 80, 200, 31], [2, 4, 6], [7, 7, 7, 7]]


@pytest.fixture(scope="module")
def models():
    jc = jcfg.ModelConfig(**CFG, quant_type=jcfg.QuantType.INT8)
    tc = tcfg.ModelConfig(**CFG, quant_type=tcfg.QuantType.INT8)
    jp = jl.random_params(jc, seed=5, qtype=jcfg.QuantType.INT8)
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


def _engines(models, kv_dtype, **spec_kw):
    """(port plain, port spec, JAX spec), three slots each."""
    jc, jp, tc, tp = models
    common = dict(max_seq_len=128, max_batch_size=3, compute_dtype="float32",
                  kv_dtype=kv_dtype)
    tec = tcfg.EngineConfig(**common)
    base = TEngine(tc, tp, TTokenizer().finalize(), tec, decode_chunk=8,
                   device="cpu")
    spec = TSpec(tc, tp, TTokenizer().finalize(), tec, decode_chunk=8,
                 device="cpu", **spec_kw)
    jspec = JSpec(jc, jp, JTokenizer().finalize(),
                  jcfg.EngineConfig(**common), decode_chunk=8, **spec_kw)
    return base, spec, jspec


def _greedy(eng, prompts, n):
    return [r.output_tokens for r in eng.generate_all(
        prompts, max_new_tokens=n, temperature=0.0, stop_tokens=())]


def _same_counts(spec, jspec):
    assert spec.spec_drafted == jspec.spec_drafted > 0
    assert spec.spec_accepted == jspec.spec_accepted


@pytest.mark.parametrize("kv_dtype", ["int8", "float32"])
def test_matches_plain_greedy(models, kv_dtype):
    base, spec, jspec = _engines(models, kv_dtype, width=4,
                                 rounds_per_chunk=3, spec_auto=False)
    want = _greedy(base, PROMPTS, 20)
    assert _greedy(spec, PROMPTS, 20) == want == _greedy(jspec, PROMPTS, 20)
    _same_counts(spec, jspec)
    assert spec.arm_chunks[0] == 0 and spec.arm_chunks[4] > 0


def test_repetitive_accepts(models):
    """A prompt whose tail repeats earlier content: n-gram drafts hit, and
    acceptance rises above zero on both sides, by the same counts."""
    base, spec, jspec = _engines(models, "int8", width=4, rounds_per_chunk=4,
                                 spec_auto=False)
    prompt = PROMPTS[0]
    first = _greedy(base, [prompt], 30)[0]
    rep = prompt + first[:20] + prompt
    want = _greedy(base, [rep], 20)
    assert _greedy(spec, [rep], 20) == want == _greedy(jspec, [rep], 20)
    _same_counts(spec, jspec)
    assert spec.spec_accepted > 0 and spec.acceptance > 0


def test_staggered_admissions_and_stop(models):
    """Admissions between chunks, a request that reaches its budget inside
    a spec chunk, and one stopped by a stop token inside a chunk."""
    base, spec, jspec = _engines(models, "int8", width=3, rounds_per_chunk=2,
                                 spec_auto=False)
    p1, p2, p3 = [1, 5, 9, 13], [2, 4, 6, 8, 10], [11, 3]
    stop = _greedy(TEngine(*_port_args(models), decode_chunk=8,
                           device="cpu"), [p2], 17)[0][6]

    def run(eng):
        r1 = eng.submit(p1, max_new_tokens=9, temperature=0.0,
                        stop_tokens=())
        eng.step()
        r2 = eng.submit(p2, max_new_tokens=17, temperature=0.0,
                        stop_tokens=(stop,))
        r3 = eng.submit(p3, max_new_tokens=5, temperature=0.0,
                        stop_tokens=())
        eng.run()
        return [r1.output_tokens, r2.output_tokens, r3.output_tokens]

    want = run(base)
    assert want[1][-1] == stop and len(want[1]) < 17
    assert run(spec) == want == run(jspec)
    _same_counts(spec, jspec)


def _port_args(models):
    _, _, tc, tp = models
    return (tc, tp, TTokenizer().finalize(),
            tcfg.EngineConfig(max_seq_len=128, max_batch_size=3,
                              compute_dtype="float32", kv_dtype="int8"))


def test_near_context_limit(models):
    """108 prompt tokens of 128: the spec chunks give way to plain chunks
    where no D-row block fits, and the full generation still comes out."""
    base, spec, jspec = _engines(models, "int8", width=4, rounds_per_chunk=8,
                                 spec_auto=False)
    prompt = list(range(2, 110))
    want = _greedy(base, [prompt], 19)
    assert _greedy(spec, [prompt], 19) == want == _greedy(jspec, [prompt], 19)
    assert len(want[0]) == 19
    assert spec.arm_chunks[0] > 0 and spec.arm_chunks[4] > 0
    _same_counts(spec, jspec)


def test_width_arms(models):
    """The tuner's arms {2, 4} + plain at width 4: every arm runs (each is
    measured once first) and greedy tokens still equal plain serving."""
    base, spec, jspec = _engines(models, "int8", width=4, rounds_per_chunk=2)
    assert spec._tuner.arms == jspec._tuner.arms == [2, 4, 0]
    want = _greedy(base, PROMPTS, 24)
    assert _greedy(spec, PROMPTS, 24) == want == _greedy(jspec, PROMPTS, 24)
    assert {2, 4, 0} <= set(spec.arm_chunks)
    assert spec.spec_drafted > 0
