"""Dispatch-ahead batched decode in the port (``FASTLLAMA_PIPELINE=1``,
``BatchedEngine._pipelined_stretch``, the JAX ``batching.py:848-923``):
with the variable set, the port's ``BatchedEngine`` (int8 KV cache, also
with deferred KV) and ``SpecBatchedEngine`` give the JAX engines' greedy
tokens under the same variable at f32 compute; the batched engines'
greedy and sampled tokens equal the port's own run without it (the same
per-slot generators, drawn in the same order), with a stretch shown to
have run (``pipelined_chunks``), a stop token inside one, and slots freed
and refilled before the queue empties; the stretch's gate; the
multi-host engines run their lockstep rounds as without the variable,
as JAX's ``MultiHostEngine.run`` never reads it.  The traffic and
:func:`serve_traffic` serve ``tests/test_torch_spec_mesh.py``'s
``model=2`` case too.  The JAX engines run on the CPU as the JAX
package's own tests run them (the spec engine on its jnp path,
``tests/test_spec_batching.py``; deferred KV with its kernels in
interpret mode).  ``jax`` and ``fastllama_tpu`` are imported inside the
test functions only."""
import pytest
import torch

from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer

# six requests on four slots (decode chunk 4, S = 64): the first stretch
# waits for the queue to empty, one slot completes inside a stretch
PROMPTS = [[5, 6, 7, 8, 9], [10, 11, 12],
           [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19],
           [40, 41], [60, 61, 62, 63], [7, 8, 9]]
BUDGETS = (13, 40, 30, 9, 30, 36)
B = 4
CHUNK = 4
SAMPLED = dict(temperature=0.8, topp=0.9)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines run many tiny ops: one intra-op thread keeps them fast
    when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def serve_traffic(eng, temperature=0.0, topp=0.9, stops=None):
    """Submit the six requests (request i seeded 7 + i; ``stops`` maps a
    request to its stop tokens), run to completion; their tokens."""
    stops = stops or {}
    reqs = [eng.submit(p, max_new_tokens=n, temperature=temperature,
                       topp=topp, seed=7 + i, stop_tokens=stops.get(i, ()))
            for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS))]
    eng.run()
    assert all(r.done for r in reqs)
    return [r.output_tokens for r in reqs]


def port_engine(tc, tp, kind, mesh="", **kw):
    """The port's engine of ``kind`` ("batched", "deferred", "spec") at
    f32 compute with an int8 KV cache, on the CPU; the spec engine's arm
    pinned to speculation (the tuner reads a clock, and a sampled run's
    draws follow the arms it takes)."""
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.spec_batching import SpecBatchedEngine
    ec = tcfg.EngineConfig(max_batch_size=B, compute_dtype="float32",
                           kv_dtype="int8", deferred_kv=kind == "deferred",
                           mesh=mesh, **kw)
    if kind == "spec":
        return SpecBatchedEngine(tc, tp, Tokenizer().finalize(), ec,
                                 decode_chunk=CHUNK, width=2,
                                 rounds_per_chunk=4, spec_auto=False,
                                 device="cpu")
    return BatchedEngine(tc, tp, Tokenizer().finalize(), ec,
                         decode_chunk=CHUNK, device="cpu")


@pytest.fixture(scope="module")
def weights():
    """(JAX config, JAX params, port config, port params): JAX
    ``random_params`` at INT8 handed over as numpy."""
    from fastllama_tpu_torch.models import llama as tl
    from tests.test_torch_spmd import CFG, jax_arrays
    jc, jp, arrays, flags = jax_arrays()
    tc = tcfg.ModelConfig(**CFG, quant_type=tcfg.QuantType.INT8)
    return jc, jp, tc, tl.params_from_numpy(tc, arrays, flags, device="cpu")


def _run(monkeypatch, pipe, eng, **kw):
    monkeypatch.setenv("FASTLLAMA_PIPELINE", "1" if pipe else "0")
    return serve_traffic(eng, **kw)


def jax_engine(jc, jp, kind):
    from fastllama_tpu import config as jcfg
    from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
    from fastllama_tpu.runtime.batching import BatchedEngine as JEngine
    from fastllama_tpu.runtime.spec_batching import SpecBatchedEngine as JSpec
    kw = dict(max_batch_size=B, compute_dtype="float32", kv_dtype="int8")
    if kind == "spec":
        return JSpec(jc, jp, JTokenizer().finalize(),
                     jcfg.EngineConfig(**kw, use_pallas=False),
                     decode_chunk=CHUNK, width=2, rounds_per_chunk=4)
    if kind == "deferred":
        kw.update(deferred_kv=True, pallas_interpret=True)
    return JEngine(jc, jp, JTokenizer().finalize(), jcfg.EngineConfig(**kw),
                   decode_chunk=CHUNK)


@pytest.mark.parametrize("kind", ["batched", "deferred", "spec"])
def test_pipeline_matches_jax(weights, monkeypatch, kind):
    """Greedy tokens under the variable equal the JAX engine's under it."""
    jc, jp, tc, tp = weights
    jeng = jax_engine(jc, jp, kind)
    if kind == "deferred":
        assert jeng._deferred_ok
    want = _run(monkeypatch, True, jeng)
    eng = port_engine(tc, tp, kind)
    assert _run(monkeypatch, True, eng) == want
    assert eng.pipelined_chunks > 0
    assert (eng.deferred_chunks > 0) == (kind == "deferred")


@pytest.mark.parametrize("kind,temperature", [
    ("batched", 0.0), ("batched", 0.8), ("deferred", 0.0),
    ("deferred", 0.8), ("spec", 0.0)])
def test_pipeline_equals_sequential(weights, monkeypatch, kind,
                                    temperature):
    """The same engine's tokens with and without the variable, exactly:
    a slot's lanes depend only on its own tokens and generator.  (The
    spec engine's sampled tokens are not compared: its stretches run
    plain chunks where the sequential run verifies, and the two draw
    different noise.)"""
    _, _, tc, tp = weights
    got = {}
    for pipe in (False, True):
        eng = port_engine(tc, tp, kind)
        got[pipe] = _run(monkeypatch, pipe, eng, temperature=temperature)
        assert (eng.pipelined_chunks > 0) == pipe
    assert got[True] == got[False]
    assert [len(t) for t in got[True]] == list(BUDGETS)


def test_stop_token_inside_a_stretch(weights, monkeypatch):
    """Request 1 stops mid-chunk inside the first stretch (its tokens
    13..28 come from one): no chunk more is dispatched after the one in
    flight, which drains, and every request's tokens are the sequential
    run's."""
    _, _, tc, tp = weights
    full = _run(monkeypatch, False, port_engine(tc, tp, "batched"))
    k = 15                                   # the first chunk's third token
    assert full[1].index(full[1][k]) == k
    stops = {1: (full[1][k],)}
    seq = _run(monkeypatch, False, port_engine(tc, tp, "batched"),
               stops=stops)
    eng = port_engine(tc, tp, "batched")
    stretches = []
    stretch = eng._pipelined_stretch

    def spy():
        n, done = eng.pipelined_chunks, eng.stats.completed
        stretch()
        if eng.pipelined_chunks > n:
            stretches.append((eng.pipelined_chunks - n,
                              eng.stats.completed - done))
    eng._pipelined_stretch = spy
    got = _run(monkeypatch, True, eng, stops=stops)
    assert got == seq and got[1] == full[1][:k + 1]
    # the first stretch: the stop's chunk and the one in flight
    assert stretches[0] == (2, 1)


def test_sampled_spec_engine_under_pipeline(weights, monkeypatch):
    """The spec engine's sampled run under the variable: every request
    gets its tokens inside the vocabulary, a stretch ran, and a seed
    repeats its output."""
    _, _, tc, tp = weights
    runs = []
    for _ in range(2):
        eng = port_engine(tc, tp, "spec")
        runs.append(_run(monkeypatch, True, eng, **SAMPLED))
        assert eng.pipelined_chunks > 0
    assert runs[0] == runs[1]
    assert [len(t) for t in runs[0]] == list(BUDGETS)
    assert all(0 <= t < tc.vocab_size for r in runs[0] for t in r)


def test_stretch_gate(weights):
    """The stretch does nothing with a request queued, with K below a full
    decode chunk, or with less than two chunks of budget or room."""
    _, _, tc, tp = weights

    def ran(budgets, queued=False, chunk=CHUNK, prompt=(5, 6, 7)):
        eng = port_engine(tc, tp, "batched")
        eng.decode_chunk = chunk
        for n in budgets:
            eng.submit(list(prompt), max_new_tokens=n, stop_tokens=())
        eng._admit_pending()
        if queued:
            eng.submit([9, 9], max_new_tokens=4, stop_tokens=())
        eng._pipelined_stretch()
        return eng.pipelined_chunks

    assert ran([9, 9]) == 2                    # 8 left: two chunks of 4
    assert ran([9, 8]) == 0                    # 7 left on one slot
    assert ran([20, 20, 20, 20], queued=True) == 0
    assert ran([20], chunk=64) == 0            # K = 19 < the chunk
    assert ran([13]) == 3


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_multihost_runs_as_without_the_variable(weights, monkeypatch, spec):
    """One host (``data=1``): ``MultiHostEngine`` and
    ``MultiHostSpecEngine`` give the same tokens with the variable set,
    and never run a stretch."""
    from fastllama_tpu_torch.runtime.multihost import MultiHostEngine
    from fastllama_tpu_torch.runtime.spec_multihost import \
        MultiHostSpecEngine
    _, _, tc, tp = weights
    ec = tcfg.EngineConfig(max_batch_size=B, compute_dtype="float32",
                           kv_dtype="int8")
    got = {}
    for pipe in (False, True):
        if spec:
            eng = MultiHostSpecEngine(tc, tp, Tokenizer().finalize(), ec,
                                      CHUNK, width=2, rounds_per_chunk=4,
                                      device="cpu")
        else:
            eng = MultiHostEngine(tc, tp, Tokenizer().finalize(), ec, CHUNK,
                                  device="cpu")
        got[pipe] = _run(monkeypatch, pipe, eng)
        assert eng.pipelined_chunks == 0
    assert got[True] == got[False]
    assert [len(t) for t in got[True]] == list(BUDGETS)
