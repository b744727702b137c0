"""The port's batched speculation across hosts
(``runtime/spec_multihost.py``) against the JAX package's
``BatchedEngine`` on the same file (``tests/test_multihost.py``'s 2-layer
``CFG``, INT8, f32 compute): greedy outputs equal plain serving's on two
gloo ranks spawned on the CPU (``data=2``, one spawn) with drafts on both
hosts, near the context limit (the fleet's plain rounds), with the auto
tuner voting, sampled rounds repeating for a seed; on one process
(``data=1``) as well; the tuner's unit cases
(``tests/test_spec_multihost.py:179-203``).  The JAX engine serves plain
decode on a multi-device mesh without ``spmd_kernels``; the port
speculates there (``data=2`` here, without them).  ``jax`` and
``fastllama_tpu`` are imported inside the test functions only."""
import numpy as np
import pytest
import torch

from fastllama_tpu_torch.config import EngineConfig, QuantType
from fastllama_tpu_torch.loaders.registry import FileType
from fastllama_tpu_torch.parallel.distributed import run_ranks
from tests.test_torch_multihost import CFG, PROMPTS, _jax_outputs, _serve

LONG = {0: list(range(2, 56)), 1: list(range(5, 59))}   # 54 of max_seq 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(ckpt, tokp, mesh="", **kw):
    from fastllama_tpu_torch.runtime.spec_multihost import \
        MultiHostSpecEngine
    return MultiHostSpecEngine.load_spec(
        ckpt, tokp, FileType.LLAMA2C, QuantType.INT8,
        EngineConfig(max_seq_len=64, max_batch_size=2,
                     compute_dtype="float32", mesh=mesh),
        decode_chunk=4, device="cpu", **kw)


def spec_job(rank, ckpt, tokp):
    """Every rank of ``data=2``: its host's prompts through the spec
    engine (tuner off, then on), its long prompt near the context limit,
    and a sampled run twice."""
    out = {}
    eng = _spec(ckpt, tokp, "data=2", width=4, rounds_per_chunk=2,
                spec_auto=False)
    d = eng.host
    out["outputs"] = _serve(eng, PROMPTS[d])
    out["drafted"] = eng.spec_drafted
    out["acceptance"] = eng.acceptance
    eng = _spec(ckpt, tokp, "data=2", width=4, rounds_per_chunk=8,
                spec_auto=False)
    out["long"] = _serve(eng, [LONG[d]], max_new=8)
    out["long_arms"] = dict(eng.arm_chunks)
    eng = _spec(ckpt, tokp, "data=2", width=4, rounds_per_chunk=2)
    out["auto"] = _serve(eng, PROMPTS[d], max_new=10)
    out["auto_arms"] = dict(eng.arm_chunks)
    sampled = []
    for _ in range(2):
        eng = _spec(ckpt, tokp, "data=2", width=3, rounds_per_chunk=2,
                    spec_auto=False)
        sampled.append([r.output_tokens for r in eng.generate_all(
            PROMPTS[d], max_new_tokens=6, temperature=0.8, topp=0.9,
            seed=42, stop_tokens=())])
    out["sampled"] = sampled
    return out


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    from fastllama_tpu.config import ModelConfig
    from fastllama_tpu.tools.synthetic import write_tiny_llama2c
    d = tmp_path_factory.mktemp("spec_multihost")
    ckpt, tokp = write_tiny_llama2c(str(d), cfg=ModelConfig(**CFG))
    return dict(ckpt=ckpt, tokp=tokp, runs=[])


def _ranks(shared):
    if not shared["runs"]:
        shared["runs"].append(run_ranks(spec_job, 2, shared["ckpt"],
                                        shared["tokp"], timeout=300))
    return shared["runs"][0]


def test_spec_fleet_matches_plain(shared):
    """The outputs, concatenated by host, are the JAX engine's plain
    greedy ones; both hosts drafted."""
    want = _jax_outputs(shared, PROMPTS[0] + PROMPTS[1])
    for d, r in enumerate(_ranks(shared)):
        assert r["outputs"] == want[2 * d:2 * d + 2]
        assert r["drafted"] > 0


def test_spec_fleet_near_context_limit(shared):
    """No D-row block fits fleet-wide at the end: the fleet's plain
    rounds keep the generation contract to the last token."""
    want = _jax_outputs(shared, [LONG[0], LONG[1]], max_new=8)
    for d, r in enumerate(_ranks(shared)):
        assert r["long"] == [want[d]] and len(r["long"][0]) == 8
    assert _ranks(shared)[0]["long_arms"] == _ranks(shared)[1]["long_arms"]


def test_spec_fleet_auto_tuner(shared):
    """With the tuners voting the fleet mixes spec and plain rounds; the
    greedy outputs are still plain serving's, and both hosts ran the same
    rounds."""
    want = _jax_outputs(shared, PROMPTS[0] + PROMPTS[1], max_new=10)
    ranks = _ranks(shared)
    for d, r in enumerate(ranks):
        assert r["auto"] == want[2 * d:2 * d + 2]
    assert ranks[0]["auto_arms"] == ranks[1]["auto_arms"]


def test_spec_fleet_sampled_deterministic(shared):
    """Sampled rounds: a fixed seed repeats, every request completes."""
    for r in _ranks(shared):
        a, b = r["sampled"]
        assert a == b and all(len(t) == 6 for t in a)


def test_spec_one_process_matches_plain(shared):
    """data=1, width 3: the engine speculates and matches plain serving."""
    prompts = ["the cat sat", "a big dog ran"]
    eng = _spec(shared["ckpt"], shared["tokp"], width=3,
                rounds_per_chunk=2, spec_auto=False)
    assert eng.n_hosts == 1
    assert _serve(eng, prompts) == _jax_outputs(shared, prompts)
    assert eng.spec_drafted > 0
    assert eng.global_stats().completed == 2


def test_spec_auto_tuner_unit():
    """SpecAutoTuner as the fleet's voter (binary arms): measures both
    modes once, then runs the winner and probes the loser; compile-polluted
    samples are discarded (``tests/test_spec_multihost.py:179-203``)."""
    from fastllama_tpu_torch.runtime.spec_batching import SpecAutoTuner
    t = SpecAutoTuner(probe_every=4)
    assert t.choose() == 1                 # measure spec first
    t.record(True, 100, 1.0)               # spec: 100 tok/s
    assert t.choose() == 0                 # then plain once
    t.record(False, 300, 1.0)              # plain: 300 tok/s -> plain wins
    assert t.choose() == 0
    assert t.choose() == 1                 # count=4: probe the loser
    t.record(True, 100, 1.0)
    assert t.choose() == 0                 # winner again
    ema = dict(t.ema)
    t.record(False, 1, 100.0, compiled=True)
    assert t.ema == ema
    for _ in range(30):
        t.record(True, 500, 1.0)
    assert t.ema[True] > t.ema[False]
    assert t.choose() in (True, False)
    assert np.mean([t.choose() for _ in range(8)]) > 0.5


def test_spec_width_below_two_raises(shared):
    with pytest.raises(ValueError, match="width >= 2"):
        _spec(shared["ckpt"], shared["tokp"], width=1)
