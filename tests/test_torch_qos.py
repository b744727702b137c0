"""The batched engines' QoS knobs on the port (``tests/test_qos.py``'s five
cases): priority admission order, queued-deadline rejection, the
``qos_chunk`` cap of plain chunks and of speculative chunks, and QoS off.
Each case runs the port's ``BatchedEngine`` / ``SpecBatchedEngine`` and
the JAX package's on the same numpy weights (JAX ``random_params_int``)
and the same calls, and holds the port to what the JAX engine does:
admission order, rejections, chunk lengths and greedy tokens.  f32 compute;
the JAX engines run their jnp path on the CPU, the port's wrappers their
plain versions."""
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
from fastllama_tpu.models import llama as jl
from fastllama_tpu.runtime.batching import BatchedEngine as JEngine
from fastllama_tpu.runtime.spec_batching import SpecBatchedEngine as JSpec
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer as TTokenizer
from fastllama_tpu_torch.runtime.batching import BatchedEngine as TEngine
from fastllama_tpu_torch.runtime.spec_batching import \
    SpecBatchedEngine as TSpec
from tests.test_torch_model import to_port

CFG = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
           vocab_size=256, max_seq_len=128)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here run many tiny ops: one intra-op thread keeps them
    fast when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jc = jcfg.ModelConfig(**CFG, quant_type=jcfg.QuantType.INT8)
    tc = tcfg.ModelConfig(**CFG, quant_type=tcfg.QuantType.INT8)
    jp = jl.random_params_int(jc, seed=3, qtype=jcfg.QuantType.INT8)
    return jc, jp, tc, to_port(tc, jp)


def _engines(models, batch, spec=None, **ec_kw):
    """(port engine, JAX engine) of one configuration; ``spec`` holds the
    SpecBatchedEngine's arguments."""
    jc, jp, tc, tp = models
    kw = dict(max_seq_len=128, max_batch_size=batch,
              compute_dtype="float32", **ec_kw)
    if spec is None:
        return (TEngine(tc, tp, TTokenizer().finalize(),
                        tcfg.EngineConfig(**kw), decode_chunk=8,
                        device="cpu"),
                JEngine(jc, jp, JTokenizer().finalize(),
                        jcfg.EngineConfig(**kw), decode_chunk=8))
    return (TSpec(tc, tp, TTokenizer().finalize(), tcfg.EngineConfig(**kw),
                  decode_chunk=8, device="cpu", **spec),
            JSpec(jc, jp, JTokenizer().finalize(), jcfg.EngineConfig(**kw),
                  decode_chunk=8, **spec))


def test_priority_admission_order(models):
    """One slot: a priority-5 request queued behind two normal ones is
    admitted first once the slot frees; FIFO within a class."""
    got = {}
    for side, eng in zip(("port", "jax"), _engines(models, batch=1)):
        lo1 = eng.submit([4, 5], max_new_tokens=2, stop_tokens=())
        lo2 = eng.submit([4, 6], max_new_tokens=2, stop_tokens=())
        hi = eng.submit([7, 8], max_new_tokens=2, stop_tokens=(),
                        priority=5)
        eng.run()
        assert all(r.done for r in (lo1, lo2, hi))
        assert hi.first_token_s < lo1.first_token_s < lo2.first_token_s
        got[side] = [r.output_tokens for r in (lo1, lo2, hi)]
    assert got["port"] == got["jax"]


def test_deadline_rejects_queued_request(models):
    """A queued request whose deadline lapses is rejected without running;
    an admitted one finishes."""
    got = {}
    for side, eng in zip(("port", "jax"), _engines(models, batch=1)):
        holder = eng.submit([1, 2, 3], max_new_tokens=8, stop_tokens=(),
                            deadline_s=60.0)
        doomed = eng.submit([4, 5], max_new_tokens=2, stop_tokens=(),
                            deadline_s=1e-9)
        eng.run()
        assert holder.done and not holder.rejected
        assert len(holder.output_tokens) == 8
        assert doomed.rejected and doomed.done and doomed.output_tokens == []
        assert eng.stats.rejected == 1
        got[side] = holder.output_tokens
    assert got["port"] == got["jax"]


def test_qos_chunk_caps_decode_while_queue_waits(models):
    """``_plan_chunk`` gives qos_chunk-step chunks while requests queue
    behind a full batch and the full decode chunk once the queue drains."""
    for eng in _engines(models, batch=1, qos_chunk=2):
        eng.submit([1, 2, 3], max_new_tokens=64, stop_tokens=())
        eng.step()                               # admit; the slot is busy
        eng.submit([4, 5], max_new_tokens=2, stop_tokens=())
        assert eng._plan_chunk(eng._live_slots())[0] == 2
        eng.queue.clear()
        assert eng._plan_chunk(eng._live_slots())[0] == 8


def test_spec_qos_chunk_caps_rounds_while_queue_waits(models):
    """While a request queues, a speculative chunk runs max(1, qos_chunk //
    width) rounds: width 2, qos_chunk 2 gives one round, at most two
    tokens beside the prefill's; the generation contract is unchanged."""
    got = {}
    spec = dict(width=2, rounds_per_chunk=32, spec_auto=False)
    for side, eng in zip(("port", "jax"),
                         _engines(models, batch=1, spec=spec, qos_chunk=2)):
        long_ = eng.submit([1, 2, 3], max_new_tokens=64, stop_tokens=())
        queued = eng.submit([4, 5], max_new_tokens=2, stop_tokens=())
        eng.step()                   # admit long_ and one capped chunk
        first = list(long_.output_tokens)
        assert 1 <= len(first) <= 3
        eng.run()
        assert len(long_.output_tokens) == 64
        assert queued.done and len(queued.output_tokens) == 2
        got[side] = (first, long_.output_tokens, queued.output_tokens,
                     eng.spec_drafted, eng.spec_accepted)
    assert got["port"] == got["jax"]


def test_qos_off_keeps_order_and_chunks(models):
    """Default config: no reordering and no cap; the chunk is the exact
    remaining budget (6 requested less the prefill's token)."""
    got = {}
    for side, eng in zip(("port", "jax"), _engines(models, batch=2)):
        a = eng.submit([1, 2], max_new_tokens=6, stop_tokens=())
        b = eng.submit([3, 4], max_new_tokens=6, stop_tokens=())
        c = eng.submit([5, 6], max_new_tokens=6, stop_tokens=())
        eng._admit_pending()                     # a, b admitted; c queued
        assert eng._plan_chunk(eng._live_slots())[0] == 5
        eng.run()
        assert a.first_token_s < c.first_token_s
        assert b.first_token_s < c.first_token_s
        assert [len(r.output_tokens) for r in (a, b, c)] == [6, 6, 6]
        got[side] = [r.output_tokens for r in (a, b, c)]
    assert got["port"] == got["jax"]
