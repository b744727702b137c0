"""Scheduler fuzz of the port (the traffic of
``tests/test_scheduler_fuzz.py:56-93`` and ``:116-158``): random request
mixes — slot churn, mixed prompt lengths, staggered submission, stop
tokens, mixed greedy and sampled slots — with ``prefix_cache`` and
``deferred_kv`` drawn at random, through the port's ``BatchedEngine`` and
``SpecBatchedEngine`` and through the JAX engines of the same
configuration on the same weights.  Half the prompts share a system prefix,
so that prefix hits happen.  Greedy requests must produce exactly the JAX
engine's tokens (f32 compute); sampled ones (their noise differs from
JAX's by design) carry no stop token, so that both sides free the same
slots at the same steps and count the same prefix hits.  The JAX engines run
their jnp path; the port's wrappers take their plain versions on the CPU,
K2b for hit tails and K2 with stats for deferred chunks."""
import dataclasses

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


CFG = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
           vocab_size=512, max_seq_len=128, group_size=16)


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


def _random_requests(rng, n):
    system = [int(x) for x in rng.integers(1, 500, size=int(
        rng.integers(16, 48)))]
    reqs = []
    for i in range(n):
        prompt = [int(x) for x in rng.integers(1, 500, size=int(
            rng.integers(1, 40)))]
        if rng.random() < 0.5:
            prompt = system + prompt
        greedy = rng.random() < 0.7
        stops = ((0,) if rng.random() < 0.5
                 else (0, int(rng.integers(1, 500))))
        if not greedy:
            # a sampled request runs to its budget on both sides, so that
            # slots free at the same steps and the prefix hits agree
            stops = ()
        reqs.append(dict(prompt=prompt,
                         max_new_tokens=int(rng.integers(1, 40)),
                         temperature=0.0 if greedy else 0.8, topp=0.9,
                         seed=1000 + i, stop_tokens=stops))
    return reqs


def _drive(eng, reqs, rng):
    """Staggered submission, a few requests a scheduler step, then drain."""
    handles, pending = [], list(reqs)
    while pending or handles and not all(h.done for h in handles):
        k = int(rng.integers(0, 4))
        for spec in pending[:k]:
            handles.append(eng.submit(**spec))
        pending = pending[k:]
        eng.step()
    eng.run()
    return handles


def _run_both(models, trial, make, seed):
    """The same traffic and submission schedule through the port and JAX
    engines that ``make(side, models, ec_kw, rng)`` builds."""
    rng = np.random.default_rng(seed)
    reqs = _random_requests(rng, int(rng.integers(5, 10)))
    ec_kw = dict(max_seq_len=128, max_batch_size=int(rng.integers(2, 5)),
                 compute_dtype="float32",
                 kv_dtype=("int8", "float32")[int(rng.integers(0, 2))],
                 prefix_cache=bool(rng.random() < 0.6),
                 deferred_kv=bool(rng.random() < 0.6))
    engine_seed = int(rng.integers(0, 1 << 30))
    out = {}
    for side in ("port", "jax"):
        eng = make(side, models, ec_kw, np.random.default_rng(engine_seed))
        handles = _drive(eng, reqs, np.random.default_rng(engine_seed + 1))
        out[side] = (handles, eng)
    for spec, h, j in zip(reqs, out["port"][0], out["jax"][0]):
        assert h.done
        assert 1 <= len(h.output_tokens) <= spec["max_new_tokens"]
        if spec["temperature"] == 0.0:
            assert h.output_tokens == j.output_tokens, (
                f"trial {trial} {ec_kw}: greedy request diverged from the "
                f"JAX engine (prompt len {len(spec['prompt'])})")
    port, jeng = out["port"][1], out["jax"][1]
    assert port.stats.prefix_hits == jeng.stats.prefix_hits
    assert port.stats.prefix_rows_reused == jeng.stats.prefix_rows_reused


def _batched(side, models, ec_kw, rng):
    jc, jp, tc, tp = models
    chunk = int(rng.integers(1, 9))
    if side == "port":
        return TEngine(tc, tp, TTokenizer().finalize(),
                       tcfg.EngineConfig(**ec_kw), decode_chunk=chunk,
                       device="cpu")
    return JEngine(jc, jp, JTokenizer().finalize(),
                   jcfg.EngineConfig(**ec_kw), decode_chunk=chunk)


def _spec(side, models, ec_kw, rng):
    jc, jp, tc, tp = models
    kw = dict(decode_chunk=int(rng.integers(1, 9)),
              width=int(rng.integers(2, 6)),
              rounds_per_chunk=int(rng.integers(1, 5)), spec_auto=False)
    if side == "port":
        return TSpec(tc, tp, TTokenizer().finalize(),
                     tcfg.EngineConfig(**ec_kw), device="cpu", **kw)
    return JSpec(jc, jp, JTokenizer().finalize(), jcfg.EngineConfig(**ec_kw),
                 **kw)


@pytest.mark.parametrize("trial", range(4))
def test_batched_scheduler_matches_jax(models, trial):
    _run_both(models, trial, _batched, trial)


@pytest.mark.parametrize("trial", range(3))
def test_spec_batched_scheduler_matches_jax(models, trial):
    """The same fuzz through ``SpecBatchedEngine`` (the tuner off, so that
    both sides run the same chunk kinds): sampled slots force plain chunks
    between spec chunks, and those take the deferred path when drawn."""
    _run_both(models, trial, _spec, 100 + trial)
