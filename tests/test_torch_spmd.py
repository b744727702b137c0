"""The port's serving on a mesh of two ranks (``parallel/`` and
``BatchedEngine(EngineConfig(mesh=...))``): gloo ranks spawned on the CPU
(``parallel.distributed.run_ranks``) against the JAX ``BatchedEngine`` on
the same mesh of virtual CPU devices, on both of its paths (GSPMD over plain jnp,
and ``spmd_kernels`` with the Pallas kernels in interpret mode), on the
same weights (JAX ``random_params`` handed over as numpy).  Greedy tokens
equal at f32 compute, with an f32 and an int8 KV cache; one decode step's
logits on the mesh within 1e-4·max|ref| of one rank's at f32 and 1e-2 at
bf16; ``evaluate_decode`` on the mesh equal to one rank's within 1e-5 in
log perplexity.  ``jax`` and ``fastllama_tpu`` are imported inside the
test functions only: the spawned ranks import this module."""
import dataclasses
import math
import pickle

import numpy as np
import pytest
import torch

from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.parallel.distributed import run_ranks

CFG = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
           vocab_size=256, max_seq_len=64, group_size=16)
# one admission wave (a second wave costs the JAX engines a compile; the
# serving tests admit into freed slots)
PROMPTS = [[5, 6, 7, 8, 9], [10, 11, 12],
           [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19],
           [40, 41]]
BUDGETS = (6, 10, 4, 8)
B = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines run many tiny ops: one intra-op thread keeps them fast
    when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_arrays(seed=3):
    """JAX ``random_params`` at INT8 as (config, params, numpy arrays,
    flags) for ``params_from_numpy``."""
    from fastllama_tpu import config as jcfg
    from fastllama_tpu.models import llama as jl
    jc = jcfg.ModelConfig(**CFG, quant_type=jcfg.QuantType.INT8)
    jp = jl.random_params(jc, seed=seed, qtype=jcfg.QuantType.INT8)
    arrays, flags = {}, {}
    for f in dataclasses.fields(jp):
        v = getattr(jp, f.name)
        if hasattr(v, "scales"):
            arrays[f.name] = (np.asarray(v.data), np.asarray(v.scales))
            flags[f.name] = dict(qtype=v.qtype.name, group_size=v.group_size,
                                 group_axis=v.group_axis, packed=v.packed)
        else:
            arrays[f.name] = None if v is None else np.asarray(v)
    return jc, jp, arrays, flags


def port_params(path):
    with open(path, "rb") as f:
        arrays, flags = pickle.load(f)
    tc = tcfg.ModelConfig(**CFG, quant_type=tcfg.QuantType.INT8)
    return tc, tl.params_from_numpy(tc, arrays, flags, device="cpu")


def serve(eng):
    reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0, stop_tokens=())
            for p, n in zip(PROMPTS, BUDGETS)]
    eng.run()
    assert all(r.done for r in reqs)
    return [r.output_tokens for r in reqs]


def _engine(tc, tp, mesh="", **kw):
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    ec = dict(max_batch_size=B, compute_dtype="float32")
    ec.update(kw)
    return BatchedEngine(tc, tp, Tokenizer().finalize(),
                         tcfg.EngineConfig(mesh=mesh, **ec), decode_chunk=4,
                         device="cpu")


def _step_logits(eng):
    """One admission wave of the first four prompts, then one decode step
    of every slot fed each prompt's first token (a sampled token could
    part at bf16): its logits (B, vocab)."""
    for p in PROMPTS[:B]:
        eng.submit(p, max_new_tokens=4, stop_tokens=())
    eng._admit_pending()
    tok = torch.tensor([p[0] for p in PROMPTS[:B]])
    lg, _ = eng.decode(tok, torch.as_tensor(eng.pos), eng.cache)
    return lg


def mesh_job(rank, path, mesh):
    """Runs on every rank: the engines on ``mesh`` and, for the logits
    and perplexity checks, one rank's engines beside them."""
    from fastllama_tpu_torch.tools.eval_ppl import evaluate_decode
    tc, tp = port_params(path)
    out = {"tokens": {}, "logits_err": {}}
    for kv in ("float32", "int8"):
        eng = _engine(tc, tp, mesh, kv_dtype=kv)
        out["tokens"][kv] = serve(eng)
    out["cache_shape"] = tuple(eng.cache.k.shape)
    out["scale_shape"] = tuple(eng.cache.k_scale.shape)
    out["wq_shape"] = tuple(eng.params.wq.shape)
    out["wo_shape"] = tuple(eng.params.wo.shape)
    out["contiguous"] = all(
        t.is_contiguous() for t in (eng.params.wq.data, eng.params.wo.scales,
                                    eng.params.embedding.data))
    for cdt in ("float32", "bfloat16"):
        got = _step_logits(_engine(tc, tp, mesh, compute_dtype=cdt,
                                   kv_dtype="int8"))
        # unfused, as the mesh engine is
        want = _step_logits(_engine(tc, tp, compute_dtype=cdt,
                                    kv_dtype="int8", fuse_weights=False))
        out["logits_err"][cdt] = float(
            (got - want).abs().max() / want.abs().max())
    ids = list(range(2, 120))
    out["ppl"] = (evaluate_decode(_engine(tc, tp, mesh), ids, 32, 16),
                  evaluate_decode(_engine(tc, tp), ids, 32, 16))
    return out


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    jc, jp, arrays, flags = jax_arrays()
    path = str(tmp_path_factory.mktemp("spmd") / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump((arrays, flags), f)
    return jc, jp, path, {}


def port_run(shared, mesh):
    """Every rank's results on ``mesh`` (run once per mesh)."""
    _, _, path, runs = shared
    if mesh not in runs:
        runs[mesh] = run_ranks(mesh_job, 2, path, mesh)
    return runs[mesh]


def jax_tokens(shared, mesh, kv, path):
    from fastllama_tpu import config as jcfg
    from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
    from fastllama_tpu.runtime.batching import BatchedEngine as JEngine
    jc, jp, _, _ = shared
    spmd = path == "spmd"
    eng = JEngine(jc, jp, JTokenizer().finalize(), jcfg.EngineConfig(
        max_batch_size=B, compute_dtype="float32", kv_dtype=kv, mesh=mesh,
        spmd_kernels=spmd, pallas_interpret=spmd), decode_chunk=4)
    return serve(eng)


MESHES = ["model=2", "data=2"]


@pytest.mark.parametrize("path", ["gspmd", "spmd"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("mesh", MESHES)
def test_batched_engine_matches_jax_mesh(shared, mesh, kv, path):
    """Every rank emits the JAX engine's greedy tokens on the same mesh."""
    want = jax_tokens(shared, mesh, kv, path)
    for rank, got in enumerate(port_run(shared, mesh)):
        assert got["tokens"][kv] == want, (mesh, kv, path, rank)


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_shards(shared, mesh):
    """Contiguous weight shards and the cache's local block: kv heads over
    'model', slots over 'data'."""
    mp = 2 if "model" in mesh else 1
    dp = 2 if "data" in mesh else 1
    hs = CFG["dim"] // CFG["n_heads"]
    for got in port_run(shared, mesh):
        assert got["contiguous"]
        assert got["wq_shape"] == (2, 128, 128 // mp)
        assert got["wo_shape"] == (2, 128 // mp, 128)
        assert got["cache_shape"] == (2, B // dp, 4 // mp, 64, hs)
        assert got["scale_shape"] == (2, B // dp, 4 // mp, 64)


@pytest.mark.parametrize("cdt,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("mesh", MESHES)
def test_decode_logits_match_one_rank(shared, mesh, cdt, tol):
    """One decode step on the mesh against one rank's engine on the same
    weights and cache contents: the sum order of the row-parallel
    partials is the only difference."""
    for got in port_run(shared, mesh):
        assert got["logits_err"][cdt] <= tol


@pytest.mark.parametrize("mesh", MESHES)
def test_evaluate_decode_on_mesh(shared, mesh):
    for got in port_run(shared, mesh):
        mesh_ppl, one = got["ppl"]
        assert abs(math.log(mesh_ppl) - math.log(one)) <= 1e-5
