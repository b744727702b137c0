"""The port's serving on a mesh of four gloo ranks, ``data=2,model=2``
(``tests/test_torch_spmd.py`` holds the two-rank meshes): the
``BatchedEngine``'s greedy tokens against the JAX engine's on the same
mesh of virtual CPU devices on both of its paths, at f32 compute with an
f32 and an int8 KV cache; the rank's shards; one decode step's logits
against one rank's (1e-4·max|ref| at f32, 1e-2 at bf16);
``evaluate_decode``; and ``spmd_prefill_tail_hits`` (one prefix-cache hit
a data shard, data-shard-local slot ids) against one rank's
``copy_slot_prefix`` and ``prefill_into_slot_at`` (logits 1e-4·max|ref|,
the hit slots' cache rows 2e-5).  ``jax`` and ``fastllama_tpu`` are
imported inside the test functions only."""
import math
import pickle

import pytest
import torch

from fastllama_tpu_torch.models import batched as tb
from tests.test_torch_spmd import (B, CFG, jax_arrays, jax_tokens, mesh_job,
                                   port_params)
from fastllama_tpu_torch.parallel.distributed import run_ranks

MESH = "data=2,model=2"
DONOR = list(range(3, 27))            # 24 tokens: prefix rows [0, 16)
TAILS = [[50, 51, 52, 53, 54], [60, 61, 62, 63, 64, 65, 66, 67]]
START, TB = 16, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hits_inputs():
    toks = torch.zeros((2, TB), dtype=torch.long)
    for i, t in enumerate(TAILS):
        toks[i, :len(t)] = torch.tensor(t)
    lengths = torch.tensor([len(t) for t in TAILS])
    return toks, lengths


def hits_job(rank, path):
    """Slots 0 and 2 (one a data shard) hold the donor prompt; each shard
    takes one hit into its second slot (global 1 and 3).  Returns the
    mesh's logits and its hit rows beside one rank's."""
    from fastllama_tpu_torch.ops.kernels import flash_decode, kv_write, qmm
    from fastllama_tpu_torch.parallel.sharding import (make_mesh,
                                                       new_slot_cache,
                                                       shard_params)
    from fastllama_tpu_torch.parallel.spmd_step import spmd_prefill_tail_hits
    tc, tp = port_params(path)
    f32 = torch.float32
    kw = dict(mm=qmm.make_mm(f32), mm_idx=qmm.make_mm_indexed(f32),
              compute_dtype=f32)
    toks, lengths = _hits_inputs()
    prompt = torch.tensor([DONOR, DONOR])
    plen = torch.tensor([len(DONOR)] * 2)

    ref = tb.BatchedKVCache.create(tc, B, device="cpu")
    tb.prefill_many(tc, tp, prompt, plen, torch.tensor([0, 2]), ref, **kw)
    want = []
    for i, (slot, donor) in enumerate(((1, 0), (3, 2))):
        tb.copy_slot_prefix(ref, donor, slot, START)
        lg, _ = tb.prefill_into_slot_at(
            tc, tp, toks[i], int(lengths[i]), slot, START, ref,
            attn_tail=flash_decode.make_attn_tail(), **kw)
        want.append(lg)

    mesh = make_mesh(MESH)
    sp = shard_params(tc, mesh, tp, "cpu")
    cache = new_slot_cache(tc, mesh, B, device="cpu")
    tb.prefill_many(tc, sp, prompt, plen, torch.tensor([0, 2]), cache,
                    slot_writer=kv_write.make_prefill_writer(), mesh=mesh,
                    data_sharded=True, **kw)
    local = torch.tensor([1, 1])
    got, cache = spmd_prefill_tail_hits(
        tc, mesh, sp, toks, lengths, local, torch.tensor([0, 0]),
        torch.tensor([START, START]), cache,
        attn_tail=flash_decode.make_attn_tail(), **kw)
    d, m = mesh.index("data"), mesh.index("model")
    heads = slice(2 * m, 2 * m + 2)
    rows = slice(0, START + TB)
    return dict(got=got, want=torch.stack(want),
                rows=cache.k[:, 1, :, rows].clone(),
                want_rows=ref.k[:, 2 * d + 1, heads, rows].clone())


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    jc, jp, arrays, flags = jax_arrays()
    path = str(tmp_path_factory.mktemp("spmd4") / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump((arrays, flags), f)
    return jc, jp, path, {}


def four_rank_job(rank, path):
    """Both jobs in one spawn of the four ranks."""
    return dict(mesh_job(rank, path, MESH), hits=hits_job(rank, path))


def port_run(shared):
    _, _, path, runs = shared
    if "serve" not in runs:
        runs["serve"] = run_ranks(four_rank_job, 4, path)
    return runs["serve"]


@pytest.mark.parametrize("path", ["gspmd", "spmd"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_batched_engine_matches_jax_4ranks(shared, kv, path):
    want = jax_tokens(shared, MESH, kv, path)
    for rank, got in enumerate(port_run(shared)):
        assert got["tokens"][kv] == want, (kv, path, rank)


def test_each_of_four_ranks_holds_its_shards(shared):
    hs = CFG["dim"] // CFG["n_heads"]
    for got in port_run(shared):
        assert got["contiguous"]
        assert got["wq_shape"] == (2, 128, 64)
        assert got["wo_shape"] == (2, 64, 128)
        assert got["cache_shape"] == (2, B // 2, 2, 64, hs)
        assert got["scale_shape"] == (2, B // 2, 2, 64)


@pytest.mark.parametrize("cdt,tol", [("float32", 1e-4), ("bfloat16", 1e-2)])
def test_decode_logits_match_one_rank_4ranks(shared, cdt, tol):
    for got in port_run(shared):
        assert got["logits_err"][cdt] <= tol


def test_evaluate_decode_on_4ranks(shared):
    for got in port_run(shared):
        mesh_ppl, one = got["ppl"]
        assert abs(math.log(mesh_ppl) - math.log(one)) <= 1e-5


def test_prefill_tail_hits_match_one_rank(shared):
    for got in (r["hits"] for r in port_run(shared)):
        want = got["want"]
        assert (got["got"] - want).abs().max() <= 1e-4 * want.abs().max()
        assert torch.allclose(got["rows"], got["want_rows"], rtol=2e-5,
                              atol=2e-5)
