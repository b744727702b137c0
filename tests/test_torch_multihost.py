"""The port's multi-host serving (``runtime/multihost.py``) against the JAX
package's ``BatchedEngine`` on the same file, greedy at f32 compute, INT8
weights (``tests/test_multihost.py``'s 2-layer ``CFG`` in a llama2c file):
one process (``data=1``), two gloo ranks spawned on the CPU (``data=2``,
a host a rank) and four (``data=2,model=2``, one spawn: a host of two
ranks), each host given ``tests/multihost_worker.py``'s prompts (copied
here), the outputs concatenated by host equal to the JAX engine's on all
of them.  Also: each host's prefix hits on its own donor (2 a host, 32
rows), ``global_stats`` equal on every rank with each request counted
once, the collectives by group (only the plan, flag and stats gathers
span hosts), a deadline's rejection, admission before the first chunk, a
sampled cold start, a host whose ranks are given different prompts (a
RuntimeError on every rank, no hang), the speculative engine on four
ranks, and the CLI's ``serve --multihost`` on two ranks.  ``jax`` and
``fastllama_tpu`` are imported inside the test functions only (the
spawned ranks import this module)."""
import collections
import contextlib
import dataclasses
import io
import re

import pytest
import torch

from fastllama_tpu_torch.config import EngineConfig, QuantType
from fastllama_tpu_torch.loaders.registry import FileType
from fastllama_tpu_torch.parallel.distributed import run_ranks

CFG = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
           vocab_size=512, max_seq_len=64, group_size=16)
# tests/multihost_worker.py's prompts: host 1's long prompt lands in
# another prefill bucket than host 0's
PROMPTS = {0: ["the cat sat", "a big dog ran"],
           1: ["one two three " * 4, "hello there world"]}
PREFIX_DONOR = list(range(3, 35))                      # 32 tokens
PREFIX_TAILS = {0: [40, 41, 42], 1: [50, 51, 52, 53]}
PREFIX_TAILS2 = {0: [60, 61], 1: [70, 71, 72]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ec(**kw):
    return EngineConfig(max_seq_len=64, compute_dtype="float32", **kw)


def _load(ckpt, tokp, **kw):
    from fastllama_tpu_torch.runtime.multihost import MultiHostEngine
    return MultiHostEngine.load(ckpt, tokp, FileType.LLAMA2C,
                                QuantType.INT8, _ec(**kw), decode_chunk=4,
                                device="cpu")


def _serve(eng, prompts, max_new=6, **kw):
    return [r.output_tokens for r in eng.generate_all(
        prompts, max_new_tokens=max_new, temperature=0.0, stop_tokens=(),
        **kw)]


def _spy(mp):
    """Count this rank's collectives by op and whether their group spans
    more than one host (a host: ``mp`` consecutive ranks), and the calls
    of ``allgather_rows``."""
    import torch.distributed as dist
    from fastllama_tpu_torch.parallel import distributed
    log = collections.Counter()
    for name in ("all_reduce", "all_gather", "broadcast",
                 "broadcast_object_list", "all_gather_object",
                 "all_gather_into_tensor", "reduce_scatter_tensor",
                 "gather", "scatter", "reduce", "all_to_all", "barrier"):
        def wrap(f, name=name):
            def spied(*a, group=None, **k):
                ranks = dist.get_process_group_ranks(
                    group if group is not None else dist.group.WORLD)
                log[(name, len({r // mp for r in ranks}) > 1)] += 1
                return f(*a, group=group, **k)
            return spied
        setattr(dist, name, wrap(getattr(dist, name)))
    rows = distributed.allgather_rows

    def counted(row):
        log["allgather_rows"] += 1
        return rows(row)
    distributed.allgather_rows = counted
    return log


def fleet_job(rank, ckpt, tokp, mesh, extra):
    """Every rank: its host's prompts, then its host's prefix hits on its
    own donor (``tests/multihost_worker.py``'s phases), the fleet's stats
    and the collectives by group; with ``extra`` (the four-rank run) also
    a deadline's rejection, the speculative engine and a host whose ranks
    are given different prompts."""
    from fastllama_tpu_torch.parallel.sharding import (DATA_AXIS,
                                                       MODEL_AXIS, make_mesh)
    mp = make_mesh(mesh).shape[MODEL_AXIS]
    log = _spy(mp)
    eng = _load(ckpt, tokp, max_batch_size=3, prefix_cache=True, mesh=mesh)
    d = eng.host
    out = {"host": d, "lead": eng.lead,
           "host_data": eng.mesh.shape[DATA_AXIS],
           "outputs": _serve(eng, PROMPTS[d])}
    donor = eng.submit(PREFIX_DONOR, max_new_tokens=12, stop_tokens=())
    eng.step()                          # admits the donor: its prefix
    hits = [eng.submit(PREFIX_DONOR[:16] + t, max_new_tokens=4,
                       stop_tokens=())
            for t in (PREFIX_TAILS[d], PREFIX_TAILS2[d])]
    eng.run()
    assert donor.done and all(h.done for h in hits)
    out.update(hit_outputs=[h.output_tokens for h in hits],
               hits=eng.stats.prefix_hits, rows=eng.stats.prefix_rows_reused,
               completed=eng.stats.completed,
               global_stats=dataclasses.asdict(eng.global_stats()),
               log=dict(log))
    if not extra:
        return out
    # the default layout: one host a machine of LOCAL_WORLD_SIZE ranks
    import os
    from fastllama_tpu_torch.parallel.distributed import default_mesh_spec
    specs = {}
    for local in ("1", "2", None):
        if local is None:
            os.environ.pop("LOCAL_WORLD_SIZE", None)
        else:
            os.environ["LOCAL_WORLD_SIZE"] = local
        specs[local] = default_mesh_spec()
    out["default_specs"] = specs
    ok = eng.submit([4, 5], max_new_tokens=2, stop_tokens=())
    doomed = eng.submit([9, 10], max_new_tokens=2, stop_tokens=(),
                        deadline_s=1e-9)
    eng.run()
    out.update(qos=(ok.done, doomed.rejected, doomed.output_tokens,
                    eng.stats.rejected),
               global_rejected=eng.global_stats().rejected)
    from fastllama_tpu_torch.runtime.spec_multihost import \
        MultiHostSpecEngine
    spec = MultiHostSpecEngine.load_spec(
        ckpt, tokp, FileType.LLAMA2C, QuantType.INT8,
        _ec(max_batch_size=3, mesh=mesh), decode_chunk=4, width=4,
        rounds_per_chunk=2, spec_auto=False, device="cpu")
    out.update(spec_outputs=_serve(spec, PROMPTS[d]),
               spec_drafted=spec.spec_drafted)
    # host 1's second rank is given other prompts than its lead
    odd = d == 1 and eng.world_mesh.index(MODEL_AXIS) == 1
    try:
        _serve(eng, ["a different prompt"] if odd else PROMPTS[d])
        out["mismatch"] = None
    except RuntimeError as e:
        out["mismatch"] = str(e)
    return out


def cli_job(rank, ckpt, tokp, pf):
    """The CLI as torchrun starts it: the group from the environment."""
    from fastllama_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["-c", ckpt, "-z", tokp, "-f", "llama2c",
                       "--mode", "serve", "--multihost", "--mesh", "data=2",
                       "--batch", "2", "--prompts-file", pf, "-n", "4",
                       "-t", "0", "--max-seq-len", "64", "--device", "cpu"])
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    from fastllama_tpu.config import ModelConfig
    from fastllama_tpu.tools.synthetic import write_tiny_llama2c
    d = tmp_path_factory.mktemp("multihost")
    ckpt, tokp = write_tiny_llama2c(str(d), cfg=ModelConfig(**CFG))
    pf = d / "p.txt"
    pf.write_text("the cat sat\na big dog\none two three\nhello there\n")
    return dict(ckpt=ckpt, tokp=tokp, pf=str(pf), runs={})


def _jax_outputs(shared, prompts, max_new=6):
    """The JAX package's BatchedEngine on the same file, one admission
    wave (``tests/test_multihost.py:22-30``)."""
    from fastllama_tpu import config as jcfg
    from fastllama_tpu.loaders.registry import FileType as JFileType
    from fastllama_tpu.runtime.batching import BatchedEngine
    eng = BatchedEngine.load(
        shared["ckpt"], shared["tokp"], JFileType.LLAMA2C,
        jcfg.QuantType.INT8,
        jcfg.EngineConfig(max_seq_len=64, max_batch_size=4,
                          compute_dtype="float32"), decode_chunk=4)
    return _serve(eng, prompts, max_new)


def _fleet(shared, mesh):
    runs = shared["runs"]
    if mesh not in runs:
        world = 4 if mesh == "data=2,model=2" else 2
        runs[mesh] = run_ranks(fleet_job, world, shared["ckpt"],
                               shared["tokp"], mesh, world == 4,
                               timeout=300)
    return runs[mesh]


def test_one_process_matches_jax(shared):
    """data=1: one host, no process group; a second admission wave (2
    slots, 3 prompts)."""
    prompts = ["the cat sat", "a big dog ran", "one two three"]
    eng = _load(shared["ckpt"], shared["tokp"], max_batch_size=2)
    assert eng.n_hosts == 1 and eng.lead
    assert _serve(eng, prompts) == _jax_outputs(shared, prompts)
    assert eng.stats.completed == 3 == eng.global_stats().completed


@pytest.mark.parametrize("mesh", ["data=2", "data=2,model=2"])
def test_fleet_matches_jax(shared, mesh):
    """Each host's outputs, concatenated by host, are the JAX engine's on
    all the prompts; each host's two prefix hits (one hit wave) reuse 32
    rows and equal whole prefills' tokens; the fleet's stats are equal
    on every rank and count each request once."""
    ranks = _fleet(shared, mesh)
    mp = len(ranks) // 2
    leads = [r for r in ranks if r["lead"]]
    assert [r["host"] for r in leads] == [0, 1]
    assert all(r["host_data"] == 1 for r in ranks)
    want = _jax_outputs(shared, PROMPTS[0] + PROMPTS[1])
    for r in ranks:
        assert r["outputs"] == want[2 * r["host"]:2 * r["host"] + 2]
    want_hits = _jax_outputs(
        shared, [PREFIX_DONOR[:16] + t for d in (0, 1)
                 for t in (PREFIX_TAILS[d], PREFIX_TAILS2[d])], max_new=4)
    for r in ranks:
        assert r["hits"] == 2 and r["rows"] == 32
        assert r["hit_outputs"] == want_hits[2 * r["host"]:
                                             2 * r["host"] + 2]
        assert r["completed"] == 5
        assert r["global_stats"] == ranks[0]["global_stats"]
    g = ranks[0]["global_stats"]
    assert g["completed"] == 10 and g["prefix_hits"] == 4
    assert g["decode_tokens"] == sum(
        len(t) - 1 for r in leads for t in r["outputs"] + r["hit_outputs"]
    ) + sum(12 - 1 for _ in leads)
    # only the plan, flag and stats gathers span hosts; the steps' own
    # collectives stay within a host ('model' on two ranks a host)
    for r in ranks:
        log = r["log"]
        cross = {k[0]: v for k, v in log.items()
                 if isinstance(k, tuple) and k[1]}
        assert cross == {"all_gather": log["allgather_rows"]}
        local = sum(v for k, v in log.items()
                    if isinstance(k, tuple) and not k[1])
        assert (local > 0) == (mp > 1)


def test_four_ranks_qos_spec_and_mismatch(shared):
    """data=2,model=2: the default layout follows LOCAL_WORLD_SIZE, a
    lapsed deadline rejects on each host (the lead's clock), the
    speculative engine's outputs are plain serving's with drafts on both
    hosts, and a host whose ranks are given different prompts raises on
    every rank, naming host 1 and its ranks."""
    ranks = _fleet(shared, "data=2,model=2")
    want = _jax_outputs(shared, PROMPTS[0] + PROMPTS[1])
    for r in ranks:
        assert r["default_specs"] == {"1": "data=4,model=1",
                                      "2": "data=2,model=2",
                                      None: "data=1,model=4"}
        assert r["qos"] == (True, True, [], 1)
        assert r["global_rejected"] == 2
        assert r["spec_outputs"] == want[2 * r["host"]:2 * r["host"] + 2]
        assert r["spec_drafted"] > 0
        assert r["mismatch"] is not None
        assert "host 1" in r["mismatch"] and "[2, 3]" in r["mismatch"]


def test_qos_priority_and_deadline():
    """One host: a priority-5 request jumps the queue; a lapsed queued
    deadline rejects without running (``tests/test_multihost.py:235-257``)."""
    from fastllama_tpu_torch.config import ModelConfig
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models.llama import random_params
    from fastllama_tpu_torch.runtime.multihost import MultiHostEngine
    cfg = ModelConfig(**CFG)
    eng = MultiHostEngine(cfg, random_params(cfg, seed=3, qtype=QuantType.INT8,
                                             device="cpu"),
                          Tokenizer().finalize(), _ec(max_batch_size=1),
                          decode_chunk=4, device="cpu")
    lo1 = eng.submit([4, 5], max_new_tokens=2, stop_tokens=())
    lo2 = eng.submit([4, 6], max_new_tokens=2, stop_tokens=())
    hi = eng.submit([7, 8], max_new_tokens=2, stop_tokens=(), priority=5)
    doomed = eng.submit([9, 10], max_new_tokens=2, stop_tokens=(),
                        deadline_s=1e-9)
    eng.run()
    assert all(r.done for r in (lo1, lo2, hi))
    assert hi.first_token_s < lo1.first_token_s < lo2.first_token_s
    assert doomed.rejected and doomed.output_tokens == []
    assert eng.stats.rejected == 1


def test_admission_fills_before_first_chunk(shared):
    """A cold backlog larger than ``_ADMIT_CAP`` is admitted in back-to-
    back waves in one round, before the first decode chunk
    (``tests/test_multihost.py:260-287``)."""
    from fastllama_tpu_torch.runtime import multihost as mh
    n = 2 * mh._ADMIT_CAP + 3
    eng = _load(shared["ckpt"], shared["tokp"], max_batch_size=n)
    for i in range(n):
        eng.submit([3, 5 + i, 7], max_new_tokens=12, stop_tokens=())
    assert eng.step()
    assert sum(r is not None for r in eng.slot_req) == n
    assert not eng.queue
    while eng.step():
        pass
    assert eng.stats.completed == n


def test_sampled_cold_start_not_greedy(shared):
    """The plan's greedy flag covers the requests it admits: a hot request
    admitted on a cold start samples its first chunk
    (``tests/test_spec_multihost.py:152-176``); fixed seeds repeat."""
    def run(temp):
        from fastllama_tpu_torch.runtime.multihost import MultiHostEngine
        eng = MultiHostEngine.load(
            shared["ckpt"], shared["tokp"], FileType.LLAMA2C,
            QuantType.INT8, _ec(max_batch_size=2), decode_chunk=8,
            device="cpu")
        req = eng.submit("the cat sat", max_new_tokens=8, temperature=temp,
                         topp=1.0, seed=3, stop_tokens=())
        eng.run()
        return req.output_tokens

    greedy, hot = run(0.0), run(5.0)
    assert len(hot) == 8 and hot != greedy
    assert run(5.0) == hot


def test_cli_serve_multihost(shared, capsys):
    """``serve --multihost --mesh data=2`` under two ranks joining from
    torchrun's variables: exit 0, host d's completions are prompts d::2,
    each the JAX CLI's on the same file, and each host prints the fleet's
    line."""
    from fastllama_tpu import cli as jcli
    ranks = run_ranks(cli_job, 2, shared["ckpt"], shared["tokp"],
                      shared["pf"], join=False, timeout=300)
    rc = jcli.main(["-c", shared["ckpt"], "-z", shared["tokp"], "-f",
                    "llama2c", "--mode", "serve", "--batch", "4",
                    "--prompts-file", shared["pf"], "-n", "4", "-t", "0",
                    "--max-seq-len", "64"])
    assert rc == 0
    want = capsys.readouterr().out

    def texts(out):
        return re.findall(r"^\[\d+\] ttft=\S+ tokens=\d+\n(.*?)\n\n", out,
                          re.M | re.S)
    assert len(texts(want)) == 4
    for d, (rc, out, err) in enumerate(ranks):
        assert rc == 0
        assert texts(out) == texts(want)[d::2]
        assert "fleet: 4 requests" in err
