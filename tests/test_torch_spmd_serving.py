"""The port's mesh serving beyond the plain batched path, on two gloo
ranks spawned on the CPU, against the JAX engines on the same mesh of
virtual CPU devices and the same weights, greedy at f32 compute: the
prefix cache (``model=2`` against JAX's ``spmd_kernels`` path;
``data=2``, where a hit's donor may sit on the other data shard and its
rows are broadcast over 'data', against its GSPMD path), the
single-stream ``Engine`` (whole prefill against JAX's GSPMD path,
chunked prefill, the per-rank tail at pos > 0, against its
``spmd_kernels`` path), ``SpecBatchedEngine`` (the tuner's arm agreed
from rank 0), ``BatchedEngine.load`` / ``Engine.load`` on a llama2c file,
and the CLI's ``serve --mesh model=2`` joining the group from torchrun's
variables (held to ``tests/test_engine.py:197-215``; rank 0 alone writes
the output).  ``jax`` and ``fastllama_tpu`` are imported inside the test
functions only."""
import contextlib
import io
import pickle

import pytest
import torch

from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.registry import FileType
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
from tests.test_torch_spmd import CFG, jax_arrays, port_params
from fastllama_tpu_torch.parallel.distributed import run_ranks

SYS = list(range(100, 132))                       # a 32-token shared prefix
PREFIX_PROMPTS = [SYS + [5, 6], SYS + [7], SYS + [8, 9, 10], SYS + [11],
                  SYS + [12, 13], SYS + [14], SYS + [15, 16]]
PREFIX_BUDGETS = (16, 3, 5, 12, 6, 8, 4)
LONG = [(7 * i + 3) % 200 + 20 for i in range(40)]
SPEC_PROMPTS = [[5, 6, 7, 8, 5, 6, 7, 8, 5, 6], [9, 10, 11, 9, 10, 11, 9],
                [20, 21, 22, 23, 24], [30, 31, 30, 31, 30, 31, 30]]
TEXT_PROMPTS = ["the cat sat", "a big dog"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve(eng, prompts, budgets):
    reqs = [eng.submit(p, max_new_tokens=n, temperature=0.0, stop_tokens=())
            for p, n in zip(prompts, budgets)]
    eng.run()
    return [r.output_tokens for r in reqs]


def _generate(eng):
    return [eng.generate(p, max_new_tokens=12, temperature=0.0,
                         stop_tokens=(), decode_chunk=4)[0]
            for p in (LONG, LONG[:9])]


def serving_job(rank, path, ckpt, tokp, mesh):
    """Every rank: the prefix cache on ``mesh``; on model=2 also the
    single-stream engine, the speculative engine and the loaders."""
    import fastllama_tpu_torch.runtime.batching as tbat
    from fastllama_tpu_torch.runtime.batching import BatchedEngine
    from fastllama_tpu_torch.runtime.engine import Engine
    from fastllama_tpu_torch.runtime.spec_batching import SpecBatchedEngine
    tc, tp = port_params(path)
    tok = Tokenizer().finalize()
    copies = []
    copy = tbat.copy_slot_prefix

    def spy(cache, src, dst, n, mesh_=None, data_sharded=False):
        copies.append((src // cache.k.shape[1], dst // cache.k.shape[1]))
        return copy(cache, src, dst, n, mesh_, data_sharded)

    tbat.copy_slot_prefix = spy
    out = {}
    eng = BatchedEngine(tc, tp, tok, tcfg.EngineConfig(
        max_batch_size=4, compute_dtype="float32", mesh=mesh,
        prefix_cache=True), decode_chunk=4, device="cpu")
    out["prefix"] = _serve(eng, PREFIX_PROMPTS, PREFIX_BUDGETS)
    out["hits"] = eng.stats.prefix_hits
    out["copies"] = copies
    if mesh != "model=2":
        return out
    out["engine"] = {}
    for chunk in (0, 16):
        e = Engine(tc, tp, tok, tcfg.EngineConfig(
            compute_dtype="float32", mesh=mesh, prefill_chunk=chunk),
            device="cpu")
        out["engine"][chunk] = _generate(e)
    spec = SpecBatchedEngine(tc, tp, tok, tcfg.EngineConfig(
        max_batch_size=4, compute_dtype="float32", mesh=mesh),
        decode_chunk=4, width=4, rounds_per_chunk=4, device="cpu")
    out["spec"] = _serve(spec, SPEC_PROMPTS, (9, 12, 7, 10))
    out["spec_arms"] = dict(spec.arm_chunks)
    lec = tcfg.EngineConfig(max_seq_len=64, max_batch_size=2,
                            compute_dtype="float32", mesh=mesh)
    be = BatchedEngine.load(ckpt, tokp, FileType.LLAMA2C,
                            tcfg.QuantType.INT8, lec, decode_chunk=4,
                            device="cpu")
    out["load"] = [r.output_tokens for r in be.generate_all(
        TEXT_PROMPTS, max_new_tokens=8, temperature=0.0, stop_tokens=())]
    out["load_wq"] = tuple(be.params.wq.shape)
    se = Engine.load(ckpt, tokp, FileType.LLAMA2C, tcfg.QuantType.INT8,
                     lec, device="cpu")
    out["load_engine"] = se.generate(TEXT_PROMPTS[0], max_new_tokens=8,
                                     temperature=0.0, stop_tokens=())[0]
    return out


def cli_job(rank, ckpt, tokp, pf):
    """The CLI as torchrun starts it: the group from the environment."""
    from fastllama_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-c", ckpt, "-z", tokp, "-f", "llama2c",
                       "--mode", "serve", "--batch", "2", "--mesh",
                       "model=2", "--prompts-file", pf, "-n", "4", "-t", "0",
                       "--max-seq-len", "64", "--device", "cpu"])
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    from fastllama_tpu import config as jcfg
    from fastllama_tpu.tools.synthetic import write_tiny_llama2c
    jc, jp, arrays, flags = jax_arrays()
    d = tmp_path_factory.mktemp("spmd_serving")
    path = str(d / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump((arrays, flags), f)
    # group size 64 on load: I/gs 2 and 4 divide the model axis
    fcfg = jcfg.ModelConfig(**{k: v for k, v in CFG.items()
                               if k != "group_size"})
    ckpt, tokp = write_tiny_llama2c(str(d / "file"), cfg=fcfg)
    pf = d / "p.txt"
    pf.write_text("the cat\nthe dog\n")
    return dict(jc=jc, jp=jp, path=path, ckpt=ckpt, tokp=tokp, pf=str(pf),
                runs={})


def port_run(shared, mesh):
    runs = shared["runs"]
    if mesh not in runs:
        runs[mesh] = run_ranks(serving_job, 2, shared["path"],
                               shared["ckpt"], shared["tokp"], mesh)
    return runs[mesh]


def _jec(mesh, path, **kw):
    from fastllama_tpu import config as jcfg
    spmd = path == "spmd"
    return jcfg.EngineConfig(compute_dtype="float32", mesh=mesh,
                             spmd_kernels=spmd, pallas_interpret=spmd, **kw)


@pytest.mark.parametrize("mesh,path", [("model=2", "spmd"),
                                       ("data=2", "gspmd")])
def test_prefix_cache_on_mesh_matches_jax(shared, mesh, path):
    from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
    from fastllama_tpu.runtime.batching import BatchedEngine as JEngine
    eng = JEngine(shared["jc"], shared["jp"], JTokenizer().finalize(),
                  _jec(mesh, path, max_batch_size=4, prefix_cache=True),
                  decode_chunk=4)
    want = _serve(eng, PREFIX_PROMPTS, PREFIX_BUDGETS)
    for got in port_run(shared, mesh):
        assert got["prefix"] == want
        assert got["hits"] == eng.stats.prefix_hits > 0
    if mesh == "data=2":
        # a donor on the other data shard: its rows went over 'data'
        assert any(s != d for s, d in port_run(shared, mesh)[0]["copies"])


@pytest.mark.parametrize("chunk,path", [(0, "gspmd"), (16, "spmd")])
def test_engine_on_mesh_matches_jax(shared, chunk, path):
    from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
    from fastllama_tpu.runtime.engine import Engine as JEngine
    eng = JEngine(shared["jc"], shared["jp"], JTokenizer().finalize(),
                  _jec("model=2", path, prefill_chunk=chunk))
    want = _generate(eng)
    for got in port_run(shared, "model=2"):
        assert got["engine"][chunk] == want


def test_spec_engine_on_mesh_matches_jax(shared):
    """JAX's spec engine on its jnp path, as tests/test_spec_batching.py
    runs it; greedy tokens do not depend on the arms the tuners pick."""
    from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
    from fastllama_tpu.runtime.spec_batching import SpecBatchedEngine as JSpec
    eng = JSpec(shared["jc"], shared["jp"], JTokenizer().finalize(),
                _jec("model=2", "gspmd", max_batch_size=4, use_pallas=False),
                decode_chunk=4, width=4, rounds_per_chunk=4)
    want = _serve(eng, SPEC_PROMPTS, (9, 12, 7, 10))
    ranks = port_run(shared, "model=2")
    for got in ranks:
        assert got["spec"] == want
    assert ranks[0]["spec_arms"] == ranks[1]["spec_arms"]
    assert sum(v for k, v in ranks[0]["spec_arms"].items() if k) > 0


def test_load_on_mesh_matches_jax(shared):
    from fastllama_tpu import config as jcfg
    from fastllama_tpu.loaders.registry import FileType as JFileType
    from fastllama_tpu.runtime.batching import BatchedEngine as JEngine
    from fastllama_tpu.runtime.engine import Engine as JSingle
    ec = _jec("model=2", "gspmd", max_seq_len=64, max_batch_size=2)
    be = JEngine.load(shared["ckpt"], shared["tokp"], JFileType.LLAMA2C,
                      jcfg.QuantType.INT8, ec, decode_chunk=4)
    want = [r.output_tokens for r in be.generate_all(
        TEXT_PROMPTS, max_new_tokens=8, temperature=0.0, stop_tokens=())]
    se = JSingle.load(shared["ckpt"], shared["tokp"], JFileType.LLAMA2C,
                      jcfg.QuantType.INT8, ec)
    want1 = se.generate(TEXT_PROMPTS[0], max_new_tokens=8, temperature=0.0,
                        stop_tokens=())[0]
    for got in port_run(shared, "model=2"):
        assert got["load"] == want
        assert got["load_engine"] == want1
        assert got["load_wq"] == (2, 128, 64)


def test_cli_serve_on_mesh(shared, capsys):
    """``serve --mesh model=2``: exit 0 on both ranks, both completions on
    rank 0's output and nothing on rank 1's; the completions are JAX's
    CLI's on the same mesh."""
    from fastllama_tpu import cli as jcli
    (rc0, out0), (rc1, out1) = run_ranks(
        cli_job, 2, shared["ckpt"], shared["tokp"], shared["pf"],
        join=False)
    assert rc0 == 0 and rc1 == 0
    assert out0.count("ttft=") == 2 and out1 == ""
    capsys.readouterr()
    rc = jcli.main(["-c", shared["ckpt"], "-z", shared["tokp"], "-f",
                    "llama2c", "--mode", "serve", "--batch", "2", "--mesh",
                    "data=1,model=2", "--prompts-file", shared["pf"], "-n",
                    "4", "-t", "0", "--max-seq-len", "64"])
    want = capsys.readouterr().out

    def texts(out):
        return [ln for ln in out.splitlines()
                if ln and not ln.startswith("[")]
    assert rc == 0 and texts(out0) == texts(want)
