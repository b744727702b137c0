"""The port's single-stream ``SpeculativeEngine`` on a mesh of two ranks
(``EngineConfig(mesh="model=2")`` for the target and the draft): one spawn
of two gloo ranks on the CPU (``parallel.distributed.run_ranks``, joining
from torchrun's variables) against the JAX ``SpeculativeEngine`` on
``data=1,model=2`` of the virtual CPU mesh, on the same weights (JAX
``random_params`` handed over as numpy), f32 compute and scales.

* Greedy, the n-gram and the draft-model drafter (a one-layer
  ``truncate_params`` draft): token ids and ``SpecStats`` equal JAX's.
* Sampled rounds (JAX's PRNG cannot be reproduced): both ranks emit the
  same tokens, equal to the port's one-card engines' on the same seed;
  the verify's ``nucleus_dist`` rows are JAX's within 1e-5 (the
  accept/residual rule's draws are held statistically by
  ``tests/test_torch_speculative.py``).
* One verify's logits: at f32 within 1e-4 of max|ref| of JAX's
  ``forward``; at bf16 compute over a bf16 cache and over the default f32
  one within 1e-2 of max|ref| of one rank's (the mesh verify attends
  before it writes, ``forward`` writes first: at bf16 the self rows may
  differ by a rounding).
* A draft off the target's mesh raises ValueError; a one-rank mesh (the
  one-card path) takes a draft without one.
* ``FASTLLAMA_PIPELINE=1`` on ``BatchedEngine(mesh="model=2")``
  (``tests/test_torch_pipeline.py``'s traffic): both ranks' tokens equal
  the sequential run's and JAX's, with a stretch run.
* The CLI's ``gen --spec`` and ``gen --draft`` with ``--mesh model=2``:
  exit 0 on both ranks, the output on rank 0's alone.

``jax`` and ``fastllama_tpu`` are imported inside the test functions
only: the spawned ranks import this module."""
import contextlib
import io
import os
import pickle

import numpy as np
import pytest
import torch

from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.parallel.distributed import run_ranks
from tests.test_torch_spmd import jax_arrays, port_params

PROMPT = [5, 9, 13, 80, 200, 31, 5, 9, 13, 80, 7]     # n-gram repeats
N = 24
WIDTH = 4
VERIFY = [7, 5, 9, 13]          # one verify block after PROMPT
EC = dict(compute_dtype="float32", scale_dtype="float32")
SAMPLED = dict(temperature=0.8, topp=0.9, seed=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines run many tiny ops: one intra-op thread keeps them fast
    when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _verify_logits(eng):
    """The target's logits of one verify of VERIFY after PROMPT."""
    cache = eng.new_cache()
    eng._prefill(PROMPT, eng._bucket(len(PROMPT)), cache, 0)
    positions = torch.arange(len(PROMPT), len(PROMPT) + len(VERIFY),
                             dtype=torch.int32)
    return eng._verify(torch.tensor(VERIFY, dtype=torch.int32), positions,
                       cache)


def _engines(tc, tp, mesh, **kw):
    """(target, one-layer draft) on ``mesh``."""
    from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
    from fastllama_tpu_torch.models import llama as tl
    from fastllama_tpu_torch.runtime.engine import Engine
    ec = tcfg.EngineConfig(mesh=mesh, **{**EC, **kw})
    tc1, tp1 = tl.truncate_params(tc, tp, 1)
    tok = Tokenizer().finalize()
    return (Engine(tc, tp, tok, ec, device="cpu"),
            Engine(tc1, tp1, tok, ec, device="cpu"))


def _cli(args):
    from fastllama_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    return rc, buf.getvalue()


def mesh_job(rank, path, ckpt, tokp):
    """Every rank: the group from torchrun's variables, then the cases."""
    from fastllama_tpu_torch.parallel import distributed
    from fastllama_tpu_torch.runtime.speculative import SpeculativeEngine
    from tests.test_torch_pipeline import port_engine, serve_traffic
    distributed.initialize(device="cpu")
    tc, tp = port_params(path)
    target, draft = _engines(tc, tp, "model=2")
    one, one_draft = _engines(tc, tp, "")
    out = {}
    for name in ("ngram", "draft"):
        kw = dict(width=WIDTH, ngram=2)
        spec = SpeculativeEngine(target, draft if name == "draft" else None,
                                 **kw)
        toks, st = spec.generate(PROMPT, max_new_tokens=N, stop_tokens=())
        out[("greedy", name)] = (toks, (st.rounds, st.drafted, st.accepted))
        out[("sampled", name)] = spec.generate(
            PROMPT, max_new_tokens=N, stop_tokens=(), **SAMPLED)[0]
        one_spec = SpeculativeEngine(
            one, one_draft if name == "draft" else None, **kw)
        out[("sampled_one", name)] = one_spec.generate(
            PROMPT, max_new_tokens=N, stop_tokens=(), **SAMPLED)[0]
    try:
        SpeculativeEngine(target, one_draft)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    out["verify_f32"] = _verify_logits(target).numpy()
    # bf16 compute over a bf16 cache and over the default f32 one
    for kv in ("bfloat16", "float32"):
        bf = dict(compute_dtype="bfloat16", kv_dtype=kv)
        got = _verify_logits(_engines(tc, tp, "model=2", **bf)[0])
        # one rank's engine unfused, as the mesh engine is
        want = _verify_logits(_engines(tc, tp, "", fuse_weights=False,
                                       **bf)[0])
        out[("verify_bf16_err", kv)] = float((got - want).abs().max()
                                             / want.abs().max())
    out["pipeline"] = {}
    for pipe in ("0", "1"):
        os.environ["FASTLLAMA_PIPELINE"] = pipe
        eng = port_engine(tc, tp, "batched", mesh="model=2")
        out["pipeline"][pipe] = (serve_traffic(eng), eng.pipelined_chunks)
    del os.environ["FASTLLAMA_PIPELINE"]
    base = ["-c", ckpt, "-z", tokp, "-f", "llama2c", "--mesh", "model=2",
            "-i", "the cat sat", "-n", "8", "-t", "0", "--max-seq-len",
            "64", "--device", "cpu", "--spec-width", "4"]
    out["cli"] = {"spec": _cli(base + ["--spec"]),
                  "draft": _cli(base + ["--draft", ckpt])}
    return out


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    from fastllama_tpu import config as jcfg
    from fastllama_tpu.tools.synthetic import write_tiny_llama2c
    from tests.test_torch_spmd import CFG
    jc, jp, arrays, flags = jax_arrays()
    d = tmp_path_factory.mktemp("spec_mesh")
    path = str(d / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump((arrays, flags), f)
    # group size 64 on load: I/gs 2 and 4 divide the model axis
    fcfg = jcfg.ModelConfig(**{k: v for k, v in CFG.items()
                               if k != "group_size"})
    ckpt, tokp = write_tiny_llama2c(str(d / "file"), cfg=fcfg)
    ranks = run_ranks(mesh_job, 2, path, ckpt, tokp, join=False,
                      timeout=240)
    return dict(jc=jc, jp=jp, ranks=ranks, path=path)


def _jax_spec(shared, drafter):
    from fastllama_tpu import config as jcfg
    from fastllama_tpu.loaders.tokenizer import Tokenizer as JTokenizer
    from fastllama_tpu.models import llama as jl
    from fastllama_tpu.runtime.engine import Engine as JEngine
    from fastllama_tpu.runtime.speculative import SpeculativeEngine as JSpec
    jc, jp = shared["jc"], shared["jp"]
    ec = jcfg.EngineConfig(mesh="data=1,model=2", **EC)
    target = JEngine(jc, jp, JTokenizer().finalize(), ec)
    draft = None
    if drafter == "draft":
        draft = JEngine(*jl.truncate_params(jc, jp, 1),
                        JTokenizer().finalize(), ec)
    return JSpec(target, draft, width=WIDTH, ngram=2)


@pytest.mark.parametrize("drafter", ["ngram", "draft"])
def test_greedy_matches_jax_on_mesh(shared, drafter):
    toks, st = _jax_spec(shared, drafter).generate(
        PROMPT, max_new_tokens=N, stop_tokens=())
    for got in shared["ranks"]:
        assert got[("greedy", drafter)] == (
            toks, (st.rounds, st.drafted, st.accepted))
    assert st.drafted > 0 and len(toks) == N


@pytest.mark.parametrize("drafter", ["ngram", "draft"])
def test_sampled_ranks_agree(shared, drafter):
    r0, r1 = shared["ranks"]
    got = r0[("sampled", drafter)]
    assert got == r1[("sampled", drafter)] == r0[("sampled_one", drafter)]
    assert len(got) == N and got != r0[("greedy", drafter)][0]


def test_verify_logits_and_rows(shared):
    """One verify on the mesh: f32 logits and their nucleus rows against
    JAX's ``forward``; bf16 logits against one rank's."""
    import jax.numpy as jnp
    from fastllama_tpu.models import llama as jl
    from fastllama_tpu.ops import sampling as jsamp
    from fastllama_tpu_torch.ops import sampling as tsamp
    jc, jp = shared["jc"], shared["jp"]
    cache = jl.KVCache.create(jc)
    _, cache = jl.forward(jc, jp, jnp.asarray(PROMPT), 0, cache)
    want, _ = jl.forward(jc, jp, jnp.asarray(VERIFY), len(PROMPT), cache)
    want = np.asarray(want)
    t, p = SAMPLED["temperature"], SAMPLED["topp"]
    rows = np.asarray(jsamp.nucleus_dist(jnp.asarray(want), t, p))
    for got in shared["ranks"]:
        lg = got["verify_f32"]
        assert np.abs(lg - want).max() <= 1e-4 * np.abs(want).max()
        np.testing.assert_allclose(
            tsamp.nucleus_dist(torch.tensor(lg), t, p).numpy(), rows,
            atol=1e-5, rtol=0)
        for kv in ("bfloat16", "float32"):
            assert got[("verify_bf16_err", kv)] <= 1e-2


def test_draft_must_share_the_mesh(shared):
    for got in shared["ranks"]:
        assert got["refused"] is not None and "mesh" in got["refused"]


def test_one_rank_mesh_takes_a_draft_off_mesh(shared):
    """A one-rank mesh runs the one-card path, so a draft without a mesh
    pairs with it, and its greedy tokens are the one-card engine's."""
    from fastllama_tpu_torch.runtime.speculative import SpeculativeEngine
    tc, tp = port_params(shared["path"])
    target, _ = _engines(tc, tp, "model=1")
    one, draft = _engines(tc, tp, "")
    assert not target._spmd and target.mesh is not None
    got = [SpeculativeEngine(t, draft, width=WIDTH, ngram=2).generate(
        PROMPT, max_new_tokens=8, stop_tokens=())[0] for t in (target, one)]
    assert got[0] == got[1] and len(got[0]) == 8


def test_pipeline_on_mesh(shared, monkeypatch):
    """``FASTLLAMA_PIPELINE=1`` on ``model=2``: every rank's tokens equal
    its sequential run's and the JAX engine's under the variable."""
    from tests.test_torch_pipeline import jax_engine, serve_traffic
    monkeypatch.setenv("FASTLLAMA_PIPELINE", "1")
    want = serve_traffic(jax_engine(shared["jc"], shared["jp"], "batched"))
    for got in shared["ranks"]:
        (seq, n0), (pipe, n1) = got["pipeline"]["0"], got["pipeline"]["1"]
        assert pipe == seq == want
        assert n0 == 0 and n1 > 0


@pytest.mark.parametrize("flag", ["spec", "draft"])
def test_cli_gen_spec_on_mesh(shared, flag):
    (rc0, out0), (rc1, out1) = (r["cli"][flag] for r in shared["ranks"])
    assert rc0 == 0 and rc1 == 0
    assert "output:" in out0 and "output_speed:" in out0 and out1 == ""
