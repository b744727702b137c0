"""The three load entry points of the port against the JAX package's on
the same files: ``Engine.load``, ``BatchedEngine.load`` and
``SpecBatchedEngine.load_spec`` on ``TINY`` checkpoints of each format
(llama2c quantized on load, FLM INT8 and INT4, GGUF ``Q8_0`` at group size
32, an HF ``.safetensors`` directory), ``device="cpu"``, f32 compute and
f32 scales on both sides, give the JAX engines' greedy tokens.  The JAX
engines run their jnp path (``use_pallas=False``); the port runs on the
CPU, where every kernel wrapper takes its plain version.  A mesh stays
refused."""
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.loaders import flm as jflm
from fastllama_tpu.loaders.registry import FileType as JFileType
from fastllama_tpu.runtime.batching import BatchedEngine as JBatched
from fastllama_tpu.runtime.engine import Engine as JEngine
from fastllama_tpu.runtime.spec_batching import SpecBatchedEngine as JSpec
from fastllama_tpu.tools import synthetic as jsyn
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.registry import FileType
from fastllama_tpu_torch.runtime.batching import BatchedEngine
from fastllama_tpu_torch.runtime.engine import Engine
from fastllama_tpu_torch.runtime.spec_batching import SpecBatchedEngine
from tests.torch_loader_files import write_gguf, write_hf


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here run many tiny ops: one intra-op thread keeps them
    fast when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = jsyn.TINY
EC = dict(compute_dtype="float32", scale_dtype="float32")
PROMPTS = [[1, 300, 17, 263, 5], [1, 42, 7, 99, 300, 5, 61, 62]]
N = 12


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("load_engine")
    w = jsyn.tiny_weights(TINY, seed=4)
    tok = jsyn.tiny_tokenizer(TINY.vocab_size)
    ck, tk = jsyn.write_tiny_llama2c(str(d / "l2c"), TINY, seed=4)
    out = {"llama2c": (ck, tk, "LLAMA2C", "INT8")}
    for qt in ("INT8", "INT4"):
        p = str(d / f"m_{qt}.flm")
        jflm.write_flm(p, TINY, tok, w, jcfg.QuantType[qt],
                       rope_convention="interleaved")
        out["flm_" + qt] = (p, "", "UNKNOWN", None)
    p = str(d / "m.gguf")
    write_gguf(p, TINY, w, tok)
    out["gguf"] = (p, "", "UNKNOWN", None)
    out["hf"] = (write_hf(str(d / "hf"), TINY, w, tok, shard="safetensors"),
                 "", "UNKNOWN", "INT8")
    return out


def _args(files, fmt):
    path, tok, ft, qt = files[fmt]
    jq = None if qt is None else jcfg.QuantType[qt]
    tq = None if qt is None else tcfg.QuantType[qt]
    return ((path, tok, JFileType[ft], jq), (path, tok, FileType[ft], tq))


@pytest.mark.parametrize("fmt", ["llama2c", "flm_INT8", "flm_INT4", "gguf",
                                 "hf"])
def test_engine_load_matches_jax(files, fmt):
    ja, ta = _args(files, fmt)
    je = JEngine.load(*ja, jcfg.EngineConfig(use_pallas=False, **EC))
    te = Engine.load(*ta, tcfg.EngineConfig(**EC), device="cpu")
    assert te.config.group_size == (32 if fmt == "gguf" else 64)
    assert te.config.hidden_dim == je.config.hidden_dim
    for p in PROMPTS:
        want, _ = je.generate(p, max_new_tokens=N, temperature=0.0,
                              stop_tokens=(), decode_chunk=8)
        got, _ = te.generate(p, max_new_tokens=N, temperature=0.0,
                             stop_tokens=(), decode_chunk=8)
        assert got == want and len(got) == N


@pytest.mark.parametrize("fmt", ["llama2c", "gguf"])
def test_batched_load_matches_jax(files, fmt):
    ja, ta = _args(files, fmt)
    kw = dict(max_batch_size=2, max_seq_len=64, **EC)
    je = JBatched.load(*ja, jcfg.EngineConfig(use_pallas=False, **kw),
                       decode_chunk=8)
    te = BatchedEngine.load(*ta, tcfg.EngineConfig(**kw), decode_chunk=8,
                            device="cpu")
    want = je.generate_all(PROMPTS, max_new_tokens=N, temperature=0.0,
                           stop_tokens=())
    got = te.generate_all(PROMPTS, max_new_tokens=N, temperature=0.0,
                          stop_tokens=())
    assert [r.output_tokens for r in got] == [r.output_tokens for r in want]
    assert all(len(r.output_tokens) == N for r in got)


def test_spec_load_matches_jax(files):
    ja, ta = _args(files, "flm_INT8")
    kw = dict(max_batch_size=2, max_seq_len=64, **EC)
    je = JSpec.load_spec(*ja, jcfg.EngineConfig(use_pallas=False, **kw),
                         decode_chunk=8, width=4, rounds_per_chunk=4)
    te = SpecBatchedEngine.load_spec(*ta, tcfg.EngineConfig(**kw),
                                     decode_chunk=8, width=4,
                                     rounds_per_chunk=4, device="cpu")
    rep = [1, 5, 9, 13, 5, 9, 13, 5, 9]
    want = je.generate_all([rep, PROMPTS[0]], max_new_tokens=N,
                           temperature=0.0, stop_tokens=())
    got = te.generate_all([rep, PROMPTS[0]], max_new_tokens=N,
                          temperature=0.0, stop_tokens=())
    assert [r.output_tokens for r in got] == [r.output_tokens for r in want]


def test_load_refusals_and_device_rule(files):
    path, tok, ft, qt = files["llama2c"]
    # a mesh larger than the world: ValueError naming both counts, before
    # the file is read (a missing path would raise another error)
    mesh = tcfg.EngineConfig(mesh="model=2")
    gone = path + ".missing"
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        Engine.load(gone, tok, FileType[ft], engine_config=mesh,
                    device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        BatchedEngine.load(gone, tok, FileType[ft], engine_config=mesh,
                           device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        SpecBatchedEngine.load_spec(gone, tok, FileType[ft],
                                    engine_config=mesh, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine.load(path, tok, FileType[ft])
    # a pre-quantized file keeps its own type over the request
    e = Engine.load(files["flm_INT4"][0], qtype=tcfg.QuantType.INT8,
                    engine_config=tcfg.EngineConfig(**EC), device="cpu")
    assert e.config.quant_type == tcfg.QuantType.INT4
    assert e.config.hidden_dim == 512
    assert np.isfinite(e.generate(PROMPTS[0], max_new_tokens=2,
                                  stop_tokens=())[1].decode_s)
