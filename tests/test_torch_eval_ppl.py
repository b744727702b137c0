"""The port's perplexity tool (``fastllama_tpu_torch/tools/eval_ppl.py``)
against the JAX tool on the same llama2c file: ``perplexity_from_logits``
to 1e-12; ``evaluate`` (a sliding-window prefill through the engine's
kernels) and ``evaluate_decode`` (teacher forcing through the
BatchedEngine's decode step: window packing, the clamped positions, the
zero-padded steps of a short last chunk) within 1e-5 in log perplexity at
f32 compute, with an f32 and an int8 KV cache; the port's decode path
against its prefill path within 1e-3 (the JAX tool's own bar,
``tests/test_engine.py:218-246``); and ``main`` with ``-q int8,none`` at
its default bf16 compute, within 1e-2.
The JAX engines run on their jnp path, as the JAX tool's test runs them."""
import math
import re

import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.loaders.registry import FileType as JFileType
from fastllama_tpu.runtime.batching import BatchedEngine as JBatched
from fastllama_tpu.runtime.engine import Engine as JEngine
from fastllama_tpu.tools import eval_ppl as jev
from fastllama_tpu.tools.synthetic import write_tiny_llama2c
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.registry import FileType
from fastllama_tpu_torch.runtime.batching import BatchedEngine
from fastllama_tpu_torch.runtime.engine import Engine
from fastllama_tpu_torch.tools import eval_ppl as tev

IDS = list(range(2, 120))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_tiny_llama2c(str(tmp_path_factory.mktemp("ppl")))


def _single(files, side):
    ckpt, tokp = files
    if side == "jax":
        return JEngine.load(ckpt, tokp, JFileType.LLAMA2C,
                            jcfg.QuantType.INT8,
                            jcfg.EngineConfig(max_seq_len=64,
                                              compute_dtype="float32"))
    return Engine.load(ckpt, tokp, FileType.LLAMA2C, tcfg.QuantType.INT8,
                       tcfg.EngineConfig(max_seq_len=64,
                                         compute_dtype="float32"),
                       device="cpu")


def _batched(files, side, kv):
    ckpt, tokp = files
    kw = dict(max_seq_len=64, max_batch_size=2, compute_dtype="float32",
              kv_dtype=kv)
    if side == "jax":
        return JBatched.load(ckpt, tokp, JFileType.LLAMA2C,
                             jcfg.QuantType.INT8, jcfg.EngineConfig(**kw))
    return BatchedEngine.load(ckpt, tokp, FileType.LLAMA2C,
                              tcfg.QuantType.INT8, tcfg.EngineConfig(**kw),
                              device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_perplexity_from_logits_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((37, 300)).astype(np.float32) * 4
    tgt = rng.integers(0, 300, 37)
    want = jev.perplexity_from_logits(logits, tgt)
    assert abs(tev.perplexity_from_logits(logits, tgt) - want) <= \
        1e-12 * want


@pytest.mark.parametrize("window", [32, 64])
def test_evaluate_matches_jax(files, window):
    want = jev.evaluate(_single(files, "jax"), IDS, window)
    got = tev.evaluate(_single(files, "port"), IDS, window)
    assert abs(math.log(got) - math.log(want)) <= 1e-5


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("window,chunk", [(32, 16), (0, 16), (0, 7)])
def test_evaluate_decode_matches_jax(files, kv, window, chunk):
    """(0, 16): 64-token windows, a short last chunk of 15 steps; (0, 7):
    positions clamped at max_seq_len - 1 in the last chunk's padded
    steps."""
    want = jev.evaluate_decode(_batched(files, "jax", kv), IDS, window,
                               chunk)
    got = tev.evaluate_decode(_batched(files, "port", kv), IDS, window,
                              chunk)
    assert abs(math.log(got) - math.log(want)) <= 1e-5


def test_decode_path_matches_prefill_path(files):
    p_prefill = tev.evaluate(_single(files, "port"), IDS, window=32)
    p_decode = tev.evaluate_decode(_batched(files, "port", "float32"), IDS,
                                   window=32, step_chunk=16)
    assert abs(math.log(p_decode) - math.log(p_prefill)) < 1e-3


def test_evaluate_decode_of_nothing_is_nan(files):
    assert math.isnan(tev.evaluate_decode(_batched(files, "port", "float32"),
                                          [5]))


def _ppl_lines(out):
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^\s*(\w+): ppl = ([0-9.]+)", out, re.M)}


@pytest.mark.parametrize("engine", ["single", "batched"])
def test_main_matches_jax(tmp_path, capsys, engine):
    """On an HF directory of fp32 weights (the format is sniffed, as the
    tool's command line has no file-type flag).  The tool runs the
    engines' default bf16 compute, where the two sides round differently:
    the bar is bf16's 1e-2 (in log perplexity)."""
    from fastllama_tpu.tools import synthetic as jsyn
    from tests.torch_loader_files import write_hf
    cfg = jsyn.TINY.replace(max_seq_len=64)
    hf = write_hf(str(tmp_path / "hf"), cfg, jsyn.tiny_weights(cfg, seed=5),
                  jsyn.tiny_tokenizer(cfg.vocab_size))
    text = tmp_path / "t.txt"
    text.write_text("the cat sat on the mat and the dog ran to the boy. " * 4)
    argv = ["-c", hf, "-f", str(text), "-q", "int8,none",
            "--window", "32", "--engine", engine, "--batch", "2"]
    assert tev.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jev.main(argv) == 0
    want = capsys.readouterr().out
    g, w = _ppl_lines(got), _ppl_lines(want)
    assert set(g) == set(w) == {"int8", "none"}
    for q in g:
        assert abs(math.log(g[q]) - math.log(w[q])) <= 1e-2
    assert "int8: delta vs fp32" in got
