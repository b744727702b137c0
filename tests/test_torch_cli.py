"""The port's CLI (``python -m fastllama_tpu_torch.cli``) in-process with
``--device cpu``: ``gen`` and ``benchmark`` at ``-t 0`` under ``--parity``
(f32 compute on both sides) print the JAX CLI's text on the same file,
``chat`` fed on stdin the JAX CLI's replies, ``-e``/``-d`` its token ids
and text; ``serve`` (plain, ``--spec``, ``--prefix-cache``) the JAX CLI's
completions at f32 compute; ``serve`` with QoS lines, ``gen --spec`` and
``--draft``, ``--debug`` and ``--profile-dir`` run to rc 0 with their
output checked; a ``--mesh`` larger than the world exits non-zero.
``tools/convert`` writes the JAX converter's bytes; ``utils/`` prints the
JAX package's lines."""
import functools
import io
import os
import re
import sys

import pytest
import torch

from fastllama_tpu import cli as jcli
from fastllama_tpu.tools import convert as jconvert
from fastllama_tpu.tools import synthetic as jsyn
from fastllama_tpu_torch import cli
from fastllama_tpu_torch.tools import convert as tconvert
from tests.torch_loader_files import write_hf


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here run many tiny ops: one intra-op thread keeps them
    fast when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = jsyn.TINY


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ck, tk = jsyn.write_tiny_llama2c(str(d), TINY, seed=6)
    return ["-c", ck, "-z", tk, "-f", "llama2c"], d


def run(main, argv, capsys, stdin=None, monkeypatch=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_gen_and_benchmark_match_jax(ckpt, capsys):
    base, _ = ckpt
    argv = base + ["-i", "the cat and the dog", "-n", "10", "-t", "0",
                   "--parity"]
    rc, want, _ = run(jcli.main, argv, capsys)
    assert rc == 0
    rc, got, _ = run(cli.main, argv + ["--device", "cpu"], capsys)
    assert rc == 0
    text = [ln for ln in got.splitlines() if ln.startswith("output:")]
    assert text and text == [ln for ln in want.splitlines()
                             if ln.startswith("output:")]
    rc, got, _ = run(cli.main, argv + ["--device", "cpu", "-m", "bm",
                                       "--rounds", "2"], capsys)
    assert rc == 0
    stats = dict(kv.split(":", 1) for kv in got.strip().splitlines()[-1]
                 .split("\t"))
    assert set(stats) == {"quant", "prompt_size", "output_size",
                          "total_latency", "prompt_token_latency",
                          "output_token_latency", "prompt_speed",
                          "output_speed"}
    assert stats["output_size"] == "10" and stats["quant"] == "INT8"
    assert float(stats["output_speed"].rstrip("tps")) > 0


def test_chat_on_stdin_matches_jax(ckpt, capsys, monkeypatch):
    base, _ = ckpt
    argv = base + ["-m", "chat", "-n", "6", "-t", "0", "--parity"]
    turns = "the cat\nand the dog\n"
    rc, want, _ = run(jcli.main, argv, capsys, turns, monkeypatch)
    assert rc == 0
    rc, got, _ = run(cli.main, argv + ["--device", "cpu"], capsys, turns,
                     monkeypatch)
    assert rc == 0 and got == want and got.count("bot> ") == 2


def test_encode_decode_match_jax(ckpt, capsys):
    base, _ = ckpt
    for extra in (["-e", "the story of a cat"], ["-d", "1,300,301,320"]):
        rc, want, _ = run(jcli.main, base + extra, capsys)
        rc2, got, _ = run(cli.main, base + extra + ["--device", "cpu"],
                          capsys)
        assert rc == rc2 == 0 and got == want
    rc, got, _ = run(cli.main, base + ["-e", "the story of a cat"], capsys)
    ids = re.search(r"\[(.*)\]", got).group(1).split(", ")
    assert ids[0] == "1"                        # BOS
    rc, got, _ = run(cli.main, base + ["-d", ",".join(ids[1:])], capsys)
    assert got.strip() == "text: the story of a cat"


def test_serve_modes(ckpt, capsys, monkeypatch):
    base, d = ckpt
    prompts = d / "prompts.txt"
    prompts.write_text("the cat and the dog\nthe cat and the boy\n"
                       "the cat and\n")
    common = base + ["-m", "serve", "--batch", "2", "-n", "6", "-t", "0",
                     "--device", "cpu", "--prompts-file", str(prompts)]
    outs = {}
    for name, extra in (("plain", []), ("spec", ["--spec"]),
                        ("prefix", ["--prefix-cache"]),
                        ("qos", ["--qos-chunk", "2", "--prefill-chunk",
                                 "16"])):
        rc, out, err = run(cli.main, common + extra, capsys)
        assert rc == 0, name
        assert "served 3 requests | aggregate decode" in err, name
        assert out.count("tokens=6") == 3, name
        outs[name] = [ln for ln in out.splitlines()
                      if not ln.startswith("[")]
    # greedy serving gives one text whatever the engine's options
    assert outs["spec"] == outs["plain"] == outs["prefix"] == outs["qos"]
    # and the JAX CLI's text at f32 compute.  Neither CLI has a flag for
    # it: serve builds its EngineConfig at the default bf16, where the
    # near-tied logits of random weights may flip between two programs
    for mod in (jcli, cli):
        monkeypatch.setattr(mod, "EngineConfig", functools.partial(
            mod.EngineConfig, compute_dtype="float32"))
    jcommon = [a for a in common if a not in ("--device", "cpu")]
    for name, extra in (("plain", []), ("spec", ["--spec"]),
                        ("prefix", ["--prefix-cache"])):
        rc, want, _ = run(jcli.main, jcommon + extra, capsys)
        rc2, got, _ = run(cli.main, common + extra, capsys)
        assert rc == rc2 == 0, name
        assert want.count("tokens=6") == got.count("tokens=6") == 3, name
        assert [ln for ln in got.splitlines() if not ln.startswith("[")] \
            == [ln for ln in want.splitlines() if not ln.startswith("[")], \
            name
    tsv = d / "prompts.tsv"
    tsv.write_text("1\t0\tthe cat\n0\t30\tthe dog\n")
    rc, out, err = run(cli.main, base + [
        "-m", "serve", "--batch", "1", "-n", "4", "-t", "0", "--device",
        "cpu", "--prompts-file", str(tsv), "--prompts-tsv"], capsys)
    assert rc == 0 and "served 2 requests" in err
    rc, out, err = run(cli.main, common + ["--prompts-file", ""], capsys,
                       "", monkeypatch)
    assert rc == 2 and "no prompts" in err


def test_gen_spec_debug_and_profile(ckpt, capsys):
    base, d = ckpt
    argv = base + ["-i", "the cat the cat the cat", "-n", "8", "-t", "0",
                   "--device", "cpu"]
    rc, plain, _ = run(cli.main, argv, capsys)
    rc2, spec, err = run(cli.main, argv + ["--spec", "--detail"], capsys)
    assert rc == rc2 == 0 and "spec acceptance" in err
    text = [ln for ln in plain.splitlines() if ln.startswith("output:")]
    assert [ln for ln in spec.splitlines() if ln.startswith("output:")] \
        == text
    # a draft model (the same file): greedy speculation keeps the text
    rc, drafted, _ = run(cli.main, argv + ["--draft", base[1]], capsys)
    assert rc == 0 and [ln for ln in drafted.splitlines()
                        if ln.startswith("output:")] == text
    prof = d / "prof"
    rc, _, err = run(cli.main, argv + ["--debug", "--profile-dir",
                                       str(prof)], capsys)
    assert rc == 0 and "# wq shape=" in err and "trace written" in err
    assert os.path.getsize(prof / "trace.json") > 0
    assert "aten::" in (prof / "kernels.txt").read_text()


def test_unported_flags_exit_nonzero(ckpt, capsys):
    """A mesh larger than the world exits 2 with the error's text (no
    process group: one rank), with ``--multihost`` too."""
    base, _ = ckpt
    for extra, text in ((["--mesh", "model=2"], "needs 2 devices, have 1"),
                        (["--spmd-kernels", "--mesh", "data=2"],
                         "needs 2 devices, have 1"),
                        (["--multihost", "-m", "serve", "--mesh", "data=2"],
                         "needs 2 devices, have 1")):
        rc, _, err = run(cli.main, base + extra + ["--device", "cpu"],
                         capsys)
        assert rc == 2 and text in err
    rc, _, err = run(cli.main, ["-i", "x"], capsys)
    assert rc == 2 and "checkpoint" in err


def test_convert_matches_jax(tmp_path, capsys):
    """Any format to FLM: the JAX converter's bytes, INT8, INT16 and
    none, from an HF directory and from an FLM file."""
    w = jsyn.tiny_weights(TINY, seed=7)
    hf = write_hf(str(tmp_path / "hf"), TINY, w,
                  jsyn.tiny_tokenizer(TINY.vocab_size), shard="bin")
    for t in ("int8", "int16", "none"):
        j, p = str(tmp_path / f"j_{t}.flm"), str(tmp_path / f"t_{t}.flm")
        assert jconvert.main(["-m", hf, "-o", j, "-t", t]) == 0
        assert tconvert.main(["-m", hf, "-o", p, "-t", t]) == 0
        assert open(j, "rb").read() == open(p, "rb").read()
    j2, p2 = str(tmp_path / "j2.flm"), str(tmp_path / "t2.flm")
    src = str(tmp_path / "j_int8.flm")
    assert jconvert.main(["-m", src, "-o", j2, "-t", "int16"]) == 0
    assert tconvert.main(["-m", src, "-o", p2, "-t", "int16"]) == 0
    assert open(j2, "rb").read() == open(p2, "rb").read()
    capsys.readouterr()


def test_utils_match_jax(tmp_path):
    """``utils/debug``'s probes print the JAX package's lines on the same
    arrays (a torch tensor and a QArray too); ``StepTimer`` and ``trace``
    / ``annotate`` on ``torch.profiler`` (CPU activity here)."""
    import numpy as np

    from fastllama_tpu.quant import groupquant as jgq
    from fastllama_tpu.utils import debug as jdebug
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.quant import groupquant as tgq
    from fastllama_tpu_torch.utils import debug as tdebug
    from fastllama_tpu_torch.utils.logging import Timer
    from fastllama_tpu_torch.utils.profiling import StepTimer, annotate, trace
    x = np.random.default_rng(8).normal(size=(4, 64)).astype(np.float32)
    t = torch.from_numpy(x)
    for fn in ("tensor_fingerprint", "top_k"):
        assert getattr(tdebug, fn)(t) == getattr(jdebug, fn)(x)
    assert tdebug.compare(t, t * 2) == jdebug.compare(x, x * 2)
    assert tdebug.weight_stats(t, "w") == jdebug.weight_stats(x, "w")
    q = tgq.quantize(t, QuantType.INT8, 64)
    deq = jgq.dequantize_np(*tgq.quantize_np(x, QuantType.INT8, 64), 64)
    assert tdebug.weight_stats(q, "q") == jdebug.weight_stats(deq, "q")
    tdebug.assert_finite(t)
    with pytest.raises(FloatingPointError):
        tdebug.assert_finite(t / 0)
    st = StepTimer()
    for _ in range(10):
        with st.step("decode"):
            pass
    st.add("prefill", 0.5)
    assert st.stats("decode")["count"] == 10 and st.stats("missing") == {}
    assert "prefill" in st.report() and "decode" in st.report()
    assert Timer().elapsed_us() >= 0
    with trace(str(tmp_path / "tr")):
        with annotate("region"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert "region" in (tmp_path / "tr" / "trace.json").read_text()
