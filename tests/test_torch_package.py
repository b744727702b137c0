"""The port as a package: it imports neither JAX nor the JAX package, its
entry points follow the device rule, and its refusals of options that are
not ported yet are loud."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
from fastllama_tpu_torch.models import batched as tb
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.ops.kernels import qmm
from fastllama_tpu_torch.runtime.batching import BatchedEngine
from fastllama_tpu_torch.runtime.engine import Engine
from fastllama_tpu_torch.runtime.spec_batching import SpecBatchedEngine

ROOT = Path(__file__).resolve().parents[1]
CFG = tcfg.ModelConfig(dim=128, hidden_dim=256, n_layers=2, n_heads=4,
                       n_kv_heads=2, vocab_size=256, max_seq_len=64)


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, leaves no
    ``jax*`` and no ``fastllama_tpu`` module behind."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fastllama_tpu_torch as p\n"
        "names = [m.name for m in\n"
        "         pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'fastllama_tpu'))\n"
        "print(' '.join(names))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    walked = r.stdout.split("\n")[0].split()
    for mod in ("runtime.engine", "runtime.sampler", "runtime.kernels",
                "runtime.spec_batching", "ops.kernels.attention",
                "ops.kernels.flash_decode", "ops.kernels.kv_write",
                "ops.kernels.qmm", "models.llama", "models.batched",
                "ops.sampling", "tools.timing", "tools.hbm_peak",
                "tools.qmm_sweep", "tools.synthetic", "tools.convert",
                "loaders.registry", "loaders.flm", "loaders.gguf",
                "loaders.hf", "loaders.llama2c", "loaders.native",
                "parallel.sharding", "parallel.distributed",
                "parallel.spmd_step", "tools.eval_ppl", "utils.profiling",
                "utils.debug", "utils.logging", "cli"):
        assert "fastllama_tpu_torch." + mod in walked


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py names no JAX module in its imports."""
    src = (ROOT / "chip_smoke.py").read_text()
    for line in src.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            assert not words[1].split(".")[0] in ("jax", "fastllama_tpu"), line


def test_entry_points_need_a_card_or_cpu():
    """Without a card, device=None (meaning "cuda") raises at every entry
    point; device="cpu" works."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    params = tl.random_params_int(CFG, seed=0, device="cpu")
    from fastllama_tpu_torch.tools import hbm_peak, qmm_sweep
    calls = [
        lambda: tl.random_params_int(CFG, seed=0),
        lambda: tl.random_params(CFG, seed=0),
        lambda: tl.random_params_int(CFG, seed=0,
                                     qtype=tcfg.QuantType.NONE),
        lambda: hbm_peak.read_gbs(1),
        lambda: qmm_sweep.make_weights(128, 128, "int8", torch.float32, 1,
                                       None),
        lambda: tb.BatchedKVCache.create(CFG, 2),
        lambda: tl.params_from_numpy(CFG, {}, {}),
        lambda: BatchedEngine(CFG, params, Tokenizer().finalize(),
                              tcfg.EngineConfig(max_batch_size=2)),
        lambda: tl.KVCache.create(CFG),
        lambda: Engine(CFG, params, Tokenizer().finalize()),
        lambda: SpecBatchedEngine(CFG, params, Tokenizer().finalize(),
                                  tcfg.EngineConfig(max_batch_size=2)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    eng = BatchedEngine(CFG, params, Tokenizer().finalize(),
                        tcfg.EngineConfig(max_batch_size=2), device="cpu")
    req = eng.generate_all([[5, 6, 7]], max_new_tokens=3, stop_tokens=())[0]
    assert req.done and len(req.output_tokens) == 3
    toks, _ = Engine(CFG, params, Tokenizer().finalize(),
                     device="cpu").generate([5, 6, 7], max_new_tokens=3,
                                            stop_tokens=())
    assert len(toks) == 3
    spec = SpecBatchedEngine(CFG, params, Tokenizer().finalize(),
                             tcfg.EngineConfig(max_batch_size=2),
                             device="cpu")
    req = spec.generate_all([[5, 6, 7]], max_new_tokens=3,
                            stop_tokens=())[0]
    assert req.done and len(req.output_tokens) == 3


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that is neither on the CPU nor on a card raises; it never
    falls back to the plain version."""
    w = tl.random_params_int(CFG, seed=0, device="cpu").wo[0]
    x = torch.zeros((2, CFG.dim))
    assert qmm.qmatmul_pallas(x, w).shape == (2, CFG.dim)
    with pytest.raises(ValueError, match="unsupported device"):
        qmm.qmatmul_pallas(x.to("meta"), w.to("meta"))


@pytest.mark.parametrize("option,err", [
    (dict(mesh="model=2"), ValueError),
    (dict(mesh="data=2", spmd_kernels=True), ValueError),
    (dict(pallas_interpret=True), NotImplementedError)],
    ids=["option0", "option1", "option2"])
def test_unported_options_raise(option, err):
    """A mesh larger than the world (one rank without a process group)
    raises ValueError naming both counts; TPU interpret mode is not
    ported."""
    params = tl.random_params_int(CFG, seed=0, device="cpu")
    for engine in (BatchedEngine, SpecBatchedEngine):
        with pytest.raises(err) as e:
            engine(CFG, params, Tokenizer().finalize(),
                   tcfg.EngineConfig(max_batch_size=2, **option),
                   device="cpu")
        if err is ValueError:
            assert "devices, have 1" in str(e.value)


def test_unported_entry_points_raise():
    """The load entry points refuse a mesh larger than the world before
    any file is read."""
    mesh = tcfg.EngineConfig(max_batch_size=2, mesh="model=2")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        BatchedEngine.load("ckpt", "tok", engine_config=mesh)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        SpecBatchedEngine.load_spec("ckpt", "tok", engine_config=mesh)
