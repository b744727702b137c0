"""The slice as a whole: the port's single-stream ``Engine`` and
``ChatSession`` against the JAX package's on the same weights (JAX
``random_params`` handed over as numpy), at f32 compute with f32 scales
pinned on both sides.  The JAX engines run their Pallas kernels in
interpret mode (``EngineConfig(pallas_interpret=True)``); the port runs on
the CPU, where every kernel wrapper takes its plain version.  Greedy tokens
are equal, and so are the tokens of ``host_sampling`` at temperature 0.8
(the xorshift sampler is exact across frameworks).  Also the
``BatchedEngine``'s ``flash_attention=False`` path."""
import dataclasses

import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.loaders.tokenizer import \
    build_byte_fallback_vocab as j_vocab
from fastllama_tpu.models import llama as jl
from fastllama_tpu.runtime.batching import BatchedEngine as JBatched
from fastllama_tpu.runtime.engine import ChatSession as JChat
from fastllama_tpu.runtime.engine import Engine as JEngine
from fastllama_tpu_torch import ChatSession, Engine
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import \
    build_byte_fallback_vocab as t_vocab
from fastllama_tpu_torch.runtime.batching import BatchedEngine as TBatched
from tests.test_torch_model import to_port


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here run many tiny ops: one intra-op thread keeps them
    fast when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V = 512
CFG = dict(dim=256, hidden_dim=512, n_layers=4, n_heads=8, n_kv_heads=4,
           vocab_size=V, max_seq_len=128)
EXTRA = [f"w{i}" for i in range(V - 259)]
EC = dict(compute_dtype="float32", scale_dtype="float32")


@pytest.fixture(scope="module")
def sides():
    """(JAX engine, port engine) over the same INT8 weights."""
    jc = jcfg.ModelConfig(**CFG, quant_type=jcfg.QuantType.INT8)
    tc = tcfg.ModelConfig(**CFG, quant_type=tcfg.QuantType.INT8)
    jp = jl.random_params(jc, seed=11, qtype=jcfg.QuantType.INT8)
    tp = to_port(tc, jp)
    je = JEngine(jc, jp, j_vocab(EXTRA),
                 jcfg.EngineConfig(pallas_interpret=True, **EC))
    te = Engine(tc, tp, t_vocab(EXTRA), tcfg.EngineConfig(**EC),
                device="cpu")
    je.raw_params, te.raw_params = jp, tp       # before fusion
    return je, te


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, V, size=n).tolist()


def test_greedy_tokens_match_jax(sides):
    """Two full chunks of 8 and a tail chunk of 3 (20 new tokens)."""
    je, te = sides
    p = _prompt(0, 21)
    want, _ = je.generate(p, max_new_tokens=20, decode_chunk=8,
                          stop_tokens=())
    got, st = te.generate(p, max_new_tokens=20, decode_chunk=8,
                          stop_tokens=())
    assert got == want and len(got) == 20
    assert st.output_tokens == 20 and st.prompt_tokens == 21


def test_chunked_equals_stepwise_and_pipe_depth(sides, monkeypatch):
    _, te = sides
    p = _prompt(1, 9)
    ref, _ = te.generate(p, max_new_tokens=14, decode_chunk=1,
                         stop_tokens=())
    for chunk in (4, 5, 32):
        assert te.generate(p, max_new_tokens=14, decode_chunk=chunk,
                           stop_tokens=())[0] == ref
    monkeypatch.setenv("FASTLLAMA_PIPE", "1")
    assert te.generate(p, max_new_tokens=14, decode_chunk=4,
                       stop_tokens=())[0] == ref
    monkeypatch.setenv("FASTLLAMA_PIPE", "0")
    with pytest.raises(ValueError, match="FASTLLAMA_PIPE"):
        te.generate(p, max_new_tokens=4, stop_tokens=())


def test_stop_tokens_callback_and_cancel_match_jax(sides):
    je, te = sides
    p = _prompt(2, 12)
    full, _ = te.generate(p, max_new_tokens=16, decode_chunk=4,
                          stop_tokens=())
    stop = full[6]
    k = full.index(stop)
    for eng in (je, te):
        toks, _ = eng.generate(p, max_new_tokens=16, decode_chunk=4,
                               stop_tokens=(stop,))
        assert toks == full[:k + 1]
    seen = {}
    for name, eng in (("jax", je), ("port", te)):
        got = []

        def cb(text, tok):
            got.append((text, tok))
            return len(got) < 5

        toks, _ = eng.generate(p, max_new_tokens=16, decode_chunk=4,
                               callback=cb, stop_tokens=())
        assert len(toks) == 5 and [t for _, t in got] == toks
        seen[name] = got
    assert seen["port"] == seen["jax"]


def test_prompt_too_long_and_budget(sides):
    _, te = sides
    with pytest.raises(ValueError, match="too long"):
        te.generate(list(range(3, 3 + CFG["max_seq_len"])), max_new_tokens=2)
    with pytest.raises(ValueError, match="empty"):
        te.generate([], max_new_tokens=2)
    # the budget shrinks to the room left in the cache
    toks, _ = te.generate(_prompt(3, 120), max_new_tokens=50,
                          decode_chunk=4, stop_tokens=())
    assert len(toks) == CFG["max_seq_len"] - 120


def test_host_sampling_tokens_match_jax(sides):
    je, te = sides
    p = _prompt(4, 10)
    for temperature, topp in ((0.8, 0.9), (0.0, 0.9)):
        kw = dict(max_new_tokens=12, temperature=temperature, topp=topp,
                  seed=7, host_sampling=True, stop_tokens=())
        want, _ = je.generate(p, **kw)
        got, _ = te.generate(p, **kw)
        assert got == want
    # greedy on the host equals greedy on the device
    assert te.generate(p, max_new_tokens=12, stop_tokens=())[0] == \
        te.generate(p, max_new_tokens=12, host_sampling=True,
                    stop_tokens=())[0]


def test_device_sampling_runs(sides):
    _, te = sides
    toks, _ = te.generate(_prompt(5, 6), max_new_tokens=10, temperature=0.8,
                          seed=3, stop_tokens=())
    assert len(toks) == 10 and all(0 <= t < V for t in toks)


def test_prefill_chunk_equals_whole_prompt(sides):
    """Blocks of 16 (the first fresh, the rest through forward at pos > 0,
    the last padded) give the whole-prompt tokens, on both sides."""
    je, te = sides
    jc, tc = je.config, te.config
    p = _prompt(6, 37)
    ref, _ = te.generate(p, max_new_tokens=8, stop_tokens=())
    jec = jcfg.EngineConfig(pallas_interpret=True, prefill_chunk=16, **EC)
    tec = tcfg.EngineConfig(prefill_chunk=16, **EC)
    je2 = JEngine(jc, je.raw_params, je.tokenizer, jec)
    te2 = Engine(tc, te.raw_params, te.tokenizer, tec, device="cpu")
    assert te2.generate(p, max_new_tokens=8, stop_tokens=())[0] == ref
    assert je2.generate(p, max_new_tokens=8, stop_tokens=())[0] == ref


def test_chat_session_matches_fresh_generate_and_jax(sides):
    """One turn equals a fresh generate over the same history; a two-turn
    session gives the JAX session's replies and positions."""
    je, te = sides
    sess = ChatSession(te)
    reply = sess.generate("w3w17 w40", max_new_tokens=8, temperature=0.0)
    hist = [te.tokenizer.bos_token_id] + te.tokenizer.encode(
        "w3w17 w40", add_bos=False)
    ref, _ = te.generate(hist, max_new_tokens=8,
                         stop_tokens=(0, te.tokenizer.eos_token_id))
    assert reply == te.tokenizer.decode(ref)
    js, ts = JChat(je, "w5 w9"), ChatSession(te, "w5 w9")
    for turn in ("w3w17 w40", "w100w2w77"):
        want = js.generate(turn, max_new_tokens=6, temperature=0.0)
        got = ts.generate(turn, max_new_tokens=6, temperature=0.0)
        assert got == want and ts.pos == js.pos


def test_chat_session_overflow_guard(sides):
    _, te = sides
    sess = ChatSession(te)
    sess.feed(_prompt(7, 60))
    assert sess.pos == 61
    with pytest.raises(ValueError, match="exhausted"):
        sess.feed(_prompt(8, 66))   # 66 rows fit, the bucket of 128 not
    assert sess.pos == 61


def test_engine_refusals(sides):
    """The errors that stand: a mesh larger than the world (ValueError
    naming both counts, with no process group, before any file is read),
    TPU interpret mode, an int8 single-stream cache; ``spmd_kernels``
    alone asks for no mesh, as in the JAX engine."""
    je, te = sides
    tc = te.config
    for option, err in ((dict(mesh="model=2"), ValueError),
                        (dict(mesh="data=2", spmd_kernels=True), ValueError),
                        (dict(pallas_interpret=True), NotImplementedError)):
        with pytest.raises(err):
            Engine(tc, te.raw_params, te.tokenizer,
                   tcfg.EngineConfig(**option), device="cpu")
    assert Engine(tc, te.raw_params, te.tokenizer,
                  tcfg.EngineConfig(spmd_kernels=True),
                  device="cpu").mesh is None
    with pytest.raises(NotImplementedError):
        Engine(tc, te.raw_params, te.tokenizer,
               tcfg.EngineConfig(kv_dtype="int8"), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        Engine.load("ckpt", "tok",
                    engine_config=tcfg.EngineConfig(mesh="model=2"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(tc, te.raw_params, te.tokenizer)


def test_parity_mode_matches_jax(sides):
    """parity_mode: unfused weights, f32 scales, the activation
    re-quantizing grouped integer dot, f32 compute."""
    je, te = sides
    ec = dict(parity_mode=True, compute_dtype="float32")
    jp = JEngine(je.config, je.raw_params, je.tokenizer,
                 jcfg.EngineConfig(**ec))
    tp = Engine(te.config, te.raw_params, te.tokenizer,
                tcfg.EngineConfig(**ec), device="cpu")
    p = _prompt(9, 8)
    assert tp.generate(p, max_new_tokens=6, stop_tokens=())[0] == \
        jp.generate(p, max_new_tokens=6, stop_tokens=())[0]


def test_batched_engine_without_flash_matches_jax():
    """flash_attention=False on the BatchedEngine: the plain per-slot
    attention over the dequantized layer slices, on both sides."""
    cfg = dict(CFG, vocab_size=1024)
    jc = jcfg.ModelConfig(**cfg, quant_type=jcfg.QuantType.INT8)
    tc = tcfg.ModelConfig(**cfg, quant_type=tcfg.QuantType.INT8)
    jp = jl.random_params(jc, seed=3, qtype=jcfg.QuantType.INT8)
    tp = to_port(tc, jp)
    prompts = [np.random.default_rng(s).integers(3, 1024, size=n).tolist()
               for s, n in ((0, 5), (1, 30), (2, 12), (3, 7))]
    out = {}
    for kv in ("int8", "float32"):
        common = dict(max_batch_size=3, compute_dtype="float32",
                      kv_dtype=kv, flash_attention=False)
        je = JBatched(jc, jp, j_vocab(), jcfg.EngineConfig(
            pallas_interpret=True, **common), decode_chunk=4)
        te = TBatched(tc, tp, t_vocab(), tcfg.EngineConfig(**common),
                      decode_chunk=4, device="cpu")
        for name, eng in (("jax", je), ("port", te)):
            reqs = eng.generate_all(prompts, max_new_tokens=9,
                                    temperature=0.0, stop_tokens=())
            out[name, kv] = [r.output_tokens for r in reqs]
        assert out["port", kv] == out["jax", kv]
        assert all(len(t) == 9 for t in out["port", kv])


def test_engine_exports():
    import fastllama_tpu_torch as p
    assert p.Engine is Engine and p.ChatSession is ChatSession
    assert dataclasses.is_dataclass(
        __import__("fastllama_tpu_torch.runtime.engine",
                   fromlist=["x"]).GenerationStats)
