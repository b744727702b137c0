"""The port's single-stream ``SpeculativeEngine`` against the JAX package's
(``tests/test_speculative.py``'s cases) on the same numpy weights, with
the draft makers ``truncate_params`` / ``requantize_params``, the n-gram
drafters, the speculative-sampling rule and ``forward`` at device
positions.  f32 compute and f32 scales on both sides; the JAX engines run
their jnp path on the CPU, as the JAX package's own tests run them; the
port runs on the CPU, where every kernel wrapper takes its plain version.

Greedy: the port's tokens and ``SpecStats`` (rounds, drafted, accepted)
equal JAX's, and the tokens equal the port's plain ``Engine.generate``.
Sampled rounds draw from ``torch.Generator``s (JAX's PRNG cannot be
reproduced), so their rule is held by statistics: 200,000 draws of the
accept/residual rule reproduce the target distribution within 5e-3."""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.loaders.tokenizer import \
    build_byte_fallback_vocab as j_vocab
from fastllama_tpu.models import llama as jl
from fastllama_tpu.ops import sampling as jsamp
from fastllama_tpu.runtime.engine import Engine as JEngine
from fastllama_tpu.runtime.speculative import SpeculativeEngine as JSpec
from fastllama_tpu.runtime.speculative import _ngram_draft as j_ngram
from fastllama_tpu_torch import SpeculativeEngine
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders.tokenizer import \
    build_byte_fallback_vocab as t_vocab
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.ops import sampling as tsamp
from fastllama_tpu_torch.quant.groupquant import QArray, pack_int4_rows
from fastllama_tpu_torch.runtime.engine import Engine
from fastllama_tpu_torch.runtime.kernels import select_kernels
from fastllama_tpu_torch.runtime.spec_batching import ngram_draft_batched
from fastllama_tpu_torch.runtime.speculative import (_ngram_draft,
                                                     accept_sampled)
from tests.test_torch_model import to_port

V = 512
CFG = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
           vocab_size=V, max_seq_len=128, group_size=16)
EC = dict(max_seq_len=128, compute_dtype="float32", scale_dtype="float32")
EXTRA = [f"w{i}" for i in range(V - 259)]
PROMPT = [1, 5, 9, 13, 80, 200, 31]
N = 24


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines here run many tiny ops: one intra-op thread keeps them
    fast when the suite's workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed):
    jc = jcfg.ModelConfig(**CFG, quant_type=jcfg.QuantType.INT8)
    tc = tcfg.ModelConfig(**CFG, quant_type=tcfg.QuantType.INT8)
    jp = jl.random_params(jc, seed=seed, qtype=jcfg.QuantType.INT8)
    return jc, jp, tc, to_port(tc, jp)


def _pair(jc, jp, tc, tp):
    """(JAX engine, port engine) over the same weights."""
    return (JEngine(jc, jp, j_vocab(EXTRA), jcfg.EngineConfig(**EC)),
            Engine(tc, tp, t_vocab(EXTRA), tcfg.EngineConfig(**EC),
                   device="cpu"))


@pytest.fixture(scope="module")
def weights():
    return _weights(5)


@pytest.fixture(scope="module")
def engines(weights):
    """name -> (JAX engine, port engine): the target, a draft with the
    same weights, an unrelated draft and the target's first layer."""
    jc, jp, tc, tp = weights
    out = {"target": _pair(jc, jp, tc, tp), "same": _pair(jc, jp, tc, tp),
           "other": _pair(*_weights(99))}
    jc1, jp1 = jl.truncate_params(jc, jp, 1)
    tc1, tp1 = tl.truncate_params(tc, tp, 1)
    out["trunc1"] = _pair(jc1, jp1, tc1, tp1)
    return out


@pytest.fixture(scope="module")
def specs(engines):
    """(JAX, port) speculative engines by case, built once so that each
    JAX chunk compiles once for the module."""
    jt, tt = engines["target"]
    out = {"ngram": (JSpec(jt, None, width=4, ngram=2),
                     SpeculativeEngine(tt, None, width=4, ngram=2)),
           "near_limit": (JSpec(jt, engines["same"][0], width=8,
                                rounds_per_call=8),
                          SpeculativeEngine(tt, engines["same"][1], width=8,
                                            rounds_per_call=8))}
    for name in ("same", "other", "trunc1"):
        jd, td = engines[name]
        out[name] = (JSpec(jt, jd, width=4), SpeculativeEngine(tt, td,
                                                               width=4))
    return out


def _plain(engine, prompt=PROMPT, n=N, **kw):
    kw.setdefault("stop_tokens", ())
    toks, _ = engine.generate(prompt, max_new_tokens=n, temperature=0.0,
                              decode_chunk=8, **kw)
    return toks


def _stats(st):
    return st.rounds, st.drafted, st.accepted


@pytest.mark.parametrize("case", ["ngram", "same", "other", "trunc1"])
def test_greedy_matches_jax_and_plain(engines, specs, case):
    js, ts = specs[case]
    want, jst = js.generate(PROMPT, max_new_tokens=N, stop_tokens=())
    got, st = ts.generate(PROMPT, max_new_tokens=N, stop_tokens=())
    assert got == want and len(got) == N
    assert _stats(st) == _stats(jst) and st.drafted > 0
    assert got == _plain(engines["target"][1])
    assert st.output_tokens == N and st.prompt_tokens == len(PROMPT)
    if case == "same":
        assert st.acceptance == 1.0


def test_truncated_draft_is_the_first_layer(engines):
    """A one-layer draft equals its own plain greedy run (its cache holds
    only the first layer) and shares the target's embedding."""
    _, td = engines["trunc1"]
    _, tt = engines["target"]
    assert td.config.n_layers == 1
    assert torch.equal(td.params.embedding.data, tt.params.embedding.data)
    assert torch.equal(td.params.wq.data[0], tt.params.wq.data[0])


def test_stop_token_mid_round_and_stream_match_jax(engines, specs):
    js, ts = specs["same"]
    full = _plain(engines["target"][1])
    stop = full[6]                   # the third token of the second round
    k = full.index(stop)
    seen = {}
    for name, spec in (("jax", js), ("port", ts)):
        got = []
        toks, _ = spec.generate(PROMPT, max_new_tokens=N,
                                stop_tokens=(stop,),
                                callback=lambda t, tok: got.append((t, tok)))
        assert toks == full[:k + 1]
        seen[name] = got
    assert seen["port"] == seen["jax"] and len(seen["port"]) == k
    # a callback returning False stops at once, on both sides
    for spec in (js, ts):
        n = []
        toks, _ = spec.generate(PROMPT, max_new_tokens=N, stop_tokens=(),
                                callback=lambda t, tok: (n.append(tok),
                                                         len(n) < 5)[1])
        assert toks == full[:5]


def test_near_context_limit_matches_jax_and_plain(engines, specs):
    """90 of 128 rows used, 38 new tokens at width 8 and 8 rounds a call:
    the last chunk shrinks and plain steps finish at the context limit."""
    js, ts = specs["near_limit"]
    long_prompt = (PROMPT * 16)[:90]
    want, jst = js.generate(long_prompt, max_new_tokens=38, stop_tokens=())
    got, st = ts.generate(long_prompt, max_new_tokens=38, stop_tokens=())
    assert got == want and len(got) == 38
    assert _stats(st) == _stats(jst)
    assert got == _plain(engines["target"][1], long_prompt, 38)


def test_engine_arguments(engines):
    _, tt = engines["target"]
    _, td = engines["same"]
    with pytest.raises(ValueError, match="width"):
        SpeculativeEngine(tt, None, width=1)
    small = copy.copy(td)
    small.config = td.config.replace(vocab_size=256)
    with pytest.raises(ValueError, match="vocab"):
        SpeculativeEngine(tt, small)
    elsewhere = copy.copy(td)
    elsewhere.device = torch.device("meta")
    with pytest.raises(ValueError, match="meta"):
        SpeculativeEngine(tt, elsewhere)
    spec = SpeculativeEngine(tt, None)
    with pytest.raises(ValueError, match="empty"):
        spec.generate([], max_new_tokens=2)
    with pytest.raises(ValueError, match="too long"):
        spec.generate(list(range(3, 131)), max_new_tokens=2)


# -- sampled rounds -----------------------------------------------------------

def test_sampled_same_draft_full_acceptance(specs):
    """q == p with draft == target: every draft is accepted; the output
    repeats per seed and changes with it."""
    _, ts = specs["same"]
    kw = dict(max_new_tokens=N, stop_tokens=(), temperature=0.8, topp=0.9)
    a, sa = ts.generate(PROMPT, seed=11, **kw)
    b, _ = ts.generate(PROMPT, seed=11, **kw)
    c, _ = ts.generate(PROMPT, seed=12, **kw)
    assert a == b and len(a) == N and sa.acceptance == 1.0
    assert c != a


@pytest.mark.parametrize("case", ["ngram", "other", "near_limit"])
def test_sampled_runs_complete(specs, case):
    _, ts = specs[case]
    prompt, n = ((PROMPT * 16)[:100], 27) if case == "near_limit" \
        else (PROMPT, N)
    toks, st = ts.generate(prompt, max_new_tokens=n, stop_tokens=(),
                           temperature=0.9, topp=0.9, seed=3)
    assert len(toks) == n and all(0 <= t < V for t in toks)
    assert st.drafted > 0


@pytest.mark.parametrize("D", [2, 4])
def test_accept_rule_reproduces_the_target(D):
    """200,000 rounds of the rule on fixed rows, drafts drawn from q: the
    first emitted token's marginal is p within 5e-3, whatever q is."""
    rng = np.random.default_rng(D)
    W, Nd = 6, 200_000
    p = rng.random((D, W)); p /= p.sum(axis=1, keepdims=True)
    q = rng.random((D, W)); q /= q.sum(axis=1, keepdims=True)
    ys = np.stack([rng.choice(W, size=Nd, p=q[i]) for i in range(D)], 1)
    gen = torch.Generator().manual_seed(D)
    emit, a = accept_sampled(
        torch.tensor(p, dtype=torch.float32).expand(Nd, D, W),
        torch.tensor(q, dtype=torch.float32).expand(Nd, D, W),
        torch.tensor(ys, dtype=torch.int32),
        torch.rand((Nd, D - 1), generator=gen),
        torch.rand((Nd, W), generator=gen), torch.rand((Nd, W), generator=gen))
    emp = np.bincount(emit[:, 0].numpy(), minlength=W) / Nd
    np.testing.assert_allclose(emp, p[0], atol=5e-3)
    # the accepted prefix is emitted as drafted
    keep = torch.arange(D)[None, :] < a[:, None]
    assert torch.equal(emit[keep], torch.tensor(ys, dtype=torch.int32)[keep])


def test_accept_rule_one_hot_draft():
    """The n-gram drafter's q is one-hot: a draft y is accepted with
    probability p(y), and a rejection never re-emits y."""
    D, W, Nd = 3, 5, 100_000
    p = torch.tensor([0.1, 0.4, 0.2, 0.2, 0.1]).expand(Nd, D, W)
    ys = torch.full((Nd, D), 1, dtype=torch.int32)
    q = torch.nn.functional.one_hot(ys.long(), W).float()
    gen = torch.Generator().manual_seed(0)
    emit, a = accept_sampled(p, q, ys, torch.rand((Nd, D - 1), generator=gen),
                             torch.rand((Nd, W), generator=gen),
                             torch.rand((Nd, W), generator=gen))
    assert abs(float((a >= 1).float().mean()) - 0.4) < 5e-3
    assert not bool((emit[a == 0, 0] == 1).any())
    emp = np.bincount(emit[:, 0].numpy(), minlength=W) / Nd
    np.testing.assert_allclose(emp, p[0, 0].numpy(), atol=5e-3)


@pytest.mark.parametrize("temperature,topp", [(0.8, 0.9), (1.0, 1.0),
                                              (0.5, 0.3)])
def test_nucleus_dist_rows_match_jax(temperature, topp):
    """The verify's (D, V) rows of ``nucleus_dist`` equal JAX's."""
    lg = np.random.default_rng(7).standard_normal((4, V)).astype(
        np.float32) * 3
    want = np.asarray(jsamp.nucleus_dist(jnp.asarray(lg), temperature, topp))
    got = tsamp.nucleus_dist(torch.tensor(lg), temperature, topp).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# -- drafters ---------------------------------------------------------------

def test_ngram_drafters_match_jax():
    rng = np.random.default_rng(0)
    for trial in range(200):
        L = int(rng.integers(1, 40))
        hist = rng.integers(1, 5, size=L).astype(np.int32)
        n, width = int(rng.integers(1, 4)), int(rng.integers(2, 9))
        want = j_ngram(hist, n, width)
        np.testing.assert_array_equal(_ngram_draft(hist, n, width), want)
        pad = np.zeros(48 + width, np.int32)
        pad[:L] = hist
        got = ngram_draft_batched(torch.tensor(pad)[None],
                                  torch.tensor([L], dtype=torch.int32), n,
                                  width)[0]
        np.testing.assert_array_equal(got.numpy(), want)


# -- draft makers -------------------------------------------------------------

def _qleaves(params):
    return {f.name: getattr(params, f.name)
            for f in dataclasses.fields(params)
            if getattr(params, f.name) is not None}


def _same_leaves(jp, tp):
    for name, jv in _qleaves(jp).items():
        tv = getattr(tp, name)
        if hasattr(jv, "scales"):
            assert (jv.qtype.name, jv.group_size, jv.group_axis,
                    jv.packed) == (tv.qtype.name, tv.group_size,
                                   tv.group_axis, tv.packed), name
            np.testing.assert_array_equal(tv.data.numpy(),
                                          np.asarray(jv.data), err_msg=name)
            np.testing.assert_array_equal(tv.scales.numpy(),
                                          np.asarray(jv.scales),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                          err_msg=name)


@pytest.mark.parametrize("n", [1, 2])
def test_truncate_params_matches_jax(weights, n):
    jc, jp, tc, tp = weights
    jc1, jp1 = jl.truncate_params(jc, jp, n)
    tc1, tp1 = tl.truncate_params(tc, tp, n)
    assert tc1.n_layers == jc1.n_layers == n
    _same_leaves(jp1, tp1)
    for bad in (0, 3):
        with pytest.raises(ValueError, match="range"):
            tl.truncate_params(tc, tp, bad)


@pytest.mark.parametrize("qtype", ["INT4", "INT8"])
def test_requantize_params_matches_jax(weights, qtype):
    jc, jp, tc, tp = weights
    want = jl.requantize_params(jc, jp, jcfg.QuantType[qtype])
    got = tl.requantize_params(tc, tp, tcfg.QuantType[qtype])
    _same_leaves(want, got)
    assert got.wq.qtype == tcfg.QuantType[qtype]


def test_requantize_packed_raises(weights):
    _, _, tc, tp = weights
    w = tl.requantize_params(tc, tp, tcfg.QuantType.INT4).wq
    packed = QArray(pack_int4_rows(w.data), w.scales, w.qtype, w.group_size,
                    w.group_axis, packed=True)
    with pytest.raises(ValueError, match="packed"):
        tl.requantize_params(tc, dataclasses.replace(tp, wq=packed),
                             tcfg.QuantType.INT8)


# -- forward at device positions -------------------------------------------

@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("T", [1, 4])
def test_forward_at_device_positions_is_bit_equal(weights, T, use_pallas):
    """``pos=None`` with device ``positions`` writes the same rows and
    gives the same logits as the host ``pos``, bit for bit."""
    _, _, tc, tp = weights
    params = tl.fuse_params(tc, tp)
    kb = select_kernels("cpu", tcfg.EngineConfig(compute_dtype="float32",
                                                 use_pallas=use_pallas),
                        torch.float32)
    hooks = dict(mm=kb.mm, attn=kb.attn, mm_idx=kb.mm_idx,
                 attn_idx=kb.attn_idx, compute_dtype=torch.float32)
    toks = torch.tensor(np.random.default_rng(T).integers(3, V, size=20 + T))
    caches, logits = [], []
    for device_pos in (False, True):
        c = tl.KVCache.create(tc, device="cpu")
        tl.forward(tc, params, toks[:20], 0, c, **hooks)
        positions = torch.arange(20, 20 + T, dtype=torch.int32)
        if device_pos:
            lg, _ = tl.forward(tc, params, toks[20:], None, c,
                               positions=positions, **hooks)
        else:
            lg, _ = tl.forward(tc, params, toks[20:], 20, c, **hooks)
        caches.append(c)
        logits.append(lg)
    assert torch.equal(logits[0], logits[1])
    assert torch.equal(caches[0].k, caches[1].k)
    assert torch.equal(caches[0].v, caches[1].v)
    with pytest.raises(ValueError, match="positions"):
        tl.forward(tc, params, toks[:T], None, caches[0], **hooks)


@pytest.mark.parametrize("case", ["other", "same"])
def test_rounds_run_stay_within_the_budget(specs, case):
    """Every queued round emits a token, so a generation of N tokens runs
    at most N rounds (the prefill gives the first, one more is read and
    counted as the JAX engine counts it); with nothing accepted it runs
    exactly the rounds it reads.  JAX's keeps two full chunks in flight
    and drops up to 2R - 1 rounds at the end."""
    _, ts = specs[case]
    ran = []
    round_fn = ts._round
    ts._round = lambda *a: (ran.append(1), round_fn(*a))[1]
    try:
        _, st = ts.generate(PROMPT, max_new_tokens=N, stop_tokens=())
    finally:
        del ts._round
    assert st.rounds <= len(ran) <= N
    if case == "other":
        assert st.accepted == 0 and len(ran) == st.rounds
