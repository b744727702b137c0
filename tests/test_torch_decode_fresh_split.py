"""K2's fresh and stats split-row mode (``flash_decode_fresh_split_kernel``:
fresh rows, stats or both, hs a multiple of 16, aligned operands): (a) the
mode choice, alignment included, on the CPU; (b) an emulation of the
mode's arithmetic in plain torch -- the cache rows ([0, pos) with a fresh
row, [0, pos] without) divided among the splits as the kernel divides them
on the device, each split's (m, l, acc) in f32, the fresh row merged into
the split that holds the last cache rows (split 0 alone at pos 0), the
splits merged in order as the last of their blocks merges them, and the
final (m, l) beside the output -- held against the JAX Pallas
``flash_decode_batched(..., stats=True)`` in interpret mode and against the
port's ``flash_decode_plain``, within 1e-5 x max|ref| at f32 (only the sum
order differs); (c) on a card, the kernel against ``flash_decode_plain``
at the batched decode step's shapes, at forced split counts, with both
counters, and a misaligned view on the tiled kernel."""
import math
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fastllama_tpu.ops.pallas import flash_decode as jfd
from fastllama_tpu.quant.groupquant import quantize_rows as j_quantize_rows
from fastllama_tpu_torch.ops.kernels import flash_decode as tfd


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast when the suite's
    workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL_EMU = 1e-5       # x max|ref|, the emulation at f32 (sum order only)
TOL_F32 = 1e-4       # x max|ref|, the kernel on the card (chip_smoke)
TOL_BF16 = 1e-2
S, HS, L = 128, 32, 2
NSPLITS = (1, 2, 3, 8)
MIN_CHUNKS = (16, 32)                 # small ones split S <= 128
GROUPS = [(4, 1), (2, 2), (2, 4), (1, 8)]      # (n_kv, hgs)
SLOT_POS = [0, 1, 15, 16, S - 1]   # idle, one row, a 16-row chunk's edges


def _merge(parts):
    """(m, l, acc) states merged at their largest max."""
    mt = parts[0][0]
    for m, _, _ in parts[1:]:
        mt = torch.maximum(mt, m)
    lt = torch.zeros_like(mt)
    at = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.exp(m - mt)
        lt = lt + l * f
        at = at + acc * f[..., None]
    return mt, lt, at


def fresh_split_emulate(q, ck, cv, pos, layer, k_scale=None, v_scale=None,
                        k_new=None, v_new=None, nsplit=1,
                        min_chunk=tfd.SPLIT_MIN_CHUNK):
    """The mode's arithmetic in plain torch, all in f32: slot b's rows
    [0, pos[b]) (with a fresh row) or [0, pos[b]] (without) divided by
    ``split_bounds``; per split with rows the max m of its scores
    (q.k)/sqrt(hs) * k_scale, l = sum exp(s - m) and acc = sum exp(s - m)
    * v_scale * v; the split holding the last cache rows (split 0 when
    there is none) also merges the fresh row (score (q.k_new)/sqrt(hs),
    value v_new, no scale); the splits merged in order at their largest
    max.  Returns (out in q's dtype, m, l), m and l (B, n_kv, hgs) f32."""
    B, H, _, hs = q.shape
    n_kv, Sc = ck.shape[2], ck.shape[3]
    hgs = H // n_kv
    f32 = torch.float32
    scale = 1.0 / math.sqrt(hs)
    fresh = k_new is not None
    out = torch.empty((B, n_kv, hgs, hs), dtype=f32)
    ms = torch.empty((B, n_kv, hgs), dtype=f32)
    ls = torch.empty_like(ms)
    for b in range(B):
        p = min(max(int(pos[b]), 0) + (0 if fresh else 1), Sc)
        qb = q[b].reshape(n_kv, hgs, hs).to(f32)
        bounds = [(r0, r1) for r0, r1 in tfd.split_bounds(p, nsplit,
                                                          min_chunk)
                  if r1 > r0] or [(0, 0)]
        parts = []
        for i, (r0, r1) in enumerate(bounds):
            m = torch.full((n_kv, hgs), tfd.NEG_INF)
            l = torch.zeros((n_kv, hgs))
            acc = torch.zeros((n_kv, hgs, hs))
            if r1 > r0:
                s = torch.einsum("kgh,ksh->kgs", qb,
                                 ck[layer, b, :, r0:r1].to(f32)) * scale
                if k_scale is not None:
                    s = s * k_scale[layer, b, :, r0:r1][:, None, :]
                m = s.amax(-1)
                e = torch.exp(s - m[..., None])
                l = e.sum(-1)
                if v_scale is not None:
                    e = e * v_scale[layer, b, :, r0:r1][:, None, :]
                acc = torch.einsum("kgs,ksh->kgh", e,
                                   cv[layer, b, :, r0:r1].to(f32))
            if fresh and i == len(bounds) - 1:
                sn = torch.einsum("kgh,kh->kg", qb, k_new[b].to(f32)) * scale
                vn = v_new[b].to(f32)[:, None, :].expand(n_kv, hgs, hs)
                m, l, acc = _merge([(m, l, acc),
                                    (sn, torch.ones_like(sn), vn)])
            parts.append((m, l, acc))
        ms[b], ls[b], at = _merge(parts)
        out[b] = at / ls[b][..., None]
    return out.reshape(B, H, 1, hs).to(q.dtype), ms, ls


def _t(a):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _rel(got, want):
    """max|got - want| / max|want|; either a torch tensor or a JAX array."""
    g, w = (t.float() if isinstance(t, torch.Tensor)
            else torch.tensor(np.array(t, np.float32)) for t in (got, want))
    return ((g - w).abs().max() / w.abs().max()).item()


def _inputs(seed, B, n_kv, hgs, cache_dt):
    """q, caches (int8 with ``quantize_rows`` scales, or bf16/f32) and the
    fresh row pair, from numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, n_kv * hgs, 1, HS)).astype(np.float32)
    ck, cv = (rng.standard_normal((L, B, n_kv, S, HS)).astype(np.float32)
              * 2.0 for _ in range(2))
    kn, vn = (rng.standard_normal((B, n_kv, HS)).astype(np.float32)
              for _ in range(2))
    ks = vs = None
    if cache_dt == "int8":
        (ck, ks), (cv, vs) = (j_quantize_rows(jnp.asarray(c))
                              for c in (ck, cv))
        ks, vs = ks[..., 0], vs[..., 0]
    elif cache_dt == "bfloat16":
        ck, cv = ck.astype(ml_dtypes.bfloat16), cv.astype(ml_dtypes.bfloat16)
    return q, ck, cv, ks, vs, kn, vn


def _offset_view(t, nbytes):
    """A contiguous copy of ``t`` that starts ``nbytes`` past a 16-byte
    boundary."""
    n = nbytes // t.element_size()
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype)
    base = (-buf.data_ptr() % 16) // t.element_size()
    view = buf[base + n:base + n + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == nbytes
    return view


# -- (a) the mode, on the CPU ------------------------------------------------

@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_dt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hs", [8, 16, 40, 64, 72, 96, 128, 136, 256])
@pytest.mark.parametrize("fresh,stats", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_decode_mode_takes_split_for_fresh_and_stats(qdt, cache_dt, hs,
                                                     fresh, stats):
    """Every call with hs a multiple of 16 (up to 256) and aligned
    operands takes a split mode, fresh rows and stats included; other
    head sizes keep the tiled kernel."""
    for n_kv, hgs in GROUPS:
        q = torch.zeros((2, n_kv * hgs, 1, hs), dtype=getattr(torch, qdt))
        ck = torch.zeros((1, 2, n_kv, 8, hs), dtype=getattr(torch, cache_dt))
        kn = vn = None
        if fresh:
            kn, vn = (torch.zeros((2, n_kv, hs), dtype=q.dtype)
                      for _ in range(2))
        want = "split" if hs % 16 == 0 else "tiled"
        assert tfd.decode_mode(q, ck, fresh, stats, ck, kn, vn) == want
        assert tfd.decode_mode(q, ck, fresh, stats) == want


@pytest.mark.parametrize("which", ["ck", "cv", "k_new", "v_new"])
@pytest.mark.parametrize("nbytes", [2, 4, 8])
def test_misaligned_operands_take_the_tiled_kernel(which, nbytes):
    """A cache or fresh row that starts off a 16-byte boundary takes the
    tiled kernel, whatever else the call is; q's own alignment does not
    matter (it is read a scalar at a time)."""
    n_kv, hgs, hs, B = 2, 2, 64, 3
    ops = {"q": torch.zeros((B, n_kv * hgs, 1, hs), dtype=torch.bfloat16),
           "ck": torch.zeros((1, B, n_kv, 8, hs), dtype=torch.bfloat16),
           "cv": torch.zeros((1, B, n_kv, 8, hs), dtype=torch.bfloat16),
           "k_new": torch.zeros((B, n_kv, hs), dtype=torch.bfloat16),
           "v_new": torch.zeros((B, n_kv, hs), dtype=torch.bfloat16)}
    assert tfd.aligned16(*ops.values())
    assert tfd.decode_mode(ops["q"], ops["ck"], True, True, ops["cv"],
                           ops["k_new"], ops["v_new"]) == "split"
    ops[which] = _offset_view(ops[which], nbytes)
    assert not tfd.aligned16(ops[which])
    assert tfd.decode_mode(ops["q"], ops["ck"], True, False, ops["cv"],
                           ops["k_new"], ops["v_new"]) == "tiled"
    if which in ("ck", "cv"):
        assert tfd.decode_mode(ops["q"], ops["ck"], False, True,
                               ops["cv"]) == "tiled"
    q = _offset_view(ops["q"], nbytes)
    assert tfd.decode_mode(q, torch.zeros_like(ops["ck"]), True, True) \
        == "split"


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors fresh and stats calls run flash_decode_plain and
    count no launch."""
    q, ck, cv, ks, vs, kn, vn = map(_t, _inputs(3, 2, 2, 2, "int8"))
    pos = torch.tensor([5, 63], dtype=torch.int32)
    fn = tfd.flash_decode_batched
    counts = ("launches", "launches_split", "launches_stats",
              "launches_stats_split")
    before = [getattr(fn, c) for c in counts]
    for stats in (False, True):
        args = (q, ck, cv, pos, 1, ks, vs, kn, vn, stats)
        got, want = fn(*args), tfd.flash_decode_plain(*args)
        for g, w in zip(got if stats else [got], want if stats else [want]):
            assert torch.equal(g, w)
    assert [getattr(fn, c) for c in counts] == before


def test_fresh_block_warps_fill_one_wave():
    """The fresh and stats mode's warps a block: the most (a power of two,
    4 at the least, at most ``split_warps``) at which the grid fits one
    wave of the card's resident blocks; at the 7B instantiation's
    occupancy on an H100 (3 blocks of 8 warps, 6 of 4 an SM) B=48 takes
    blocks of 4 warps and B=12 (S=2048, one split) blocks of 8."""
    def h100(nw):
        return 132 * {16: 1, 8: 3, 4: 6}[nw]
    assert tfd.fresh_block_warps(48, 32, 1, 1, True, h100) == 4
    assert tfd.fresh_block_warps(12, 32, 1, 1, True, h100) == 8
    assert tfd.fresh_block_warps(1, 32, 4, 1, True, h100) == 8
    assert tfd.fresh_block_warps(1, 32, 1, 1, False, h100) == 16
    for B in (1, 3, 12, 48, 64):
        for n_kv in (1, 8, 32):
            for nsplit in (1, 2, 4, 16):
                for hgs in (1, 2, 4, 8):
                    for int8 in (False, True):
                        most = tfd.split_warps(hgs, int8)
                        grid = B * n_kv * nsplit
                        nw = tfd.fresh_block_warps(B, n_kv, nsplit, hgs,
                                                   int8, h100)
                        assert nw in (4, 8, 16) and nw <= most
                        assert nw == 4 or grid <= h100(nw)
                        assert nw == most or grid > h100(2 * nw)


def test_design_tool_builds_the_sources_macros():
    """``tools/fresh_split_design.py`` varies macros that the source reads
    (each under ``#ifndef``), and its ``base`` variant is the source's
    defaults, so that the build the wrapper loads is one of the timed
    variants."""
    from fastllama_tpu_torch.tools import fresh_split_design as design
    src = design.SOURCE.read_text()
    defaults = tuple(int(re.search(rf"#define {m} (\d+)", src).group(1))
                     for m in design.MACROS)
    assert all(f"#ifndef {m}" in src for m in design.MACROS)
    assert design.VARIANTS["base"] == defaults
    assert all(len(v) == len(design.MACROS)
               for v in design.VARIANTS.values())
    assert design.defines(design.VARIANTS["io16_u2"])[0] \
        == "-DFRESH_SPLIT_INT8_BYTES=16"
    assert torch.cuda.is_available() \
        or design.main(["--variants", "base"]) == 2


# -- (b) the split, fresh row, merge and stats against JAX, on the CPU -------

@pytest.mark.parametrize("cache_dt", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("n_kv,hgs", GROUPS)
def test_fresh_split_emulation_vs_pallas(cache_dt, n_kv, hgs):
    """Per-slot positions 0, 1, 15, 16 and S - 1 over a 2-layer cache:
    the emulation's o, m and l at every split count and small least chunk
    against the Pallas flash_decode_batched with fresh rows and stats
    (interpret mode) and flash_decode_plain."""
    pos = np.array(SLOT_POS, np.int32)
    B = len(pos)
    q, ck, cv, ks, vs, kn, vn = _inputs(10 * n_kv + hgs, B, n_kv, hgs,
                                        cache_dt)
    want = jfd.flash_decode_batched(
        _j(q), _j(ck), _j(cv), _j(pos), 1, block_s=16, interpret=True,
        k_scale=_j(ks), v_scale=_j(vs), k_new=_j(kn), v_new=_j(vn),
        stats=True)
    args = tuple(map(_t, (q, ck, cv, pos))) + (1,) + tuple(
        map(_t, (ks, vs, kn, vn)))
    plain = tfd.flash_decode_plain(*args, stats=True)
    for p, w in zip(plain, want):
        assert _rel(p, w) <= TOL_EMU
    for nsplit in NSPLITS:
        for mc in MIN_CHUNKS:
            got = fresh_split_emulate(*args, nsplit=nsplit, min_chunk=mc)
            assert got[0].shape == (B, n_kv * hgs, 1, HS)
            assert got[1].shape == got[2].shape == (B, n_kv, hgs)
            for g, w, p in zip(got, want, plain):
                assert _rel(g, w) <= TOL_EMU, (nsplit, mc)
                assert _rel(g, p) <= TOL_EMU, (nsplit, mc)


@pytest.mark.parametrize("cache_dt", ["int8", "float32"])
@pytest.mark.parametrize("n_kv,hgs", [(4, 1), (1, 8)])
def test_stats_split_emulation_without_fresh_rows_vs_pallas(cache_dt, n_kv,
                                                            hgs):
    """A stats call without fresh rows reads [0, pos] (the non-fresh mask)
    and takes the same kernel: the emulation's o, m and l against the
    Pallas kernel with stats and no fresh rows (interpret mode)."""
    pos = np.array(SLOT_POS, np.int32)
    B = len(pos)
    q, ck, cv, ks, vs, _, _ = _inputs(30 + hgs, B, n_kv, hgs, cache_dt)
    want = jfd.flash_decode_batched(
        _j(q), _j(ck), _j(cv), _j(pos), 0, block_s=16, interpret=True,
        k_scale=_j(ks), v_scale=_j(vs), stats=True)
    args = tuple(map(_t, (q, ck, cv, pos))) + (0,) + tuple(
        map(_t, (ks, vs)))
    plain = tfd.flash_decode_plain(*args, stats=True)
    for nsplit in NSPLITS:
        got = fresh_split_emulate(*args, nsplit=nsplit, min_chunk=16)
        for g, w, p in zip(got, want, plain):
            assert _rel(g, w) <= TOL_EMU, nsplit
            assert _rel(g, p) <= TOL_EMU, nsplit


def test_fresh_split_emulation_idle_slots_are_exactly_v_new():
    """Every slot at pos 0 (idle slots park there): no split holds a cache
    row, split 0 takes the fresh row alone, and each query row is exactly
    its fresh value row, with m its fresh score and l = 1, as in the
    Pallas kernel."""
    n_kv, hgs, B = 2, 4, 3
    q, ck, cv, ks, vs, kn, vn = _inputs(7, B, n_kv, hgs, "int8")
    pos = np.zeros(B, np.int32)
    want = jfd.flash_decode_batched(
        _j(q), _j(ck), _j(cv), _j(pos), 0, block_s=16, interpret=True,
        k_scale=_j(ks), v_scale=_j(vs), k_new=_j(kn), v_new=_j(vn),
        stats=True)
    args = tuple(map(_t, (q, ck, cv, pos))) + (0,) + tuple(
        map(_t, (ks, vs, kn, vn)))
    for nsplit in (1, 8):
        o, m, l = fresh_split_emulate(*args, nsplit=nsplit, min_chunk=16)
        v0 = args[-1][:, :, None].expand(B, n_kv, hgs, HS)
        assert torch.equal(o.reshape(B, n_kv, hgs, HS), v0)
        assert torch.equal(l, torch.ones_like(l))
        s_new = torch.einsum("bkgh,bkh->bkg",
                             args[0].reshape(B, n_kv, hgs, HS),
                             args[-2]) / math.sqrt(HS)
        torch.testing.assert_close(m, s_new, rtol=1e-6, atol=1e-6)
        for g, w in zip((o, m, l), want):
            assert _rel(g, w) <= TOL_EMU


# -- (c) the kernel on the card ----------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(dev, seed, Lc, B, n_kv, hgs, Sc, hs, qdt, cache_dt):
    """q, caches (int8 with ``quantize_rows`` scales, or bf16/f32) and the
    fresh rows on the card."""
    from fastllama_tpu_torch.quant.groupquant import quantize_rows
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qt = getattr(torch, qdt)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q = rnd(B, n_kv * hgs, 1, hs).to(qt)
    ck, cv = rnd(Lc, B, n_kv, Sc, hs), rnd(Lc, B, n_kv, Sc, hs)
    kn, vn = rnd(B, n_kv, hs).to(qt), rnd(B, n_kv, hs).to(qt)
    if cache_dt == "int8":
        (ck, ks), (cv, vs) = quantize_rows(ck), quantize_rows(cv)
        return (q, ck, cv, ks[..., 0].contiguous(), vs[..., 0].contiguous(),
                kn, vn)
    ct = getattr(torch, cache_dt)
    return q, ck.to(ct), cv.to(ct), None, None, kn, vn


def _positions(dev, B, Sc, seed):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, Sc, B)
    pos[:min(B, 4)] = [0, 1, 107, Sc - 1][:min(B, 4)]
    return torch.tensor(pos, dtype=torch.int32, device=dev)


def _check_outputs(got, want, tol):
    """o within ``tol``, m and l within TOL_F32 (f32 in both dtypes)."""
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w, t in zip(got, want, (tol, TOL_F32, TOL_F32)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        err = _rel(g, w)
        assert err <= t, err


def _counts():
    fn = tfd.flash_decode_batched
    return (fn.launches, fn.launches_split, fn.launches_stats,
            fn.launches_stats_split)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt,cache_dt", [("bfloat16", "int8"),
                                          ("float32", "int8"),
                                          ("bfloat16", "bfloat16"),
                                          ("float32", "float32")])
@pytest.mark.parametrize("hs", [64, 128, 256])
@pytest.mark.parametrize("B,Sc", [(48, 512), (12, 2048), (1, 2048)])
def test_fresh_split_kernel_vs_plain_on_card(cuda, qdt, cache_dt, hs, B,
                                             Sc):
    """The fresh and stats split mode against flash_decode_plain within
    TOL_F32 (f32 q) or TOL_BF16 (bf16 q), m and l within TOL_F32, at hgs
    1, 2, 4 and 8 and per-slot positions 0, 1, 107 and S - 1: fresh rows
    (one ``launches`` and ``launches_split``), fresh rows with stats and
    stats alone (one ``launches_stats`` and ``launches_stats_split``).
    The same inputs at 2, 3, 8 and 16 splits of at least 16 rows (several
    merge) agree too."""
    tol = TOL_F32 if qdt == "float32" else TOL_BF16
    for hgs in (1, 2, 4, 8):
        n_kv = 32 // hgs if B > 1 else 8
        q, ck, cv, ks, vs, kn, vn = _card_inputs(
            cuda, hs + B + hgs, 2, B, n_kv, hgs, Sc, hs, qdt, cache_dt)
        pos = _positions(cuda, B, Sc, hs + hgs)
        for fresh, stats in ((True, False), (True, True), (False, True)):
            f = (kn, vn) if fresh else (None, None)
            assert tfd.decode_mode(q, ck, fresh, stats, cv, *f) == "split"
            args = (q, ck, cv, pos, 1, ks, vs, *f)
            want = tfd.flash_decode_plain(*args, stats=stats)
            n0 = _counts()
            got = tfd.flash_decode_batched(*args, stats=stats)
            step = (0, 0, 1, 1) if stats else (1, 1, 0, 0)
            assert _counts() == tuple(a + d for a, d in zip(n0, step))
            _check_outputs(got, want, tol)
            for nsplit in (2, 3, 8, 16):
                got = tfd._split_launch(*args[:7], nsplit, 16, k_new=f[0],
                                        v_new=f[1], stats=stats)
                _check_outputs(got, want, tol)
            if fresh:
                idle = (pos == 0).nonzero().flatten()
                o = got[0] if stats else got
                assert torch.equal(
                    o[idle, :, 0].float(),
                    vn[idle].float().repeat_interleave(hgs, dim=1))


@pytest.mark.gpu
def test_make_attn_paths_take_the_split_mode_on_card(cuda):
    """``make_attn_batched_flash`` and ``make_attn_batched_flash_stats`` on
    the 7B decode step's operands (B=48, 32 heads of 128, bf16, int8
    cache, q and the fresh rows sliced from the step's projections as
    ``decode_step`` passes them) take the split mode and agree with the
    plain versions."""
    from fastllama_tpu_torch.models.batched import BatchedKVCache
    q, ck, cv, ks, vs, kn, vn = _card_inputs(cuda, 5, 2, 48, 32, 1, 512,
                                             128, "bfloat16", "int8")
    cache = BatchedKVCache(ck, cv, ks, vs)
    pos = _positions(cuda, 48, 512, 5)
    qkv = torch.cat([q[:, :, 0], kn, vn], 1)      # (B, 3 * 32, hs)
    qv, kv, vv = qkv[:, :32], qkv[:, 32:64], qkv[:, 64:]
    n0 = _counts()
    got = tfd.make_attn_batched_flash()(qv, cache, pos, 1, kv, vv)
    want = tfd.make_attn_batched_plain()(qv, cache, pos, 1, kv, vv)
    _check_outputs(got, want, TOL_BF16)
    got = tfd.make_attn_batched_flash_stats()(qv, cache, pos, 1, kv, vv)
    want = tfd.flash_decode_plain(q, ck, cv, pos, 1, ks, vs, kn, vn,
                                  stats=True)
    _check_outputs((got[0], got[1], got[2]),
                   (want[0][:, :, 0], want[1], want[2]), TOL_BF16)
    n1 = _counts()
    assert (n1[1] - n0[1], n1[3] - n0[3]) == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["ck", "k_new", "v_new"])
def test_misaligned_view_takes_the_tiled_kernel_on_card(cuda, which):
    """A cache or fresh row off a 16-byte boundary takes the tiled kernel
    (``launches``, or ``launches_stats``, advances; the split counts do
    not), against flash_decode_plain; the aligned call takes the split
    mode."""
    q, ck, cv, ks, vs, kn, vn = _card_inputs(cuda, 9, 2, 3, 2, 2, 256, 64,
                                             "bfloat16", "bfloat16")
    ops = {"ck": ck, "k_new": kn, "v_new": vn}
    t = ops[which]
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=cuda)
    base = (-buf.data_ptr() % 16) // t.element_size()
    view = buf[base + 1:base + 1 + t.numel()].view(t.shape)
    view.copy_(t)
    ops[which] = view
    pos = torch.tensor([0, 100, 255], dtype=torch.int32, device=cuda)
    for stats in (False, True):
        args = (q, ops["ck"], cv, pos, 1, ks, vs, ops["k_new"],
                ops["v_new"])
        assert tfd.decode_mode(q, ops["ck"], True, stats, cv, ops["k_new"],
                               ops["v_new"]) == "tiled"
        n0 = _counts()
        got = tfd.flash_decode_batched(*args, stats=stats)
        step = (0, 0, 1, 0) if stats else (1, 0, 0, 0)
        assert _counts() == tuple(a + d for a, d in zip(n0, step))
        _check_outputs(got, tfd.flash_decode_plain(*args, stats=stats),
                       TOL_BF16)
    n0 = _counts()
    got = tfd.flash_decode_batched(q, ck, cv, pos, 1, ks, vs, kn, vn)
    assert _counts()[1] == n0[1] + 1
    _check_outputs(got, tfd.flash_decode_plain(q, ck, cv, pos, 1, ks, vs,
                                               kn, vn), TOL_BF16)
