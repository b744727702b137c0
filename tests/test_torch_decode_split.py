"""K2's split-row mode (non-fresh calls without stats, hs a multiple of
16): (a) the mode choice and the split count on the CPU; (b) an emulation
of the mode's split and merge in plain torch -- rows divided among the
splits as the kernel divides them on the device, each split's (m, l,
acc) in f32, the splits merged in order as the last of their blocks
merges them -- held against the JAX Pallas ``flash_decode_single``,
``decode_attention_pallas_indexed``, ``decode_attention_pallas_batched``
and non-fresh ``flash_decode_batched`` in interpret mode and against the
port's ``flash_decode_plain``, within 1e-5 x max|ref| at f32 (only the
sum order differs); (c) on a card, the kernel against
``flash_decode_plain`` through every wrapper, with the launch counts."""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fastllama_tpu.ops.pallas import attention as jpatt
from fastllama_tpu.ops.pallas import flash_decode as jfd
from fastllama_tpu.quant.groupquant import quantize_rows as j_quantize_rows
from fastllama_tpu_torch.ops.kernels import attention as tkatt
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
NSPLITS = (1, 2, 3, 8, 16)
MIN_CHUNKS = (16, 32, tfd.SPLIT_MIN_CHUNK)  # small ones split S <= 128
GROUPS = [(4, 1), (2, 2), (2, 4), (1, 8)]      # (n_kv, hgs)
SLOT_POS = [0, 1, 63, S - 1]   # per-slot: pos 63 ends a 16-row chunk


def split_emulate(q, ck, cv, pos, layer, k_scale=None, v_scale=None,
                  nsplit=1, min_chunk=tfd.SPLIT_MIN_CHUNK):
    """The split mode's arithmetic in plain torch, all in f32: slot b's
    rows [0, pos[b]] divided by ``split_bounds``; per split with rows the
    max m of its scores (q.k)/sqrt(hs) * k_scale, l = sum exp(s - m) and
    acc = sum exp(s - m) * v_scale * v; those splits merged in order at
    their largest max, as the last of their blocks merges them (the empty
    ones stay out); output acc / l in q's dtype."""
    B, H, _, hs = q.shape
    n_kv, Sc = ck.shape[2], ck.shape[3]
    hgs = H // n_kv
    f32 = torch.float32
    out = torch.empty((B, n_kv, hgs, hs), dtype=f32)
    for b in range(B):
        p = min(max(int(pos[b]), 0) + 1, Sc)
        qb = q[b].reshape(n_kv, hgs, hs).to(f32)
        parts = []
        for r0, r1 in tfd.split_bounds(p, nsplit, min_chunk):
            if r1 <= r0:
                continue
            s = torch.einsum("kgh,ksh->kgs", qb,
                             ck[layer, b, :, r0:r1].to(f32)) / math.sqrt(hs)
            if k_scale is not None:
                s = s * k_scale[layer, b, :, r0:r1][:, None, :]
            m = s.amax(-1)
            e = torch.exp(s - m[..., None])
            l = e.sum(-1)
            if v_scale is not None:
                e = e * v_scale[layer, b, :, r0:r1][:, None, :]
            parts.append((m, l, torch.einsum(
                "kgs,ksh->kgh", e, cv[layer, b, :, r0:r1].to(f32))))
        mt = parts[0][0]
        for m, _, _ in parts[1:]:
            mt = torch.maximum(mt, m)
        lt = torch.zeros_like(mt)
        at = torch.zeros((n_kv, hgs, hs))
        for m, l, acc in parts:
            f = torch.exp(m - mt)
            lt = lt + l * f
            at = at + acc * f[..., None]
        out[b] = at / lt[..., None]
    return out.reshape(B, H, 1, hs).to(q.dtype)


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a)


def _rel(got, want):
    """max|got - want| / max|want|; either a torch tensor or a JAX array."""
    g, w = (t.float() if isinstance(t, torch.Tensor)
            else torch.tensor(np.array(t, np.float32)) for t in (got, want))
    return ((g - w).abs().max() / w.abs().max()).item()


def _caches(rng, shape, cache_dt):
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    if cache_dt == "bfloat16":
        ck, cv = ck.astype(ml_dtypes.bfloat16), cv.astype(ml_dtypes.bfloat16)
    return ck, cv


# -- (a) the mode and the split count, on the CPU ----------------------------

@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_dt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hs", [8, 16, 40, 64, 72, 96, 128, 136, 256])
@pytest.mark.parametrize("fresh,stats", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_decode_mode_takes_split_exactly(qdt, cache_dt, hs, fresh, stats):
    """The split mode exactly for calls with hs a multiple of 16 (up to
    256), fresh rows and stats included (their split kernel is
    ``flash_decode_fresh_split_kernel``); other head sizes keep the tiled
    kernel."""
    for n_kv, hgs in GROUPS:
        q = torch.zeros((2, n_kv * hgs, 1, hs), dtype=getattr(torch, qdt))
        ck = torch.zeros((1, 2, n_kv, 8, hs), dtype=getattr(torch, cache_dt))
        want = "split" if hs % 16 == 0 else "tiled"
        assert tfd.decode_mode(q, ck, fresh, stats) == want


def test_split_count_rule():
    """About one wave of 16 warps an H100 SM, at least 512 rows a split
    in a full cache and at most 16 splits, one split once B * n_kv blocks
    fill the wave; blocks of the most warps that keep the grid in that
    wave, 4 at the least; the 7B shapes."""
    for B in (1, 2, 3, 4, 8, 32, 48, 64):
        for n_kv in (1, 2, 8, 32):
            for Sc in (16, 64, 128, 512, 2048, 4096):
                for hgs in (1, 2, 4, 8):
                    for int8 in (False, True):
                        w = tfd.split_warps(hgs, int8)
                        n = tfd.split_count(B, n_kv, Sc, hgs, int8)
                        cap = min(Sc // tfd.SPLIT_MIN_ROWS, tfd.SPLIT_MAX)
                        assert 1 <= n <= max(1, cap)
                        warps = B * n_kv * w
                        assert n == 1 or n * warps <= tfd.SPLIT_WAVE_WARPS
                        if n < cap:
                            assert (n + 1) * warps > tfd.SPLIT_WAVE_WARPS
                        nw = tfd.split_block_warps(B, n_kv, n, hgs, int8)
                        assert nw in (4, 8, 16) and 4 <= nw <= w
                        assert (nw == 4 or B * n_kv * n * nw
                                <= tfd.SPLIT_WAVE_WARPS)
                        assert (nw == w or B * n_kv * n * 2 * nw
                                > tfd.SPLIT_WAVE_WARPS)
    assert [tfd.split_warps(g) for g in (1, 2, 4, 8)] == [16, 8, 4, 4]
    assert tfd.split_warps(1, int8=True) == 8
    assert tfd.split_count(1, 32, 512) == 1
    assert tfd.split_count(1, 32, 2048) == 4       # 128 blocks of 16 warps
    assert tfd.split_count(4, 32, 2048) == 1
    assert tfd.split_count(1, 8, 4096, 8) == 8     # 70B's GQA at B=1
    assert tfd.split_block_warps(1, 32, 4) == 16
    assert tfd.split_block_warps(32, 32, 1) == 4   # 1024 blocks


@pytest.mark.parametrize("min_chunk", MIN_CHUNKS)
@pytest.mark.parametrize("nsplit", NSPLITS)
def test_split_bounds_cover_the_rows(nsplit, min_chunk):
    """The splits tile [0, p) in order, each a multiple of 16 rows and at
    least ``min_chunk`` but the last one with rows; the splits past p are
    empty (p = 1 reads row 0)."""
    for p in (1, 2, 15, 16, 17, 33, 64, 108, 511, 512, 2048):
        bounds = tfd.split_bounds(p, nsplit, min_chunk)
        assert len(bounds) == nsplit and bounds[0][0] == 0
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        assert bounds[-1][1] == p
        sizes = [r1 - r0 for r0, r1 in bounds]
        full = [n for n in sizes if n > 0]
        assert all(n % tfd.SPLIT_UNIT == 0 and n >= min_chunk
                   for n in full[:-1])
        assert sizes == full + [0] * (nsplit - len(full))
    assert [r1 for _, r1 in tfd.split_bounds(108, 4)] == [108] * 4
    assert [r1 for _, r1 in tfd.split_bounds(2048, 4)] == [512, 1024, 1536,
                                                           2048]


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the split mode's inputs run flash_decode_plain and
    count no launch."""
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.standard_normal((2, 4, 1, 32)).astype(np.float32))
    ck = torch.tensor(rng.standard_normal((1, 2, 2, 64, 32)).astype(
        np.float32))
    pos = torch.tensor([5, 63], dtype=torch.int32)
    assert tfd.decode_mode(q, ck) == "split"
    before = (tfd.flash_decode_batched.launches,
              tfd.flash_decode_batched.launches_split)
    got = tfd.flash_decode_batched(q, ck, ck, pos, 0)
    assert torch.equal(got, tfd.flash_decode_plain(q, ck, ck, pos, 0))
    assert (tfd.flash_decode_batched.launches,
            tfd.flash_decode_batched.launches_split) == before


# -- (b) the split and merge against JAX, on the CPU -------------------------

@pytest.mark.parametrize("cache_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_kv,hgs", GROUPS)
def test_split_emulation_vs_pallas_batched(cache_dt, n_kv, hgs):
    """Per-slot positions at B=4 (0, 1, a 16-row chunk's end, S-1) over a
    2-layer cache: the emulation at every split count against
    decode_attention_pallas_batched (interpret mode) and
    flash_decode_plain."""
    B = len(SLOT_POS)
    rng = np.random.default_rng(10 * n_kv + hgs)
    q = rng.standard_normal((B, n_kv * hgs, 1, HS)).astype(np.float32)
    ck, cv = _caches(rng, (L, B, n_kv, S, HS), cache_dt)
    pos = np.array(SLOT_POS, np.int32)
    want = jpatt.decode_attention_pallas_batched(
        *map(jnp.asarray, (q, ck, cv, pos)), 1, interpret=True)
    tq, tk, tv, tp = _t(q), _t(ck), _t(cv), _t(pos)
    plain = tfd.flash_decode_plain(tq, tk, tv, tp, 1)
    for nsplit in NSPLITS:
        for mc in MIN_CHUNKS:
            got = split_emulate(tq, tk, tv, tp, 1, nsplit=nsplit,
                                min_chunk=mc)
            assert got.shape == (B, n_kv * hgs, 1, HS)
            assert _rel(got, want) <= TOL_EMU, (nsplit, mc)
            assert _rel(got, plain) <= TOL_EMU, (nsplit, mc)


@pytest.mark.parametrize("cache_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_kv,hgs,pos", [(4, 1, 47), (1, 8, 1)])
def test_split_emulation_vs_pallas_single(cache_dt, n_kv, hgs, pos):
    """B=1 on the stacked (L, n_kv, S, hs) cache: the emulation against
    flash_decode_single and decode_attention_pallas_indexed (interpret
    mode); pos 47 ends the third 16-row chunk (at a 16-row least chunk:
    3 splits of 16 rows, the rest empty)."""
    rng = np.random.default_rng(pos + hgs)
    q = rng.standard_normal((n_kv * hgs, 1, HS)).astype(np.float32)
    ck, cv = _caches(rng, (L, n_kv, S, HS), cache_dt)
    jq, jk, jv = map(jnp.asarray, (q, ck, cv))
    wants = [jfd.flash_decode_single(jq, jk, jv, pos, 1, block_s=16,
                                     interpret=True),
             jpatt.decode_attention_pallas_indexed(jq, jk, jv, pos, 1,
                                                   interpret=True)]
    tq, tk, tv = _t(q)[None], _t(ck)[:, None], _t(cv)[:, None]
    tp = torch.tensor([pos], dtype=torch.int32)
    for nsplit in NSPLITS:
        for mc in MIN_CHUNKS:
            got = split_emulate(tq, tk, tv, tp, 1, nsplit=nsplit,
                                min_chunk=mc)[0]
            for want in wants:
                assert _rel(got, want) <= TOL_EMU, (nsplit, mc)


@pytest.mark.parametrize("n_kv,hgs", GROUPS)
def test_split_emulation_int8_vs_pallas(n_kv, hgs):
    """An int8 cache with ``quantize_rows`` row scales, per-slot positions
    at B=4: the emulation against non-fresh flash_decode_batched with its
    row scales (interpret mode) and flash_decode_plain."""
    B = len(SLOT_POS)
    rng = np.random.default_rng(20 + hgs)
    q = rng.standard_normal((B, n_kv * hgs, 1, HS)).astype(np.float32)
    ck, cv = _caches(rng, (L, B, n_kv, S, HS), "float32")
    jk, jks = j_quantize_rows(jnp.asarray(ck))
    jv, jvs = j_quantize_rows(jnp.asarray(cv))
    jks, jvs = jks[..., 0], jvs[..., 0]
    pos = np.array(SLOT_POS, np.int32)
    want = jfd.flash_decode_batched(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                                    0, block_s=16, interpret=True,
                                    k_scale=jks, v_scale=jvs)
    tq, tk, tv, tks, tvs, tp = map(_t, (q, jk, jv, jks, jvs, pos))
    plain = tfd.flash_decode_plain(tq, tk, tv, tp, 0, tks, tvs)
    for nsplit in NSPLITS:
        for mc in MIN_CHUNKS:
            got = split_emulate(tq, tk, tv, tp, 0, tks, tvs, nsplit, mc)
            assert _rel(got, want) <= TOL_EMU, (nsplit, mc)
            assert _rel(got, plain) <= TOL_EMU, (nsplit, mc)


# -- (c) the kernel on the card ----------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_operands(dev, rng, Lc, B, n_kv, hgs, Sc, hs, qdt, cache_dt):
    """q (B, H, 1, hs) in qdt; caches (Lc, B, n_kv, Sc, hs) in cache_dt,
    int8 with ``quantize_rows`` scales."""
    from fastllama_tpu_torch.quant.groupquant import quantize_rows
    q = torch.tensor(rng.standard_normal((B, n_kv * hgs, 1, hs)).astype(
        np.float32), device=dev).to(getattr(torch, qdt))
    ck, cv = (torch.tensor(rng.standard_normal(
        (Lc, B, n_kv, Sc, hs)).astype(np.float32), device=dev)
        for _ in range(2))
    if cache_dt == "int8":
        (ck, ks), (cv, vs) = quantize_rows(ck), quantize_rows(cv)
        return q, ck, cv, ks[..., 0].contiguous(), vs[..., 0].contiguous()
    return q, ck.to(getattr(torch, cache_dt)), cv.to(getattr(torch,
                                                             cache_dt)), \
        None, None


def _check(fn, args, plain, pargs, tol, split=True):
    n0, s0 = fn.launches, fn.launches_split
    got = fn(*args)
    assert fn.launches == n0 + 1
    assert fn.launches_split == s0 + (1 if split else 0)
    want = plain(*pargs)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    err = _rel(got, want)
    assert err <= tol, err


def _check_merges(q, ck, cv, pos, ks, vs, tol):
    """The split mode at other split counts and a 16-row least chunk, so
    that several splits hold rows and merge, against the plain version."""
    want = tfd.flash_decode_plain(q, ck, cv, pos, 1, ks, vs)
    for nsplit in (2, 3, 16):
        got = tfd._split_launch(q, ck, cv, pos, 1, ks, vs, nsplit, 16)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got.float()).all())
        assert _rel(got, want) <= tol, nsplit


@pytest.mark.gpu
@pytest.mark.parametrize("qdt,cache_dt", [("bfloat16", "bfloat16"),
                                          ("float32", "float32"),
                                          ("bfloat16", "int8"),
                                          ("float32", "int8")])
@pytest.mark.parametrize("hs", [64, 96, 128, 256])
@pytest.mark.parametrize("B", [1, 3, 32])
def test_split_kernel_vs_plain_on_card(cuda, qdt, cache_dt, hs, B):
    """The split mode against flash_decode_plain within TOL_F32 (f32 q) or
    TOL_BF16 (bf16 q) at S 512 and 2048, hgs 1, 2, 4 and 8: at B=1 pos
    0, 1, 107, S-1 through flash_decode_single (and, over f32 or bf16
    caches, decode_attention_pallas_indexed and decode_attention_pallas);
    at B 3 and 32 per-slot positions through flash_decode_batched (and
    decode_attention_pallas_batched).  Every call advances ``launches``
    and ``launches_split`` of the wrapper called.  The same inputs at 2, 3
    and 16 splits of at least 16 rows exercise the merge."""
    tol = TOL_F32 if qdt == "float32" else TOL_BF16
    for Sc in (512, 2048):
        for hgs in (1, 2, 4, 8):
            n_kv = max(1, 8 // hgs) if B < 32 else 2
            rng = np.random.default_rng(Sc + hs + B + hgs)
            q, ck, cv, ks, vs = _card_operands(cuda, rng, 2, B, n_kv, hgs,
                                               Sc, hs, qdt, cache_dt)
            assert tfd.decode_mode(q, ck) == "split"
            if B == 1:
                for p in (0, 1, 107, Sc - 1):
                    pos = torch.tensor([p], dtype=torch.int32, device=cuda)
                    _check_merges(q, ck, cv, pos, ks, vs, tol)
                    if ks is not None:
                        _check(tfd.flash_decode_batched,
                               (q, ck, cv, pos, 1, ks, vs),
                               tfd.flash_decode_plain,
                               (q, ck, cv, pos, 1, ks, vs), tol)
                        continue
                    q1, k1, v1 = q[0], ck[:, 0], cv[:, 0]
                    for fn, args, plain, pargs in (
                            (tfd.flash_decode_single, (q1, k1, v1, pos, 1),
                             tfd.flash_decode_single_plain,
                             (q1, k1, v1, pos, 1)),
                            (tkatt.decode_attention_pallas_indexed,
                             (q1, k1, v1, pos, 1),
                             tfd.flash_decode_single_plain,
                             (q1, k1, v1, pos, 1)),
                            (tkatt.decode_attention_pallas,
                             (q1, k1[1], v1[1], p),
                             tkatt.decode_attention_plain,
                             (q1, k1[1], v1[1], p))):
                        _check(fn, args, plain, pargs, tol)
                continue
            pos = torch.tensor(rng.integers(0, Sc, B), dtype=torch.int32)
            pos[:3] = torch.tensor([0, 1, Sc - 1])
            pos = pos.to(cuda)
            _check_merges(q, ck, cv, pos, ks, vs, tol)
            _check(tfd.flash_decode_batched, (q, ck, cv, pos, 1, ks, vs),
                   tfd.flash_decode_plain, (q, ck, cv, pos, 1, ks, vs), tol)
            if ks is None:
                _check(tkatt.decode_attention_pallas_batched,
                       (q, ck, cv, pos, 1), tfd.flash_decode_plain,
                       (q, ck, cv, pos, 1), tol)


@pytest.mark.gpu
@pytest.mark.parametrize("hs", [40, 72, 136])
@pytest.mark.parametrize("cache_dt", ["bfloat16", "int8"])
def test_other_head_sizes_and_modes_keep_the_tiled_kernel_on_card(
        cuda, hs, cache_dt):
    """hs off the multiple of 16: the tiled kernel (``launches`` advances,
    ``launches_split`` does not), against flash_decode_plain; at hs 64
    fresh rows take the split mode (``launches_split`` advances), stats
    too (``launches_stats_split`` advances, ``launches_split`` does not),
    and so does the call without either."""
    rng = np.random.default_rng(hs)
    B, n_kv, hgs, Sc = 3, 2, 4, 256
    q, ck, cv, ks, vs = _card_operands(cuda, rng, 2, B, n_kv, hgs, Sc, hs,
                                       "bfloat16", cache_dt)
    pos = torch.tensor([0, 100, Sc - 1], dtype=torch.int32, device=cuda)
    assert tfd.decode_mode(q, ck) == "tiled"
    _check(tfd.flash_decode_batched, (q, ck, cv, pos, 1, ks, vs),
           tfd.flash_decode_plain, (q, ck, cv, pos, 1, ks, vs), TOL_BF16,
           split=False)
    q, ck, cv, ks, vs = _card_operands(cuda, rng, 2, B, n_kv, hgs, Sc, 64,
                                       "bfloat16", cache_dt)
    kn, vn = (torch.randn((B, n_kv, 64), device=cuda).to(torch.bfloat16)
              for _ in range(2))
    _check(tfd.flash_decode_batched, (q, ck, cv, pos, 1, ks, vs, kn, vn),
           tfd.flash_decode_plain, (q, ck, cv, pos, 1, ks, vs, kn, vn),
           TOL_BF16, split=True)
    s0 = tfd.flash_decode_batched.launches_split
    n0 = tfd.flash_decode_batched.launches_stats
    t0 = tfd.flash_decode_batched.launches_stats_split
    o, m, l = tfd.flash_decode_batched(q, ck, cv, pos, 1, ks, vs, stats=True)
    assert tfd.flash_decode_batched.launches_stats == n0 + 1
    assert tfd.flash_decode_batched.launches_stats_split == t0 + 1
    assert tfd.flash_decode_batched.launches_split == s0
    wo, wm, wl = tfd.flash_decode_plain(q, ck, cv, pos, 1, ks, vs,
                                        stats=True)
    torch.cuda.synchronize()
    assert _rel(o, wo) <= TOL_BF16 and _rel(l, wl) <= TOL_BF16
    _check(tfd.flash_decode_batched, (q, ck, cv, pos, 1, ks, vs),
           tfd.flash_decode_plain, (q, ck, cv, pos, 1, ks, vs), TOL_BF16)
