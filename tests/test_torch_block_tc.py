"""K2b's TC mode (``flash_block_attend`` for bf16 q over an int8 or bf16
cache, hs % 16 == 0): the mode choice and the TC mode's row tiling on the
CPU; an emulation of the TC kernel's roundings in plain torch (64-row
tiles, online softmax in f32, e * v_scale rounded to bf16 before P.V)
held against the JAX Pallas ``flash_block_attend`` in interpret mode, so
that the card's tolerance is shown to cover the new rounding; and, on a
card, the kernel against ``flash_block_plain`` at ragged shapes with its
launch counts."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastllama_tpu.ops.pallas.flash_decode import \
    flash_block_attend as j_block
from fastllama_tpu_torch.ops.kernels import flash_decode as tfd


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast when the suite's
    workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL_BF16 = 1e-2      # x max|ref|, bf16 outputs (chip_smoke.TOL_BF16)
TOL_F32 = 1e-4
TILE = 64            # K/V rows a tile of the TC kernel
BLOCK = 16           # the Pallas kernel's cache block
BF16 = torch.bfloat16
NEG_INF = -1e30


def _bf16(a):
    """f32 numpy array rounded to bf16 values (still f32)."""
    return torch.tensor(a).to(BF16).float().numpy()


def _inputs(rng, L, B, n_kv, hgs, S, hs, T, cache_dt):
    """numpy operands: q (H, T, hs) and the fresh block (n_kv, T, hs) in
    bf16 values; caches (L, B, n_kv, S, hs) int8 with f32 row scales, or
    bf16 values without."""
    q = _bf16(rng.standard_normal((n_kv * hgs, T, hs)).astype(np.float32))
    kn, vn = (_bf16(rng.standard_normal((n_kv, T, hs)).astype(np.float32))
              for _ in range(2))
    shape = (L, B, n_kv, S, hs)
    if cache_dt == "int8":
        ck, cv = (rng.integers(-127, 128, shape).astype(np.int8)
                  for _ in range(2))
        ks, vs = ((rng.random(shape[:-1]) * 0.05).astype(np.float32)
                  for _ in range(2))
        return q, ck, cv, ks, vs, kn, vn
    ck, cv = (_bf16(rng.standard_normal(shape).astype(np.float32))
              for _ in range(2))
    return q, ck, cv, None, None, kn, vn


def _torch(arrays, cache_dt, device="cpu"):
    q, ck, cv, ks, vs, kn, vn = arrays
    cdt = torch.int8 if cache_dt == "int8" else BF16

    def t(a, dt):
        return None if a is None else torch.tensor(a).to(dt).to(device)
    return (t(q, BF16), t(ck, cdt), t(cv, cdt), t(ks, torch.float32),
            t(vs, torch.float32), t(kn, BF16), t(vn, BF16))


def tc_key_width(T, hgs, n_kv, hs):
    """Keys of each 64-row tile one warp of the TC kernel takes: its block
    holds R = hgs * TQ query rows in R / 16 row groups of 4 warps, and the
    4 / groups warps of a row group split each tile's keys."""
    groups = -(-hgs * tfd.block_rows(T, hgs, n_kv, "tc", hs) // 16)
    return {1: 16, 2: 32}.get(groups, 64)


def tc_emulate(q, ck, cv, slot, layer, start, ks, vs, kn, vn, kw=TILE):
    """The TC kernel's arithmetic in plain torch: the slot's cache rows
    [0, start) and then the fresh block in tiles of 64 rows, each split
    into key groups of ``kw`` keys; per key group a running max and sum
    and an O of its own, per tile the scores (bf16 products summed in
    f32) times 1/sqrt(hs) and the K row scale, the masks (fresh rows above
    the diagonal), the sum of the f32 e, and e * v_scale rounded to bf16
    before P.V in f32; the key groups merged at the end; output acc / sum
    in bf16."""
    n_heads, T, hs = q.shape
    n_kv = ck.shape[2]
    hgs = n_heads // n_kv
    f32 = torch.float32
    qf = q.to(f32).reshape(n_kv, hgs * T, hs)
    tpos = torch.arange(T).repeat(hgs)              # row g * T + t

    def part(t, lo, hi):
        return None if t is None else t[..., lo:hi]
    cache = [a if a is None else a[layer, slot, :, :start]
             for a in (ck, cv, ks, vs)]
    state = []
    for g0 in range(0, TILE, kw):
        m = torch.full((n_kv, hgs * T), NEG_INF)
        l = torch.zeros((n_kv, hgs * T))
        o = torch.zeros((n_kv, hgs * T, hs))
        tiles = [(r0 + g0, min(r0 + g0 + kw, start), None, cache)
                 for r0 in range(0, start, TILE)]
        tiles += [(j0 + g0, min(j0 + g0 + kw, T), j0 + g0, (kn, vn, None,
                                                              None))
                  for j0 in range(0, T, TILE)]
        for lo, hi, j0, (k, v, ksc, vsc) in tiles:
            if hi <= lo:
                continue
            kk, vv = k[:, lo:hi], v[:, lo:hi]
            s = torch.einsum("krh,kjh->krj", qf, kk.to(f32)) / math.sqrt(hs)
            if ksc is not None:
                s = s * part(ksc, lo, hi)[:, None, :]
            if j0 is not None:
                keys = torch.arange(lo, hi)
                s = torch.where(keys[None, None, :] <= tpos[None, :, None],
                                s, torch.full_like(s, NEG_INF))
            mx = torch.maximum(m, s.amax(-1))
            mu = torch.where(mx == NEG_INF, torch.zeros_like(mx), mx)
            corr = torch.exp(m - mu)
            e = torch.exp(s - mu[..., None])
            l = l * corr + e.sum(-1)
            p = e if vsc is None else e * part(vsc, lo, hi)[:, None, :]
            p = p.to(BF16).to(f32)
            o = o * corr[..., None] + torch.einsum("krj,kjh->krh", p,
                                                   vv.to(f32))
            m = mx
        state.append((m, l, o))
    m, l, o = state[0]
    for mk, lk, ok in state[1:]:
        mm = torch.maximum(m, mk)
        mu = torch.where(mm == NEG_INF, torch.zeros_like(mm), mm)
        fa, fb = torch.exp(m - mu), torch.exp(mk - mu)
        l, o, m = l * fa + lk * fb, o * fa[..., None] + ok * fb[..., None], mm
    return (o / l[..., None]).reshape(n_heads, T, hs).to(BF16)


def _rel_err(got, want):
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / w.abs().max()).item()


# -- (a) the mode and the TC mode's rows, on the CPU -------------------------

@pytest.mark.parametrize("qdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("cache_dt", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("hs", [16, 64, 72, 128, 136, 256, 8])
@pytest.mark.parametrize("hgs", [1, 64])
def test_block_mode_picks_tc_exactly(qdt, cache_dt, hs, hgs):
    """TC exactly for bf16 q over an int8 or bf16 cache with hs % 16 == 0
    (up to 256; past 128 only for hgs <= 32, since a block then holds at
    most 32 query rows); every other case here with hgs = 1, or hs up to
    128 (hs a multiple of 8, aligned operands), the split-TF32 mode; the
    f32 mode for the rest (the modes' full rule is held in
    test_torch_block_tf32.py)."""
    q = torch.zeros((2 * hgs, 3, hs), dtype=getattr(torch, qdt))
    ck = torch.zeros((1, 1, 2, 8, hs), dtype=getattr(torch, cache_dt))
    rows = hs <= 128 or hgs <= 32
    want = ("tc" if qdt == "bfloat16" and cache_dt != "float32"
            and hs % 16 == 0 and rows else "tf32" if rows else "f32")
    assert tfd.block_mode(q, ck) == want


@pytest.mark.parametrize("hgs", [1, 2, 3, 4, 5, 6, 8, 16, 32, 64])
@pytest.mark.parametrize("hs", [128, 256])
def test_block_rows_tc_rule(hgs, hs):
    """The TC mode's query tile: hgs * TQ <= 64 rows (32 past hs 128), a
    multiple of 16 wherever that limit allows one; no more than T needs;
    halved only while the grid is short of the card's 132 SMs."""
    if hs > 128 and hgs > 32:
        return                              # the f32 mode's (block_mode)
    rows = 64 if hs <= 128 else 32
    unit = 16 // math.gcd(hgs, 16)
    for T in (1, 15, 17, 32, 63, 65, 150, 256, 496):
        for n_kv in (1, 8, 32):
            tq = tfd.block_rows(T, hgs, n_kv, "tc", hs)
            assert 1 <= tq and hgs * tq <= rows
            if hgs * unit <= rows:
                assert tq % unit == 0 and (hgs * tq) % 16 == 0
            assert tq <= max(unit, 2 * T)       # no more than T needs
    # the 7B tail shapes and LLaMA-2-70B's GQA at a one-row tail
    assert tfd.block_rows(256, 1, 32, "tc") == 32     # 256 blocks
    assert tfd.block_rows(32, 1, 32, "tc") == 16      # 64 blocks
    assert tfd.block_rows(1, 8, 8, "tc") == 2         # one 16-row warp


def test_block_tc_inputs_take_the_plain_version_on_the_cpu():
    """On CPU tensors the TC mode's inputs run flash_block_plain and count
    no launch."""
    rng = np.random.default_rng(3)
    args = _torch(_inputs(rng, 1, 2, 2, 2, 64, 32, 9, "int8"), "int8")
    n0, n_tc = tfd.flash_block_attend.launches, \
        tfd.flash_block_attend.launches_tc
    q, ck, cv, ks, vs, kn, vn = args
    got = tfd.flash_block_attend(q, ck, cv, 1, 0, 20, ks, vs, kn, vn)
    want = tfd.flash_block_plain(q, ck, cv, 1, 0, 20, ks, vs, kn, vn)
    assert torch.equal(got, want)
    assert (tfd.flash_block_attend.launches,
            tfd.flash_block_attend.launches_tc) == (n0, n_tc)


# -- (b) the TC rounding against JAX, on the CPU ------------------------------

@pytest.mark.parametrize("cache_dt", ["int8", "bfloat16"])
@pytest.mark.parametrize("hgs", [1, 4])
@pytest.mark.parametrize("T", [16, 37])
@pytest.mark.parametrize("start", [0, 100])
def test_tc_emulation_vs_pallas(cache_dt, hgs, T, start):
    """The TC mode's roundings (emulated) against the Pallas kernel in
    interpret mode, within TOL_BF16 x max|ref|: hs 128, slot 1 / layer 1
    of a 2-slot cache, start 100 ending inside the second 64-row tile."""
    rng = np.random.default_rng(T + 7 * hgs + start)
    L, B, n_kv, S, hs = 2, 2, 2, 144, 128
    arrays = _inputs(rng, L, B, n_kv, hgs, S, hs, T, cache_dt)
    q, ck, cv, ks, vs, kn, vn = arrays
    jdt = jnp.int8 if cache_dt == "int8" else jnp.bfloat16
    want = j_block(jnp.asarray(q, jnp.bfloat16), jnp.asarray(ck, jdt),
                   jnp.asarray(cv, jdt), 1, 1, start, block_s=BLOCK,
                   interpret=True,
                   k_scale=None if ks is None else jnp.asarray(ks),
                   v_scale=None if vs is None else jnp.asarray(vs),
                   k_new=jnp.asarray(kn, jnp.bfloat16),
                   v_new=jnp.asarray(vn, jnp.bfloat16))
    want = torch.tensor(np.asarray(want, np.float32))
    tq, tck, tcv, tks, tvs, tkn, tvn = _torch(arrays, cache_dt)
    got = tc_emulate(tq, tck, tcv, 1, 1, start, tks, tvs, tkn, tvn,
                     tc_key_width(T, hgs, n_kv, hs))
    assert got.shape == (n_kv * hgs, T, hs) and got.dtype == BF16
    assert bool(torch.isfinite(got.float()).all())
    assert _rel_err(got, want) <= TOL_BF16
    plain = tfd.flash_block_plain(tq, tck, tcv, 1, 1, start, tks, tvs, tkn,
                                  tvn)
    assert _rel_err(got, plain) <= TOL_BF16


# -- (c) the kernel on the card -----------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dt", ["int8", "bfloat16"])
@pytest.mark.parametrize("hgs", [1, 2, 4, 8])
@pytest.mark.parametrize("hs", [64, 128])
def test_tc_kernel_vs_plain_on_card(cuda, cache_dt, hgs, hs):
    """The TC mode against flash_block_plain within TOL_BF16 at ragged T
    and start in {0, 1, 100, S - T}; each call advances ``launches`` and
    ``launches_tc`` by one."""
    L, B, n_kv, S = 2, 3, 2, 256
    for T in (1, 15, 17, 63, 65, 150):
        for start in (0, 1, 100, S - T):
            if start + T > S:
                continue
            rng = np.random.default_rng(T + 3 * start + hgs + hs)
            q, ck, cv, ks, vs, kn, vn = _torch(
                _inputs(rng, L, B, n_kv, hgs, S, hs, T, cache_dt), cache_dt,
                cuda)
            assert tfd.block_mode(q, ck) == "tc"
            n0 = tfd.flash_block_attend.launches
            n_tc = tfd.flash_block_attend.launches_tc
            got = tfd.flash_block_attend(q, ck, cv, 2, 1, start, ks, vs, kn,
                                         vn)
            assert tfd.flash_block_attend.launches == n0 + 1
            assert tfd.flash_block_attend.launches_tc == n_tc + 1
            want = tfd.flash_block_plain(q, ck, cv, 2, 1, start, ks, vs, kn,
                                         vn)
            torch.cuda.synchronize()
            assert got.dtype == BF16
            assert bool(torch.isfinite(got.float()).all())
            err = _rel_err(got, want)
            assert err <= TOL_BF16, (T, start, err)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dt", ["int8", "bfloat16"])
@pytest.mark.parametrize("hs,hgs", [(48, 8), (96, 2), (144, 4), (256, 1),
                                    (256, 8)])
def test_tc_kernel_padded_head_sizes_on_card(cuda, cache_dt, hs, hgs):
    """Head sizes the TC mode pads to 64, 128 or 256 (zero dims), and hs
    256, where a block holds at most 32 rows: against flash_block_plain
    within TOL_BF16."""
    L, B, n_kv, S = 2, 3, 2, 256
    for T, start in ((1, 0), (17, 1), (65, 100), (150, 106)):
        rng = np.random.default_rng(T + start + hs)
        q, ck, cv, ks, vs, kn, vn = _torch(
            _inputs(rng, L, B, n_kv, hgs, S, hs, T, cache_dt), cache_dt,
            cuda)
        assert tfd.block_mode(q, ck) == "tc"
        n_tc = tfd.flash_block_attend.launches_tc
        got = tfd.flash_block_attend(q, ck, cv, 2, 1, start, ks, vs, kn, vn)
        assert tfd.flash_block_attend.launches_tc == n_tc + 1
        want = tfd.flash_block_plain(q, ck, cv, 2, 1, start, ks, vs, kn, vn)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got.float()).all())
        assert _rel_err(got, want) <= TOL_BF16, (T, start)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt,cache_dt,hs", [
    ("float32", "int8", 128), ("float32", "bfloat16", 128),
    ("bfloat16", "float32", 128), ("float32", "float32", 64),
    ("bfloat16", "int8", 72)])
def test_f32_mode_leaves_launches_tc_on_card(cuda, qdt, cache_dt, hs):
    """f32 q, an f32 cache or an hs off the multiple of 16 runs a mode
    other than TC (here, with hs a multiple of 8 and aligned operands, the
    split-TF32 mode): ``launches`` advances, ``launches_tc`` does not."""
    rng = np.random.default_rng(hs)
    L, B, n_kv, hgs, S, T, start = 2, 3, 2, 2, 128, 33, 70
    q, ck, cv, ks, vs, kn, vn = _inputs(rng, L, B, n_kv, hgs, S, hs, T,
                                        "int8" if cache_dt == "int8"
                                        else "bfloat16")
    qt, ct = getattr(torch, qdt), getattr(torch, cache_dt)

    def t(a, dt):
        return None if a is None else torch.tensor(a).to(dt).to(cuda)
    q, kn, vn = t(q, qt), t(kn, qt), t(vn, qt)
    ck, cv, ks, vs = t(ck, ct), t(cv, ct), t(ks, torch.float32), \
        t(vs, torch.float32)
    assert tfd.block_mode(q, ck) == "tf32"
    n0 = tfd.flash_block_attend.launches
    n_tc = tfd.flash_block_attend.launches_tc
    got = tfd.flash_block_attend(q, ck, cv, 1, 0, start, ks, vs, kn, vn)
    assert tfd.flash_block_attend.launches == n0 + 1
    assert tfd.flash_block_attend.launches_tc == n_tc
    want = tfd.flash_block_plain(q, ck, cv, 1, 0, start, ks, vs, kn, vn)
    torch.cuda.synchronize()
    tol = TOL_F32 if qdt == "float32" else TOL_BF16
    assert _rel_err(got, want) <= tol
