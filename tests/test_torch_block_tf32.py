"""K2b's split-TF32 mode (``flash_block_attend`` for f32 q, for bf16 q over
an f32 cache, and for bf16 q at a head size off the multiple of 16): the
mode choice by dtype, head size, head group and alignment on the CPU; an
emulation of the kernel's arithmetic in plain torch (32-row tiles split
over key groups, every f32 operand split into two TF32 parts rounded to
nearest with ties away from zero, the passes big.big + big.small +
small.big, P split for f32 q and rounded once for bf16 q) held against
the JAX Pallas ``flash_block_attend`` in interpret mode, beside the same
arithmetic in one TF32 pass, which the f32 contract does not allow; and,
on a card, the kernel against ``flash_block_plain`` with its launch
counts."""
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
TOL_F32 = 1e-4       # x max|ref|, f32 outputs (chip_smoke.TOL_F32)
TILE = 32            # K/V rows a tile of the TF32 kernel
BLOCK = 16           # the Pallas kernel's cache block
F32, BF16 = torch.float32, torch.bfloat16
NEG_INF = -1e30
DTYPES = {"float32": F32, "bfloat16": BF16, "int8": torch.int8}


def tf32(x):
    """f32 values rounded to TF32 (10 mantissa bits) as cvt.rna.tf32.f32
    does: half a TF32 unit added to the magnitude (the sign bit stays out
    of the sum), the 13 low bits cleared."""
    b = x.to(F32).contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(F32)


def split(x):
    """x as big + small, both TF32; small is 0 where x is exact in TF32
    (bf16 and int8 values)."""
    big = tf32(x)
    return big, tf32(x.to(F32) - big)


def _inputs(rng, L, B, n_kv, hgs, S, hs, T, qdt, cache_dt):
    """numpy operands: q (H, T, hs) and the fresh block (n_kv, T, hs) in
    q's dtype's values; caches (L, B, n_kv, S, hs) with f32 row scales at
    int8."""
    def vals(shape, dt):
        a = rng.standard_normal(shape).astype(np.float32)
        return torch.tensor(a).to(DTYPES[dt]).float().numpy()
    q = vals((n_kv * hgs, T, hs), qdt)
    kn, vn = vals((n_kv, T, hs), qdt), vals((n_kv, T, hs), qdt)
    shape = (L, B, n_kv, S, hs)
    if cache_dt == "int8":
        ck, cv = (rng.integers(-127, 128, shape).astype(np.int8)
                  for _ in range(2))
        ks, vs = ((rng.random(shape[:-1]) * 0.05).astype(np.float32)
                  for _ in range(2))
        return q, ck, cv, ks, vs, kn, vn
    return q, vals(shape, cache_dt), vals(shape, cache_dt), None, None, kn, vn


def _torch(arrays, qdt, cache_dt, device="cpu"):
    q, ck, cv, ks, vs, kn, vn = arrays

    def t(a, dt):
        return None if a is None else torch.tensor(a).to(dt).to(device)
    qt, ct = DTYPES[qdt], DTYPES[cache_dt]
    return (t(q, qt), t(ck, ct), t(cv, ct), t(ks, F32), t(vs, F32),
            t(kn, qt), t(vn, qt))


def tf32_key_width(T, hgs, n_kv, hs):
    """Keys of each 32-row tile one warp of the TF32 kernel takes: its
    block holds R = hgs * TQ query rows in ceil(R / 16) row groups of 4
    warps (4 groups past 48 rows), and the warps of a row group split
    each tile's keys."""
    groups = -(-hgs * tfd.block_rows(T, hgs, n_kv, "tf32", hs) // 16)
    return {1: 8, 2: 16}.get(groups, 32)


def _product(a, b, eq, passes):
    """einsum of split operands: big.big, plus big.small + small.big for
    the split kernel (passes 3; a small part of 0 adds nothing, as the
    kernel skips it), big.big alone in one TF32 pass (passes 1)."""
    (ah, al), (bh, bl) = a, b
    out = torch.einsum(eq, ah, bh)
    if passes == 3:
        out = out + (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh))
    return out


def tf32_emulate(q, ck, cv, slot, layer, start, ks, vs, kn, vn, kw=TILE,
                 passes=3):
    """The TF32 kernel's arithmetic in plain torch: the slot's cache rows
    [0, start) and then the fresh block in tiles of 32 rows, each split
    into key groups of ``kw`` keys; per key group a running max and sum
    and an O of its own; per tile the scores from split operands (Q and
    K; bf16 and int8 values have no small part) times 1/sqrt(hs) and the
    K row scale, the masks, the sum of the f32 e, e * v_scale split (f32
    q) or rounded once to TF32 (bf16 q) before P.V on split V; the key
    groups merged at the end; output acc / sum in q's dtype.  ``passes``
    1: every operand rounded once to TF32 instead (one TF32 pass)."""
    n_heads, T, hs = q.shape
    n_kv = ck.shape[2]
    hgs = n_heads // n_kv
    f32 = q.dtype == F32
    qf = q.to(F32).reshape(n_kv, hgs * T, hs)
    qs = split(qf) if passes == 3 else (tf32(qf), torch.zeros_like(qf))
    tpos = torch.arange(T).repeat(hgs)              # row g * T + t

    def part(t, lo, hi):
        return None if t is None else t[..., lo:hi]

    def ops(x):
        x = x.to(F32)
        return split(x) if passes == 3 else (tf32(x), torch.zeros_like(x))
    cache = [a if a is None else a[layer, slot, :, :start]
             for a in (ck, cv, ks, vs)]
    state = []
    for g0 in range(0, TILE, kw):
        m = torch.full((n_kv, hgs * T), NEG_INF)
        l = torch.zeros((n_kv, hgs * T))
        o = torch.zeros((n_kv, hgs * T, hs))
        tiles = [(r0 + g0, min(r0 + g0 + kw, start), None, cache)
                 for r0 in range(0, start, TILE)]
        tiles += [(j0 + g0, min(j0 + g0 + kw, T), j0 + g0,
                   (kn, vn, None, None)) for j0 in range(0, T, TILE)]
        for lo, hi, j0, (k, v, ksc, vsc) in tiles:
            if hi <= lo:
                continue
            s = _product(qs, ops(k[:, lo:hi]), "krh,kjh->krj", passes)
            s = s * (1.0 / math.sqrt(hs))
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
            ps = (split(p) if f32 and passes == 3
                  else (tf32(p), torch.zeros_like(p)))
            o = o * corr[..., None] + _product(ps, ops(v[:, lo:hi]),
                                               "krj,kjh->krh", passes)
            m = mx
        state.append((m, l, o))
    m, l, o = state[0]
    for mk, lk, ok in state[1:]:
        mm = torch.maximum(m, mk)
        mu = torch.where(mm == NEG_INF, torch.zeros_like(mm), mm)
        fa, fb = torch.exp(m - mu), torch.exp(mk - mu)
        l, o, m = l * fa + lk * fb, o * fa[..., None] + ok * fb[..., None], mm
    return (o / l[..., None]).reshape(n_heads, T, hs).to(q.dtype)


def _rel_err(got, want):
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / w.abs().max()).item()


def _misaligned(t):
    """A view of ``t``'s values one element past a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 16, dtype=t.dtype)
    return flat[1:1 + t.numel()].view(t.shape).copy_(t)


# -- (a) the mode, on the CPU -------------------------------------------------

def test_tf32_round_is_nearest_ties_away():
    """The emulation's TF32 rounding: 10 mantissa bits, to nearest, ties
    away from zero in both signs, exact on bf16 and int8 values."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4,
                      -(one + ulp / 2), 2.0 - ulp / 2, 3.0, -127.0],
                     dtype=F32)
    want = torch.tensor([one + ulp, one, one + ulp, -(one + ulp), 2.0, 3.0,
                         -127.0], dtype=F32)
    assert torch.equal(tf32(x), want)
    b = torch.randn(1000).to(BF16).float()
    assert torch.equal(tf32(b), b)
    big, small = split(torch.randn(1000))
    assert torch.equal(tf32(small), small)
    assert bool((small.abs() <= big.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("qdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("cache_dt", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("hs", [8, 24, 64, 72, 80, 128, 136, 256, 12, 264])
@pytest.mark.parametrize("hgs", [1, 8, 32, 64])
def test_block_mode_picks_tf32_exactly(qdt, cache_dt, hs, hgs):
    """TC for bf16 q over an int8 or bf16 cache with hs % 16 == 0 (past
    hs 128 only for hgs <= 32: at most 32 query rows a block there); TF32
    for every other call with hs % 8 == 0 up to 256 (past hs 128 only for
    hgs <= 16: at most 16 rows) and aligned operands; the f32 mode for the
    rest, and for a TF32 call with any operand off a 16-byte boundary."""
    q = torch.zeros((2 * hgs, 3, hs), dtype=DTYPES[qdt])
    ck = torch.zeros((1, 1, 2, 8, hs), dtype=DTYPES[cache_dt])
    fresh = torch.zeros((2, 3, hs), dtype=DTYPES[qdt])
    tc = (qdt == "bfloat16" and cache_dt != "float32" and hs % 16 == 0
          and hs <= 256 and (hs <= 128 or hgs <= 32))
    ok = hs % 8 == 0 and hs <= 256 and (hs <= 128 or hgs <= 16)
    want = "tc" if tc else "tf32" if ok else "f32"
    assert tfd.block_mode(q, ck, ck, fresh, fresh) == want
    assert tfd.block_mode(q, ck) == want
    for i in range(5):
        args = [q, ck, ck, fresh, fresh]
        args[i] = _misaligned(args[i])
        assert tfd.block_mode(*args) == ("tc" if tc else "f32")


@pytest.mark.parametrize("hgs", [1, 2, 3, 4, 5, 6, 8, 16, 32, 64])
def test_block_rows_tf32_rule(hgs):
    """The TF32 mode's query tile: hgs * TQ <= 64 rows (16 past hs 128),
    a multiple of 16 wherever that limit allows one; no more than T needs;
    halved only while the grid is short of the card's 132 SMs."""
    unit = 16 // math.gcd(hgs, 16)
    for T in (1, 15, 17, 32, 63, 65, 150, 256, 496):
        for n_kv in (1, 8, 32):
            for hs in (64, 128, 256):
                if hs > 128 and hgs > 16:
                    continue                    # the f32 mode's (block_mode)
                rows = 64 if hs <= 128 else 16
                tq = tfd.block_rows(T, hgs, n_kv, "tf32", hs)
                assert 1 <= tq and hgs * tq <= rows
                if hgs * unit <= rows:
                    assert tq % unit == 0 and (hgs * tq) % 16 == 0
                assert tq <= max(unit, 2 * T)
    assert tfd.block_rows(256, 1, 32, "tf32") == 32        # 256 blocks
    assert tfd.block_rows(32, 1, 32, "tf32") == 16         # 64 blocks


@pytest.mark.parametrize("qdt,cache_dt", [("float32", "int8"),
                                          ("float32", "float32"),
                                          ("bfloat16", "float32")])
def test_tf32_inputs_take_the_plain_version_on_the_cpu(qdt, cache_dt):
    """On CPU tensors the TF32 mode's inputs run flash_block_plain and
    count no launch in any mode."""
    rng = np.random.default_rng(5)
    q, ck, cv, ks, vs, kn, vn = _torch(
        _inputs(rng, 1, 2, 2, 2, 64, 32, 9, qdt, cache_dt), qdt, cache_dt)
    assert tfd.block_mode(q, ck, cv, kn, vn) == "tf32"
    fn = tfd.flash_block_attend
    n0 = (fn.launches, fn.launches_tc, fn.launches_tf32)
    got = fn(q, ck, cv, 1, 0, 20, ks, vs, kn, vn)
    want = tfd.flash_block_plain(q, ck, cv, 1, 0, 20, ks, vs, kn, vn)
    assert torch.equal(got, want)
    assert (fn.launches, fn.launches_tc, fn.launches_tf32) == n0


# -- (b) the split arithmetic against JAX, on the CPU -------------------------

def _jax_ref(arrays, qdt, cache_dt, slot, layer, start):
    q, ck, cv, ks, vs, kn, vn = arrays
    jq = jnp.float32 if qdt == "float32" else jnp.bfloat16
    jc = {"int8": jnp.int8, "bfloat16": jnp.bfloat16,
          "float32": jnp.float32}[cache_dt]
    want = j_block(jnp.asarray(q, jq), jnp.asarray(ck, jc),
                   jnp.asarray(cv, jc), slot, layer, start, block_s=BLOCK,
                   interpret=True,
                   k_scale=None if ks is None else jnp.asarray(ks),
                   v_scale=None if vs is None else jnp.asarray(vs),
                   k_new=jnp.asarray(kn, jq), v_new=jnp.asarray(vn, jq))
    return torch.tensor(np.asarray(want, np.float32))


@pytest.mark.parametrize("qdt,cache_dt,tol", [
    ("float32", "int8", TOL_F32), ("float32", "bfloat16", TOL_F32),
    ("float32", "float32", TOL_F32), ("bfloat16", "float32", TOL_BF16)])
@pytest.mark.parametrize("hgs,T,start,hs", [(1, 37, 100, 64),
                                           (8, 5, 33, 64),
                                           (1, 16, 0, 128),
                                           (8, 1, 143, 40)])
def test_tf32_emulation_vs_pallas(qdt, cache_dt, tol, hgs, T, start, hs,
                                  record_property):
    """The split arithmetic (emulated) against the Pallas kernel in
    interpret mode within the f32 contract (TOL_F32 for f32 q, TOL_BF16
    for bf16 q's bf16 output), at ragged T and start, hgs 1 and 8; the
    same arithmetic in one TF32 pass, recorded beside it, misses the f32
    contract by far more than the split."""
    rng = np.random.default_rng(T + 7 * hgs + start + hs)
    L, B, n_kv, S = 2, 2, 2, 144
    arrays = _inputs(rng, L, B, n_kv, hgs, S, hs, T, qdt, cache_dt)
    want = _jax_ref(arrays, qdt, cache_dt, 1, 1, start)
    tq, tck, tcv, tks, tvs, tkn, tvn = _torch(arrays, qdt, cache_dt)
    assert tfd.block_mode(tq, tck, tcv, tkn, tvn) == "tf32"
    kw = tf32_key_width(T, hgs, n_kv, hs)
    got, one = (tf32_emulate(tq, tck, tcv, 1, 1, start, tks, tvs, tkn, tvn,
                             kw, passes) for passes in (3, 1))
    assert got.shape == (n_kv * hgs, T, hs) and got.dtype == tq.dtype
    assert bool(torch.isfinite(got.float()).all())
    err, err_one = _rel_err(got, want), _rel_err(one, want)
    record_property("split_rel_err", err)
    record_property("one_pass_rel_err", err_one)
    print(f"split {err:.3e}, one TF32 pass {err_one:.3e}")
    assert err <= tol
    plain = tfd.flash_block_plain(tq, tck, tcv, 1, 1, start, tks, tvs, tkn,
                                  tvn)
    assert _rel_err(got, plain) <= tol
    if qdt == "float32":
        assert err_one > 4 * err


@pytest.mark.parametrize("cache_dt", ["int8", "float32"])
def test_one_tf32_pass_misses_the_f32_contract(cache_dt):
    """Why the split: at 7B's head size one TF32 pass of f32 q over a
    long cache lands outside TOL_F32, the split well inside it."""
    rng = np.random.default_rng(11)
    L, B, n_kv, hgs, S, hs, T, start = 1, 1, 1, 4, 512, 128, 32, 400
    arrays = _inputs(rng, L, B, n_kv, hgs, S, hs, T, "float32", cache_dt)
    tq, tck, tcv, tks, tvs, tkn, tvn = _torch(arrays, "float32", cache_dt)
    plain = tfd.flash_block_plain(tq, tck, tcv, 0, 0, start, tks, tvs, tkn,
                                  tvn)
    kw = tf32_key_width(T, hgs, n_kv, hs)
    got, one = (tf32_emulate(tq, tck, tcv, 0, 0, start, tks, tvs, tkn, tvn,
                             kw, passes) for passes in (3, 1))
    assert _rel_err(got, plain) <= TOL_F32 / 10
    assert _rel_err(one, plain) > TOL_F32


# -- (c) the kernel on the card -----------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_call(cuda, qdt, cache_dt, L, B, n_kv, hgs, S, hs, T, start, slot,
               seed):
    rng = np.random.default_rng(seed)
    args = _torch(_inputs(rng, L, B, n_kv, hgs, S, hs, T, qdt, cache_dt),
                  qdt, cache_dt, cuda)
    q, ck, cv, ks, vs, kn, vn = args
    fn = tfd.flash_block_attend
    mode = tfd.block_mode(q, ck, cv, kn, vn)
    n0, n_tf = fn.launches, fn.launches_tf32
    got = fn(q, ck, cv, slot, L - 1, start, ks, vs, kn, vn)
    assert fn.launches == n0 + 1
    assert fn.launches_tf32 == n_tf + (mode == "tf32")
    want = tfd.flash_block_plain(q, ck, cv, slot, L - 1, start, ks, vs, kn,
                                 vn)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    assert bool(torch.isfinite(got.float()).all())
    return mode, _rel_err(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt,cache_dt", [
    ("float32", "int8"), ("float32", "bfloat16"), ("float32", "float32"),
    ("bfloat16", "float32")])
@pytest.mark.parametrize("hgs", [1, 8])
@pytest.mark.parametrize("hs", [64, 80, 96, 128, 256])
def test_tf32_kernel_vs_plain_on_card(cuda, qdt, cache_dt, hgs, hs):
    """The TF32 mode against flash_block_plain within TOL_F32 (f32 q) or
    TOL_BF16 (bf16 q) at ragged T (1-150) and start (0, 1, 100, S - T);
    each call advances ``launches`` and ``launches_tf32`` by one."""
    tol = TOL_F32 if qdt == "float32" else TOL_BF16
    for T in (1, 15, 17, 63, 65, 150):
        for start in (0, 1, 100, 256 - T):
            mode, err = _card_call(cuda, qdt, cache_dt, 2, 3, 2, hgs, 256,
                                   hs, T, start, 2, T + 3 * start + hs)
            assert mode == "tf32"
            assert err <= tol, (T, start, err)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dt", ["int8", "bfloat16"])
@pytest.mark.parametrize("hs,hgs", [(40, 1), (72, 8), (200, 2)])
def test_tf32_kernel_bf16_q_off_16_on_card(cuda, cache_dt, hs, hgs):
    """bf16 q over an int8 or bf16 cache at a head size off the multiple
    of 16 (the TC mode's domain ends there): the TF32 mode, within
    TOL_BF16 (int8 rows of hs bytes, not a multiple of 16, copied 8 bytes
    at a time)."""
    for T, start in ((1, 0), (17, 1), (65, 100), (150, 106)):
        mode, err = _card_call(cuda, "bfloat16", cache_dt, 2, 3, 2, hgs, 256,
                               hs, T, start, 1, T + start + hs)
        assert mode == "tf32"
        assert err <= TOL_BF16, (T, start, err)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt,cache_dt", [("float32", "float32"),
                                          ("bfloat16", "float32")])
def test_misaligned_view_takes_the_f32_mode_on_card(cuda, qdt, cache_dt):
    """A cache view off a 16-byte boundary, and an hs off the multiple of
    8, take the CUDA-core f32 mode: ``launches`` advances,
    ``launches_tf32`` does not; the result holds against the plain
    version."""
    rng = np.random.default_rng(3)
    tol = TOL_F32 if qdt == "float32" else TOL_BF16
    L, B, n_kv, hgs, S, T, start = 2, 3, 2, 2, 128, 33, 70
    for hs, shift in ((64, True), (36, False)):
        q, ck, cv, ks, vs, kn, vn = _torch(
            _inputs(rng, L, B, n_kv, hgs, S, hs, T, qdt, cache_dt), qdt,
            cache_dt, cuda)
        if shift:
            flat = torch.zeros(ck.numel() + 4, dtype=ck.dtype, device=cuda)
            ck = flat[1:1 + ck.numel()].view(ck.shape).copy_(ck)
        fn = tfd.flash_block_attend
        assert tfd.block_mode(q, ck, cv, kn, vn) == "f32"
        n0, n_tf = fn.launches, fn.launches_tf32
        got = fn(q, ck, cv, 1, 0, start, ks, vs, kn, vn)
        assert (fn.launches, fn.launches_tf32) == (n0 + 1, n_tf)
        want = tfd.flash_block_plain(q, ck, cv, 1, 0, start, ks, vs, kn, vn)
        torch.cuda.synchronize()
        assert _rel_err(got, want) <= tol
