"""K2s's split-row mode (the speculative verify's attention with R = hgs *
T <= 8 query rows a (slot, kv head) and hs a multiple of 16): (a) the mode
choice, the padded rows and the int8 byte-permute conversion on the CPU;
(b) an emulation of the mode's arithmetic in plain torch -- the strict
cache rows [0, pos) divided among the splits as the kernel divides them on
the device, each split's (m, l, acc) in f32, the causal fresh block merged
into the split that holds the last cache rows (split 0 alone at pos 0),
the splits merged in order as the last of their blocks merges them --
held against the JAX Pallas ``flash_spec_batched`` in interpret mode and
against the port's ``flash_spec_plain``, within 1e-5 x max|ref| at f32
(only the sum order differs); (c) on a card, the kernel against
``flash_spec_plain`` through ``flash_spec_batched`` and
``make_attn_spec_batched``, at forced split counts, the tiled kernel on
the same inputs, and the launch counts."""
import math

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
GROUPS_T = [(n_kv, hgs, T) for n_kv, hgs in ((4, 1), (2, 2), (1, 4))
            for T in (2, 4, 8) if hgs * T <= 8]


def slot_pos(T):
    """Per-slot positions: an idle slot (no cache row), one row, the end
    and the start of a 16-row chunk, and the last full verify S - T."""
    return [0, 1, 15, 16, S - T]


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


def spec_split_emulate(q, ck, cv, pos, layer, k_scale=None, v_scale=None,
                       k_new=None, v_new=None, k_self=None, v_self=None,
                       nsplit=1, min_chunk=tfd.SPLIT_MIN_CHUNK):
    """The split mode's arithmetic in plain torch, all in f32: slot b's
    rows [0, pos[b]) divided by ``split_bounds``; per split with rows the
    max m of its scores (q.k)/sqrt(hs) * k_scale, l = sum exp(s - m) and
    acc = sum exp(s - m) * v_scale * v; the split holding the last cache
    rows (split 0 when there is none) also merges the fresh block: query
    row g * T + t scores fresh rows j <= t, the diagonal against k_self
    when given, and adds their values (v_self at the diagonal); the splits
    merged in order at their largest max; output acc / l in q's dtype."""
    B, H, T, hs = q.shape
    n_kv, Sc = ck.shape[2], ck.shape[3]
    R = (H // n_kv) * T
    f32 = torch.float32
    scale = 1.0 / math.sqrt(hs)
    t_of = torch.arange(R) % T                       # query row -> t
    out = torch.empty((B, n_kv, R, hs), dtype=f32)
    for b in range(B):
        p = min(max(int(pos[b]), 0), Sc)
        qb = q[b].reshape(n_kv, R, hs).to(f32)
        bounds = [(r0, r1) for r0, r1 in tfd.split_bounds(p, nsplit,
                                                          min_chunk)
                  if r1 > r0] or [(0, 0)]
        parts = []
        for i, (r0, r1) in enumerate(bounds):
            m = torch.full((n_kv, R), tfd.NEG_INF)
            l = torch.zeros((n_kv, R))
            acc = torch.zeros((n_kv, R, hs))
            if r1 > r0:
                s = torch.einsum("krh,ksh->krs", qb,
                                 ck[layer, b, :, r0:r1].to(f32)) * scale
                if k_scale is not None:
                    s = s * k_scale[layer, b, :, r0:r1][:, None, :]
                m = s.amax(-1)
                e = torch.exp(s - m[..., None])
                l = e.sum(-1)
                if v_scale is not None:
                    e = e * v_scale[layer, b, :, r0:r1][:, None, :]
                acc = torch.einsum("krs,ksh->krh", e,
                                   cv[layer, b, :, r0:r1].to(f32))
            if i == len(bounds) - 1:
                kf = k_new[b].to(f32)                     # (n_kv, T, hs)
                s = torch.einsum("krh,kjh->krj", qb, kf) * scale
                if k_self is not None:
                    ke = k_self[b].to(f32)[:, t_of]      # (n_kv, R, hs)
                    d = (qb * ke).sum(-1) * scale
                    s[:, torch.arange(R), t_of] = d
                vis = torch.arange(T)[None, :] <= t_of[:, None]
                s = torch.where(vis, s, torch.full_like(s, tfd.NEG_INF))
                mf = s.amax(-1)
                e = torch.exp(s - mf[..., None]) * vis
                lf = e.sum(-1)
                vf = v_new[b].to(f32)[:, None].expand(n_kv, R, T, hs)
                if v_self is not None:
                    diag = (torch.arange(T)[None, :] == t_of[:, None])
                    vf = torch.where(diag[None, :, :, None],
                                     v_self[b].to(f32)[:, t_of][:, :, None],
                                     vf)
                af = torch.einsum("krj,krjh->krh", e, vf)
                m, l, acc = _merge([(m, l, acc), (mf, lf, af)])
            parts.append((m, l, acc))
        _, lt, at = _merge(parts)
        out[b] = at / lt[..., None]
    return out.reshape(B, H, T, hs).to(q.dtype)


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


def _inputs(seed, B, n_kv, hgs, T, cache_dt):
    """q, caches (int8 with ``quantize_rows`` scales, or bf16/f32), the
    fresh block and, with the int8 cache, the exact diagonal rows (the
    fresh block then their quantize round trip, as the verify feeds it)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, n_kv * hgs, T, HS)).astype(np.float32)
    ck, cv = (rng.standard_normal((L, B, n_kv, S, HS)).astype(np.float32)
              * 2.0 for _ in range(2))
    ke, ve = (rng.standard_normal((B, n_kv, T, HS)).astype(np.float32)
              * 2.0 for _ in range(2))
    ks = vs = None
    if cache_dt == "int8":
        (ck, ks), (cv, vs) = (j_quantize_rows(jnp.asarray(c))
                              for c in (ck, cv))
        ks, vs = ks[..., 0], vs[..., 0]
        (kq, ksc), (vq, vsc) = (j_quantize_rows(jnp.asarray(x))
                                for x in (ke, ve))
        kn = np.asarray(kq, np.float32) * np.asarray(ksc)
        vn = np.asarray(vq, np.float32) * np.asarray(vsc)
        return q, ck, cv, ks, vs, kn, vn, ke, ve
    if cache_dt == "bfloat16":
        ck, cv = ck.astype(ml_dtypes.bfloat16), cv.astype(ml_dtypes.bfloat16)
    return q, ck, cv, ks, vs, ke, ve, None, None


# -- (a) the mode, the padded rows and the int8 conversion, on the CPU -------

@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_dt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hs", [8, 16, 40, 64, 72, 96, 128, 136, 256])
def test_spec_mode_takes_split_exactly(qdt, cache_dt, hs):
    """The split mode exactly for R = hgs * T <= 8 query rows and hs a
    multiple of 16 (up to 256), at every q and cache dtype; R of 9 and 16
    and other head sizes keep the tiled kernel."""
    for R in (1, 2, 3, 4, 8, 9, 16):
        for hgs in (1, 2, 4, 8):
            if R % hgs:
                continue
            n_kv = 8 // hgs
            q = torch.zeros((2, n_kv * hgs, R // hgs, hs),
                            dtype=getattr(torch, qdt))
            ck = torch.zeros((1, 2, n_kv, 8, hs),
                             dtype=getattr(torch, cache_dt))
            want = "split" if R <= 8 and hs % 16 == 0 else "tiled"
            assert tfd.spec_mode(q, ck) == want, (R, hgs)


def test_spec_rows_and_split_count_at_the_verify_shapes():
    """RP, the least of 2, 4, 8 that holds R; the split count at RP rows:
    one split at phase 4c's B=32, S=512 (the 7B verify at widths 2, 4 and
    8); at S=2048 four for B=1, and for B=4 four at RP 4 and 8 (blocks of
    4 warps) and two at RP 2 (blocks of 8)."""
    assert [tfd.spec_rows(R) for R in range(1, 9)] == [2, 2, 4, 4, 8, 8, 8,
                                                        8]
    for T in (2, 4, 8):
        rp = tfd.spec_rows(T)
        assert tfd.split_count(32, 32, 512, rp, True) == 1
        assert tfd.split_count(4, 32, 2048, rp, True) == (2 if T == 2
                                                          else 4)
        assert tfd.split_count(1, 32, 2048, rp, True) == 4
        assert tfd.split_block_warps(32, 32, 1, rp, True) == 4
    assert tfd.split_warps(2, True) == 8 and tfd.split_warps(4, True) == 4


def test_int8_byte_permute_is_exact():
    """The split mode's int8 conversion, mirrored in numpy: x ^ 0x80 put
    in the low byte of 0x4B000000 is the float 2^23 + x + 128, and less
    2^23 + 128 it is x, for every byte."""
    x = np.arange(-128, 128, dtype=np.int8)
    u = (x.view(np.uint8).astype(np.uint32) ^ 0x80) | 0x4B000000
    f = u.view(np.float32) - np.float32(8388736.0)
    assert f.dtype == np.float32
    np.testing.assert_array_equal(f, x.astype(np.float32))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors a split-mode call runs flash_spec_plain and counts no
    launch."""
    q, ck, cv, ks, vs, kn, vn, ke, ve = map(_t, _inputs(3, 2, 2, 2, 2,
                                                        "int8"))
    pos = torch.tensor([5, 63], dtype=torch.int32)
    assert tfd.spec_mode(q, ck) == "split"
    before = (tfd.flash_spec_batched.launches,
              tfd.flash_spec_batched.launches_split)
    args = (q, ck, cv, pos, 1, ks, vs, kn, vn, ke, ve)
    assert torch.equal(tfd.flash_spec_batched(*args),
                       tfd.flash_spec_plain(*args))
    assert (tfd.flash_spec_batched.launches,
            tfd.flash_spec_batched.launches_split) == before


# -- (b) the split, fresh block and merge against JAX, on the CPU ------------

@pytest.mark.parametrize("cache_dt", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("n_kv,hgs,T", GROUPS_T)
def test_spec_split_emulation_vs_pallas(cache_dt, n_kv, hgs, T):
    """Per-slot positions 0, 1, 15, 16 and S - T over a 2-layer cache: the
    emulation at every split count and small least chunk against the
    Pallas flash_spec_batched (interpret mode) and flash_spec_plain; the
    int8 cache with the exact diagonal, bf16 and f32 caches without."""
    pos = np.array(slot_pos(T), np.int32)
    B = len(pos)
    q, ck, cv, ks, vs, kn, vn, ke, ve = _inputs(
        100 * n_kv + 10 * hgs + T, B, n_kv, hgs, T, cache_dt)
    want = jfd.flash_spec_batched(
        _j(q), _j(ck), _j(cv), _j(pos), 1, block_s=16, interpret=True,
        k_scale=_j(ks), v_scale=_j(vs), k_new=_j(kn), v_new=_j(vn),
        k_self=_j(ke), v_self=_j(ve))
    args = tuple(map(_t, (q, ck, cv, pos))) + (1,) + tuple(
        map(_t, (ks, vs, kn, vn, ke, ve)))
    plain = tfd.flash_spec_plain(*args)
    assert _rel(plain, want) <= TOL_EMU
    for nsplit in NSPLITS:
        for mc in MIN_CHUNKS:
            got = spec_split_emulate(*args, nsplit=nsplit, min_chunk=mc)
            assert got.shape == (B, n_kv * hgs, T, HS)
            assert _rel(got, want) <= TOL_EMU, (nsplit, mc)
            assert _rel(got, plain) <= TOL_EMU, (nsplit, mc)


@pytest.mark.parametrize("exact", [False, True])
def test_spec_split_emulation_idle_slots_attend_the_fresh_block(exact):
    """Every slot at pos 0 (idle slots park there): no split holds a cache
    row, split 0 takes the fresh block alone, and query row t is the
    causal softmax over fresh rows 0..t (row 0: exactly its value row)."""
    n_kv, hgs, T = 2, 2, 2
    q, ck, cv, ks, vs, kn, vn, ke, ve = _inputs(7, 3, n_kv, hgs, T, "int8")
    if not exact:
        ke = ve = None
    pos = np.zeros(3, np.int32)
    args = tuple(map(_t, (q, ck, cv, pos))) + (0,) + tuple(
        map(_t, (ks, vs, kn, vn, ke, ve)))
    want = jfd.flash_spec_batched(
        _j(q), _j(ck), _j(cv), _j(pos), 0, block_s=16, interpret=True,
        k_scale=_j(ks), v_scale=_j(vs), k_new=_j(kn), v_new=_j(vn),
        k_self=_j(ke), v_self=_j(ve))
    for nsplit in (1, 8):
        got = spec_split_emulate(*args, nsplit=nsplit, min_chunk=16)
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= TOL_EMU
        v0 = (args[-1] if exact else args[-3])[:, :, 0]   # (B, n_kv, hs)
        first = got.reshape(3, n_kv, hgs, T, HS)[:, :, :, 0]
        torch.testing.assert_close(first, v0[:, :, None].expand_as(first),
                                   rtol=1e-6, atol=1e-6)


# -- (c) the kernel on the card ----------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(dev, seed, Lc, B, n_kv, hgs, T, Sc, hs, qdt, cache_dt):
    """The verify's operands on the card: q, caches (int8 with
    ``quantize_rows`` scales and the exact diagonal, whose quantize round
    trip is the fresh block; or bf16/f32 without it)."""
    from fastllama_tpu_torch.quant.groupquant import (dequantize_rows,
                                                      quantize_rows)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qt = getattr(torch, qdt)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q = rnd(B, n_kv * hgs, T, hs).to(qt)
    ck, cv = rnd(Lc, B, n_kv, Sc, hs), rnd(Lc, B, n_kv, Sc, hs)
    ke, ve = rnd(B, n_kv, T, hs).to(qt), rnd(B, n_kv, T, hs).to(qt)
    if cache_dt == "int8":
        (ck, ks), (cv, vs) = quantize_rows(ck), quantize_rows(cv)
        kn = dequantize_rows(*quantize_rows(ke), qt)
        vn = dequantize_rows(*quantize_rows(ve), qt)
        return (q, ck, cv, ks[..., 0].contiguous(), vs[..., 0].contiguous(),
                kn, vn, ke, ve)
    ct = getattr(torch, cache_dt)
    return q, ck.to(ct), cv.to(ct), None, None, ke, ve, None, None


def _positions(dev, B, Sc, T, seed):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, Sc - T + 1, B)
    pos[:min(B, 4)] = [0, 1, 107, Sc - T][:min(B, 4)]
    return torch.tensor(pos, dtype=torch.int32, device=dev)


def _check_call(fn, args, want, tol, split=True):
    n0 = tfd.flash_spec_batched.launches
    s0 = tfd.flash_spec_batched.launches_split
    got = fn(*args)
    assert tfd.flash_spec_batched.launches == n0 + 1
    assert tfd.flash_spec_batched.launches_split == s0 + (1 if split else 0)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    err = _rel(got, want)
    assert err <= tol, err


@pytest.mark.gpu
@pytest.mark.parametrize("qdt,cache_dt", [("bfloat16", "int8"),
                                          ("float32", "int8"),
                                          ("bfloat16", "bfloat16"),
                                          ("float32", "float32")])
@pytest.mark.parametrize("hs", [64, 128, 256])
@pytest.mark.parametrize("B,Sc", [(32, 512), (4, 2048), (1, 2048)])
def test_spec_split_kernel_vs_plain_on_card(cuda, qdt, cache_dt, hs, B,
                                            Sc):
    """The split mode against flash_spec_plain within TOL_F32 (f32 q) or
    TOL_BF16 (bf16 q) through flash_spec_batched, at (hgs, T) with R in
    {1, 2, 4, 6, 8} and per-slot positions 0, 1, 107 and S - T; every call
    one launch on ``launches`` and ``launches_split``.  The same inputs at
    2, 3, 8 and 16 splits of at least 16 rows (several merge) and in the
    tiled kernel agree too."""
    tol = TOL_F32 if qdt == "float32" else TOL_BF16
    for hgs, T in ((1, 1), (1, 2), (1, 4), (1, 8), (2, 2), (2, 3), (4, 2),
                   (8, 1)):
        n_kv = 32 // hgs if B > 1 else 8
        ops = _card_inputs(cuda, hs + B + 10 * T + hgs, 2, B, n_kv, hgs, T,
                           Sc, hs, qdt, cache_dt)
        q, ck, cv, ks, vs, kn, vn, ke, ve = ops
        pos = _positions(cuda, B, Sc, T, hs + T)
        assert tfd.spec_mode(q, ck) == "split"
        args = (q, ck, cv, pos, 1, ks, vs, kn, vn, ke, ve)
        want = tfd.flash_spec_plain(*args)
        _check_call(tfd.flash_spec_batched, args, want, tol)
        for nsplit in (2, 3, 8, 16):
            got = tfd._spec_split_launch(*args, nsplit, 16)
            torch.cuda.synchronize()
            assert _rel(got, want) <= tol, nsplit
        assert _rel(tfd._spec_launch(*args), want) <= tol


@pytest.mark.gpu
def test_spec_split_through_make_attn_on_card(cuda):
    """``make_attn_spec_batched`` on the 7B verify's operands (B=32, 32
    heads of 128, width 4, bf16, int8 cache with the exact diagonal, the
    rope'd K and V transposed as ``spec_decode_step`` passes them) takes
    the split mode and agrees with the plain version."""
    from fastllama_tpu_torch.models.batched import BatchedKVCache
    q, ck, cv, ks, vs, kn, vn, ke, ve = _card_inputs(
        cuda, 5, 2, 32, 32, 1, 4, 512, 128, "bfloat16", "int8")
    cache = BatchedKVCache(ck, cv, ks, vs)
    pos = _positions(cuda, 32, 512, 4, 5)
    attn = tfd.make_attn_spec_batched()
    args = (q.transpose(1, 2).contiguous().transpose(1, 2), cache, pos, 1,
            kn, vn)
    want = tfd.flash_spec_plain(q, ck, cv, pos, 1, ks, vs, kn, vn, ke, ve)
    n0 = tfd.flash_spec_batched.launches_split
    got = attn(*args, k_self=ke.transpose(2, 3).contiguous().transpose(2, 3),
               v_self=ve)
    torch.cuda.synchronize()
    assert tfd.flash_spec_batched.launches_split == n0 + 1
    assert _rel(got, want) <= TOL_BF16


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dt", ["int8", "bfloat16"])
def test_other_shapes_keep_the_tiled_kernel_on_card(cuda, cache_dt):
    """R > 8 (hgs 4 at T 4) and hs off the multiple of 16 take the tiled
    kernel (``launches`` advances, ``launches_split`` does not), against
    flash_spec_plain."""
    for hgs, T, hs in ((4, 4, 64), (1, 4, 40), (2, 8, 128)):
        ops = _card_inputs(cuda, hs + T, 2, 3, 2, hgs, T, 256, hs,
                           "bfloat16", cache_dt)
        pos = _positions(cuda, 3, 256, T, hs)
        args = (ops[0], ops[1], ops[2], pos, 1) + ops[3:]
        assert tfd.spec_mode(ops[0], ops[1]) == "tiled"
        _check_call(tfd.flash_spec_batched, args,
                    tfd.flash_spec_plain(*args), TOL_BF16, split=False)
