"""K1 at a group size that is a multiple of 32 and not of 64 (GGUF
``Q8_0``'s 32; at 96 a group ends halfway through a 64-row stage): the
G32 instantiations of the ring (``qmm_pipe_g32_kernel``,
``qmm_pipe_wide_g32_kernel``) and of the prefill mode
(``qmm_wgmma_g32_kernel``, ``qmm_wgmma_wide_g32_kernel``), in which each
32-row half of a stage reads the scale row of its own group.

On the CPU: torch emulations of the two arithmetics held against the JAX
package's Pallas kernels in interpret mode at gs 32 and 96 (the standard
one, a half's weights ``bf16(bf16(w) * bf16(s_half))`` and f32 sums, at
1e-2 of max|ref| like ``tests/test_torch_qmm_prefill.py``'s emulations;
the wide one, each half's exact-integer partial times its f32 scale, at
1e-5 of max|ref| like ``tests/test_torch_int16_planes.py``); the routing
table at gs 16, 32, 64, 80 and 96; the second scale row's place in a ring
slot (the W rows' pads) and the prefill plans at gs 32 within an H100
block's 227 KB with gs 64's stages.

On the card (``gpu``): each G32 instantiation against ``qmm_fused_plain``
at the 7B projections (1e-4 of max|ref| for f32 outputs, 1e-2 for bf16),
one launch a call on the mode's count."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fastllama_tpu.ops.pallas.qmm import (make_mm_indexed as j_make_mm_idx,
                                          qmatmul_pallas as j_qmm,
                                          qmatmul_pallas_indexed as j_qmm_idx)
from fastllama_tpu_torch.ops.kernels import qmm as tqmm
from tests.test_torch_qmm import _weights
from tests.test_torch_wide_pipe import split_planes


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast when the suite's
    workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32, BF16 = torch.float32, torch.bfloat16
TOL_STD = 1e-2             # x max|ref|: bf16 outputs, another sum order
TOL_WIDE = 1e-5            # x max|ref|: the wide emulation against Pallas
I_OF = {32: 256, 96: 384}  # I a multiple of gs and of a 64-row stage


def _close(got: torch.Tensor, want, tol: float):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _x(rng, T, I, xdt):
    """(numpy f32 values, torch x): bf16 x's values are bf16-rounded, so
    that the reference multiplies the same numbers."""
    x = rng.standard_normal((T, I)).astype(np.float32)
    if xdt == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        return x, torch.tensor(x).to(BF16)
    return x, torch.tensor(x)


def _norm(x: torch.Tensor, norm_gain, eps: float) -> torch.Tensor:
    """K1f's prologue, as ``qmm_fused_plain``: one rounding to x's dtype."""
    if norm_gain is None:
        return x
    xf = x.to(F32)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * r * norm_gain.to(F32)).to(x.dtype)


def _halves(I: int, splits: int):
    """Each split's 32-row halves of its 64-row stages, in order."""
    _, kps = tqmm._explicit_split(I, 64, splits)
    return [[h for k0 in range(kbeg, min(I, kbeg + kps), 64)
             for h in (k0, k0 + 32) if h < I]
            for kbeg in range(0, I, kps)]


def g32_emulated(x: torch.Tensor, w, norm_gain=None, eps: float = 1e-5,
                 residual=None, splits: int = 1) -> torch.Tensor:
    """The G32 standard arithmetic (``qmm_pipe_g32_kernel``,
    ``qmm_wgmma_g32_kernel``) on the CPU: the K1f prologue; x rounded to
    bf16; each 32-row half of a stage dequantized with its own group's
    scale, ``bf16(bf16(w) * bf16(s_half))`` (the product of two bf16
    values is exact in f32, so this is one rounding); each split's f32 sum
    over its halves in order; the residual, then the splits, summed in
    order; x's dtype out."""
    x = _norm(x, norm_gain, eps)
    xb = x.to(BF16).to(F32)
    wd = w.data.to(F32)
    sb = w.scales.to(BF16).to(F32)
    out = (torch.zeros((x.shape[0], w.data.shape[1]), dtype=F32)
           if residual is None else residual.to(F32))
    for halves in _halves(x.shape[1], splits):
        acc = torch.zeros_like(out)
        for h in halves:
            wh = (wd[h:h + 32] * sb[h // w.group_size]).to(BF16).to(F32)
            acc = acc + xb[:, h:h + 32] @ wh
        out = out + acc
    return out.to(x.dtype)


def g32_wide_emulated(x: torch.Tensor, w, norm_gain=None, eps: float = 1e-5,
                      residual=None, splits: int = 1,
                      out_dtype=None) -> torch.Tensor:
    """The G32 wide arithmetic (``qmm_pipe_wide_g32_kernel``,
    ``qmm_wgmma_wide_g32_kernel``) on the CPU: the K1f prologue; x's bf16
    planes (three for f32 x, one for bf16); the exact integers (INT16:
    its lo and 256 hi planes); each 32-row half's k16 steps, every x
    plane (lo, mid, hi) times every weight plane, into one f32 partial,
    scaled into the split's accumulator by the half's group scale (an exact
    f32 value); the residual, then the splits, summed in order;
    ``out_dtype`` (default x's) out."""
    x = _norm(x, norm_gain, eps)
    planes = split_planes(x)[::-1]
    if w.data.dtype == torch.int16:
        hi, lo = tqmm.int16_planes(w.data)
        wplanes = (lo.to(F32), 256 * hi.to(F32))
    else:
        wplanes = (w.data.to(F32),)
    sc = w.scales.to(F32)
    out = (torch.zeros((x.shape[0], w.data.shape[1]), dtype=F32)
           if residual is None else residual.to(F32))
    for halves in _halves(x.shape[1], splits):
        acc = torch.zeros_like(out)
        for h in halves:
            part = torch.zeros_like(out)
            for k in (h, h + 16):
                for p in planes:
                    for wp in wplanes:
                        part = part + p[:, k:k + 16] @ wp[k:k + 16]
            acc = acc + part * sc[h // w.group_size]
        out = out + acc
    return out.to(out_dtype or x.dtype)


# -- the standard arithmetic -------------------------------------------------

@pytest.mark.parametrize("gs,T,sdt", [(32, 48, "float32"),
                                      (32, 160, "bfloat16"),
                                      (96, 48, "bfloat16"),
                                      (96, 160, "float32")])
def test_standard_emulation_vs_pallas(gs, T, sdt):
    """INT8 at bf16 compute on bf16 x: the emulation at one and two splits
    and the wrapper's plain twin against ``qmatmul_pallas`` in interpret
    mode; the call takes the ring (T <= 128) or the prefill mode, on the
    G32 instantiation."""
    I = I_OF[gs]
    rng = np.random.default_rng(gs + T + len(sdt))
    scale_dt = np.float32 if sdt == "float32" else ml_dtypes.bfloat16
    jw, tw = _weights(rng, (I, 256), "INT8", gs=gs, scale_dtype=scale_dt)
    x, tx = _x(rng, T, I, "bfloat16")
    assert tqmm._kernel(tx, tw, BF16, False, None) == (
        "pipe" if T <= 128 else "prefill") and tqmm.g32(tw)
    want = j_qmm(jnp.asarray(x).astype(jnp.bfloat16), jw, jnp.bfloat16,
                 interpret=True)
    for splits in (1, 2):
        _close(g32_emulated(tx, tw, splits=splits), want, TOL_STD)
    _close(tqmm.qmatmul_pallas(tx, tw), want, TOL_STD)


@pytest.mark.parametrize("gs", [32, 96])
@pytest.mark.parametrize("glue", ["none", "norm", "res", "both"])
def test_standard_indexed_glue_vs_pallas(gs, glue):
    """Layer 1 of a stacked INT8 weight through ``qmatmul_pallas_indexed``
    (bare, or K1f's glue: the norm, the residual, both; bf16 scales, as the
    single stream holds them) against the JAX indexed form in interpret
    mode, the emulation at one and two splits."""
    I, T = I_OF[gs], 40
    rng = np.random.default_rng(gs + len(glue))
    jw, tw = _weights(rng, (2, I, 256), "INT8", gs=gs,
                      scale_dtype=ml_dtypes.bfloat16)
    x, tx = _x(rng, T, I, "bfloat16")
    g = (rng.standard_normal(I) * 0.1 + 1.0).astype(np.float32)
    r = rng.standard_normal((T, 256)).astype(np.float32)
    norm, res = glue in ("norm", "both"), glue in ("res", "both")
    want = j_qmm_idx(
        jnp.asarray(x).astype(jnp.bfloat16), jw, 1, jnp.bfloat16,
        interpret=True, norm_gain=jnp.asarray(g) if norm else None,
        eps=1e-5, residual=jnp.asarray(r).astype(jnp.bfloat16) if res
        else None)
    tkw = dict(norm_gain=torch.tensor(g) if norm else None, eps=1e-5,
               residual=torch.tensor(r).to(BF16) if res else None)
    assert tqmm._kernel(tx, tw[1], BF16, False, tkw["residual"]) == "pipe"
    for splits in (1, 2):
        _close(g32_emulated(tx, tw[1], splits=splits, **tkw), want, TOL_STD)
    _close(tqmm.qmatmul_pallas_indexed(tx, tw, 1, **tkw), want, TOL_STD)


# -- the wide arithmetic -----------------------------------------------------

@pytest.mark.parametrize("gs", [32, 96])
@pytest.mark.parametrize("qname,xdt,cdt,T", [
    ("INT8", "float32", "float32", 48), ("INT8", "bfloat16", "float32", 160),
    ("INT16", "float32", "float32", 160),
    ("INT16", "bfloat16", "bfloat16", 48)])
def test_wide_emulation_vs_pallas(gs, qname, xdt, cdt, T):
    """The wide mode (an int8-held weight at f32 compute, INT16 at any):
    the emulation at one and two splits against the Pallas wide kernel in
    interpret mode at f32 compute on the same values, at 1e-5 of max|ref|;
    one exact-integer partial a half is what holds it there."""
    I = I_OF[gs]
    rng = np.random.default_rng(gs + T + len(qname + xdt + cdt))
    jw, tw = _weights(rng, (I, 256), qname, gs=gs)
    x, tx = _x(rng, T, I, xdt)
    assert tqmm._kernel(tx, tw, getattr(torch, cdt), False, None) == (
        "wide_pipe" if T <= 128 else "wide_prefill")
    want = j_qmm(jnp.asarray(x), jw, jnp.float32, interpret=True)
    for splits in (1, 2):
        _close(g32_wide_emulated(tx, tw, splits=splits, out_dtype=F32), want,
               TOL_WIDE)
    _close(tqmm.qmm_fused_plain(tx.float(), tw, F32), want, TOL_WIDE)


@pytest.mark.parametrize("gs", [32, 96])
@pytest.mark.parametrize("qname,cdt", [("INT8", "float32"),
                                       ("INT16", "bfloat16")])
def test_wide_glue_vs_forward_mm(gs, qname, cdt):
    """K1f's glue (the norm and the residual) on layer 1 of a stacked
    weight at the wide mode, f32 x, against the JAX ``make_mm_indexed``
    that ``forward`` calls, at 1e-5 of max|ref|, at one split and at two;
    the port's wrapper the same."""
    I, T = I_OF[gs], 24
    rng = np.random.default_rng(gs + len(qname))
    jw, tw = _weights(rng, (2, I, 256), qname, gs=gs)
    x = rng.standard_normal((T, I)).astype(np.float32)
    g = (rng.standard_normal(I) * 0.1 + 1.0).astype(np.float32)
    r = rng.standard_normal((T, 256)).astype(np.float32)
    want = j_make_mm_idx(getattr(jnp, cdt), interpret=True)(
        jnp.asarray(x), jw, 1, norm_gain=jnp.asarray(g), eps=1e-5,
        residual=jnp.asarray(r))
    tkw = dict(norm_gain=torch.tensor(g), eps=1e-5, residual=torch.tensor(r))
    tx, td = torch.tensor(x), getattr(torch, cdt)
    assert tqmm._kernel(tx, tw[1], td, False, tkw["residual"]) == "wide_pipe"
    for splits in (1, 2):
        _close(g32_wide_emulated(tx, tw[1], splits=splits, **tkw), want,
               TOL_WIDE)
    _close(tqmm.qmatmul_pallas_indexed(tx, tw, 1, td, **tkw), want, TOL_WIDE)


def test_one_scale_a_stage_misses_at_96():
    """At gs 96 a group ends halfway through a stage: scaling a whole stage
    by its first row's scale (gs 64's rule) misses the Pallas reference by
    far more than 1e-5 of max|ref|, a scale a half does not."""
    rng = np.random.default_rng(96)
    jw, tw = _weights(rng, (384, 256), "INT8", gs=96)
    x, tx = _x(rng, 16, 384, "float32")
    want = np.asarray(j_qmm(jnp.asarray(x), jw, jnp.float32, interpret=True))
    rows = torch.arange(384) // 64 * 64 // 96       # a stage's first group
    whole = (tx @ (tw.data.to(F32) * tw.scales[rows])).numpy()
    assert np.abs(whole - want).max() > 1e3 * TOL_WIDE * np.abs(want).max()
    half = g32_wide_emulated(tx, tw).numpy()
    assert np.abs(half - want).max() <= TOL_WIDE * np.abs(want).max()


# -- which kernel a call takes -----------------------------------------------

def _expected(kind: str, gs: int, T: int) -> str:
    """The ring up to 128 rows, the prefill mode above: the standard and
    the wide kernels at gs % 32 == 0 on an unpacked weight, the packed
    weight and the groupdot ring at gs % 64 == 0; else the loop
    (``qmm_f32_kernel`` for a wide call)."""
    big = T > tqmm.PIPE_MAX_T
    if kind == "int8":
        return ("prefill" if big else "pipe") if gs % 32 == 0 else "loop"
    if kind == "int4p":
        return ("prefill" if big else "pipe") if gs % 64 == 0 else "loop"
    if kind == "groupdot":
        return "pipe" if gs % 64 == 0 and not big else "loop"
    return ("wide_prefill" if big else "wide_pipe") if gs % 32 == 0 \
        else "wide"


@pytest.mark.parametrize("gs", [16, 32, 64, 80, 96])
@pytest.mark.parametrize("kind", ["int8", "int4p", "groupdot", "wide",
                                  "int16"])
@pytest.mark.parametrize("T", [1, 48, 128, 129, 2048])
def test_routing_table(gs, kind, T):
    """``qmm._kernel`` at I = 1920 (a multiple of every gs here and of 128)
    from dtypes, shapes and alignment; :func:`g32` says which instantiation
    a ring or prefill call runs: the G32 one on an unpacked weight off gs %
    64."""
    qname = {"int4p": "INT4", "int16": "INT16"}.get(kind, "INT8")
    _, w = _weights(np.random.default_rng(gs + T), (1920, 256), qname,
                    gs=gs)
    if kind == "int4p":
        from fastllama_tpu_torch.quant.groupquant import pack_int4_rows, \
            QArray
        w = QArray(pack_int4_rows(w.data), w.scales, w.qtype, gs,
                   group_axis=-2, packed=True)
    cdt = F32 if kind == "wide" else BF16
    x = torch.zeros((T, 1920), dtype=BF16)
    want = _expected(kind, gs, T)
    assert tqmm._kernel(x, w, cdt, kind == "groupdot", None) == want
    assert tqmm.g32(w) == (kind not in ("int4p",) and gs % 64 != 0)
    if want == "prefill":
        assert tqmm.prefill_kernel(x, w, cdt) == "prefill"
    if kind in ("wide", "int16"):
        assert tqmm.wide_kernel(x, w, cdt) == {
            "wide_pipe": "pipe", "wide_prefill": "prefill"}.get(want, "f32")


def test_prefill_needs_whole_stages():
    """At gs 32 an I off a multiple of 64 (288) leaves the prefill kernels,
    whose stages are 64 rows: the loop and ``qmm_f32_kernel`` above 128
    rows; the ring, which zero-fills a stage's tail, up to 128."""
    _, w = _weights(np.random.default_rng(1), (288, 256), "INT8", gs=32)
    for T, std, wide in ((48, "pipe", "wide_pipe"), (160, "loop", "wide")):
        x = torch.zeros((T, 288), dtype=BF16)
        assert tqmm._kernel(x, w, BF16, False, None) == std
        assert tqmm._kernel(x, w, F32, False, None) == wide


# -- the plans ---------------------------------------------------------------

PROJ_7B = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
           "w2": (11008, 4096), "classifier": (4096, 32000)}


def proj_at(name: str, gs: int):
    """A 7B projection's (I, O) at group size ``gs``: at 96, which divides
    neither 4096 nor 11008, I cut to a multiple of 192 (4032, 10944) so
    that it holds whole groups and whole 64-row stages."""
    I, O = PROJ_7B[name]
    return (I - I % 192 if gs == 96 else I), O


@pytest.mark.parametrize("w_bytes", [1, 2])
@pytest.mark.parametrize("ssz", [4, 2])
def test_second_scale_row_sits_in_the_w_pads(ssz, w_bytes):
    """A G32 ring stage's second scale row lies in the 16-byte pads that
    end its W rows (``g32_pad_offset``): each 16-byte chunk in its own pad,
    past every W byte and inside the slot's 64 W rows, so the slot, the
    ring and the blocks an SM are gs 64's (``pipe_smem`` is one for
    both)."""
    row = w_bytes * tqmm.PIPE_COLS + 16
    used = set()
    for c in range(tqmm.PIPE_COLS):
        off = tqmm.g32_pad_offset(c, ssz, w_bytes)
        r, b = divmod(off, row)
        assert r < 64 and w_bytes * tqmm.PIPE_COLS <= b \
            and b + ssz <= row, c
        assert off not in used
        used.add(off)
    # a lane's scales read 16 bytes at most from one pad: 4 f32 or 8 bf16
    for c in range(0, tqmm.PIPE_COLS, 16 // ssz):
        ends = {tqmm.g32_pad_offset(c + j, ssz, w_bytes) // row
                for j in range(16 // ssz)}
        assert len(ends) == 1


@pytest.mark.parametrize("T", [129, 256, 2048])
@pytest.mark.parametrize("ssz", [4, 2])
def test_prefill_plan_at_gs32(T, ssz):
    """The G32 prefill kernel's plan at every 7B projection: the second
    scale row takes the slot that K1p's second plane takes, so the stages,
    ring and grid are gs 64's and the TMA bytes a stage one scale row
    more."""
    for name, (I, O) in PROJ_7B.items():
        p64 = tqmm.prefill_plan(T, I, O, False, ssz)
        p32 = tqmm.prefill_plan(T, I, O, False, ssz, g32=True)
        assert p64.smem + p64.static_smem <= tqmm.PREFILL_SMEM_BLOCK
        assert (p32.stages, p32.stage_bytes, p32.smem, p32.grid) == (
            p64.stages, p64.stage_bytes, p64.smem, p64.grid), name
        assert p32.tx_bytes == p64.tx_bytes + 128 * ssz
        assert (p64.stages, p64.smem) == (5, 5 * (8192 + 2 * 16384 + 2048)
                                          + 1024)


@pytest.mark.parametrize("x_f32,w_bytes,stages", [(True, 1, 3), (True, 2, 3),
                                                  (False, 1, 8),
                                                  (False, 2, 6)])
@pytest.mark.parametrize("ssz", [4, 2])
def test_wide_prefill_plan_at_gs32(x_f32, w_bytes, stages, ssz):
    """The G32 wide prefill kernel's plan: a second 1 KB scale slot a
    stage, within a block's 227 KB at gs 64's stages (3 on f32 x, 8 on
    bf16 x at int8, 6 at int16) and one block an SM; gs 64's plan as
    before (one slot)."""
    T = 2048
    for name, (I, O) in PROJ_7B.items():
        p64 = tqmm.wide_prefill_plan(T, I, O, x_f32, ssz, w_bytes=w_bytes)
        p32 = tqmm.wide_prefill_plan(T, I, O, x_f32, ssz, w_bytes=w_bytes,
                                     g32=True)
        planes = 3 if x_f32 else 1
        boxes = w_bytes * 128 * 64 + 2 * planes * 128 * 32 * 2
        assert p64.stage_bytes == boxes + 1024
        assert p32.stage_bytes == boxes + 2048
        assert p32.stages == p64.stages == stages, name
        assert p32.smem + p32.static_smem <= tqmm.PREFILL_SMEM_BLOCK
        assert 2 * (p32.smem + 1024) > 233472        # one block an SM
        assert p32.tx_bytes == p64.tx_bytes + 128 * ssz
        assert p32.grid == p64.grid


def test_cpu_calls_count_nothing():
    """A CPU tensor at gs 32 runs the plain twin and moves no count."""
    _, w = _weights(np.random.default_rng(5), (2, 256, 256), "INT8", gs=32)
    fns = (tqmm.qmatmul_pallas, tqmm.qmatmul_pallas_indexed,
           tqmm.qmatmul_pallas_indexed_fused)
    keys = ("launches", "launches_pipe", "launches_prefill",
            "launches_wide_pipe", "launches_wide_prefill")
    before = [[getattr(f, k) for k in keys] for f in fns]
    for T, cdt in ((4, BF16), (200, BF16), (4, F32), (200, F32)):
        x = torch.randn(T, 256).to(BF16)
        assert torch.equal(tqmm.qmatmul_pallas(x, w[0], cdt),
                           tqmm.qmm_plain(x, w[0], cdt))
        tqmm.qmatmul_pallas_indexed(x, w, 1, cdt,
                                    residual=torch.randn(T, 256).to(BF16))
    assert before == [[getattr(f, k) for k in keys] for f in fns]


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_weight(gen, shape, qname, sdt, dev, gs):
    """A random INT8 or INT16 weight on the card, ``gs`` rows a group,
    random positive scales."""
    from fastllama_tpu_torch.config import QuantType
    from fastllama_tpu_torch.quant.groupquant import QArray
    qt = QuantType[qname]
    d = torch.empty(shape, dtype=torch.int16 if qname == "INT16"
                    else torch.int8, device=dev)
    d.random_(-qt.factor, qt.factor + 1, generator=gen)
    s = (torch.rand((*shape[:-2], shape[-2] // gs, shape[-1]), generator=gen,
                    device=dev) + 0.5) * (0.02 / qt.factor)
    return QArray(d, s.to(sdt), qt, gs, group_axis=-2)


GLUES = ({}, {"norm": True}, {"res": True}, {"norm": True, "res": True})


def _run_glues(w, x, cdt, attr, tol, cuda, gen):
    """Each glue on layer 1 of ``w``: one launch on ``attr`` of the called
    wrapper, and within ``tol`` x max|plain| of ``qmm_fused_plain``."""
    I, O = w.data.shape[1:]
    for glue in GLUES:
        kw = {}
        if glue.get("norm"):
            kw["norm_gain"] = torch.rand((I,), generator=gen,
                                         device=cuda) + 0.5
        if glue.get("res"):
            kw["residual"] = torch.randn((x.shape[0], O), generator=gen,
                                         device=cuda).to(x.dtype)
        f = (tqmm.qmatmul_pallas_indexed_fused if kw
             else tqmm.qmatmul_pallas_indexed)
        n0 = getattr(f, attr)
        got = f(x, w, 1, cdt, **kw)
        assert getattr(f, attr) == n0 + 1, (attr, glue)
        want = tqmm.qmm_fused_plain(x, w[1], cdt, **kw).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        assert err <= tol * want.abs().max().item(), (glue, err)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["wqkv", "wo", "w13", "w2"])
@pytest.mark.parametrize("T", [1, 48, 128, 129, 2048])
@pytest.mark.parametrize("gs,sdt", [(32, "float32"), (32, "bfloat16"),
                                    (96, "bfloat16")])
def test_g32_standard_on_card(cuda, name, T, gs, sdt):
    """INT8 at bf16 compute, bf16 x: the ring's G32 instantiation (T <=
    128, ``launches_pipe``) and the prefill mode's (``launches_prefill``)
    at a 7B projection (:func:`proj_at`), bare and with K1f's glue."""
    I, O = proj_at(name, gs)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(T + I + gs)
    w = _card_weight(gen, (2, I, O), "INT8", getattr(torch, sdt), cuda, gs)
    x = torch.randn((T, I), generator=gen, device=cuda).to(BF16)
    kernel = "pipe" if T <= 128 else "prefill"
    assert tqmm._kernel(x, w[1], BF16, False, None) == kernel
    _run_glues(w, x, BF16, f"launches_{kernel}", 1e-2, cuda, gen)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["wqkv", "w2"])
@pytest.mark.parametrize("T", [1, 48, 128, 129, 2048])
@pytest.mark.parametrize("qname,xdt,cdt,gs", [
    ("INT8", "float32", "float32", 32), ("INT8", "bfloat16", "float32", 32),
    ("INT8", "float32", "float32", 96), ("INT16", "bfloat16", "bfloat16", 32),
    ("INT16", "float32", "float32", 32)])
def test_g32_wide_on_card(cuda, name, T, qname, xdt, cdt, gs):
    """The wide mode (int8-held at f32 compute, INT16): the wide ring's
    G32 instantiation (``launches_wide_pipe``) and the wide prefill
    kernel's (``launches_wide_prefill``) at wqkv's and w2's shapes, bare
    and with the glue, f32 scales; 1e-4 of max|plain| on f32 x, 1e-2 on
    bf16."""
    I, O = proj_at(name, gs)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(T + I + gs + len(qname))
    w = _card_weight(gen, (2, I, O), qname, F32, cuda, gs)
    xd, cd = getattr(torch, xdt), getattr(torch, cdt)
    x = torch.randn((T, I), generator=gen, device=cuda).to(xd)
    kernel = "wide_pipe" if T <= 128 else "wide_prefill"
    assert tqmm._kernel(x, w[1], cd, False, None) == kernel
    _run_glues(w, x, cd, f"launches_{kernel}", 1e-4 if xdt == "float32"
               else 1e-2, cuda, gen)


@pytest.mark.gpu
def test_g32_splits_on_card(cuda):
    """The G32 ring and prefill kernels at forced split counts (a split
    ends on a stage, so on a half): within 1e-2 of the plain version."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    w = _card_weight(gen, (4096, 4096), "INT8", F32, cuda, 32)
    for T in (16, 48, 300):
        x = torch.randn((T, 4096), generator=gen, device=cuda).to(BF16)
        want = tqmm.qmm_plain(x, w).float()
        for splits in (1, 3, 8):
            got = tqmm._launch(x, w, BF16, splits=splits).float()
            torch.cuda.synchronize()
            assert (got - want).abs().max().item() <= \
                1e-2 * want.abs().max().item(), (T, splits)
