"""The port's mesh layout (``parallel/sharding.py``, ``distributed.py``,
``spmd_step._check_dims``) without a process group: ``make_mesh``'s specs
and errors against the JAX ``make_mesh``; every leaf of ``shard_params``
at every rank coordinate of model=2, model=4, data=2,model=2, GQA
over-sharding (model=8 over 4 kv heads) and scales too small to split
(model=4 at group size 64) bit-equal to the JAX shard on the same
coordinate of the virtual CPU mesh, and contiguous; the caches' local
shapes against the JAX shardings' shard shapes; ``_check_dims``'s errors
against JAX's; a packed INT4 shard's values; ``distributed.initialize``'s
no-op and its refusals."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.models import llama as jl
from fastllama_tpu.parallel import sharding as js
from fastllama_tpu.parallel import spmd_step as jspmd
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.parallel import distributed
from fastllama_tpu_torch.parallel import sharding as ts
from fastllama_tpu_torch.parallel import spmd_step as tspmd
from fastllama_tpu_torch.quant.groupquant import (QArray, pack_int4_rows,
                                                  unpack_int4_rows)

CFG = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
           vocab_size=256, max_seq_len=32, group_size=16)


def _models(**over):
    kw = dict(CFG, **over)
    jc = jcfg.ModelConfig(**kw, quant_type=jcfg.QuantType.INT8)
    jp = jl.random_params(jc, seed=3, qtype=jcfg.QuantType.INT8)
    arrays, flags = {}, {}
    for f in dataclasses.fields(jp):
        v = getattr(jp, f.name)
        if hasattr(v, "scales"):
            arrays[f.name] = (np.asarray(v.data), np.asarray(v.scales))
            flags[f.name] = dict(qtype=v.qtype.name, group_size=v.group_size,
                                 group_axis=v.group_axis, packed=v.packed)
        else:
            arrays[f.name] = np.asarray(v)
    tc = tcfg.ModelConfig(**kw, quant_type=tcfg.QuantType.INT8)
    return jc, jp, tc, tl.params_from_numpy(tc, arrays, flags, device="cpu")


def _world(spec):
    shape = ts.parse_mesh_spec(spec)
    return shape["data"] * shape["model"]


def _jax_shard(arr, mesh, d, m):
    dev = mesh.devices[d, m]
    for sh in arr.addressable_shards:
        if sh.device == dev:
            return np.asarray(sh.data)
    raise AssertionError("no shard on the device")


@pytest.mark.parametrize("spec,over", [
    ("model=2", {}), ("model=4", {}), ("data=2,model=2", {}),
    ("model=8", {}), ("model=4", dict(group_size=64))])
def test_shard_params_bit_equal_to_jax(spec, over):
    jc, jp, tc, tp = _models(**over)
    n = _world(spec)
    jmesh = js.make_mesh(spec, jax.devices()[:n])
    jsp = js.shard_params(jc, jmesh, jp)
    mp = jmesh.shape["model"]
    for rank in range(n):
        mesh = ts.make_mesh(spec, world_size=n, rank=rank)
        d, m = mesh.index("data"), mesh.index("model")
        assert (d, m) == divmod(rank, mp)
        tsp = ts.shard_params(tc, mesh, tp, "cpu")
        for f in dataclasses.fields(jsp):
            jv, tv = getattr(jsp, f.name), getattr(tsp, f.name)
            pairs = ([(jv.data, tv.data), (jv.scales, tv.scales)]
                     if hasattr(jv, "scales") else [(jv, tv)])
            for ja, ta in pairs:
                assert ta.is_contiguous() and ta.device.type == "cpu"
                np.testing.assert_array_equal(ta.numpy(),
                                              _jax_shard(ja, jmesh, d, m),
                                              err_msg=f"{spec} {f.name}")
                # its own storage: the whole leaf can go
                assert ta.untyped_storage().nbytes() == \
                    ta.numel() * ta.element_size()


def _raw_weights(tc, seed=5):
    """fp32 leaves in the checkpoint layout (projections (L, out, in))."""
    rng = np.random.default_rng(seed)
    L, D, H, V = tc.n_layers, tc.dim, tc.hidden_dim, tc.vocab_size
    q, kv = tc.n_heads * tc.head_size, tc.kv_dim
    shapes = dict(embedding=(V, D), attn_norm=(L, D), wq=(L, q, D),
                  wk=(L, kv, D), wv=(L, kv, D), wo=(L, D, q),
                  ffn_norm=(L, D), w1=(L, H, D), w2=(L, D, H), w3=(L, H, D),
                  out_norm=(D,), classifier=(V, D))
    return {k: (rng.standard_normal(sh) * 0.05).astype(np.float32)
            for k, sh in shapes.items()}


@pytest.mark.parametrize("spec,qtype,prequant", [
    ("model=2", "INT8", False), ("model=4", "INT4", False),
    ("data=2,model=2", "INT16", False), ("model=8", "INT8", False),
    ("model=2", "NONE", False), ("model=2", "INT8", True)])
def test_shard_raw_builds_the_shard_params_leaves(spec, qtype, prequant):
    """A rank that slices the loader's leaves (``shard_raw``) and builds
    them gets :func:`shard_params`' shard of the whole build, bit for bit
    (quantized, and nibble-packed at INT4, on its block alone)."""
    from fastllama_tpu_torch.quant.groupquant import quantize
    qt = tcfg.QuantType[qtype]
    tc = tcfg.ModelConfig(**CFG, quant_type=qt)
    raw = _raw_weights(tc)
    if prequant:
        for k in ("embedding", "wq", "wk", "wv", "wo", "w1", "w2", "w3",
                  "classifier"):
            a = quantize(torch.from_numpy(raw[k]), qt, tc.group_size)
            raw[k] = (a.data.numpy(), a.scales.numpy())
    whole = tl.build_params(tc, raw, qt, "cpu")
    n = _world(spec)
    for rank in range(n):
        mesh = ts.make_mesh(spec, world_size=n, rank=rank)
        want = ts.shard_params(tc, mesh, whole, "cpu")
        got = tl.build_params(tc, ts.shard_raw(tc, mesh, raw), qt, "cpu")
        for f in dataclasses.fields(want):
            w, g = getattr(want, f.name), getattr(got, f.name)
            if hasattr(w, "scales"):
                assert g.packed == w.packed, f"{spec} {f.name}"
                pairs = [(w.data, g.data), (w.scales, g.scales)]
            else:
                pairs = [(w, g)]
            for a, b in pairs:
                assert b.is_contiguous(), f"{spec} {f.name}"
                assert torch.equal(a, b), f"{spec} rank {rank} {f.name}"


@pytest.mark.parametrize("spec", ["model=2", "data=2,model=2", "model=8",
                                  "data=2"])
def test_cache_shapes_match_jax(spec):
    jc, _, tc, _ = _models()
    n = _world(spec)
    jmesh = js.make_mesh(spec, jax.devices()[:n])
    B, L, S = 4, CFG["n_layers"], CFG["max_seq_len"]
    hs = CFG["dim"] // CFG["n_heads"]
    g5, g4 = (L, B, 4, S, hs), (L, B, 4, S)
    sh5, sh4 = js.slot_cache_sharding(jc, jmesh, B)
    single = js.cache_sharding(jc, jmesh).k
    for rank in range(n):
        mesh = ts.make_mesh(spec, world_size=n, rank=rank)
        c = ts.new_slot_cache(tc, mesh, B, "int8", "cpu")
        assert tuple(c.k.shape) == sh5.shard_shape(g5)
        assert tuple(c.k_scale.shape) == sh4.shard_shape(g4)
        k = ts.new_cache(tc, mesh, torch.float32, "cpu").k
        assert tuple(k.shape) == single.shard_shape((L, 4, S, hs))


def test_shard_cache_takes_the_rank_block():
    _, _, tc, _ = _models()
    from fastllama_tpu_torch.models.llama import KVCache
    full = KVCache.create(tc, device="cpu")
    full.k.copy_(torch.arange(full.k.numel(), dtype=torch.float32)
                 .reshape(full.k.shape))
    mesh = ts.make_mesh("model=2", world_size=2, rank=1)
    got = ts.shard_cache(tc, mesh, full)
    assert torch.equal(got.k, full.k[:, 2:4]) and got.k.is_contiguous()


@pytest.mark.parametrize("spec,world,rank,coord", [
    ("", 1, 0, (0, 0)), ("model=1", 1, 0, (0, 0)), ("data=1", 1, 0, (0, 0)),
    ("model=2", 2, 1, (0, 1)), ("data=2,model=4", 8, 5, (1, 1)),
    ("", 4, 3, (0, 3))])
def test_make_mesh_specs(spec, world, rank, coord):
    mesh = ts.make_mesh(spec, world_size=world, rank=rank)
    want = js.make_mesh(spec, jax.devices()[:world]).shape
    assert mesh.shape == dict(want)
    assert (mesh.index("data"), mesh.index("model")) == coord
    assert mesh.device_mesh is None


def test_make_mesh_errors():
    """Larger than the world: JAX's error and text, with no process group
    (a one-rank world); a mesh leaving ranks out; an unknown axis."""
    with pytest.raises(ValueError) as want:
        js.make_mesh("model=2", jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        ts.make_mesh("model=2")
    assert str(got.value) == str(want.value)
    assert "needs 2 devices, have 1" in str(got.value)
    with pytest.raises(ValueError, match="covers 2 of 4"):
        ts.make_mesh("model=2", world_size=4)
    with pytest.raises(ValueError, match="pipe"):
        ts.make_mesh("pipe=2")
    mesh = ts.make_mesh("model=2", world_size=2)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.group("model")


@pytest.mark.parametrize("over,spec,B,sharded", [
    ({}, "model=2", 4, True), ({}, "model=8", 4, False),
    (dict(hidden_dim=200), "model=4", 4, False),
    (dict(group_size=64), "model=4", 4, False),
    ({}, "data=2,model=2", 3, True), ({}, "data=2,model=2", 3, False)])
def test_check_dims_matches_jax(over, spec, B, sharded):
    kw = dict(CFG, **over)
    jc = jcfg.ModelConfig(**kw)
    tc = tcfg.ModelConfig(**kw)
    n = _world(spec)
    jmesh = js.make_mesh(spec, jax.devices()[:n])
    mesh = ts.make_mesh(spec, world_size=n)
    try:
        jspmd._check_dims(jc, jmesh, B, sharded)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tspmd._check_dims(tc, mesh, B, sharded)
        assert str(got.value) == str(e)
    else:
        tspmd._check_dims(tc, mesh, B, sharded)


def test_packed_row_shard_repacks_its_rows():
    """A nibble-packed INT4 row-parallel weight: each shard holds the
    values of its own in-feature rows (split-half packing pairs rows of
    the whole axis, so the shard repacks)."""
    g = torch.Generator().manual_seed(0)
    L, I, O, gs = 2, 2048, 256, 64
    vals = torch.randint(-7, 8, (L, I, O), generator=g, dtype=torch.int8)
    sc = torch.rand((L, I // gs, O), generator=g)
    w = QArray(pack_int4_rows(vals), sc, tcfg.QuantType.INT4, gs, -2, True)
    tc = tcfg.ModelConfig(**dict(CFG, quant_type=tcfg.QuantType.INT4))
    params = tl.random_params_int(tc, seed=0, device="cpu")
    params = dataclasses.replace(params, wo=w)
    for rank in range(2):
        mesh = ts.make_mesh("model=2", world_size=2, rank=rank)
        got = ts.shard_params(tc, mesh, params, "cpu").wo
        rows = slice(rank * I // 2, (rank + 1) * I // 2)
        assert got.packed and got.data.shape == (L, I // 4, O)
        assert torch.equal(unpack_int4_rows(got.data), vals[:, rows])
        assert torch.equal(got.scales, sc[:, rank * I // gs // 2:
                                          (rank + 1) * I // gs // 2])


def test_initialize_is_a_noop_without_a_group(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is None
    assert not distributed.is_multiprocess()
    assert distributed.agree({"arm": 2}) == {"arm": 2}


def test_initialize_refuses_what_it_cannot_place(monkeypatch):
    """torchrun's variables without LOCAL_RANK and no device: it raises,
    never picks a device itself; no MASTER_ADDR: it raises."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        distributed.initialize()
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        distributed.initialize()
    assert not distributed.is_initialized()
