"""Tensor-parallel layout over a ('data', 'model') mesh of ranks (port of
``fastllama_tpu/parallel/sharding.py``).

The JAX package annotates global arrays with ``NamedSharding``s and lets
XLA place the shards.  Here every rank is its own process and holds only
its shard, a contiguous tensor on its device; the annotations become the
slices a rank keeps:

* wq/wk/wv, w1/w3 : out-features over 'model' (column parallel)
* wo, w2          : in-features over 'model' (row parallel; the partial
  sums are all-reduced in ``parallel/spmd_step.py``), their scales along
  in/gs where that divides, else replicated (``_fit_spec``)
* embedding, classifier : the vocabulary over 'model'
* KV cache        : kv heads over 'model', slots over 'data'
* norms           : replicated

A rank's coordinate is ``(rank // model, rank % model)``: 'data' outermost,
the JAX package's device order.  GQA over-sharding (model > n_kv_heads)
shards K/V heads over a 'kv' sub-axis and replicates each over the 'rep'
ranks of its query-head group, as ``gqa_submesh`` does there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fastllama_tpu_torch.config import ModelConfig
from fastllama_tpu_torch.device import resolve_device, torch_dtype
from fastllama_tpu_torch.quant.groupquant import (QArray, pack_int4_rows,
                                                  pack_supported)

DATA_AXIS = "data"
MODEL_AXIS = "model"
KV_AXIS = "kv"
REP_AXIS = "rep"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of the mesh: axis names and sizes (row-major over the
    ranks), this rank, and the ``torch.distributed`` DeviceMesh whose
    groups the collectives run on (None for a layout without a process
    group: one rank, or a rank's coordinate for planning and tests, where
    a collective over an axis of size > 1 raises)."""

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int = 0
    device_mesh: object = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        coord = np.unravel_index(self.rank, self.sizes)
        return int(coord[self.axes.index(axis)])

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if self.device_mesh is None:
            raise RuntimeError(f"mesh {self.shape} has no process group: "
                               f"no collective over '{axis}'")
        return self.device_mesh.get_group(axis)

    def global_rank(self, **coord) -> int:
        """The rank at this rank's coordinate with ``coord`` replaced."""
        idx = [coord.get(a, self.index(a)) for a in self.axes]
        return int(np.ravel_multi_index(idx, self.sizes))


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """'data=2,model=4' -> {'data': 2, 'model': 4}; missing axes are 1."""
    shape = {DATA_AXIS: 1, MODEL_AXIS: 1}
    for part in spec.split(","):
        k, v = part.split("=")
        k = k.strip()
        if k not in shape:
            raise ValueError(f"mesh axis '{k}' is not one of "
                             f"{DATA_AXIS}, {MODEL_AXIS}")
        shape[k] = int(v)
    return shape


def make_mesh(spec: str = "", world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """A mesh from a 'data=2,model=4' spec over the ranks of the process
    group (one rank without one); the default puts every rank on 'model'.
    A mesh needing more ranks than the world raises ValueError naming both
    counts; so does one that leaves ranks out (their collectives would
    hang).  ``world_size``/``rank`` ask for a rank's layout without a
    process group."""
    import torch.distributed as dist
    joined = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if joined else 1
    if rank is None:
        rank = dist.get_rank() if joined else 0
    shape = ({DATA_AXIS: 1, MODEL_AXIS: world_size} if not spec
             else parse_mesh_spec(spec))
    total = shape[DATA_AXIS] * shape[MODEL_AXIS]
    if total > world_size:
        raise ValueError(f"mesh {shape} needs {total} devices, have "
                         f"{world_size}")
    if total < world_size:
        raise ValueError(f"mesh {shape} covers {total} of {world_size} "
                         f"ranks; a multi-process mesh must include every "
                         f"rank")
    device_mesh = None
    if joined and world_size == dist.get_world_size():
        from torch.distributed.device_mesh import DeviceMesh
        from fastllama_tpu_torch.parallel.distributed import rank_device
        dev = rank_device()
        device_mesh = DeviceMesh(
            "cpu" if dev is None else dev.type,
            torch.arange(total).reshape(shape[DATA_AXIS], shape[MODEL_AXIS]),
            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh((DATA_AXIS, MODEL_AXIS),
                (shape[DATA_AXIS], shape[MODEL_AXIS]), rank, device_mesh)


def host_mesh(mesh: Mesh) -> Mesh:
    """This rank's view of its own host on a multi-host ``mesh`` (a host
    is a data coordinate): 'data' of size 1 and the rank's 'model' line,
    whose process group is this rank's 'model' group of ``mesh``.  The
    multi-host engines run ``models/batched.py``'s steps on it, so that no
    collective of a step crosses hosts."""
    mp = mesh.shape[MODEL_AXIS]
    sub_mesh = None
    if mesh.device_mesh is not None and mp > 1:
        sub_mesh = mesh.device_mesh[MODEL_AXIS]
    return Mesh((DATA_AXIS, MODEL_AXIS), (1, mp), mesh.index(MODEL_AXIS),
                sub_mesh)


def gqa_submesh(mesh: Mesh, n_kv_heads: int) -> Mesh:
    """The mesh with its 'model' axis split into ('kv', 'rep') for GQA
    over-sharding (model > n_kv_heads): a KV head lives on the ``rep =
    model / n_kv`` ranks that hold its query-head group.  Same ranks, same
    order."""
    mp = mesh.shape[MODEL_AXIS]
    if mp % n_kv_heads:
        raise ValueError(f"model axis {mp} not a multiple of n_kv_heads "
                         f"{n_kv_heads}")
    return Mesh((DATA_AXIS, KV_AXIS, REP_AXIS),
                (mesh.shape[DATA_AXIS], n_kv_heads, mp // n_kv_heads),
                mesh.rank)


Spec = Tuple[Optional[str], ...]


def _fit_spec(mesh: Mesh, shape, spec: Spec) -> Spec:
    """Drop the sharding of axes whose extent the mesh axis does not
    divide (the per-group scale arrays; the data arrays themselves must
    divide — ``pad_hidden_for_sharding`` aligns them)."""
    return tuple(None if ax is None or shape[i] % mesh.shape[ax] else ax
                 for i, ax in enumerate(spec))


def local_slices(mesh: Mesh, shape, spec: Spec) -> Tuple[slice, ...]:
    """The index of this rank's block of a ``shape`` array laid out by
    ``spec``; an axis its mesh axis does not divide raises."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None:
            out.append(slice(None))
            continue
        n = mesh.shape[ax]
        if shape[i] % n:
            raise ValueError(f"axis {i} of {tuple(shape)} ({shape[i]}) does "
                             f"not divide the mesh axis '{ax}' ({n})")
        e = shape[i] // n
        j = mesh.index(ax)
        out.append(slice(j * e, (j + 1) * e))
    return tuple(out)


def local_shape(mesh: Mesh, shape, spec: Spec) -> Tuple[int, ...]:
    return tuple(len(range(*s.indices(n))) for s, n in
                 zip(local_slices(mesh, shape, spec), shape))


@dataclasses.dataclass(frozen=True)
class Placement:
    """How one leaf is laid out: the mesh view its axis names refer to
    and the specs of its data and (for a QArray) its scales."""

    mesh: Mesh
    spec: Spec
    scale_spec: Optional[Spec] = None


def _leaf(mesh: Mesh, value, spec: Spec) -> Placement:
    if isinstance(value, QArray):
        return Placement(mesh, spec, _fit_spec(mesh, value.scales.shape,
                                               spec))
    return Placement(mesh, spec)


def _field_specs(cfg: ModelConfig, mesh: Mesh) -> Dict[str, Tuple[Mesh,
                                                                  Spec]]:
    """Each field's (mesh view, spec) in the built (in, out) layout."""
    mp = mesh.shape[MODEL_AXIS]
    if cfg.n_kv_heads % mp != 0 and mp % cfg.n_kv_heads != 0:
        raise ValueError(
            f"model axis {mp} incompatible with n_kv_heads={cfg.n_kv_heads}"
            " (reference analogue: n_heads % n_kv_heads == 0,"
            " transformer.cpp:215-218)")
    # transposed (in, out) weight layout: (L, I, O), scales (L, I/gs, O)
    col = (None, None, MODEL_AXIS)
    row = (None, MODEL_AXIS, None)
    if cfg.n_kv_heads % mp == 0:
        kv = (mesh, col)
    else:
        kv = (gqa_submesh(mesh, cfg.n_kv_heads), (None, None, KV_AXIS))
    return {"embedding": (mesh, (MODEL_AXIS, None)),        # (V, D)
            "attn_norm": (mesh, (None, None)),
            "wq": (mesh, col), "wk": kv, "wv": kv, "wo": (mesh, row),
            "ffn_norm": (mesh, (None, None)),
            "w1": (mesh, col), "w2": (mesh, row), "w3": (mesh, col),
            "out_norm": (mesh, (None,)),
            "classifier": (mesh, (None, MODEL_AXIS))}       # (D, V)


def param_shardings(cfg: ModelConfig, mesh: Mesh, params):
    """A LlamaParams-shaped tree of :class:`Placement`s (None where a
    fused-away field is None).  Column-parallel weights shard the
    out-features axis, row-parallel ones the in-features axis; scales
    follow their data where they divide."""
    from fastllama_tpu_torch.models.llama import LlamaParams
    specs = _field_specs(cfg, mesh)

    def leaf(name):
        v = getattr(params, name)
        return None if v is None else _leaf(specs[name][0], v,
                                            specs[name][1])

    return LlamaParams(**{f.name: leaf(f.name)
                          for f in dataclasses.fields(LlamaParams)})


def shard_raw(cfg: ModelConfig, mesh: Mesh, raw: dict) -> dict:
    """This rank's block of every leaf of a loader's dict, in the
    checkpoint layout (projections (…, out, in) with their groups along
    in; fp32 arrays or ``(data, scales)`` pairs), as views: what
    ``build_params`` turns into :func:`shard_params`' leaves, so that a
    rank reads, quantizes and packs its block alone.  Quantization groups
    run along in, and a row-parallel block starts at a group boundary
    (``_check_dims``), so quantizing the block gives the block of the
    quantized whole."""
    specs = _field_specs(cfg, mesh)
    out = {}
    for name, v in raw.items():
        if name not in specs or v is None:
            out[name] = v
            continue
        m, spec = specs[name]
        if name not in ("embedding", "attn_norm", "ffn_norm", "out_norm"):
            spec = spec[:-2] + (spec[-1], spec[-2])       # (…, out, in)
        if isinstance(v, tuple):
            data, scales = v
            out[name] = (data[local_slices(m, data.shape, spec)],
                         scales[local_slices(m, scales.shape,
                                             _fit_spec(m, scales.shape,
                                                       spec))])
        else:
            out[name] = v[local_slices(m, v.shape, spec)]
    return out


def _own(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` that shares no storage with
    it, so that the full tensor can go."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def _place(value, pl: Placement, device: torch.device):
    if not isinstance(value, QArray):
        return _own(value[local_slices(pl.mesh, value.shape, pl.spec)],
                    device)
    data = value.unpacked().data if value.packed else value.data
    d = data[local_slices(pl.mesh, data.shape, pl.spec)]
    s = value.scales[local_slices(pl.mesh, value.scales.shape,
                                  pl.scale_spec)]
    packed = False
    if value.packed:
        # split-half packing pairs row r with row r + I/2 of the WHOLE in
        # axis: a shard repacks its own rows where they pack
        I, O = d.shape[-2], d.shape[-1]
        packed = pack_supported(I, O, value.group_size)
        if packed:
            d = pack_int4_rows(d)
    return QArray(_own(d, device), _own(s, device), value.qtype,
                  value.group_size, value.group_axis, packed)


def shard_params(cfg: ModelConfig, mesh: Mesh, params, device=None):
    """This rank's shard of every leaf of ``params`` (on any device), each
    a contiguous tensor of its own on ``device`` (None: the card).  Fused
    params keep their None leaves (fused layouts are legal only on a
    one-rank mesh, where every shard is the whole leaf).  A nibble-packed
    INT4 projection sharded along its in-features repacks its rows (the
    JAX package slices the packed bytes, which under split-half packing
    hold rows of both halves of the whole axis)."""
    from fastllama_tpu_torch.models.llama import LlamaParams
    dev = resolve_device(device)
    pls = param_shardings(cfg, mesh, params)
    return LlamaParams(**{
        f.name: (None if getattr(params, f.name) is None else
                 _place(getattr(params, f.name), getattr(pls, f.name), dev))
        for f in dataclasses.fields(params)})


def _head_axis(cfg: ModelConfig, mesh: Mesh):
    """(mesh view, axis name) for the kv-heads axis: 'model' when heads
    divide, the 'kv' sub-axis when over-sharded, replicated otherwise."""
    mp = mesh.shape[MODEL_AXIS]
    if cfg.n_kv_heads % mp == 0:
        return mesh, MODEL_AXIS
    if mp % cfg.n_kv_heads == 0:
        return gqa_submesh(mesh, cfg.n_kv_heads), KV_AXIS
    return mesh, None


def cache_sharding(cfg: ModelConfig, mesh: Mesh,
                   batched: bool = False) -> Placement:
    """The KV cache's layout: kv heads over 'model' (the 'kv' sub-axis
    under GQA over-sharding), a leading slot axis over 'data'."""
    hmesh, head_ax = _head_axis(cfg, mesh)
    spec = ((DATA_AXIS, None, head_ax, None, None) if batched
            else (None, head_ax, None, None))
    return Placement(hmesh, spec)


def slot_cache_sharding(cfg: ModelConfig, mesh: Mesh, batch_size: int
                        ) -> Tuple[Placement, Placement]:
    """The continuous-batching cache's layout: slots over 'data' where
    they divide, kv heads over 'model'.  Returns the placements of the
    data (L, B, n_kv, S, hs) and of the int8 cache's scales (L, B, n_kv,
    S)."""
    dp = mesh.shape[DATA_AXIS]
    hmesh, head_ax = _head_axis(cfg, mesh)
    slot_ax = DATA_AXIS if dp > 1 and batch_size % dp == 0 else None
    return (Placement(hmesh, (None, slot_ax, head_ax, None, None)),
            Placement(hmesh, (None, slot_ax, head_ax, None)))


def new_slot_cache(cfg: ModelConfig, mesh: Mesh, batch_size: int,
                   dtype=torch.float32, device=None):
    """This rank's block of a ``BatchedKVCache`` for ``batch_size`` slots,
    allocated at its local shape (L, B/dp, n_kv/mp, S, hs), scales (L,
    B/dp, n_kv/mp, S) beside an int8 cache."""
    from fastllama_tpu_torch.models.batched import BatchedKVCache
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    p5, p4 = slot_cache_sharding(cfg, mesh, batch_size)
    shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, cfg.max_seq_len,
             cfg.head_size)
    s5 = local_shape(p5.mesh, shape, p5.spec)
    if dtype == torch.int8:
        s4 = local_shape(p4.mesh, shape[:-1], p4.spec)
        return BatchedKVCache(
            torch.zeros(s5, dtype=torch.int8, device=dev),
            torch.zeros(s5, dtype=torch.int8, device=dev),
            torch.ones(s4, dtype=torch.float32, device=dev),
            torch.ones(s4, dtype=torch.float32, device=dev))
    return BatchedKVCache(torch.zeros(s5, dtype=dtype, device=dev),
                          torch.zeros(s5, dtype=dtype, device=dev))


def new_cache(cfg: ModelConfig, mesh: Mesh, dtype=torch.float32,
              device=None):
    """This rank's block of the single-stream ``KVCache`` (L, n_kv/mp, S,
    hs)."""
    from fastllama_tpu_torch.models.llama import KVCache
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    pl = cache_sharding(cfg, mesh)
    shape = local_shape(pl.mesh, (cfg.n_layers, cfg.n_kv_heads,
                                  cfg.max_seq_len, cfg.head_size), pl.spec)
    return KVCache(torch.zeros(shape, dtype=dtype, device=dev),
                   torch.zeros(shape, dtype=dtype, device=dev))


def shard_cache(cfg: ModelConfig, mesh: Mesh, cache, batched: bool = False,
                device=None):
    """This rank's block of a whole single-stream (or, ``batched``, slot)
    cache, on ``device`` (None: where the cache is)."""
    dev = cache.k.device if device is None else resolve_device(device)
    pl = cache_sharding(cfg, mesh, batched)
    return type(cache)(*[_own(t[local_slices(pl.mesh, t.shape, pl.spec)],
                              dev) for t in (cache.k, cache.v)])


def pad_hidden_for_sharding(cfg: ModelConfig, weights: dict,
                            model_parallel: int) -> ModelConfig:
    """Zero-pad the FFN hidden dimension to a multiple of
    ``group_size * model_parallel`` (LLaMA2-7B's 11008 -> 11264 at 8), so
    that w2's row-parallel shards and their quant-group scales align.
    Exact: padded w1/w3 output rows are zero, so silu(0)*0 = 0 flows into
    zero w2 columns.  Mutates ``weights`` (numpy arrays or ``(data,
    scales)`` pairs in checkpoint layout) in place and returns the updated
    config."""
    align = cfg.group_size * model_parallel
    H = cfg.hidden_dim
    newH = -(-H // align) * align
    if newH == H:
        return cfg
    padH = newH - H

    def pad_axis(v, axis: int, n: int):
        if isinstance(v, tuple):
            data, scales = v
            dpad = [(0, 0)] * data.ndim
            dpad[axis] = (0, n)
            spad = [(0, 0)] * scales.ndim
            # a scales axis matching a group axis shrinks by group_size
            spad[axis] = (0, n if scales.shape[axis] == data.shape[axis]
                          else n // cfg.group_size)
            return (np.pad(data, dpad), np.pad(scales, spad))
        pad = [(0, 0)] * v.ndim
        pad[axis] = (0, n)
        return np.pad(v, pad)

    weights["w1"] = pad_axis(weights["w1"], 1, padH)   # (L, H, D): O rows
    weights["w3"] = pad_axis(weights["w3"], 1, padH)
    weights["w2"] = pad_axis(weights["w2"], 2, padH)   # (L, D, H): I cols
    return cfg.replace(hidden_dim=newH)
