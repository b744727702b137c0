"""What a rank adds to the batched steps on a mesh (port of
``fastllama_tpu/parallel/spmd_step.py``).

The JAX package writes each step as a ``shard_map`` body.  Here the body
is ``models/batched.py``'s own step, given the ``mesh``: every rank runs
it in its own process on the shards that ``parallel/sharding.
shard_params`` left it, with the same hand-written kernels as on one card
at the shard shapes.  This module holds what the mesh changes in those
steps.  The per-layer ``psum`` after the row-parallel projections (wo,
w2) becomes an all-reduce over the mesh's 'model' group of f32 partials,
rounded once to the compute dtype before the residual is added, as on
one card.
The embedding lookup runs on the vocabulary-sharded table (a masked
local gather, then an all-reduce), and the classifier's local logits are
all-gathered over 'model'; both stay outside the layer loop, as the JAX
package keeps them outside the ``shard_map``.  Without a mesh, or on an
axis of size 1, each helper is the one-card step's own operation and
runs no collective.

Sharding contract (``parallel/sharding.py``):
  wq/wk/wv/w1/w3  (L, I, O/mp)   column parallel
  wo/w2           (L, I/mp, O)   row parallel -> all-reduce
  caches          (L, B/dp, n_kv/mp, S, hs)
  norms replicated; embedding and classifier sharded over the vocabulary.

The steps take the GLOBAL tokens and positions (every rank holds the same
scheduler state) and return the global logits.  ``data_sharded``: the
cache holds this rank's slots only, the slot axis split over 'data' in
contiguous ranges (rank coordinate d holds slots [d·Bl, (d+1)·Bl)); a
rank decodes or verifies its own range and the logits are all-gathered
over 'data'.  Without it the cache holds every slot (replicated over
'data') and every rank runs every row, as the JAX bodies do.  The JAX
package's ``data_sharded`` prefill takes data-shard-local slot ids in
rows split evenly over 'data'; here a prefill takes global slot ids and
each data shard prefills the rows whose slots it holds (so a wave need
not split evenly), and the logits are summed over 'data' from zero rows
elsewhere, which is exact.  :func:`spmd_prefill_tail_hits` keeps the JAX
contract.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from fastllama_tpu_torch.config import ModelConfig
from fastllama_tpu_torch.models.llama import LlamaParams, embed_tokens
from fastllama_tpu_torch.ops.norms import rmsnorm
from fastllama_tpu_torch.parallel.sharding import DATA_AXIS, MODEL_AXIS, Mesh


def _check_dims(cfg: ModelConfig, mesh: Mesh, B: int,
                data_sharded: bool) -> None:
    mp = mesh.shape[MODEL_AXIS]
    if cfg.n_heads % mp or cfg.n_kv_heads % mp or cfg.hidden_dim % mp:
        raise ValueError(f"heads/hidden must divide the model axis ({mp})")
    gs = cfg.group_size
    if (cfg.n_heads * cfg.head_size // gs) % mp or (cfg.hidden_dim // gs) % mp:
        raise ValueError(
            f"row-parallel quant-group counts (I/gs) must divide the model "
            f"axis ({mp}); pad hidden/heads or shrink group_size")
    if data_sharded and B % mesh.shape[DATA_AXIS]:
        raise ValueError(
            f"batch {B} must divide the data axis ({mesh.shape[DATA_AXIS]})")


def _size(mesh: Optional[Mesh], axis: str) -> int:
    return 1 if mesh is None else mesh.shape[axis]


def all_reduce(mesh: Optional[Mesh], t: torch.Tensor,
               axis: str = MODEL_AXIS) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` (in place; the psum)."""
    if _size(mesh, axis) > 1:
        dist.all_reduce(t, group=mesh.group(axis))
    return t


def all_gather(mesh: Optional[Mesh], t: torch.Tensor, axis: str, dim: int
               ) -> torch.Tensor:
    """The blocks of ``t`` over ``axis``, concatenated along ``dim`` in
    coordinate order."""
    n = _size(mesh, axis)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def local_heads(cfg: ModelConfig, mesh: Optional[Mesh]):
    """(query heads, kv heads) of this rank."""
    mp = _size(mesh, MODEL_AXIS)
    return cfg.n_heads // mp, cfg.n_kv_heads // mp


def embed(mesh: Optional[Mesh], emb, tokens: torch.Tensor, dtype
          ) -> torch.Tensor:
    """Rows of the vocabulary-sharded table: each rank gathers the tokens
    in its block, zeros elsewhere, and the all-reduce over 'model' sums
    the one non-zero row of each token."""
    if _size(mesh, MODEL_AXIS) == 1:
        return embed_tokens(emb, tokens, dtype)
    Vl = emb.shape[0]
    local = tokens.to(torch.long) - mesh.index(MODEL_AXIS) * Vl
    inside = (local >= 0) & (local < Vl)
    x = embed_tokens(emb, local.clamp(0, Vl - 1), dtype)
    x = torch.where(inside[:, None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    return all_reduce(mesh, x)


def classify(cfg: ModelConfig, mesh: Optional[Mesh], params: LlamaParams,
             x: torch.Tensor, mm: Callable) -> torch.Tensor:
    """out_norm, the (local) classifier, the logits gathered over 'model'
    (f32)."""
    x = rmsnorm(x, params.out_norm, cfg.norm_eps)
    return all_gather(mesh, mm(x, params.classifier).to(torch.float32),
                      MODEL_AXIS, -1)


def row_parallel(mesh: Optional[Mesh], proj, x: torch.Tensor,
                 h: torch.Tensor, w, l: int) -> torch.Tensor:
    """The residual ``x`` plus ``h @ w[l]`` summed over 'model'.  On more
    than one rank the partials stay f32 (h goes in as f32, which K1
    rounds to the compute dtype exactly, so its output is f32), their sum
    is rounded once to the compute dtype, as one card's K1 rounds its f32
    accumulator once, and the residual is added as on one card: the two
    differ only in the order of the f32 sum."""
    if _size(mesh, MODEL_AXIS) == 1:
        return x + proj(h, w, l)
    total = all_reduce(mesh, proj(h.to(torch.float32), w, l))
    return x + total.to(x.dtype)


def slot_range(mesh: Optional[Mesh], B: int, data_sharded: bool) -> slice:
    """The global slot rows this rank runs."""
    if not data_sharded or _size(mesh, DATA_AXIS) == 1:
        return slice(0, B)
    Bl = B // mesh.shape[DATA_AXIS]
    d = mesh.index(DATA_AXIS)
    return slice(d * Bl, (d + 1) * Bl)


def gather_slots(mesh: Optional[Mesh], logits: torch.Tensor,
                 data_sharded: bool) -> torch.Tensor:
    """Every data shard's slot rows of ``logits``, in slot order."""
    if not data_sharded:
        return logits
    return all_gather(mesh, logits, DATA_AXIS, 0)


def owned(mesh: Mesh, slots, Bl: int):
    """(indices of the rows whose global ``slots`` this data shard holds,
    their local slot ids), on the host."""
    lo = mesh.index(DATA_AXIS) * Bl
    slots = [int(s) for s in slots]
    idx = [i for i, s in enumerate(slots) if lo <= s < lo + Bl]
    return idx, [slots[i] - lo for i in idx]


def sum_rows(mesh: Mesh, n: int, idx, rows: Optional[torch.Tensor],
             V: int, device) -> torch.Tensor:
    """The (n, V) logits of every row: this shard's ``rows`` at ``idx``,
    zeros elsewhere, summed over 'data' (each row is non-zero on one
    shard)."""
    out = torch.zeros((n, V), dtype=torch.float32, device=device)
    if idx:
        out[torch.as_tensor(idx, device=device)] = rows
    return all_reduce(mesh, out, DATA_AXIS)


def spmd_prefill_tail_hits(cfg: ModelConfig, mesh: Mesh,
                           params: LlamaParams, tokens: torch.Tensor,
                           lengths: torch.Tensor, slots: torch.Tensor,
                           donors: torch.Tensor, starts: torch.Tensor,
                           cache, *,
                           mm: Callable, mm_idx: Optional[Callable],
                           attn_tail: Optional[Callable] = None,
                           slot_writer: Optional[Callable] = None,
                           compute_dtype=torch.bfloat16):
    """Up to k prefix-cache hits per data shard with their donor copies
    (the multi-host hit wave), with the JAX contract: tokens (H·k, TB),
    H the data axis, shard h owning rows [h·k, (h+1)·k); lengths, slots,
    donors and starts (H·k,) with DATA-SHARD-LOCAL slot ids.  Each hit
    copies its donor's rows [0, start) into its slot on the local cache,
    then runs its TB-row tail at [start, start+TB) through
    ``models/batched.prefill_into_slot_at`` on the mesh.  Returns
    (last-valid-token logits (H·k, vocab) f32, cache)."""
    from fastllama_tpu_torch.models.batched import (copy_slot_prefix,
                                                    prefill_into_slot_at)
    N = tokens.shape[0]
    _check_dims(cfg, mesh, cache.k.shape[1], True)
    dp = mesh.shape[DATA_AXIS]
    if N % dp:
        raise ValueError(f"hit rows {N} must divide the data axis {dp}")
    k_hits = N // dp
    lo = mesh.index(DATA_AXIS) * k_hits
    host = [t[lo:lo + k_hits].tolist()
            for t in (lengths, slots, donors, starts)]
    out = []
    for i, (length, slot, donor, start) in enumerate(zip(*host)):
        copy_slot_prefix(cache, donor, slot, start)
        lg, cache = prefill_into_slot_at(
            cfg, params, tokens[lo + i], length, slot, start, cache, mm=mm,
            mm_idx=mm_idx, attn_tail=attn_tail, slot_writer=slot_writer,
            compute_dtype=compute_dtype, mesh=mesh)
        out.append(lg[None])
    return all_gather(mesh, torch.cat(out), DATA_AXIS, 0), cache
