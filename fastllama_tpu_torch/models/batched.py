"""Slot-batched LLaMA forward, the continuous-batching substrate (port of
``fastllama_tpu/models/batched.py``).

* :class:`BatchedKVCache` — one preallocated ``(L, B, n_kv, S, hs)`` buffer
  per K and V; slot ``b`` is an independent sequence.  ``dtype=int8``
  stores rows int8 with per-row f32 scales ``(L, B, n_kv, S)``.
* :func:`prefill_many` — N prompts into N slots in one pass; attention is
  block-diagonal (each prompt over its own fresh K/V).
* :func:`prefill_into_slot` — one prompt into one slot at positions
  [0, T): the single-stream engine's fresh prefill at ``pos == 0``.
* :func:`prefill_into_slot_at` / :func:`copy_slot_prefix` — the
  prefix cache: a donor slot's rows copied, then only the prompt's tail
  prefilled at positions [start, start+T).
* :func:`decode_step` — one token for every slot at per-slot positions.
* :func:`decode_step_deferred` with :func:`make_staged` /
  :func:`land_staged` — the same step with the chunk's fresh rows staged
  outside the cache and landed once at the chunk's end.
* :func:`spec_decode_step` — D tokens for every slot (pending + drafts)
  in one forward, the batched speculative verify.

On a mesh of ranks (``mesh``, ``parallel/``) the prefill, decode, verify
and tail steps run per rank on its shards; ``parallel/spmd_step.py`` holds
the collectives they add.

Cache writes are deferred out of the layer loop, as in the JAX package:
attention reads cache rows [0, pos[b]) strictly plus the fresh row, and
every layer's new rows land after the loop in one writer call.  The port
updates the cache tensors in place (JAX donates the buffers instead); the
functions return the same cache object.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from fastllama_tpu_torch.config import ModelConfig
from fastllama_tpu_torch.device import resolve_device, torch_dtype
from fastllama_tpu_torch.models.llama import LlamaParams, embed_tokens
from fastllama_tpu_torch.ops.attention import (gqa_attention,
                                               gqa_attention_decode_batched)
from fastllama_tpu_torch.ops.norms import rmsnorm, swiglu
from fastllama_tpu_torch.ops.qmatmul import qmatmul
from fastllama_tpu_torch.ops.rope import apply_rope_half, rope_tables
from fastllama_tpu_torch.parallel.sharding import DATA_AXIS, MODEL_AXIS
from fastllama_tpu_torch.parallel.spmd_step import (
    _check_dims, classify, embed, gather_slots, local_heads, owned,
    row_parallel, slot_range, sum_rows)
from fastllama_tpu_torch.quant.groupquant import dequantize_rows, quantize_rows


@dataclasses.dataclass
class BatchedKVCache:
    """(L, B, n_kv, max_seq, head_size) per tensor; slot = independent
    stream.  Quantized (int8) when ``k_scale``/``v_scale`` are present."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def create(cfg: ModelConfig, batch_size: int,
               max_seq_len: Optional[int] = None, dtype=torch.float32,
               device=None) -> "BatchedKVCache":
        dev = resolve_device(device)
        dtype = torch_dtype(dtype)
        S = max_seq_len or cfg.max_seq_len
        shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, S, cfg.head_size)
        if dtype == torch.int8:
            sshape = shape[:-1]
            return BatchedKVCache(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.ones(sshape, dtype=torch.float32, device=dev),
                torch.ones(sshape, dtype=torch.float32, device=dev))
        return BatchedKVCache(torch.zeros(shape, dtype=dtype, device=dev),
                              torch.zeros(shape, dtype=dtype, device=dev))

    @property
    def batch_size(self) -> int:
        return self.k.shape[1]


def _split_qkv(cfg: ModelConfig, params: LlamaParams, proj, h, l):
    """QKV projection (fused or separate) -> q, k, v as flat feature rows."""
    qdim, kvdim = cfg.n_heads * cfg.head_size, cfg.kv_dim
    if params.wk is None:                      # fused QKV (fuse_params)
        qkv = proj(h, params.wq, l)
        return (qkv[:, :qdim], qkv[:, qdim:qdim + kvdim],
                qkv[:, qdim + kvdim:])
    return proj(h, params.wq, l), proj(h, params.wk, l), proj(h, params.wv, l)


def _ffn_hidden(cfg: ModelConfig, params: LlamaParams, proj, h, l):
    """swiglu(h·w1, h·w3): the FFN's hidden rows (gate|up fused or
    separate)."""
    if params.w3 is None:                      # fused gate|up
        g13 = proj(h, params.w1, l)
        hdim = cfg.hidden_dim
        return swiglu(g13[:, :hdim], g13[:, hdim:])
    return swiglu(proj(h, params.w1, l), proj(h, params.w3, l))


def _make_proj(mm: Callable, mm_idx: Optional[Callable]):
    """proj(h, w_stacked, layer): the layer-indexed matmul when given,
    else ``mm`` on the layer's view."""
    if mm_idx is not None:
        return mm_idx
    return lambda h, w, l: mm(h, w[l])


def _decode_layer_qkv(cfg: ModelConfig, params: LlamaParams, proj,
                      x, l, attn_norm_l, cos, sin, mesh=None):
    """Decode-layer front half: norm -> QKV -> per-head reshape -> rope.
    x (B, dim); returns q (B, H, hs), k/v (B, n_kv, hs), this rank's
    heads on a ``mesh``."""
    B = x.shape[0]
    hs = cfg.head_size
    n_heads, n_kv = local_heads(cfg, mesh)
    h = rmsnorm(x, attn_norm_l, cfg.norm_eps)
    q, k, v = _split_qkv(cfg, params, proj, h, l)
    q = apply_rope_half(q.reshape(B, n_heads, hs), cos[:, None], sin[:, None])
    k = apply_rope_half(k.reshape(B, n_kv, hs), cos[:, None], sin[:, None])
    return q, k, v.reshape(B, n_kv, hs)


def _layer_tail(cfg: ModelConfig, params: LlamaParams, proj, x, o, l,
                mesh=None):
    """A layer's back half: the output projection and its residual, then
    the FFN block and its residual.  o (rows, H*hs).  On a ``mesh`` wo
    and w2 are row parallel, their partials summed over 'model'
    (``spmd_step.row_parallel``)."""
    x = row_parallel(mesh, proj, x, o, params.wo, l)
    h = rmsnorm(x, params.ffn_norm[l], cfg.norm_eps)
    return row_parallel(mesh, proj, x, _ffn_hidden(cfg, params, proj, h, l),
                        params.w2, l)


def _write_slot(cache: BatchedKVCache, ks: torch.Tensor, vs: torch.Tensor,
                slot: int) -> BatchedKVCache:
    """Write (L, n_kv, T, hs) fresh K/V rows into slot ``slot`` at rows
    [0, T), quantizing rows when the cache is int8 (the writer-less
    path)."""
    T = ks.shape[2]
    if cache.quantized:
        kq, ksc = quantize_rows(ks)
        vq, vsc = quantize_rows(vs)
        cache.k[:, slot, :, :T] = kq
        cache.v[:, slot, :, :T] = vq
        cache.k_scale[:, slot, :, :T] = ksc[..., 0]
        cache.v_scale[:, slot, :, :T] = vsc[..., 0]
    else:
        cache.k[:, slot, :, :T] = ks.to(cache.k.dtype)
        cache.v[:, slot, :, :T] = vs.to(cache.v.dtype)
    return cache


def _layer_slices(cache: BatchedKVCache, l: int, compute_dtype,
                  slot: Optional[int] = None):
    """Dequantized (B, n_kv, S, hs) K/V of layer ``l``, or slot ``slot``'s
    (n_kv, S, hs): the attention fallbacks' read path (the kernels read in
    place)."""
    idx = (l,) if slot is None else (l, slot)
    if cache.quantized:
        return (dequantize_rows(cache.k[idx], cache.k_scale[idx][..., None],
                                compute_dtype),
                dequantize_rows(cache.v[idx], cache.v_scale[idx][..., None],
                                compute_dtype))
    return cache.k[idx], cache.v[idx]


def prefill_many(cfg: ModelConfig, params: LlamaParams,
                 tokens: torch.Tensor, lengths: torch.Tensor,
                 slots: torch.Tensor, cache: BatchedKVCache, *,
                 mm: Callable = qmatmul,
                 mm_idx: Optional[Callable] = None,
                 slot_writer: Optional[Callable] = None,
                 compute_dtype=torch.float32, mesh=None,
                 data_sharded: bool = False
                 ) -> Tuple[torch.Tensor, BatchedKVCache]:
    """Prefill N prompts into N slots in one pass.

    tokens (N, T) at positions [0, T); lengths (N,); slots (N,) int32.
    Matmuls see an (N*T, dim) activation; attention is block-diagonal.
    Duplicate slot ids (N padded by repeating a request) write identical
    rows.  On a ``mesh`` (``parallel/spmd_step.py``) the layers run over
    this rank's heads; with ``data_sharded`` the slots are global and a
    data shard prefills the prompts whose slots it holds (none: no layer
    runs on its data line).  Returns (last-valid-token logits (N, vocab)
    f32, cache)."""
    N, T = tokens.shape
    hs = cfg.head_size
    n_heads, n_kv = local_heads(cfg, mesh)
    proj = _make_proj(mm, mm_idx)
    dev = tokens.device
    sharded = mesh is not None and data_sharded \
        and mesh.shape[DATA_AXIS] > 1
    if mesh is not None:
        Bl = cache.k.shape[1]
        _check_dims(cfg, mesh, Bl * mesh.shape[DATA_AXIS] if data_sharded
                    else N, data_sharded)
    if sharded:
        idx, local = owned(mesh, slots.tolist(), Bl)
        V = mesh.shape[MODEL_AXIS] * params.classifier.shape[-1]
        if not idx:
            return sum_rows(mesh, N, idx, None, V, dev), cache
        sel = torch.as_tensor(idx, device=dev)
        tokens, lengths = tokens[sel], lengths.to(dev)[sel]
        slots = torch.as_tensor(local, dtype=torch.int32, device=dev)
    Nl = tokens.shape[0]

    x = embed(mesh, params.embedding, tokens.reshape(Nl * T), compute_dtype)
    cos, sin = rope_tables(cfg, torch.arange(T, device=dev), compute_dtype)
    kv_dtype = cache.k.dtype if not cache.quantized else compute_dtype

    ks, vs = [], []
    for l in range(cfg.n_layers):
        h = rmsnorm(x, params.attn_norm[l], cfg.norm_eps)
        q, k, v = _split_qkv(cfg, params, proj, h, l)
        q = q.reshape(Nl, T, n_heads, hs).transpose(1, 2)
        k = k.reshape(Nl, T, n_kv, hs).transpose(1, 2)
        v = v.reshape(Nl, T, n_kv, hs).transpose(1, 2)
        q = apply_rope_half(q, cos, sin)
        k = apply_rope_half(k, cos, sin)

        o = gqa_attention(q, k, v, 0)             # each prompt over itself
        x = _layer_tail(cfg, params, proj, x,
                        o.transpose(1, 2).reshape(Nl * T, n_heads * hs), l,
                        mesh)
        ks.append(k.to(kv_dtype))
        vs.append(v.to(kv_dtype))
    ks = torch.stack(ks)                          # (L, N, n_kv, T, hs)
    vs = torch.stack(vs)

    if slot_writer is not None:
        if cache.quantized:
            kq, ks_ = quantize_rows(ks)
            vq, vs_ = quantize_rows(vs)
            slot_writer(cache, kq, vq, ks_[..., 0], vs_[..., 0], slots)
        else:
            slot_writer(cache, ks.to(cache.k.dtype), vs.to(cache.v.dtype),
                        None, None, slots)
    else:
        for n in range(Nl):
            _write_slot(cache, ks[:, n], vs[:, n], int(slots[n]))

    x = x.reshape(Nl, T, -1)
    rows = x[torch.arange(Nl, device=dev), lengths.to(dev, torch.long) - 1]
    logits = classify(cfg, mesh, params, rows, mm)         # (N, V)
    if sharded:
        logits = sum_rows(mesh, N, idx, logits, logits.shape[-1], dev)
    return logits, cache


def prefill_into_slot(cfg: ModelConfig, params: LlamaParams,
                      tokens: torch.Tensor, length: int, slot: int,
                      cache: BatchedKVCache, *, mm: Callable = qmatmul,
                      mm_idx: Optional[Callable] = None,
                      compute_dtype=torch.float32
                      ) -> Tuple[torch.Tensor, BatchedKVCache]:
    """Prefill ``tokens`` (T,) into cache slot ``slot`` at positions
    [0, T): attention over the prompt's own K/V only, the rows written
    after the layer loop (``prefill_many`` with N = 1 and no writer
    kernel, as the JAX ``prefill_into_slot`` writes with a plain slice
    update).  Rows >= ``length`` are padding, written and masked later.
    Returns (last-valid-token logits (vocab,) f32, cache)."""
    logits, cache = prefill_many(
        cfg, params, tokens[None], torch.tensor([int(length)]),
        torch.tensor([int(slot)], dtype=torch.int32), cache, mm=mm,
        mm_idx=mm_idx, compute_dtype=compute_dtype)
    return logits[0], cache


def prefill_into_slot_at(cfg: ModelConfig, params: LlamaParams,
                         tokens: torch.Tensor, length: int, slot: int,
                         start: int, cache: BatchedKVCache, *,
                         mm: Callable = qmatmul,
                         mm_idx: Optional[Callable] = None,
                         attn_tail: Optional[Callable] = None,
                         slot_writer: Optional[Callable] = None,
                         compute_dtype=torch.float32, mesh=None,
                         data_sharded: bool = False
                         ) -> Tuple[torch.Tensor, BatchedKVCache]:
    """Mid-sequence slot prefill (``batched.py:241-324``): ``tokens`` (T,)
    at positions [start, start+T) of slot ``slot``, attending the slot's
    existing rows [0, start) plus the block's own causal K/V — the tail
    prefill behind the prefix cache, and the single-stream engine's block
    at pos > 0 on a mesh.

    ``attn_tail(q, cache, slot, l, start, k, v)`` (K2b) reads the cache
    rows in place and takes the block's raw K/V; without it the fallback
    places the block into a dequantized copy of the slot's layer rows and
    runs the masked attention at ``pos = start``.  length/slot/start are
    host ints.  Rows >= length are padding, written and masked later.
    The rows land at [start, start+T) after the layer loop, through
    ``slot_writer(cache, kq, vq, ks, vs, slots, starts)`` (K3) or the plain
    scatter; the caller keeps start + T <= S.  On a ``mesh`` the layers
    run over this rank's heads; with ``data_sharded`` ``slot`` is global
    and only the data shard holding it runs the block.  Returns
    (last-valid-token logits (vocab,) f32, cache)."""
    from fastllama_tpu_torch.ops.kernels.kv_write import prefill_write_plain
    T = tokens.shape[0]
    hs = cfg.head_size
    n_heads, n_kv = local_heads(cfg, mesh)
    proj = _make_proj(mm, mm_idx)
    dev = tokens.device
    sharded = mesh is not None and data_sharded \
        and mesh.shape[DATA_AXIS] > 1
    if sharded:
        Bl = cache.k.shape[1]
        idx, local = owned(mesh, [slot], Bl)
        V = mesh.shape[MODEL_AXIS] * params.classifier.shape[-1]
        if not idx:
            return sum_rows(mesh, 1, idx, None, V, dev)[0], cache
        slot = local[0]

    x = embed(mesh, params.embedding, tokens, compute_dtype)      # (T, dim)
    cos, sin = rope_tables(cfg, start + torch.arange(T, device=dev),
                           compute_dtype)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        h = rmsnorm(x, params.attn_norm[l], cfg.norm_eps)
        q, k, v = _split_qkv(cfg, params, proj, h, l)
        q = apply_rope_half(q.reshape(T, n_heads, hs).transpose(0, 1), cos,
                            sin)
        k = apply_rope_half(k.reshape(T, n_kv, hs).transpose(0, 1), cos, sin)
        v = v.reshape(T, n_kv, hs).transpose(0, 1)
        if attn_tail is not None:
            o = attn_tail(q, cache, slot, l, start, k, v)
        else:
            kk, vv = (t.to(compute_dtype, copy=True) for t in
                      _layer_slices(cache, l, compute_dtype, slot))
            kk[:, start:start + T] = k
            vv[:, start:start + T] = v
            o = gqa_attention(q, kk, vv, start)
        x = _layer_tail(cfg, params, proj, x,
                        o.transpose(0, 1).reshape(T, n_heads * hs), l, mesh)
        ks.append(k)
        vs.append(v)
    ks = torch.stack(ks)[:, None]                 # (L, 1, n_kv, T, hs)
    vs = torch.stack(vs)[:, None]

    if cache.quantized:
        kq, ksc = quantize_rows(ks)
        vq, vsc = quantize_rows(vs)
        ksc, vsc = ksc[..., 0], vsc[..., 0]
    else:
        kq, vq = ks.to(cache.k.dtype), vs.to(cache.v.dtype)
        ksc = vsc = None
    slots = torch.full((1,), slot, dtype=torch.int32, device=dev)
    starts = torch.full((1,), start, dtype=torch.int32, device=dev)
    (slot_writer or prefill_write_plain)(cache, kq, vq, ksc, vsc, slots,
                                         starts)

    logits = classify(cfg, mesh, params, x[length - 1:length], mm)
    if sharded:
        logits = sum_rows(mesh, 1, [0], logits, logits.shape[-1], dev)
    return logits[0], cache


def copy_slot_prefix(cache: BatchedKVCache, src: int, dst: int,
                     n_rows: int, mesh=None,
                     data_sharded: bool = False) -> BatchedKVCache:
    """Slot ``dst`` rows [0, n_rows) := slot ``src`` rows [0, n_rows), all
    layers and heads, scales included (``batched.py:327-349``; JAX
    computes it in jnp, outside any kernel).  Plain indexed copies, in
    place; returns ``cache``.  On a ``mesh`` with ``data_sharded`` the
    slots are global: across data shards the donor's shard broadcasts the
    rows over its 'data' line and the receiving shard writes them."""
    if mesh is None or not data_sharded or mesh.shape[DATA_AXIS] == 1:
        for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
            if t is not None:
                t[:, dst, :, :n_rows] = t[:, src, :, :n_rows]
        return cache
    import torch.distributed as dist
    Bl = cache.k.shape[1]
    d = mesh.index(DATA_AXIS)
    s_shard, d_shard = src // Bl, dst // Bl
    if s_shard == d_shard:
        if d == s_shard:
            copy_slot_prefix(cache, src - d * Bl, dst - d * Bl, n_rows)
        return cache
    root = mesh.global_rank(**{DATA_AXIS: s_shard})
    for t in (cache.k, cache.v, cache.k_scale, cache.v_scale):
        if t is None:
            continue
        buf = (t[:, src - d * Bl, :, :n_rows].contiguous() if d == s_shard
               else torch.empty_like(t[:, 0, :, :n_rows]))
        dist.broadcast(buf, src=root, group=mesh.group(DATA_AXIS))
        if d == d_shard:
            t[:, dst - d * Bl, :, :n_rows] = buf
    return cache


def decode_step(cfg: ModelConfig, params: LlamaParams, tokens: torch.Tensor,
                pos: torch.Tensor, cache: BatchedKVCache, *,
                mm: Callable = qmatmul,
                mm_idx: Optional[Callable] = None,
                attn_bidx: Optional[Callable] = None,
                kv_writer: Optional[Callable] = None,
                compute_dtype=torch.float32, mesh=None,
                data_sharded: bool = False
                ) -> Tuple[torch.Tensor, BatchedKVCache]:
    """One decode token for every slot: tokens (B,) at per-slot positions
    pos (B,) int32.  Returns (logits (B, vocab) f32, cache).

    ``attn_bidx(q, cache, pos, l, k_new, v_new)`` is the batched
    layer-indexed decode attention over the stacked cache; without it the
    fallback dequantizes layer ``l`` and runs the plain attention.  On a
    ``mesh`` the step runs over this rank's heads and, with
    ``data_sharded``, its data shard's slots; the logits are every
    slot's."""
    if mesh is not None:
        _check_dims(cfg, mesh, tokens.shape[0], data_sharded)
        rows = slot_range(mesh, tokens.shape[0], data_sharded)
        tokens, pos = tokens[rows], pos[rows]
    B = tokens.shape[0]
    hs = cfg.head_size
    n_heads = local_heads(cfg, mesh)[0]
    proj = _make_proj(mm, mm_idx)

    x = embed(mesh, params.embedding, tokens, compute_dtype)        # (B, dim)
    cos, sin = rope_tables(cfg, pos, compute_dtype)                 # (B, hs/2)

    ks, vs = [], []
    for l in range(cfg.n_layers):
        q, k, v = _decode_layer_qkv(cfg, params, proj, x, l,
                                    params.attn_norm[l], cos, sin, mesh)
        if attn_bidx is not None:
            o = attn_bidx(q, cache, pos, l, k, v)                   # (B, H, hs)
        else:
            ck_l, cv_l = _layer_slices(cache, l, compute_dtype)
            o = gqa_attention_decode_batched(q, ck_l[:B], cv_l[:B], k, v,
                                             pos)
        x = _layer_tail(cfg, params, proj, x, o.reshape(B, n_heads * hs), l,
                        mesh)
        ks.append(k)
        vs.append(v)
    ks = torch.stack(ks)                          # (L, B, n_kv, hs)
    vs = torch.stack(vs)

    if cache.quantized:
        kq, ks_ = quantize_rows(ks)
        vq, vs_ = quantize_rows(vs)
        ks2, vs2 = ks_[..., 0], vs_[..., 0]
    else:
        kq, vq = ks.to(cache.k.dtype), vs.to(cache.v.dtype)
        ks2 = vs2 = None
    if kv_writer is not None:
        kv_writer(cache, kq, vq, ks2, vs2, pos)
    else:
        for b in range(B):
            p = int(pos[b])
            cache.k[:, b, :, p] = kq[:, b]
            cache.v[:, b, :, p] = vq[:, b]
            if cache.quantized:
                cache.k_scale[:, b, :, p] = ks2[:, b]
                cache.v_scale[:, b, :, p] = vs2[:, b]

    logits = classify(cfg, mesh, params, x, mm)                     # (B, V)
    return gather_slots(mesh, logits, data_sharded), cache


def make_staged(cfg: ModelConfig, cache: BatchedKVCache, B: int, K: int):
    """Zeroed staging buffers for a K-step deferred decode chunk, in JAX's
    (L, B, K, n_kv, hs) layout (``batched.py:629-647``): K and V in the
    cache dtype, plus (L, B, K, n_kv) f32 row scales for an int8 cache."""
    L, hs, n_kv = cfg.n_layers, cfg.head_size, cfg.n_kv_heads
    dev = cache.k.device
    sk = torch.zeros((L, B, K, n_kv, hs), dtype=cache.k.dtype, device=dev)
    sv = torch.zeros_like(sk)
    if cache.quantized:
        return (sk, sv,
                torch.zeros((L, B, K, n_kv), dtype=torch.float32, device=dev),
                torch.zeros((L, B, K, n_kv), dtype=torch.float32, device=dev))
    return (sk, sv)


def land_staged(cache: BatchedKVCache, staged, pos0: torch.Tensor,
                spec_writer: Callable) -> BatchedKVCache:
    """Land a chunk's staged rows: slot b's K rows go to cache rows
    [pos0[b], pos0[b]+K) (``batched.py:650-678``).  The JAX package lands
    them in spec_write launches of at most 8 rows, a TPU VMEM limit; here
    one ``spec_writer`` call of D = K lands them all."""
    sk, sv = staged[0], staged[1]
    ks = vs = None
    if cache.quantized:
        ks = staged[2].transpose(2, 3).contiguous()      # (L, B, n_kv, K)
        vs = staged[3].transpose(2, 3).contiguous()
    spec_writer(cache, sk.transpose(2, 3).contiguous(),
                sv.transpose(2, 3).contiguous(), ks, vs, pos0)
    return cache


def decode_step_deferred(cfg: ModelConfig, params: LlamaParams,
                         tokens: torch.Tensor, pos0: torch.Tensor,
                         step_s: int, staged, cache: BatchedKVCache, *,
                         mm: Callable = qmatmul,
                         mm_idx: Optional[Callable] = None,
                         attn_stats: Optional[Callable] = None,
                         compute_dtype=torch.float32):
    """One decode token for every slot with chunk-deferred cache writes
    (``batched.py:681-804``).

    ``pos0`` (B,) are the chunk's start positions, fixed for its K steps,
    and ``step_s`` is the step's index in the chunk (a host int: the chunk
    needs no host sync).  Attention composes three parts as the sequential
    steps would see them: cache rows [0, pos0[b]) and the current fresh
    row through ``attn_stats`` (K2 with its softmax stats); the chunk's
    earlier rows [0, step_s) from ``staged``, attended in plain torch in
    their cache dtype (int8 values, K scales after the dot, V scales on
    the probabilities); and the exact two-partial merge of the online
    softmax.  This step's rows are staged at index ``step_s`` (quantized
    for an int8 cache); the cache is not touched, and the engine lands the
    chunk with :func:`land_staged`.  Returns (logits (B, vocab) f32,
    staged), the staging buffers updated in place."""
    from fastllama_tpu_torch.ops.attention import NEG_INF
    B = tokens.shape[0]
    hs, n_heads, n_kv = cfg.head_size, cfg.n_heads, cfg.n_kv_heads
    hgs = n_heads // n_kv
    proj = _make_proj(mm, mm_idx)
    quant = cache.quantized
    sk, sv = staged[0], staged[1]
    Kp = sk.shape[2]
    f32 = torch.float32
    scale = 1.0 / float(hs) ** 0.5
    dev = tokens.device
    tmask = (torch.arange(Kp, device=dev) < step_s)[None, None, None]

    x = embed_tokens(params.embedding, tokens, compute_dtype)       # (B, dim)
    cos, sin = rope_tables(cfg, pos0 + step_s, compute_dtype)
    for l in range(cfg.n_layers):
        q, k, v = _decode_layer_qkv(cfg, params, proj, x, l,
                                    params.attn_norm[l], cos, sin)
        o1, m1, l1 = attn_stats(q, cache, pos0, l, k, v)
        o1 = o1.reshape(B, n_kv, hgs, hs).to(f32)

        qf = q.reshape(B, n_kv, hgs, hs).to(f32)
        s2 = torch.einsum("bngh,bknh->bngk", qf, sk[l].to(f32)) * scale
        if quant:
            s2 = s2 * staged[2][l].transpose(1, 2)[:, :, None, :]
        s2 = torch.where(tmask, s2, torch.full_like(s2, NEG_INF))
        m2 = s2.amax(dim=-1, keepdim=True)                  # (B, n_kv, hgs, 1)
        e = torch.where(tmask, torch.exp(s2 - m2), torch.zeros_like(s2))
        l2 = e.sum(dim=-1, keepdim=True)
        if quant:
            e = e * staged[3][l].transpose(1, 2)[:, :, None, :]
        acc2 = torch.einsum("bngk,bknh->bngh", e, sv[l].to(f32))

        m1e = m1[..., None]
        mx = torch.maximum(m1e, m2)
        w1 = l1[..., None] * torch.exp(m1e - mx)
        w2 = torch.exp(m2 - mx)                 # 0 when no row is staged
        o = (o1 * w1 + acc2 * w2) / (w1 + l2 * w2)
        x = _layer_tail(cfg, params, proj, x,
                        o.reshape(B, n_heads * hs).to(compute_dtype), l)

        if quant:
            kq, ksc = quantize_rows(k)
            vq, vsc = quantize_rows(v)
            sk[l, :, step_s] = kq
            sv[l, :, step_s] = vq
            staged[2][l, :, step_s] = ksc[..., 0]
            staged[3][l, :, step_s] = vsc[..., 0]
        else:
            sk[l, :, step_s] = k.to(sk.dtype)
            sv[l, :, step_s] = v.to(sv.dtype)

    x = rmsnorm(x, params.out_norm, cfg.norm_eps)
    logits = mm(x, params.classifier)                               # (B, V)
    return logits.to(torch.float32), staged


def spec_decode_step(cfg: ModelConfig, params: LlamaParams,
                     tokens: torch.Tensor, pos: torch.Tensor,
                     cache: BatchedKVCache, *,
                     mm: Callable = qmatmul,
                     mm_idx: Optional[Callable] = None,
                     attn_sbidx: Optional[Callable] = None,
                     spec_writer: Optional[Callable] = None,
                     compute_dtype=torch.float32, mesh=None,
                     data_sharded: bool = False
                     ) -> Tuple[torch.Tensor, BatchedKVCache]:
    """Batched speculative verify: D tokens for every slot in one forward
    (``batched.py:429-538``).

    tokens (B, D): slot b's rows sit at positions pos[b]..pos[b]+D-1 (row
    0 its pending token, rows 1.. its drafts); pos (B,) int32.  The
    matmuls see a (B*D, dim) activation.  Returns (logits (B, D, vocab)
    f32, cache) with the D fresh K/V rows of every layer written per slot
    after the layer loop (rows past the accepted prefix are stale and
    masked by position next round).

    With an int8 cache the fresh K/V round-trip through ``quantize_rows``
    before attention: row d attends row d' < d as the sequential decode
    steps would read it back from the cache, while the diagonal keeps the
    exact row (``k_self``/``v_self``).  The quantized bytes and scales are
    kept, so that the cache write is that same quantization.
    ``attn_sbidx(q, cache, pos, l, k, v, k_self=, v_self=)`` is the verify
    attention over the stacked cache; without it the plain
    ``gqa_attention_spec_batched`` reads the dequantized layer slices.
    Without ``spec_writer`` the rows land through the plain scatter.  On a
    ``mesh`` the verify runs over this rank's heads and, with
    ``data_sharded``, its data shard's slots; the logits are every
    slot's."""
    from fastllama_tpu_torch.ops.attention import gqa_attention_spec_batched
    from fastllama_tpu_torch.ops.kernels.kv_write import spec_write_plain
    if mesh is not None:
        _check_dims(cfg, mesh, tokens.shape[0], data_sharded)
        rows = slot_range(mesh, tokens.shape[0], data_sharded)
        tokens, pos = tokens[rows], pos[rows]
    B, D = tokens.shape
    hs = cfg.head_size
    n_heads, n_kv = local_heads(cfg, mesh)
    proj = _make_proj(mm, mm_idx)
    dev = tokens.device

    x = embed(mesh, params.embedding, tokens.reshape(B * D), compute_dtype)
    positions = pos[:, None] + torch.arange(D, dtype=pos.dtype, device=dev)
    cos, sin = rope_tables(cfg, positions.reshape(-1), compute_dtype)
    cos = cos.reshape(B, 1, D, -1)
    sin = sin.reshape(B, 1, D, -1)

    outs = []
    for l in range(cfg.n_layers):
        h = rmsnorm(x, params.attn_norm[l], cfg.norm_eps)
        q, k, v = _split_qkv(cfg, params, proj, h, l)
        q = apply_rope_half(q.reshape(B, D, n_heads, hs).transpose(1, 2),
                            cos, sin)
        k = apply_rope_half(k.reshape(B, D, n_kv, hs).transpose(1, 2),
                            cos, sin)
        v = v.reshape(B, D, n_kv, hs).transpose(1, 2)

        k_self = v_self = None
        if cache.quantized:
            k_self, v_self = k, v
            kq_, ksc_ = quantize_rows(k)
            vq_, vsc_ = quantize_rows(v)
            k = dequantize_rows(kq_, ksc_, compute_dtype)
            v = dequantize_rows(vq_, vsc_, compute_dtype)
            outs.append((kq_, vq_, ksc_[..., 0], vsc_[..., 0]))
        else:
            outs.append((k, v))

        if attn_sbidx is not None:
            o = attn_sbidx(q, cache, pos, l, k, v, k_self=k_self,
                           v_self=v_self)
        else:
            ck_l, cv_l = _layer_slices(cache, l, compute_dtype)
            o = gqa_attention_spec_batched(q, ck_l[:B], cv_l[:B], k, v, pos,
                                           k_self=k_self, v_self=v_self)
        x = _layer_tail(cfg, params, proj, x,
                        o.transpose(1, 2).reshape(B * D, n_heads * hs), l,
                        mesh)

    stacked = [torch.stack(t).contiguous()
               for t in zip(*outs)]             # (L, B, n_kv, D, ...)
    if cache.quantized:
        kq, vq, ks2, vs2 = stacked
    else:
        kq, vq = (t.to(cache.k.dtype) for t in stacked)
        ks2 = vs2 = None
    (spec_writer or spec_write_plain)(cache, kq, vq, ks2, vs2, pos)

    logits = classify(cfg, mesh, params, x, mm).reshape(B, D, -1)
    return gather_slots(mesh, logits, data_sharded), cache
