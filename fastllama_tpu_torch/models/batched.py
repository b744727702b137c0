"""Slot-batched LLaMA forward, the continuous-batching substrate (part of
``fastllama_tpu/models/batched.py``: the cache, ``prefill_many``,
``decode_step`` with their shared layer halves, and the speculative
verify ``spec_decode_step``).

* :class:`BatchedKVCache` — one preallocated ``(L, B, n_kv, S, hs)`` buffer
  per K and V; slot ``b`` is an independent sequence.  ``dtype=int8``
  stores rows int8 with per-row f32 scales ``(L, B, n_kv, S)``.
* :func:`prefill_many` — N prompts into N slots in one pass; attention is
  block-diagonal (each prompt over its own fresh K/V).
* :func:`prefill_into_slot` — one prompt into one slot at positions
  [0, T): the single-stream engine's fresh prefill at ``pos == 0``.
* :func:`decode_step` — one token for every slot at per-slot positions.
* :func:`spec_decode_step` — D tokens for every slot (pending + drafts)
  in one forward, the batched speculative verify.

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


def _ffn(cfg: ModelConfig, params: LlamaParams, proj, h, l):
    hdim = cfg.hidden_dim
    if params.w3 is None:                      # fused gate|up
        g13 = proj(h, params.w1, l)
        hd = swiglu(g13[:, :hdim], g13[:, hdim:])
    else:
        hd = swiglu(proj(h, params.w1, l), proj(h, params.w3, l))
    return proj(hd, params.w2, l)


def _make_proj(mm: Callable, mm_idx: Optional[Callable]):
    """proj(h, w_stacked, layer): the layer-indexed matmul when given,
    else ``mm`` on the layer's view."""
    if mm_idx is not None:
        return mm_idx
    return lambda h, w, l: mm(h, w[l])


def _decode_layer_qkv(cfg: ModelConfig, params: LlamaParams, proj,
                      x, l, attn_norm_l, cos, sin):
    """Decode-layer front half: norm -> QKV -> per-head reshape -> rope.
    x (B, dim); returns q (B, H, hs), k/v (B, n_kv, hs)."""
    B = x.shape[0]
    hs, n_heads, n_kv = cfg.head_size, cfg.n_heads, cfg.n_kv_heads
    h = rmsnorm(x, attn_norm_l, cfg.norm_eps)
    q, k, v = _split_qkv(cfg, params, proj, h, l)
    q = apply_rope_half(q.reshape(B, n_heads, hs), cos[:, None], sin[:, None])
    k = apply_rope_half(k.reshape(B, n_kv, hs), cos[:, None], sin[:, None])
    return q, k, v.reshape(B, n_kv, hs)


def _decode_layer_tail(cfg: ModelConfig, params: LlamaParams, proj,
                       x, o, l, ffn_norm_l):
    """Decode-layer back half: output projection + residual, then the FFN
    block.  o (B, H*hs)."""
    x = x + proj(o, params.wo, l)
    h = rmsnorm(x, ffn_norm_l, cfg.norm_eps)
    return x + _ffn(cfg, params, proj, h, l)


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


def _layer_slices(cache: BatchedKVCache, l: int, compute_dtype):
    """Dequantized (B, n_kv, S, hs) K/V of layer ``l``: the attention
    fallback's read path (a copy; the kernel reads in place)."""
    if cache.quantized:
        return (dequantize_rows(cache.k[l], cache.k_scale[l][..., None],
                                compute_dtype),
                dequantize_rows(cache.v[l], cache.v_scale[l][..., None],
                                compute_dtype))
    return cache.k[l], cache.v[l]


def prefill_many(cfg: ModelConfig, params: LlamaParams,
                 tokens: torch.Tensor, lengths: torch.Tensor,
                 slots: torch.Tensor, cache: BatchedKVCache, *,
                 mm: Callable = qmatmul,
                 mm_idx: Optional[Callable] = None,
                 slot_writer: Optional[Callable] = None,
                 compute_dtype=torch.float32
                 ) -> Tuple[torch.Tensor, BatchedKVCache]:
    """Prefill N prompts into N slots in one pass.

    tokens (N, T) at positions [0, T); lengths (N,); slots (N,) int32.
    Matmuls see an (N*T, dim) activation; attention is block-diagonal.
    Duplicate slot ids (N padded by repeating a request) write identical
    rows.  Returns (last-valid-token logits (N, vocab) f32, cache)."""
    N, T = tokens.shape
    hs, n_heads, n_kv = cfg.head_size, cfg.n_heads, cfg.n_kv_heads
    proj = _make_proj(mm, mm_idx)
    dev = tokens.device

    x = embed_tokens(params.embedding, tokens.reshape(N * T), compute_dtype)
    cos, sin = rope_tables(cfg, torch.arange(T, device=dev), compute_dtype)
    kv_dtype = cache.k.dtype if not cache.quantized else compute_dtype

    ks, vs = [], []
    for l in range(cfg.n_layers):
        h = rmsnorm(x, params.attn_norm[l], cfg.norm_eps)
        q, k, v = _split_qkv(cfg, params, proj, h, l)
        q = q.reshape(N, T, n_heads, hs).transpose(1, 2)
        k = k.reshape(N, T, n_kv, hs).transpose(1, 2)
        v = v.reshape(N, T, n_kv, hs).transpose(1, 2)
        q = apply_rope_half(q, cos, sin)
        k = apply_rope_half(k, cos, sin)

        o = gqa_attention(q, k, v, 0)             # each prompt over itself
        o = o.transpose(1, 2).reshape(N * T, n_heads * hs)
        x = x + proj(o, params.wo, l)

        h = rmsnorm(x, params.ffn_norm[l], cfg.norm_eps)
        x = x + _ffn(cfg, params, proj, h, l)
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
        for n in range(N):
            _write_slot(cache, ks[:, n], vs[:, n], int(slots[n]))

    x = rmsnorm(x, params.out_norm, cfg.norm_eps).reshape(N, T, -1)
    rows = x[torch.arange(N, device=dev), lengths.to(dev, torch.long) - 1]
    logits = mm(rows, params.classifier)                   # (N, V)
    return logits.to(torch.float32), cache


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


def decode_step(cfg: ModelConfig, params: LlamaParams, tokens: torch.Tensor,
                pos: torch.Tensor, cache: BatchedKVCache, *,
                mm: Callable = qmatmul,
                mm_idx: Optional[Callable] = None,
                attn_bidx: Optional[Callable] = None,
                kv_writer: Optional[Callable] = None,
                compute_dtype=torch.float32
                ) -> Tuple[torch.Tensor, BatchedKVCache]:
    """One decode token for every slot: tokens (B,) at per-slot positions
    pos (B,) int32.  Returns (logits (B, vocab) f32, cache).

    ``attn_bidx(q, cache, pos, l, k_new, v_new)`` is the batched
    layer-indexed decode attention over the stacked cache; without it the
    fallback dequantizes layer ``l`` and runs the plain attention."""
    B = tokens.shape[0]
    hs, n_heads = cfg.head_size, cfg.n_heads
    proj = _make_proj(mm, mm_idx)

    x = embed_tokens(params.embedding, tokens, compute_dtype)       # (B, dim)
    cos, sin = rope_tables(cfg, pos, compute_dtype)                 # (B, hs/2)

    ks, vs = [], []
    for l in range(cfg.n_layers):
        q, k, v = _decode_layer_qkv(cfg, params, proj, x, l,
                                    params.attn_norm[l], cos, sin)
        if attn_bidx is not None:
            o = attn_bidx(q, cache, pos, l, k, v)                   # (B, H, hs)
        else:
            ck_l, cv_l = _layer_slices(cache, l, compute_dtype)
            o = gqa_attention_decode_batched(q, ck_l[:B], cv_l[:B], k, v,
                                             pos)
        x = _decode_layer_tail(cfg, params, proj, x,
                               o.reshape(B, n_heads * hs), l,
                               params.ffn_norm[l])
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

    x = rmsnorm(x, params.out_norm, cfg.norm_eps)
    logits = mm(x, params.classifier)                               # (B, V)
    return logits.to(torch.float32), cache


def spec_decode_step(cfg: ModelConfig, params: LlamaParams,
                     tokens: torch.Tensor, pos: torch.Tensor,
                     cache: BatchedKVCache, *,
                     mm: Callable = qmatmul,
                     mm_idx: Optional[Callable] = None,
                     attn_sbidx: Optional[Callable] = None,
                     spec_writer: Optional[Callable] = None,
                     compute_dtype=torch.float32
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
    Without ``spec_writer`` the rows land through the plain scatter."""
    from fastllama_tpu_torch.ops.attention import gqa_attention_spec_batched
    from fastllama_tpu_torch.ops.kernels.kv_write import spec_write_plain
    B, D = tokens.shape
    hs, n_heads, n_kv = cfg.head_size, cfg.n_heads, cfg.n_kv_heads
    proj = _make_proj(mm, mm_idx)
    dev = tokens.device

    x = embed_tokens(params.embedding, tokens.reshape(B * D), compute_dtype)
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
        o = o.transpose(1, 2).reshape(B * D, n_heads * hs)
        x = x + proj(o, params.wo, l)

        h = rmsnorm(x, params.ffn_norm[l], cfg.norm_eps)
        x = x + _ffn(cfg, params, proj, h, l)

    stacked = [torch.stack(t).contiguous()
               for t in zip(*outs)]             # (L, B, n_kv, D, ...)
    if cache.quantized:
        kq, vq, ks2, vs2 = stacked
    else:
        kq, vq = (t.to(cache.k.dtype) for t in stacked)
        ks2 = vs2 = None
    (spec_writer or spec_write_plain)(cache, kq, vq, ks2, vs2, pos)

    x = rmsnorm(x, params.out_norm, cfg.norm_eps)
    logits = mm(x, params.classifier)                      # (B*D, V)
    return logits.reshape(B, D, -1).to(torch.float32), cache
