"""Single-token decode attention over the whole cache (port of
``fastllama_tpu/ops/pallas/attention.py``).

``decode_attention_pallas`` (attention.py:48, one layer's cache),
``decode_attention_pallas_indexed`` (attention.py:110, the layer-stacked
cache) and ``decode_attention_pallas_batched`` (attention.py:178, the
stacked batched cache, one row per slot) compute softmax over cache rows
[0, pos] (per slot: [0, pos[b]]) in f32.  The Pallas kernels
stream all S rows and mask; the port runs them on K2's non-fresh mode
(``csrc/flash_decode.cu``), which reads only the rows the mask keeps — the
same function.  A one-layer cache is viewed as ``(1, 1, n_kv, S, hs)`` and
the stacked one as ``(L, 1, n_kv, S, hs)``: free views, no copy.

``make_attn_batched`` is, as in the JAX package (attention.py:222-239), the
plain per-slot attention over the dequantized layer slices: the engine's
``flash_attention=False`` path for the ``BatchedEngine``.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.  Each wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

from fastllama_tpu_torch.ops.kernels.flash_decode import (attend,
                                                          flash_decode_plain,
                                                          pos_tensor)


def _one_layer(q, k_cache, v_cache):
    n_kv, S, hs = k_cache.shape
    return (q[None], k_cache.view(1, 1, n_kv, S, hs),
            v_cache.view(1, 1, n_kv, S, hs))


def _stacked(q, ck, cv):
    L, n_kv, S, hs = ck.shape
    return q[None], ck.view(L, 1, n_kv, S, hs), cv.view(L, 1, n_kv, S, hs)


def decode_attention_pallas(q, k_cache, v_cache, pos):
    """q (n_heads, 1, hs); caches (n_kv, S, hs) f32/bf16; attends to rows
    <= pos (int or device tensor).  Returns (n_heads, 1, hs) in q.dtype."""
    qb, kb, vb = _one_layer(q, k_cache, v_cache)
    return attend(decode_attention_pallas, qb, kb, vb,
                  pos_tensor(pos, q.device), 0)[0]


def decode_attention_pallas_indexed(q, ck, cv, pos, layer: int):
    """Layer-indexed form: caches are the stacked (L, n_kv, S, hs) buffers,
    read in place at layer ``layer``."""
    qb, kb, vb = _stacked(q, ck, cv)
    return attend(decode_attention_pallas_indexed, qb, kb, vb,
                  pos_tensor(pos, q.device), layer)[0]


def decode_attention_pallas_batched(q, ck, cv, pos, layer: int):
    """Per-slot form: q (B, n_heads, 1, hs); caches (L, B, n_kv, S, hs)
    f32/bf16, read in place at layer ``layer``; slot b attends its rows
    [0, pos[b]] (pos (B,) int32).  Returns (B, n_heads, 1, hs)."""
    return attend(decode_attention_pallas_batched, q, ck, cv, pos, layer)


decode_attention_pallas.launches = 0
decode_attention_pallas_indexed.launches = 0
decode_attention_pallas_batched.launches = 0
decode_attention_pallas.launches_split = 0
decode_attention_pallas_indexed.launches_split = 0
decode_attention_pallas_batched.launches_split = 0


def decode_attention_plain(q, k_cache, v_cache, pos):
    """The plain version of :func:`decode_attention_pallas`."""
    qb, kb, vb = _one_layer(q, k_cache, v_cache)
    return flash_decode_plain(qb, kb, vb, pos_tensor(pos, q.device), 0)[0]


def decode_attention_batched_plain(q, ck, cv, pos, layer: int):
    """The plain version of :func:`decode_attention_pallas_batched`."""
    return flash_decode_plain(q, ck, cv, pos, layer)


def make_attn():
    """attention(q, k_cache, v_cache, pos) for ``models.llama.forward``:
    the kernel for one query row, the plain masked attention for a block."""
    from fastllama_tpu_torch.ops.attention import gqa_attention

    def attn(q, k_cache, v_cache, pos):
        if q.shape[1] == 1:
            return decode_attention_pallas(q, k_cache, v_cache, pos)
        return gqa_attention(q, k_cache, v_cache, pos)

    return attn


def make_attn_plain():
    """The plain versions behind :func:`make_attn`'s interface."""
    from fastllama_tpu_torch.ops.attention import gqa_attention

    def attn(q, k_cache, v_cache, pos):
        if q.shape[1] == 1:
            return decode_attention_plain(q, k_cache, v_cache, pos)
        return gqa_attention(q, k_cache, v_cache, pos)

    return attn


def make_attn_indexed():
    """attn_idx(q, ck_full, cv_full, pos, layer): the kernel for one query
    row, the plain masked attention on the layer's cache for a block."""
    from fastllama_tpu_torch.ops.attention import gqa_attention

    def attn_idx(q, ck, cv, pos, layer):
        if q.shape[1] == 1:
            return decode_attention_pallas_indexed(q, ck, cv, pos, layer)
        return gqa_attention(q, ck[layer], cv[layer], pos)

    return attn_idx


def make_attn_batched():
    """attn_bidx(q, cache, pos, layer, k_new, v_new) for
    ``models.batched.decode_step``: cache rows [0, pos) plus the fresh row
    through the plain ``gqa_attention_decode_batched`` over the layer's
    dequantized slices, as the JAX package's own ``make_attn_batched``."""
    from fastllama_tpu_torch.models.batched import _layer_slices
    from fastllama_tpu_torch.ops.attention import \
        gqa_attention_decode_batched

    def attn_bidx(q, cache, pos, layer, k_new, v_new):
        ck_l, cv_l = _layer_slices(cache, layer, q.dtype)
        B = q.shape[0]
        return gqa_attention_decode_batched(q, ck_l[:B], cv_l[:B], k_new,
                                            v_new, pos)

    return attn_bidx
