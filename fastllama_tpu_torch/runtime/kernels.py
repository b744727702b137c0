"""Kernel selection for the serving engines (port of
``fastllama_tpu/runtime/kernels.py`` and the hook choice of
``fastllama_tpu/runtime/engine.py:116-169``).

One place decides which compute path an engine runs.  With
``EngineConfig.use_pallas`` (the default) it is the kernel wrappers: on a
CUDA device they launch the hand-written kernels or raise, on the CPU they
run their plain versions.  ``use_pallas=False`` asks for the plain PyTorch
versions on any device, the reference path the kernels are held against.
``flash_attention=False`` takes the always-streaming attention functions of
``ops/kernels/attention.py`` for the single-stream ``attn_idx`` and, as the
JAX package does, the plain per-slot attention for the batched
``attn_bidx``.  The speculative verify takes K2s (``attn_sbidx``) and the
K3 scatter (``spec_writer``) whenever the kernels are on, as the JAX
``SpecBatchedEngine`` does; ``use_pallas=False`` leaves ``attn_sbidx``
None, so ``spec_decode_step`` takes the plain ``gqa_attention_spec_batched``,
the JAX package's jnp path.  The same gate holds for the prefix cache's
tail attention K2b (``attn_tail``, on whenever the kernels are, as JAX's
``_get_tail_prefill`` takes it with any Pallas attention) and for K2 with
softmax stats (``attn_stats``, only with ``flash_attention``, JAX's
deferred-KV gate, ``runtime/batching.py:196-209``).  With both None the
engines take the plain copy-and-mask tail and never run a deferred chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from fastllama_tpu_torch.config import EngineConfig


@dataclasses.dataclass
class KernelBundle:
    """The engine compute path: matmul, layer-indexed matmul, the
    single-stream attention on one layer's cache (``attn``) and on the
    stacked cache (``attn_idx``), batched decode attention, the batched
    speculative-verify attention (``attn_sbidx``), the prefix-cache tail
    attention (``attn_tail``), decode attention with softmax stats for
    deferred KV (``attn_stats``) and the cache writers."""

    mm: Callable
    mm_idx: Optional[Callable] = None
    attn: Optional[Callable] = None
    attn_idx: Optional[Callable] = None
    attn_bidx: Optional[Callable] = None
    kv_writer: Optional[Callable] = None
    slot_writer: Optional[Callable] = None
    attn_sbidx: Optional[Callable] = None
    spec_writer: Optional[Callable] = None
    attn_tail: Optional[Callable] = None
    attn_stats: Optional[Callable] = None


def select_kernels(device, ec: EngineConfig, compute_dtype) -> KernelBundle:
    """Pick the compute path for ``device`` and an engine config."""
    from fastllama_tpu_torch.ops.kernels import (attention, flash_decode,
                                                 kv_write, qmm)
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if ec.use_pallas:
        return KernelBundle(
            mm=qmm.make_mm(compute_dtype),
            mm_idx=qmm.make_mm_indexed(compute_dtype),
            attn=attention.make_attn(),
            attn_idx=(flash_decode.make_attn_indexed_flash()
                      if ec.flash_attention
                      else attention.make_attn_indexed()),
            attn_bidx=(flash_decode.make_attn_batched_flash()
                       if ec.flash_attention
                       else attention.make_attn_batched()),
            kv_writer=kv_write.make_kv_writer(),
            slot_writer=kv_write.make_prefill_writer(),
            attn_sbidx=flash_decode.make_attn_spec_batched(),
            spec_writer=kv_write.make_spec_writer(),
            attn_tail=flash_decode.make_attn_tail(),
            attn_stats=(flash_decode.make_attn_batched_flash_stats()
                        if ec.flash_attention else None))
    return KernelBundle(
        mm=qmm.make_mm_plain(compute_dtype),
        mm_idx=qmm.make_mm_indexed_plain(compute_dtype),
        attn=attention.make_attn_plain(),
        attn_idx=flash_decode.make_attn_indexed_plain(),
        attn_bidx=(flash_decode.make_attn_batched_plain()
                   if ec.flash_attention else attention.make_attn_batched()),
        kv_writer=kv_write.decode_write_plain,
        slot_writer=kv_write.prefill_write_plain,
        spec_writer=kv_write.spec_write_plain)
