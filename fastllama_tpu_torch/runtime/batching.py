"""Continuous batching: a slot-based scheduler over the batched forward
(port of ``fastllama_tpu/runtime/batching.py``).

* :class:`Request` — one generation job (prompt, sampling params, stream
  callback, collected output).
* :class:`BatchedEngine` — owns ``B`` cache slots.  Each :meth:`step`
  admits queued requests into free slots (one ``prefill_many`` call per
  prefill bucket wave) and then runs ONE decode chunk of K tokens for ALL
  slots.  A chunk is a Python loop of ``decode_step`` + sampling; tokens
  stay on the device and the host fetches them once per chunk.  Requests
  join and leave at chunk boundaries; idle slots decode garbage that is
  discarded on the host.
* ``EngineConfig.prefix_cache``: an admission whose prompt shares a
  16-token-aligned prefix with a live slot copies that donor's K/V rows
  and prefills only its tail (K2b), one call a hit, hits first.
* ``EngineConfig.deferred_kv``: a chunk of 2 <= K <= 32 steps stages its
  fresh rows outside the cache (``decode_step_deferred``, K2 with softmax
  stats) and lands them with one ``spec_write`` at its end.

Slot-state invariants (host mirrors device exactly):
  ``pos[b]``  = number of K/V rows valid in slot b's cache,
  ``pending[b]`` = last sampled token, not yet written to the cache; the
  next decode step writes its K/V row at ``pos[b]`` and samples the
  following token.  Positions advance ``min(pos+1, S-1)`` per step; idle
  slots park at 0.

The KV cache is updated in place (the JAX engine donates its buffers to
the same effect).  Weights are INT8, INT16 or INT4 (split-half packed
where it packs, through K1p; int8-held otherwise; mixed layouts stay
unfused).

``EngineConfig.mesh`` ('data=2,model=4', with or without ``spmd_kernels``)
serves on a mesh of ranks (``parallel/``): every rank runs this scheduler
on the same submissions, in lockstep, and keeps its shard of the weights
and its block of the cache (B/dp slots, n_kv/mp heads).  Every step of
``models/batched.py`` runs per rank, given the mesh, with the same
kernels (``parallel/spmd_step.py`` holds the collectives it adds); the
logits are gathered, so every rank samples all B slots with the same
per-slot generators and emits the same tokens.  A deadline's expiry is
rank 0's on every rank.  The JAX package has a second mesh path (GSPMD
over plain jnp, its default); the port has this one.  On more than one
rank the weights stay unfused and deferred KV is off, as in JAX.

``FASTLLAMA_PIPELINE=1`` turns on dispatch-ahead decode
(:meth:`BatchedEngine._pipelined_stretch`, ``batching.py:848-923``):
while the schedule is sure (nothing queued, every live slot has at least
two full chunks of budget and room) chunk k+1 is queued from chunk k's
last token row, still on the device, before the host reads chunk k.
Its decisions come from tokens and budgets only, so on a mesh every rank
takes the same ones.
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fastllama_tpu_torch.config import (EngineConfig, ModelConfig,
                                        resolve_scale_dtype)
from fastllama_tpu_torch.device import resolve_device, torch_dtype
from fastllama_tpu_torch.loaders.tokenizer import StreamDecoder, Tokenizer
from fastllama_tpu_torch.models.batched import (BatchedKVCache,
                                                copy_slot_prefix, decode_step,
                                                decode_step_deferred,
                                                land_staged, make_staged,
                                                prefill_into_slot_at,
                                                prefill_many)
from fastllama_tpu_torch.models.llama import LlamaParams, fuse_params
from fastllama_tpu_torch.ops import sampling
from fastllama_tpu_torch.quant.groupquant import compress_scales

DEFAULT_CHUNK = 16
_ROWS_CAP = 2048      # prefill rows (N * bucket) per admission wave
PIPE = 2              # chunks in flight in a dispatch-ahead stretch


@dataclasses.dataclass
class Request:
    """One generation job tracked through the scheduler."""

    id: int
    prompt_tokens: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    topp: float = 0.9
    seed: int = 128391297
    callback: Optional[Callable[[str, int], object]] = None
    stop_tokens: Tuple[int, ...] = ()
    # QoS: higher priority admits first (FIFO within a class); a nonzero
    # deadline rejects the request if it is still queued deadline_s seconds
    # after submit
    priority: int = 0
    deadline_s: float = 0.0

    # filled by the engine
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False
    submit_s: float = 0.0
    first_token_s: float = 0.0
    finish_s: float = 0.0
    _prev_token: int = -1
    _stream: object = None

    @property
    def ttft(self) -> float:
        return self.first_token_s - self.submit_s

    def text(self, tokenizer: Tokenizer) -> str:
        return tokenizer.decode(self.output_tokens)


@dataclasses.dataclass
class BatchStats:
    """Aggregate serving statistics."""

    completed: int = 0
    total_prompt_tokens: int = 0
    total_output_tokens: int = 0    # all emitted tokens (incl. prefill-sampled)
    decode_tokens: int = 0          # tokens produced by decode chunks only
    decode_s: float = 0.0
    prefill_s: float = 0.0
    prefix_hits: int = 0            # admissions served from the prefix cache
    prefix_rows_reused: int = 0     # K/V rows copied instead of prefilled
    rejected: int = 0

    @property
    def aggregate_tps(self) -> float:
        """Decode throughput: decode-produced tokens over decode wall time
        (each request's first token is sampled during prefill)."""
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0


def _refuse_unported(ec: EngineConfig) -> None:
    if ec.pallas_interpret:
        raise NotImplementedError("EngineConfig.pallas_interpret is not "
                                  "ported (TPU interpret mode has no "
                                  "counterpart)")


def open_mesh(ec: EngineConfig, device):
    """(mesh, the rank's device) for ``ec.mesh``, or (None, the device)
    without one.  ``device=None`` on a mesh is the device
    ``parallel.distributed.initialize`` gave the rank (the card without a
    process group).  ``spmd_kernels`` alone asks for no mesh, as in the
    JAX package."""
    if not ec.mesh:
        return None, resolve_device(device)
    from fastllama_tpu_torch.parallel.distributed import rank_device
    from fastllama_tpu_torch.parallel.sharding import make_mesh
    mesh = make_mesh(ec.mesh)
    if device is None:
        device = rank_device()
    return mesh, resolve_device(device)


def to_host(t: torch.Tensor):
    """Queue the copy of a device tensor to pinned host memory and mark it
    with an event: (host tensor, event or None).  The host waits on the
    event, not on the whole stream, so later launches stay queued."""
    if t.device.type != "cuda":
        return t.clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _fold_seed(seed: int, req_id: int) -> int:
    """A request's decode-noise seed from its seed and id, so draws do not
    depend on which slot or neighbours it gets."""
    return (int(seed) * 1_000_003 + int(req_id) + 1) & 0x7FFF_FFFF_FFFF_FFFF


class BatchedEngine:
    """Continuous-batching engine over ``max_batch_size`` KV-cache slots.

    ``device=None`` means ``"cuda"``; without a card it raises unless
    ``device="cpu"`` is passed.  ``sharded``: on a mesh, ``params`` are
    this rank's shard already (the load entry points build them so)."""

    def __init__(self, config: ModelConfig, params: LlamaParams,
                 tokenizer: Tokenizer,
                 engine_config: Optional[EngineConfig] = None,
                 decode_chunk: int = DEFAULT_CHUNK, device=None, *,
                 sharded: bool = False):
        ec = engine_config or EngineConfig()
        _refuse_unported(ec)
        if ec.max_seq_len:
            config = config.replace(max_seq_len=min(config.max_seq_len,
                                                    ec.max_seq_len))
        config.validate()
        self.B = max(1, ec.max_batch_size)
        self.mesh, self.device = self._open_mesh(ec, device)
        if self.mesh is not None:
            from fastllama_tpu_torch.parallel.sharding import shard_params
            from fastllama_tpu_torch.parallel.spmd_step import _check_dims
            _check_dims(config, self.mesh, self.B, True)
            if not sharded:
                params = shard_params(config, self.mesh, params,
                                      self.device)
            if self.mesh.size > 1:
                # the concatenated layouts straddle the shard boundaries;
                # deferred KV stays off on the mesh path (batching.py:196)
                ec = dataclasses.replace(ec, fuse_weights=False,
                                         deferred_kv=False)
        else:
            params = params.to(self.device)
        if ec.fuse_weights and not ec.parity_mode:
            try:
                params = fuse_params(config, params)
            except ValueError:          # mixed quant layouts: keep unfused
                ec = dataclasses.replace(ec, fuse_weights=False)
        scale_dt = resolve_scale_dtype(ec, config, batched=True)
        if scale_dt != "float32" and not ec.parity_mode:
            params = compress_scales(params, torch_dtype(scale_dt))
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.ec = ec
        self.decode_chunk = decode_chunk
        self.kv_dtype = torch_dtype(ec.kv_dtype)
        self._cdt = torch_dtype(ec.compute_dtype)

        from fastllama_tpu_torch.runtime.kernels import select_kernels
        self.kernels = select_kernels(self.device, ec, self._cdt)

        self.cache = self.new_cache()
        # per-slot noise generators (reseeded per request at admission)
        self._gens = []
        for b in range(self.B):
            g = torch.Generator(device=self.device)
            g.manual_seed(b)
            self._gens.append(g)

        S = config.max_seq_len
        self.S = S
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self.pos = np.zeros(self.B, np.int32)
        self.pending = np.zeros(self.B, np.int32)
        self.temps = np.zeros(self.B, np.float32)
        self.topps = np.ones(self.B, np.float32)

        self.queue = deque()
        self.stats = BatchStats()
        self._next_id = 0

        # prefix cache: (plen, hash of the prefix) -> donor slot.  A donor's
        # rows [0, plen) stay fixed while it is live (decode writes at
        # pos >= plen); its entries go when the slot is freed (an idle
        # slot's decode writes row 0)
        self._prefix_block = 16
        self._prefix_index = {}
        self._slot_prefix_keys = [[] for _ in range(self.B)]
        self._prefix_enabled = bool(ec.prefix_cache)
        # deferred staged-KV chunks: K2 with stats on (flash attention and
        # the kernels), as JAX gates them (batching.py:193-209)
        self._deferred_ok = bool(ec.deferred_kv and self.mesh is None
                                 and self.kernels.attn_stats is not None)
        self.deferred_chunks = 0
        # chunks run by dispatch-ahead stretches (FASTLLAMA_PIPELINE=1)
        self.pipelined_chunks = 0

    @staticmethod
    def load(ckpt_path: str, tokenizer_path: str = "",
             file_type=None, qtype=None,
             engine_config: Optional[EngineConfig] = None,
             decode_chunk: int = DEFAULT_CHUNK,
             device=None) -> "BatchedEngine":
        """A serving engine on a checkpoint file (see ``Engine.load``)."""
        from fastllama_tpu_torch.loaders.registry import (FileType,
                                                          resolve_and_build)
        cfg, params, tok = resolve_and_build(
            ckpt_path, tokenizer_path, file_type or FileType.UNKNOWN, qtype,
            engine_config, device)
        return BatchedEngine(cfg, params, tok, engine_config, decode_chunk,
                             device, sharded=bool(engine_config
                                                  and engine_config.mesh))

    def _open_mesh(self, ec: EngineConfig, device):
        """(the mesh the steps run on, the rank's device)."""
        return open_mesh(ec, device)

    # -- compute ---------------------------------------------------------------

    def new_cache(self) -> BatchedKVCache:
        """An empty slot cache: on a mesh, this rank's block of it."""
        if self.mesh is None:
            return BatchedKVCache.create(self.config, self.B,
                                         dtype=self.kv_dtype,
                                         device=self.device)
        from fastllama_tpu_torch.parallel.sharding import new_slot_cache
        return new_slot_cache(self.config, self.mesh, self.B, self.kv_dtype,
                              self.device)

    def decode(self, tok: torch.Tensor, pos: torch.Tensor,
               cache: BatchedKVCache):
        """One decode step of every slot on ``cache`` (the engine's own, or
        one of the same shape): (logits (B, vocab) f32, cache)."""
        kb = self.kernels
        return decode_step(
            self.config, self.params, tok, pos, cache, mm=kb.mm,
            mm_idx=kb.mm_idx, attn_bidx=kb.attn_bidx,
            kv_writer=kb.kv_writer, compute_dtype=self._cdt, mesh=self.mesh,
            data_sharded=True)

    def _bucket(self, n: int) -> int:
        for b in self.ec.prefill_buckets:
            if b >= n and b <= self.S:
                return b
        return self.S

    def _sample(self, logits, gens, temps: np.ndarray, topps: np.ndarray):
        if np.all(temps <= 0.0):
            return sampling.greedy(logits)
        return sampling.sample_batched(
            logits, gens,
            torch.as_tensor(temps, device=self.device),
            torch.as_tensor(topps, device=self.device))

    def _prefill(self, toks_np, lens, slots_np, temps, topps, seeds):
        """One admission wave on the device; returns first tokens (host)."""
        kb = self.kernels
        dev = self.device
        args = (torch.as_tensor(toks_np, device=dev),
                torch.as_tensor(lens, device=dev),
                torch.as_tensor(slots_np, device=dev), self.cache)
        logits, self.cache = prefill_many(
            self.config, self.params, *args, mm=kb.mm, mm_idx=kb.mm_idx,
            slot_writer=kb.slot_writer, compute_dtype=self._cdt,
            mesh=self.mesh, data_sharded=True)
        gens = []
        if not np.all(temps <= 0.0):
            for s in seeds:         # the first draw uses the request's seed
                g = torch.Generator(device=dev)
                g.manual_seed(int(s))
                gens.append(g)
        return self._sample(logits, gens, temps, topps).cpu().numpy()

    def _device_io(self):
        """(pending, pos, temps, topps) of every slot, uploaded."""
        return tuple(torch.as_tensor(a, device=self.device) for a in
                     (self.pending, self.pos, self.temps, self.topps))

    def _dispatch_chunk(self, K: int, greedy_only: bool,
                        io=None) -> torch.Tensor:
        """K decode steps for every slot; returns the (K, B) token tensor
        on the device (no host sync inside the chunk).  ``io``: the
        chunk's (pending, pos, temps, topps) as device tensors (a
        dispatch-ahead stretch passes the previous chunk's last token row
        and positions); None uploads the host's.  With
        ``deferred_kv`` a chunk of 2 <= K <= 32 steps (``batching.py:794``;
        past 32 the staged re-reads outgrow the one landing, and 1 step
        has nothing to amortize) stages its rows at the fixed chunk-start
        positions and lands them once at its end; the host keeps
        max(pos) + K <= S - 1 (``_plan_chunk``).  Both kinds draw from
        ``_gens`` in the same order."""
        kb = self.kernels
        dev = self.device
        tok, pos, temps, topps = io if io is not None else self._device_io()
        toks = torch.empty((K, self.B), dtype=torch.long, device=dev)
        deferred = self._deferred_ok and 2 <= K <= 32
        if deferred:
            staged = make_staged(self.config, self.cache, self.B, K)
        for k in range(K):
            if deferred:
                logits, staged = decode_step_deferred(
                    self.config, self.params, tok, pos, k, staged,
                    self.cache, mm=kb.mm, mm_idx=kb.mm_idx,
                    attn_stats=kb.attn_stats, compute_dtype=self._cdt)
            else:
                logits, self.cache = self.decode(tok, pos, self.cache)
                pos = torch.clamp(pos + 1, max=self.S - 1)
            if greedy_only:
                tok = sampling.greedy(logits)
            else:
                tok = sampling.sample_batched(logits, self._gens, temps,
                                              topps)
            toks[k] = tok
        if deferred:
            land_staged(self.cache, staged, pos, kb.spec_writer)
            self.deferred_chunks += 1
        return toks

    # -- scheduling ------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 256,
               temperature: float = 0.0, topp: float = 0.9,
               seed: int = 128391297,
               stop_tokens: Optional[Sequence[int]] = None,
               callback=None, priority: int = 0,
               deadline_s: float = 0.0) -> Request:
        """Queue a generation job; returns the live Request handle.

        ``priority``: admission order class (higher first, FIFO within);
        ``deadline_s``: > 0 rejects the request if still queued that many
        seconds after submit (``req.rejected``)."""
        tokens = (self.tokenizer.encode(prompt, add_bos=True)
                  if isinstance(prompt, str) else list(prompt))
        if not tokens:
            raise ValueError("empty prompt")
        if len(tokens) >= self.S:
            raise ValueError(f"prompt too long: {len(tokens)} >= {self.S}")
        if stop_tokens is None:
            stop_tokens = (0, self.tokenizer.eos_token_id)
        req = Request(
            id=self._next_id, prompt_tokens=tokens,
            max_new_tokens=min(max_new_tokens, self.S - len(tokens) - 1),
            temperature=temperature, topp=topp, seed=seed,
            callback=callback, stop_tokens=tuple(int(t) for t in stop_tokens),
            priority=priority, deadline_s=deadline_s,
            submit_s=time.perf_counter())
        self._next_id += 1
        self.queue.append(req)
        return req

    def _late(self) -> set:
        """The ids of queued requests past their deadline: a clock's
        reading, so on a mesh every rank takes rank 0's."""
        if not any(r.deadline_s > 0 for r in self.queue):
            return set()
        now = time.perf_counter()
        late = {r.id for r in self.queue
                if r.deadline_s > 0 and now - r.submit_s > r.deadline_s}
        if self.mesh is not None:
            from fastllama_tpu_torch.parallel.distributed import agree
            late = agree(late)
        return late

    def _qos_queue_pass(self) -> None:
        """Deadline-expire queued requests, then order the queue by
        priority class (stable: FIFO within a class)."""
        late = self._late()
        if late:
            now = time.perf_counter()
            kept = deque()
            for r in self.queue:
                if r.id in late:
                    r.rejected = r.done = True
                    r.finish_s = now
                    self.stats.rejected += 1
                else:
                    kept.append(r)
            self.queue = kept
        if any(r.priority for r in self.queue):
            self.queue = deque(sorted(self.queue,
                                      key=lambda r: -r.priority))

    def _free_slots(self) -> List[int]:
        return [b for b, r in enumerate(self.slot_req) if r is None]

    def _live_slots(self) -> List[int]:
        return [b for b, r in enumerate(self.slot_req) if r is not None]

    def _emit(self, slot: int, tok: int, from_decode: bool = True) -> None:
        """Append one accepted token to slot's request; free the slot on a
        stop token, the length limit, or a callback returning False."""
        req = self.slot_req[slot]
        if not req.output_tokens:
            req.first_token_s = time.perf_counter()
        req.output_tokens.append(tok)
        self.stats.total_output_tokens += 1
        if from_decode:
            self.stats.decode_tokens += 1
        cancelled = False
        # stop tokens are recorded but not streamed
        if req.callback is not None and tok not in req.stop_tokens:
            if req._stream is None:
                req._stream = StreamDecoder(self.tokenizer)
            text = req._stream.piece(tok, req._prev_token)
            cancelled = req.callback(text, tok) is False
        req._prev_token = tok
        if cancelled or tok in req.stop_tokens \
                or len(req.output_tokens) >= req.max_new_tokens:
            req.done = True
            req.finish_s = time.perf_counter()
            self.slot_req[slot] = None
            # park the idle slot at position 0: the flash-decode kernel
            # then reads no cache row for it.  An idle slot's decode writes
            # its row 0, so its prefix-cache entries go
            self._prefix_release(slot)
            self.pos[slot] = 0
            self.pending[slot] = 0
            self.stats.completed += 1

    def _admit_pending(self) -> None:
        """Admit queued requests into free slots, one prefill per bucket
        wave (N padded to a power of two by repeating the last request —
        duplicate slot writes are identical, so harmless)."""
        self._qos_queue_pass()
        free = self._free_slots()
        take = min(len(free), len(self.queue))
        if take == 0:
            return
        items = [(self.queue.popleft(), slot) for slot in free[:take]]

        # prefix-cache hits first: one tail call each
        if self._prefix_enabled:
            rest = []
            for req, slot in items:
                donor, plen = self._prefix_lookup(req.prompt_tokens)
                if donor is not None:
                    self._admit_prefix_hit(req, slot, donor, plen)
                else:
                    rest.append((req, slot))
            items = rest

        groups = {}
        for req, slot in items:
            groups.setdefault(self._bucket(len(req.prompt_tokens)),
                              []).append((req, slot))
        waves = []
        for bucket, grp in sorted(groups.items()):
            # a power-of-two wave size, so padding never passes the cap
            per = max(1, _ROWS_CAP // bucket)
            per = 1 << (per.bit_length() - 1)
            for i in range(0, len(grp), per):
                waves.append((bucket, grp[i:i + per]))
        for bucket, grp in waves:
            self._run_wave(bucket, grp)

    def _run_wave(self, bucket: int, grp) -> None:
        """One admission wave: the (request, slot) pairs of ``grp``, whose
        prompts fit ``bucket``, prefilled in one call and admitted."""
        t0 = time.perf_counter()
        N = len(grp)
        Np = 1 << (N - 1).bit_length()
        grp_p = grp + [grp[-1]] * (Np - N)
        toks_np = np.zeros((Np, bucket), np.int64)
        lens = np.zeros(Np, np.int64)
        slots_np = np.zeros(Np, np.int32)
        temps = np.zeros(Np, np.float32)
        topps = np.ones(Np, np.float32)
        seeds = np.zeros(Np, np.int64)
        for i, (req, slot) in enumerate(grp_p):
            toks_np[i, :len(req.prompt_tokens)] = req.prompt_tokens
            lens[i] = len(req.prompt_tokens)
            slots_np[i] = slot
            temps[i] = req.temperature
            topps[i] = req.topp
            seeds[i] = req.seed
        firsts = self._prefill(toks_np, lens, slots_np, temps, topps, seeds)
        for req, slot in grp:
            self._gens[slot].manual_seed(_fold_seed(req.seed, req.id))
        self.stats.prefill_s += time.perf_counter() - t0
        for i, (req, slot) in enumerate(grp):
            self.slot_req[slot] = req
            self.pos[slot] = lens[i]
            self.temps[slot] = req.temperature
            self.topps[slot] = req.topp
            self.pending[slot] = int(firsts[i])
            req._prev_token = req.prompt_tokens[-1]
            self.stats.total_prompt_tokens += int(lens[i])
            if self._prefix_enabled:
                self._prefix_register(slot, req.prompt_tokens)
            self._emit(slot, int(firsts[i]), from_decode=False)

    def _admit_prefix_hit(self, req: Request, slot: int, donor: int,
                          plen: int) -> None:
        """Admission through the prefix cache (``batching.py:718-752``):
        the donor's rows [0, plen) copied into ``slot``, only the prompt's
        tail prefilled at ``plen`` (padded to its bucket), its first token
        sampled."""
        kb = self.kernels
        dev = self.device
        t0 = time.perf_counter()
        tail = req.prompt_tokens[plen:]
        padded = np.zeros(self._bucket(len(tail)), np.int64)
        padded[:len(tail)] = tail
        toks = torch.as_tensor(padded, device=dev)
        copy_slot_prefix(self.cache, donor, slot, plen, self.mesh,
                         data_sharded=True)
        logits, self.cache = prefill_into_slot_at(
            self.config, self.params, toks, len(tail), slot, plen,
            self.cache, mm=kb.mm, mm_idx=kb.mm_idx, attn_tail=kb.attn_tail,
            slot_writer=kb.slot_writer, compute_dtype=self._cdt,
            mesh=self.mesh, data_sharded=True)
        # the first draw uses the request's own seed, as a prefill's does
        gens = []
        if req.temperature > 0.0:
            g = torch.Generator(device=dev)
            g.manual_seed(int(req.seed))
            gens.append(g)
        first = int(self._sample(logits[None], gens,
                                 np.array([req.temperature], np.float32),
                                 np.array([req.topp], np.float32))[0])
        self._gens[slot].manual_seed(_fold_seed(req.seed, req.id))
        self.stats.prefill_s += time.perf_counter() - t0
        self.stats.prefix_hits += 1
        self.stats.prefix_rows_reused += plen
        self.slot_req[slot] = req
        self.pos[slot] = len(req.prompt_tokens)
        self.temps[slot] = req.temperature
        self.topps[slot] = req.topp
        self.pending[slot] = first
        req._prev_token = req.prompt_tokens[-1]
        self.stats.total_prompt_tokens += len(req.prompt_tokens)
        self._prefix_register(slot, req.prompt_tokens)
        self._emit(slot, first, from_decode=False)

    # -- prefix cache ----------------------------------------------------------

    @staticmethod
    def _prefix_hashes(prompt: List[int], BL: int) -> List[int]:
        """A rolling hash for each BL-token prefix level.  Python's hash of
        a tuple of ints does not depend on PYTHONHASHSEED; a collision
        costs a wasted compare, never a wrong admission (hits are checked
        token by token)."""
        hashes, h = [], 0
        for l in range(BL, len(prompt) + 1, BL):
            h = hash((h, tuple(prompt[l - BL:l])))
            hashes.append(h)
        return hashes

    def _prefix_register(self, slot: int, prompt: List[int]) -> None:
        BL = self._prefix_block
        for i, h in enumerate(self._prefix_hashes(prompt, BL)):
            key = ((i + 1) * BL, h)
            # the first registration wins: a shared prefix stays with the
            # donor that holds it longest
            if key not in self._prefix_index:
                self._prefix_index[key] = slot
                self._slot_prefix_keys[slot].append(key)

    def _prefix_release(self, slot: int) -> None:
        for key in self._slot_prefix_keys[slot]:
            if self._prefix_index.get(key) == slot:
                del self._prefix_index[key]
        self._slot_prefix_keys[slot] = []

    def _prefix_lookup(self, prompt: List[int]):
        """(donor slot, plen): the longest block-aligned live prefix
        strictly shorter than the prompt (a tail token must remain to give
        the first logits), confirmed token by token against the donor's
        request; (None, 0) without one.  A candidate counts only if
        plen + bucket(tail) <= S: the tail writes a whole bucket of rows
        from plen (``batching.py:398-415``)."""
        BL = self._prefix_block
        hashes = self._prefix_hashes(prompt, BL)
        top = (len(prompt) - 1) // BL
        for i in range(min(top, len(hashes)) - 1, -1, -1):
            l = (i + 1) * BL
            slot = self._prefix_index.get((l, hashes[i]))
            if slot is not None:
                donor = self.slot_req[slot]
                if donor is not None and \
                        donor.prompt_tokens[:l] == prompt[:l] and \
                        l + self._bucket(len(prompt) - l) <= self.S:
                    return slot, l
        return None, 0

    def _plan_chunk(self, live):
        """(K, greedy_only): the exact chunk length — no longer than the
        decode chunk, the shortest slot's room, or the longest remaining
        budget; capped at ``qos_chunk`` while requests wait."""
        K = min(self.decode_chunk,
                min(self.S - 1 - int(self.pos[b]) for b in live),
                max(req.max_new_tokens - len(req.output_tokens)
                    for req in (self.slot_req[b] for b in live)))
        if self.ec.qos_chunk and self.queue:
            K = min(K, self.ec.qos_chunk)
        K = max(K, 1)
        greedy_only = all(self.slot_req[b].temperature <= 0.0 for b in live)
        return K, greedy_only

    def _apply_chunk(self, toks_np: np.ndarray, K: int, live) -> None:
        """Host bookkeeping for one consumed chunk: mirror the device
        position arithmetic, park idle slots, emit tokens."""
        self.pos = np.minimum(self.pos + K, self.S - 1).astype(np.int32)
        self.pending = toks_np[K - 1].astype(np.int32)
        for b in range(self.B):
            if self.slot_req[b] is None:
                self.pos[b] = 0
                self.pending[b] = 0
        for b in live:
            for k in range(K):
                if self.slot_req[b] is None:
                    break                               # finished mid-chunk
                self._emit(b, int(toks_np[k, b]))

    def step(self) -> bool:
        """Admit queued requests, run one decode chunk.  Returns True while
        any work (live or queued) remains."""
        self._admit_pending()
        live = self._live_slots()
        if not live:
            return bool(self.queue)
        self._plain_chunk(live)
        return bool(self.queue) or bool(self._live_slots())

    def _plain_chunk(self, live, plan=None) -> float:
        """Plan (unless ``plan`` gives (K, greedy_only)), run and apply one
        decode chunk; returns its seconds (from the first launch to the
        chunk's one fetch), which are also added to ``stats.decode_s``."""
        K, greedy_only = plan or self._plan_chunk(live)
        t0 = time.perf_counter()
        toks_np = self._dispatch_chunk(K, greedy_only).cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats.decode_s += dt
        self._apply_chunk(toks_np, K, live)
        return dt

    def _pipelined_stretch(self) -> None:
        """Dispatch-ahead decode (``FASTLLAMA_PIPELINE=1``,
        ``batching.py:848-923``) while the schedule is sure: nothing
        queued, K a full ``decode_chunk``, and every live slot's budget
        and the cache's room hold at least two chunks.  Chunk k+1 starts
        from chunk k's last token row and positions on the device, so it
        is queued before the host reads chunk k (its tokens come back
        through pinned memory and an event, :func:`to_host`); the host
        waits only on the oldest chunk.  A slot's lane depends on nothing
        but its own tokens and generator, so every live slot's tokens are
        those of sequential chunks: a slot that stops mid-stretch only
        wastes its lanes in the chunk in flight, and idle slots' lanes
        (their positions advance K a chunk, as JAX's do) are discarded.
        Once a request completes no chunk more is dispatched; the chunk
        in flight drains."""
        if self.queue:
            return
        live = self._live_slots()
        if not live:
            return
        K, greedy_only = self._plan_chunk(live)
        if K < self.decode_chunk:
            return                                  # tail: plain steps
        budget = min(self.slot_req[b].max_new_tokens
                     - len(self.slot_req[b].output_tokens) for b in live)
        room = self.S - 1 - int(self.pos.max())
        n_chunks = min(budget, room) // K
        if n_chunks < 2:
            return
        t0 = time.perf_counter()
        tok, pos, temps, topps = self._device_io()
        inflight = deque()
        dispatched = 0
        completed = self.stats.completed
        stop = False
        while inflight or (dispatched < n_chunks and not stop):
            while len(inflight) < PIPE and dispatched < n_chunks \
                    and not stop:
                toks = self._dispatch_chunk(K, greedy_only,
                                            (tok, pos, temps, topps))
                tok = toks[K - 1]
                pos = torch.clamp(pos + K, max=self.S - 1)
                inflight.append(to_host(toks))
                dispatched += 1
                self.pipelined_chunks += 1
            host, ev = inflight.popleft()
            if ev is not None:
                ev.synchronize()
            self._apply_chunk(host.numpy(), K, self._live_slots())
            # a request finished: its slot goes back to admission
            stop = self.stats.completed != completed
        self.stats.decode_s += time.perf_counter() - t0

    def run(self) -> BatchStats:
        """Drain the queue to completion.  ``FASTLLAMA_PIPELINE=1``: each
        turn admits, runs a dispatch-ahead stretch where the schedule is
        sure, then a step (``batching.py:912-923``)."""
        pipe = os.environ.get("FASTLLAMA_PIPELINE", "0") == "1"
        while True:
            if pipe:
                self._admit_pending()
                self._pipelined_stretch()
            if not self.step():
                return self.stats

    def generate_all(self, prompts: Sequence, **kw) -> List[Request]:
        """Convenience: submit prompts, run to completion, return requests."""
        reqs = [self.submit(p, **kw) for p in prompts]
        self.run()
        return reqs
