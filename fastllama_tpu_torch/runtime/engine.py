"""Single-stream inference engine (port of ``fastllama_tpu/runtime/engine.py``).

* :class:`Engine` — ``generate`` prefills the whole prompt (bucketed, fresh,
  through ``models.batched.prefill_into_slot``) or, with
  ``EngineConfig.prefill_chunk``, in fixed blocks (the first fresh, the rest
  through ``models.llama.forward`` at ``pos > 0``), then decodes in chunks
  of K steps with sampling on the device, plus one shorter tail chunk.
* :class:`ChatSession` — a multi-turn session whose history stays in the
  cache.

A decode chunk is a Python loop of ``forward`` + sampling that does not
sync with the host: its positions are one device tensor made per chunk, the
next step's token is the previous step's device tensor, and the chunk's
tokens land in a device buffer.  Two chunks are in flight (``FASTLLAMA_PIPE``,
default 2): right after chunk k is queued its tokens are copied into pinned
host memory (``non_blocking``) behind a CUDA event; chunk k+1 is queued and
only then does the host wait on chunk k's event.  Without the event, a
plain ``.cpu()`` of chunk k's tokens would wait for chunk k+1 too.

The cache is updated in place (JAX donates its buffers to the same effect).
Weights are INT8, INT16 or INT4 (split-half packed where it packs, through
K1p; int8-held otherwise; mixed layouts stay unfused).  On a mesh of more
than one rank (``EngineConfig.mesh``) every block and step runs per rank
through ``models/batched.py``'s steps given the mesh, on its shards and
its block of the cache (a one-slot view), as the JAX engine does under
``spmd_kernels`` (``engine.py:111-112``), the speculative verify
(:meth:`Engine._verify`) too; a one-rank mesh takes the path above.
``pallas_interpret`` is not ported and raises.  :meth:`Engine.load`
builds an engine on a checkpoint file.
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
from fastllama_tpu_torch.device import torch_dtype
from fastllama_tpu_torch.loaders.tokenizer import StreamDecoder, Tokenizer
from fastllama_tpu_torch.models.batched import (BatchedKVCache, decode_step,
                                                prefill_into_slot,
                                                prefill_into_slot_at,
                                                prefill_many,
                                                spec_decode_step)
from fastllama_tpu_torch.models.llama import (KVCache, LlamaParams,
                                              forward, fuse_params)
from fastllama_tpu_torch.ops import sampling
from fastllama_tpu_torch.ops.attention import gqa_attention
from fastllama_tpu_torch.ops.qmatmul import qmatmul_parity
from fastllama_tpu_torch.quant.groupquant import compress_scales
from fastllama_tpu_torch.runtime.batching import open_mesh, to_host
from fastllama_tpu_torch.runtime.kernels import KernelBundle, select_kernels
from fastllama_tpu_torch.runtime.sampler import HostSampler

DEFAULT_DECODE_CHUNK = 32


@dataclasses.dataclass
class GenerationStats:
    prompt_tokens: int = 0
    output_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0

    @property
    def prefill_tps(self) -> float:
        return self.prompt_tokens / self.prefill_s if self.prefill_s else 0.0

    @property
    def decode_tps(self) -> float:
        return self.output_tokens / self.decode_s if self.decode_s else 0.0


def _pipe_depth() -> int:
    """Chunks in flight (``FASTLLAMA_PIPE``, default 2).  A depth below 1
    would decode nothing, so it raises."""
    depth = int(os.environ.get("FASTLLAMA_PIPE", "2"))
    if depth < 1:
        raise ValueError(f"FASTLLAMA_PIPE={depth}: the decode pipeline "
                         f"needs at least one chunk in flight")
    return depth


class Engine:
    """Single-stream generation over INT8/INT16/INT4 LLaMA weights and an
    f32 or bf16 KV cache.  ``device=None`` means ``"cuda"``; without a card it
    raises unless ``device="cpu"`` is passed.  ``sharded``: on a mesh,
    ``params`` are this rank's shard already (as :meth:`load` builds
    them)."""

    def __init__(self, config: ModelConfig, params: LlamaParams,
                 tokenizer: Tokenizer,
                 engine_config: Optional[EngineConfig] = None, device=None,
                 *, sharded: bool = False):
        ec = engine_config or EngineConfig()
        if ec.pallas_interpret:
            raise NotImplementedError(
                "EngineConfig.pallas_interpret is not ported (TPU "
                "interpret mode has no counterpart)")
        if ec.max_seq_len:
            config = config.replace(max_seq_len=min(config.max_seq_len,
                                                    ec.max_seq_len))
        config.validate()
        self.mesh, self.device = open_mesh(ec, device)
        # the per-rank path only on a mesh of more than one rank
        # (engine.py:111-112)
        self._spmd = self.mesh is not None and self.mesh.size > 1
        if self.mesh is not None:
            from fastllama_tpu_torch.parallel.sharding import shard_params
            if self._spmd:
                from fastllama_tpu_torch.parallel.spmd_step import \
                    _check_dims
                _check_dims(config, self.mesh, 1, False)
                ec = dataclasses.replace(ec, fuse_weights=False)
            if not sharded:
                params = shard_params(config, self.mesh, params,
                                      self.device)
        else:
            params = params.to(self.device)
        if ec.fuse_weights and not ec.parity_mode:
            try:
                params = fuse_params(config, params)
            except ValueError:          # mixed quant layouts: keep unfused
                ec = dataclasses.replace(ec, fuse_weights=False)
        # "auto" narrows scales to bf16 only where the kernels run (the JAX
        # rule: its jnp fallback dequantizes in f32, where the storage
        # rounding would show; so does the port's plain path on the CPU)
        kernels_live = (ec.use_pallas and not ec.parity_mode
                        and self.device.type == "cuda" and not self._spmd)
        scale_dt = resolve_scale_dtype(ec, config, batched=False,
                                       pallas_live=kernels_live)
        if scale_dt != "float32" and not ec.parity_mode:
            params = compress_scales(params, torch_dtype(scale_dt))
        self.kv_dtype = torch_dtype(ec.kv_dtype)
        if self.kv_dtype == torch.int8:
            raise NotImplementedError(
                "kv_dtype='int8' is a BatchedEngine feature (per-row "
                "quantized cache); the single-stream engine keeps f32/bf16")
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.ec = ec
        self._cdt = (torch.float32 if ec.parity_mode
                     else torch_dtype(ec.compute_dtype))
        if ec.parity_mode:
            self.kernels = KernelBundle(mm=qmatmul_parity, attn=gqa_attention)
        else:
            self.kernels = select_kernels(self.device, ec, self._cdt)

    @staticmethod
    def load(ckpt_path: str, tokenizer_path: str = "",
             file_type=None, qtype=None,
             engine_config: Optional[EngineConfig] = None,
             device=None) -> "Engine":
        """An engine on a checkpoint file (llama2c, FLM, GGUF or an HF
        directory; ``file_type`` None or UNKNOWN sniffs it): the weights
        are built on ``device`` (None: the card) and quantized to
        ``qtype`` if the file holds fp32 weights."""
        from fastllama_tpu_torch.loaders.registry import (FileType,
                                                          resolve_and_build)
        cfg, params, tok = resolve_and_build(
            ckpt_path, tokenizer_path, file_type or FileType.UNKNOWN, qtype,
            engine_config, device)
        return Engine(cfg, params, tok, engine_config, device,
                      sharded=bool(engine_config and engine_config.mesh))

    # -- compute ---------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.ec.prefill_buckets:
            if b >= n and b <= self.config.max_seq_len:
                return b
        return self.config.max_seq_len

    def new_cache(self) -> KVCache:
        """An empty cache: on a mesh, this rank's block of it."""
        if self.mesh is not None:
            from fastllama_tpu_torch.parallel.sharding import new_cache
            return new_cache(self.config, self.mesh, self.kv_dtype,
                             self.device)
        return KVCache.create(self.config, dtype=self.kv_dtype,
                              device=self.device)

    def _forward(self, tokens, pos: int, cache: KVCache, **kw):
        kb = self.kernels
        return forward(self.config, self.params, tokens, pos, cache,
                       mm=kb.mm, attn=kb.attn, mm_idx=kb.mm_idx,
                       attn_idx=kb.attn_idx, compute_dtype=self._cdt, **kw)

    @staticmethod
    def _slot_view(cache: KVCache) -> BatchedKVCache:
        """The cache as a one-slot BatchedKVCache (a view)."""
        L, n_kv, S, hs = cache.k.shape
        return BatchedKVCache(cache.k.view(L, 1, n_kv, S, hs),
                              cache.v.view(L, 1, n_kv, S, hs))

    def _step(self, tok: torch.Tensor, pos: int, cache: KVCache,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode token (tok (1,)) at ``pos``: its logits (1, vocab)
        f32.  On a mesh, the per-rank decode step on a one-slot view."""
        if not self._spmd:
            lg, _ = self._forward(tok, pos, cache, positions=positions)
            return lg
        if positions is None:
            positions = torch.tensor([pos], dtype=torch.int32,
                                     device=self.device)
        kb = self.kernels
        lg, _ = decode_step(
            self.config, self.params, tok, positions, self._slot_view(cache),
            mm=kb.mm, mm_idx=kb.mm_idx, attn_bidx=kb.attn_bidx,
            kv_writer=kb.kv_writer, compute_dtype=self._cdt, mesh=self.mesh)
        return lg

    def _verify(self, batch: torch.Tensor, positions: torch.Tensor,
                cache: KVCache) -> torch.Tensor:
        """The speculative verify: ``batch`` (D,) at the consecutive device
        ``positions`` (D,), its D rows written; their logits (D, vocab)
        f32.  Off a mesh ``forward`` at device positions; on one the
        per-rank verify step (``models/batched.spec_decode_step``: K2s and
        ``spec_write``) on a one-slot view, which attends before it
        writes."""
        if not self._spmd:
            lg, _ = self._forward(batch, None, cache, positions=positions)
            return lg
        kb = self.kernels
        lg, _ = spec_decode_step(
            self.config, self.params, batch[None], positions[:1],
            self._slot_view(cache), mm=kb.mm, mm_idx=kb.mm_idx,
            attn_sbidx=kb.attn_sbidx, spec_writer=kb.spec_writer,
            compute_dtype=self._cdt, mesh=self.mesh)
        return lg[0]

    def _prefill(self, tokens: Sequence[int], bucket: int, cache: KVCache,
                 pos: int) -> torch.Tensor:
        """One padded block of ``bucket`` rows at ``pos``: fresh at pos 0
        (attention over the block only), else the mid-sequence forward over
        the cache.  Returns the last valid token's logits (vocab,) f32."""
        padded = np.zeros(bucket, np.int64)
        padded[:len(tokens)] = tokens
        toks = torch.as_tensor(padded, device=self.device)
        if self._spmd:
            return self._spmd_prefill(toks, len(tokens), cache, pos)
        if pos == 0:
            L, n_kv, S, hs = cache.k.shape
            bc = BatchedKVCache(cache.k.view(L, 1, n_kv, S, hs),
                                cache.v.view(L, 1, n_kv, S, hs))
            kb = self.kernels
            logits, _ = prefill_into_slot(
                self.config, self.params, toks, len(tokens), 0, bc,
                mm=kb.mm, mm_idx=kb.mm_idx, compute_dtype=self._cdt)
            return logits
        logits, _ = self._forward(toks, pos, cache,
                                  last_index=len(tokens) - 1)
        return logits[0]

    def _spmd_prefill(self, toks: torch.Tensor, n: int, cache: KVCache,
                      pos: int) -> torch.Tensor:
        """A padded block on a mesh: the per-rank fresh prefill at pos 0,
        else the per-rank tail (K2b over the rows before it)."""
        kb = self.kernels
        kw = dict(mm=kb.mm, mm_idx=kb.mm_idx, slot_writer=kb.slot_writer,
                  compute_dtype=self._cdt, mesh=self.mesh)
        bc = self._slot_view(cache)
        if pos == 0:
            dev = self.device
            logits, _ = prefill_many(
                self.config, self.params, toks[None],
                torch.tensor([n], device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev), bc, **kw)
            return logits[0]
        logits, _ = prefill_into_slot_at(
            self.config, self.params, toks, n, 0, pos, bc,
            attn_tail=kb.attn_tail, **kw)
        return logits

    def _decode_chunk(self, cache: KVCache, token: torch.Tensor, pos0: int,
                      n: int, temperature: float, topp: float,
                      gen: torch.Generator) -> torch.Tensor:
        """``n`` decode steps from ``token`` (a device tensor) at positions
        pos0.. with sampling on the device.  Returns the (n,) token tensor
        on the device; nothing inside waits for the device."""
        positions = torch.arange(pos0, pos0 + n, dtype=torch.int32,
                                 device=self.device)
        toks = torch.empty(n, dtype=torch.long, device=self.device)
        tok = token.reshape(1)
        for k in range(n):
            lg = self._step(tok, pos0 + k, cache, positions[k:k + 1])
            tok = sampling.sample(lg[0], gen, temperature, topp).reshape(1)
            toks[k] = tok[0]
        return toks

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return gen

    # -- generation ------------------------------------------------------------

    def encode(self, prompt: str) -> List[int]:
        return self.tokenizer.encode(prompt, add_bos=True)

    def generate(self, prompt, max_new_tokens: int = 512,
                 temperature: float = 0.0, topp: float = 0.9,
                 seed: int = 128391297,
                 stop_tokens: Optional[Sequence[int]] = None,
                 callback: Optional[Callable[[str, int], bool]] = None,
                 decode_chunk: int = DEFAULT_DECODE_CHUNK,
                 host_sampling: bool = False,
                 ) -> Tuple[List[int], GenerationStats]:
        """Greedy/temperature/top-p generation.  Returns the generated
        token ids (prompt excluded) and timing stats.  ``callback(text,
        token)`` is invoked per decoded token that is not a stop token;
        returning False stops generation."""
        cfg = self.config
        decode_chunk = max(1, decode_chunk)
        tokens = (self.encode(prompt) if isinstance(prompt, str)
                  else list(prompt))
        if not tokens:
            raise ValueError("empty prompt")
        if len(tokens) >= cfg.max_seq_len:
            raise ValueError(f"prompt too long: {len(tokens)} >= "
                             f"{cfg.max_seq_len}")
        max_new_tokens = min(max_new_tokens, cfg.max_seq_len - len(tokens))
        if stop_tokens is None:
            stop_tokens = (0, self.tokenizer.eos_token_id)
        stop_set = set(int(t) for t in stop_tokens)
        stats = GenerationStats(prompt_tokens=len(tokens))
        pipe = _pipe_depth()

        t0 = time.perf_counter()
        cache = self.new_cache()
        C = self.ec.prefill_chunk
        if C and len(tokens) > C:
            # only the last block is padded, so no padding row is ever
            # attended by a later block
            for s in range(0, len(tokens), C):
                last_logits = self._prefill(tokens[s:s + C], C, cache, s)
        else:
            last_logits = self._prefill(tokens, self._bucket(len(tokens)),
                                        cache, 0)
        pos = len(tokens)
        prev_token = tokens[-1]

        out: List[int] = []
        host = HostSampler(cfg.vocab_size, seed) if host_sampling else None
        stream = StreamDecoder(self.tokenizer) if callback is not None \
            else None

        def emit(tok: int) -> bool:
            nonlocal prev_token
            out.append(tok)
            ok = True
            # stop tokens are recorded in the returned ids, never streamed
            if callback is not None and tok not in stop_set:
                ok = callback(stream.piece(tok, prev_token), tok) \
                    is not False
            prev_token = tok
            return ok

        gen = None
        if host_sampling:
            first = host.sample(last_logits.cpu().numpy(), temperature, topp)
        else:
            gen = self._generator(seed)
            first = int(sampling.sample(last_logits, gen, temperature, topp))
        stats.prefill_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        if not emit(first) or first in stop_set:
            stats.output_tokens = len(out)
            stats.decode_s = time.perf_counter() - t0
            return out, stats

        if host_sampling:
            tok = first
            while len(out) < max_new_tokens:
                lg = self._step(torch.tensor([tok], device=self.device),
                                pos, cache)
                pos += 1
                tok = host.sample(lg[0].cpu().numpy(), temperature, topp)
                if not emit(tok) or tok in stop_set:
                    break
        else:
            # the next chunk's input token is the previous chunk's last
            # token, a device value, so chunk k+1 is queued before chunk
            # k's tokens are read.  On a stop token the chunk in flight is
            # dropped: its cache rows sit past the stop.
            tok = torch.tensor(first, device=self.device)
            inflight = deque()
            planned = 0                 # tokens dispatched so far
            stop = False
            while not stop and (len(out) < max_new_tokens or inflight):
                while len(inflight) < pipe and planned < max_new_tokens - 1:
                    n = min(decode_chunk, max_new_tokens - 1 - planned)
                    toks = self._decode_chunk(cache, tok, pos + planned, n,
                                              temperature, topp, gen)
                    tok = toks[n - 1]
                    planned += n
                    inflight.append(to_host(toks))
                if not inflight:
                    break
                toks_host, ev = inflight.popleft()
                if ev is not None:
                    ev.synchronize()
                for t in toks_host.tolist():
                    if not emit(int(t)) or int(t) in stop_set:
                        stop = True
                        break
        stats.output_tokens = len(out)
        stats.decode_s = time.perf_counter() - t0
        return out, stats

    def generate_text(self, prompt: str, **kw) -> str:
        toks, _ = self.generate(prompt, **kw)
        return self.tokenizer.decode(toks)


class ChatSession:
    """Multi-turn session with a persistent KV cache: the history stays in
    the cache between turns."""

    def __init__(self, engine: Engine, system_prompt: str = ""):
        self.engine = engine
        self.cache = engine.new_cache()
        self.pos = 0
        self._last_logits = None
        if system_prompt:
            self.feed(engine.tokenizer.encode(system_prompt, add_bos=True))
        else:
            self.feed([engine.tokenizer.bos_token_id])

    def remaining(self) -> int:
        return self.engine.config.max_seq_len - self.pos

    def feed(self, tokens: Sequence[int]) -> None:
        """Prefill tokens at the current position (no sampling), in blocks
        of ``EngineConfig.prefill_chunk`` when it is set."""
        eng = self.engine
        if not tokens:
            return
        C = eng.ec.prefill_chunk
        if C and len(tokens) > C:
            # only the final block may be padded
            for s in range(0, len(tokens), C):
                self._feed_block(list(tokens[s:s + C]), C)
            return
        self._feed_block(list(tokens), eng._bucket(len(tokens)))

    def _feed_block(self, tokens: List[int], bucket: int) -> None:
        eng = self.engine
        # the padded bucket must fit: the prefill writes `bucket` rows at
        # self.pos
        if len(tokens) >= self.remaining() or self.pos + bucket > \
                eng.config.max_seq_len:
            raise ValueError("context window exhausted")
        self._last_logits = eng._prefill(tokens, bucket, self.cache,
                                         self.pos)
        self.pos += len(tokens)

    def generate(self, text: str, max_new_tokens: int = 256,
                 temperature: float = 0.8, topp: float = 0.9,
                 seed: int = 128391297, callback=None) -> str:
        """Feed a user turn, then decode assistant tokens until EOS.

        Invariant: ``self.pos`` counts tokens whose K/V rows are valid in
        the cache; rows past it are stale and masked.  ``pending`` is the
        sampled next token, not yet in the cache."""
        eng = self.engine
        toks = eng.tokenizer.encode(text, add_bos=False)
        if toks:
            self.feed(toks)
        max_new_tokens = min(max_new_tokens, self.remaining() - 2)

        gen = eng._generator(seed + self.pos)
        pending = int(sampling.sample(self._last_logits, gen, temperature,
                                      topp))
        stop = {0, eng.tokenizer.eos_token_id}
        out: List[int] = []
        prev = toks[-1] if toks else -1
        stream = StreamDecoder(eng.tokenizer) if callback is not None \
            else None
        while pending not in stop and len(out) < max_new_tokens:
            out.append(pending)
            if callback is not None:
                callback(stream.piece(pending, prev))
            prev = pending
            n = min(DEFAULT_DECODE_CHUNK, max_new_tokens - len(out) + 1,
                    self.remaining() - 1)
            if n < 1:
                break
            seq = eng._decode_chunk(
                self.cache, torch.tensor(pending, device=eng.device),
                self.pos, n, temperature, topp, gen).tolist()
            accepted = 1                      # pending's row was written
            nxt = seq[-1]                     # not in the cache
            for t in seq[:-1]:
                if int(t) in stop or len(out) >= max_new_tokens:
                    nxt = int(t)
                    break
                out.append(int(t))
                if callback is not None:
                    callback(stream.piece(int(t), prev))
                prev = int(t)
                accepted += 1
            self.pos += accepted
            pending = int(nxt)
        return eng.tokenizer.decode(out)
