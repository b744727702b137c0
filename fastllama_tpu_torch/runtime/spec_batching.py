"""Batched speculative decoding: speculation inside the serving engine
(port of ``fastllama_tpu/runtime/spec_batching.py``).

Every round drafts D-1 tokens per slot by n-gram prompt lookup over a
device-resident per-slot history and verifies them with one target forward
over (B, D) rows (``models/batched.spec_decode_step``), so the weight
stream and each slot's KV read are shared by every accepted token.  Greedy
outputs equal the plain ``BatchedEngine``'s for any draft quality;
acceptance only changes speed.

A chunk runs R rounds as a Python loop with no host sync inside it: the
drafts, tokens, accepted counts, pending tokens, positions and history
stay on the device, and one fetch of (tokens, accepted counts, pending)
ends the chunk.  Near the context limit (no full D-row block fits) and
whenever the :class:`SpecAutoTuner` measures plain chunks as faster, the
engine runs the parent's plain chunks.  The kernels are K2s
(``flash_spec_batched``) and K3 as ``spec_write``.  On a mesh (the
parent's ``EngineConfig.mesh``) every rank drafts all slots and verifies
its own through ``spec_decode_step`` given the mesh; the tuner's
arm is rank 0's on every rank.  The prefix cache and
deferred KV come from the parent: a slot admitted by a prefix hit gets its
history like any other newly admitted slot, and the plain chunks take the
deferred path under the parent's gate (as JAX's ``spec_batching.py:452``).
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Optional

import numpy as np
import torch

from fastllama_tpu_torch.config import EngineConfig, ModelConfig
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
from fastllama_tpu_torch.models.batched import spec_decode_step
from fastllama_tpu_torch.models.llama import LlamaParams
from fastllama_tpu_torch.ops import sampling
from fastllama_tpu_torch.runtime.batching import DEFAULT_CHUNK, BatchedEngine


def ngram_draft_batched(hist: torch.Tensor, hlen: torch.Tensor, n: int,
                        D: int) -> torch.Tensor:
    """Per-slot prompt-lookup drafting on the device: the most recent
    earlier occurrence of slot b's trailing n-gram proposes the D tokens
    that followed it.  hist (B, H) int32, hlen (B,) valid lengths
    (including the pending token).  Returns (B, D) int32, zeros where
    there is no match (they are rejected).  The tail's start is clamped to
    [0, H - n], as JAX's ``dynamic_slice`` clamps it."""
    B, H = hist.shape
    dev = hist.device
    hlen = hlen.to(torch.long)
    ar_n = torch.arange(n, device=dev)
    ar_h = torch.arange(H, device=dev)
    tail = hist.gather(1, torch.clamp(hlen - n, 0, H - n)[:, None] + ar_n)
    idx = torch.clamp(ar_h[:, None] + ar_n[None, :], max=H - 1)     # (H, n)
    match = (hist[:, idx] == tail[:, None, :]).all(dim=-1) \
        & (ar_h[None, :] < (hlen - n)[:, None])
    s = torch.where(match, ar_h[None, :],
                    torch.full_like(match, -1, dtype=torch.long)).amax(dim=1)
    k = s[:, None] + n + torch.arange(D, device=dev)[None, :]        # (B, D)
    got = hist.gather(1, torch.clamp(k, 0, H - 1))
    keep = (s[:, None] >= 0) & (k < hlen[:, None])
    return torch.where(keep, got, torch.zeros_like(got)).to(torch.int32)


class SpecAutoTuner:
    """Per-chunk throughput arbiter between speculative and plain decode
    chunks, so that speculation never loses.

    Speculation's win depends on batch, context length and the workload's
    acceptance rate.  Rather than model it, measure it: an EMA of
    emitted-tokens-per-second for each mode, run the winner, and probe the
    losers round-robin every ``probe_every`` chunks so a drifting workload
    (acceptance collapsing, batch draining) can flip the decision back.
    Samples from chunks flagged ``compiled`` are discarded.

    Arms: 0 = plain; a positive arm = a speculative chunk at that draft
    width D, so that the same measured arbitration picks the width too.
    With ``widths=None`` the tuner is the binary spec/plain arbiter (arm 1
    = "spec at the engine's static width")."""

    def __init__(self, probe_every: int = 16, decay: float = 0.8,
                 widths=None, backoff_cap: int = 8):
        spec_arms = sorted({int(d) for d in widths}) if widths else [1]
        if any(a <= 0 for a in spec_arms):
            raise ValueError(f"speculative arms must be positive: "
                             f"{spec_arms}")
        self.arms = spec_arms + [0]        # choose() measures spec first
        self.ema = {a: None for a in self.arms}
        self.count = 0
        self.probe_every = probe_every
        self.decay = decay
        self._probe_i = 0
        # probe-rate backoff: every probe that confirms the standing winner
        # doubles the probe interval (capped at backoff_cap * probe_every);
        # a winner flip resets it.  A losing arm's probe chunk costs its
        # full throughput gap, so a fixed interval drags on the winner
        self.backoff_cap = backoff_cap
        self._gap = probe_every
        self._last_probe = 0
        self._prev_winner = None
        # drift watch: backoff assumes a stationary workload.  When the
        # winner's own EMA moves more than drift_tol since the last probe,
        # the workload changed (e.g. positions sweeping up, where the best
        # width can flip), so the probe interval resets
        self.drift_tol = 0.10
        self._ema_ref = None

    def record(self, arm, tokens: int, secs: float,
               compiled: bool = False) -> None:
        if compiled or secs <= 0 or tokens <= 0:
            return
        tps = tokens / secs
        e = self.ema[int(arm)]
        self.ema[int(arm)] = tps if e is None else \
            self.decay * e + (1.0 - self.decay) * tps

    def choose(self) -> int:
        """Arm to run next: 0 = plain, else the draft width to speculate
        at (1 in binary mode = the engine's static width)."""
        self.count += 1
        for a in self.arms:
            if self.ema[a] is None:
                return a                   # measure every arm once
        winner = max(self.arms, key=lambda a: self.ema[a])
        if winner != self._prev_winner:
            if self._prev_winner is not None:
                self._gap = self.probe_every     # order flipped: re-probe fast
            self._prev_winner = winner
            self._ema_ref = self.ema[winner]
        elif (self._ema_ref and abs(self.ema[winner] / self._ema_ref - 1.0)
                > self.drift_tol):
            self._gap = self.probe_every         # workload drifted: re-probe
            self._ema_ref = self.ema[winner]
        if (len(self.arms) > 1
                and self.count - self._last_probe >= self._gap):
            self._last_probe = self.count
            self._gap = min(self._gap * 2,
                            self.probe_every * self.backoff_cap)
            self._ema_ref = self.ema[winner]
            losers = [a for a in self.arms if a != winner]
            self._probe_i += 1
            return losers[self._probe_i % len(losers)]
        return winner


def _accepted(ok: torch.Tensor) -> torch.Tensor:
    """Length of the all-ones prefix of each row of ``ok`` (B, D-1)."""
    return torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def build_spec_chunk(verify: Callable, D: int, greedy: bool) -> Callable:
    """R speculative rounds as one device-resident chunk.

    ``verify(pending, pos, hist) -> (ys, lg)`` drafts D-1 tokens per slot
    (ys (B, D)) and runs the (B, D)-row target forward (logits (B, D, V)),
    writing the fresh K/V rows into the cache.  Returns ``chunk(pending,
    pos, hist, gens, temps, topps, R) -> (gs (R, B, D), accs (R, B),
    pending, pos)``; ``hist`` (B, H) is updated in place.  Nothing inside
    reads a value back to the host.

    Greedy rounds accept the longest prefix where the draft equals the
    argmax.  Sampled rounds run per-slot speculative sampling with the
    n-gram draft as a one-hot proposal: accept draft y_i if u_i < p_i(y_i);
    the first rejection draws from norm(max(p - onehot, 0)) (p where that
    is empty); full acceptance draws a bonus token from the last row.  The
    rows are ``nucleus_dist_dynamic``'s, so greedy slots (temperature <= 0)
    are deltas and reproduce plain greedy exactly.  Noise comes from each
    slot's own generator in ``gens``."""

    def commit(emit, a, hist, pos):
        """Pending token, history and position after a round.  Rows past
        the accepted prefix are garbage but sit beyond the new history
        length, which masks them.  The history write starts at pos + 1,
        clamped to [0, H - D] as JAX's ``dynamic_update_slice`` clamps."""
        pending = emit.gather(1, a[:, None].to(torch.long))[:, 0]
        start = torch.clamp(pos + 1, 0, hist.shape[1] - D).to(torch.long)
        hist.scatter_(1, start[:, None] + torch.arange(D, device=pos.device),
                      emit)
        return pending, pos + a + 1

    def greedy_round(pending, pos, hist, gens, temps, topps):
        ys, lg = verify(pending, pos, hist)
        g = torch.argmax(lg, dim=-1).to(torch.int32)                # (B, D)
        return g, _accepted(ys[:, :D - 1] == g[:, :D - 1])

    def sampled_round(pending, pos, hist, gens, temps, topps):
        ys, lg = verify(pending, pos, hist)
        B, _, V = lg.shape
        p_rows = sampling.nucleus_dist_dynamic(lg, temps[:, None],
                                               topps[:, None])      # (B, D, V)
        noise = torch.stack([torch.rand(D - 1 + 2 * V, generator=g,
                                        device=lg.device)
                             for g in gens[:B]])
        ys_l = ys.to(torch.long)
        py = p_rows[:, :D - 1].gather(2, ys_l[:, :D - 1, None])[..., 0]
        a = _accepted(noise[:, :D - 1] < py)                         # (B,)
        a_l = a.to(torch.long)
        pa = p_rows.gather(1, a_l[:, None, None].expand(B, 1, V))[:, 0]
        ya = ys_l.gather(1, torch.clamp(a_l, max=D - 2)[:, None])[:, 0]
        resid = torch.clamp(
            pa - torch.nn.functional.one_hot(ya, V).to(torch.float32), min=0)
        resid = torch.where(resid.sum(dim=-1, keepdim=True) > 1e-9, resid, pa)
        t_rej = sampling._gumbel_argmax(torch.log(resid + 1e-30),
                                        noise[:, D - 1:D - 1 + V])
        t_bonus = sampling._gumbel_argmax(
            torch.log(p_rows[:, D - 1] + 1e-30), noise[:, D - 1 + V:])
        t_last = torch.where(a < D - 1, t_rej, t_bonus).to(torch.int32)
        emit = torch.where(
            torch.arange(D, device=lg.device)[None, :] == a_l[:, None],
            t_last[:, None], ys)
        return emit, a

    round_fn = greedy_round if greedy else sampled_round

    def chunk(pending, pos, hist, gens, temps, topps, R: int):
        B = pending.shape[0]
        gs = torch.zeros((R, B, D), dtype=torch.int32, device=pending.device)
        accs = torch.zeros((R, B), dtype=torch.int32, device=pending.device)
        for r in range(R):
            emit, a = round_fn(pending, pos, hist, gens, temps, topps)
            pending, pos = commit(emit, a, hist, pos)
            gs[r] = emit
            accs[r] = a
        return gs, accs, pending, pos

    return chunk


class SpecBatchedEngine(BatchedEngine):
    """BatchedEngine whose decode chunks run speculative rounds.

    ``width``: verify rows per slot per round (1 pending + width-1 drafts);
    ``ngram``: lookup n-gram length; ``rounds_per_chunk``: rounds per
    chunk; ``spec_auto``: let the :class:`SpecAutoTuner` pick between plain
    chunks and speculation at the width arms {2, 4, 8} below ``width`` and
    ``width`` itself (at most three).  ``arm_chunks`` counts the chunks each
    arm ran (0 = plain).  ``device=None`` means ``"cuda"``."""

    def __init__(self, config: ModelConfig, params: LlamaParams,
                 tokenizer: Tokenizer,
                 engine_config: Optional[EngineConfig] = None,
                 decode_chunk: int = DEFAULT_CHUNK,
                 width: int = 4, ngram: int = 3, rounds_per_chunk: int = 8,
                 spec_auto: bool = True, device=None, *,
                 sharded: bool = False):
        super().__init__(config, params, tokenizer, engine_config,
                         decode_chunk, device, sharded=sharded)
        if width < 2:
            raise ValueError("speculation needs width >= 2")
        self.width = width
        self.ngram = ngram
        self.R = max(1, rounds_per_chunk)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.arm_chunks = collections.Counter()
        arms = sorted({d for d in (2, 4, 8) if d < width} | {width})[-3:]
        self._tuner = SpecAutoTuner(widths=arms) if spec_auto else None
        # per-slot token history on the device (prompt + emitted tokens,
        # the pending one included); length = pos + 1 for live slots
        self._hist = torch.zeros((self.B, self.S + width + 1),
                                 dtype=torch.int32, device=self.device)
        # scheduler state kept on the device between spec chunks: pending
        # and pos come back from every chunk, temps/topps change only on
        # admission, so a steady full batch uploads nothing per chunk
        self._io_dirty = True
        self._hist_stale = False
        self._pend_dev = self._pos_dev = None
        self._temps_dev = self._topps_dev = None

    @staticmethod
    def load_spec(ckpt_path: str, tokenizer_path: str = "",
                  file_type=None, qtype=None,
                  engine_config: Optional[EngineConfig] = None,
                  decode_chunk: int = DEFAULT_CHUNK, width: int = 4,
                  ngram: int = 3, rounds_per_chunk: int = 8,
                  spec_auto: bool = True,
                  device=None) -> "SpecBatchedEngine":
        """A speculative serving engine on a checkpoint file (see
        ``Engine.load``)."""
        from fastllama_tpu_torch.loaders.registry import (FileType,
                                                          resolve_and_build)
        cfg, params, tok = resolve_and_build(
            ckpt_path, tokenizer_path, file_type or FileType.UNKNOWN, qtype,
            engine_config, device)
        return SpecBatchedEngine(cfg, params, tok, engine_config,
                                 decode_chunk, width, ngram,
                                 rounds_per_chunk, spec_auto, device,
                                 sharded=bool(engine_config
                                              and engine_config.mesh))

    def _spec_chunk(self, D: int, greedy: bool) -> Callable:
        cfg, kb, cdt, n = self.config, self.kernels, self._cdt, self.ngram

        def verify(pending, pos, hist):
            ys = ngram_draft_batched(hist, pos + 1, n, D)           # (B, D)
            batch = torch.cat([pending[:, None], ys[:, :D - 1]], dim=1)
            # on a mesh every rank verifies its own slots on its shards
            # (spec_batching.py:359-366); drafting above is replicated
            lg, self.cache = spec_decode_step(
                cfg, self.params, batch, pos, self.cache, mm=kb.mm,
                mm_idx=kb.mm_idx, attn_sbidx=kb.attn_sbidx,
                spec_writer=kb.spec_writer, compute_dtype=cdt,
                mesh=self.mesh, data_sharded=True)
            return ys, lg

        return build_spec_chunk(verify, D, greedy)

    # -- scheduling ----------------------------------------------------------

    def _set_history(self, slots, rows: np.ndarray) -> None:
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        self._hist[idx] = torch.as_tensor(rows, device=self.device)

    def _write_history(self, slots) -> None:
        """Seed the device history of freshly admitted slots: prompt
        tokens and the prefill-sampled pending token."""
        rows = np.zeros((len(slots), self._hist.shape[1]), np.int32)
        for i, b in enumerate(slots):
            toks = self.slot_req[b].prompt_tokens + [int(self.pending[b])]
            rows[i, :len(toks)] = toks
        self._set_history(slots, rows)

    def _resync_history(self) -> None:
        """After plain chunks, rebuild the live slots' device histories
        from host state."""
        live = self._live_slots()
        if live:
            rows = np.zeros((len(live), self._hist.shape[1]), np.int32)
            for i, b in enumerate(live):
                req = self.slot_req[b]
                toks = (req.prompt_tokens + req.output_tokens
                        )[:int(self.pos[b])] + [int(self.pending[b])]
                rows[i, :len(toks)] = toks
            self._set_history(live, rows)

    def _admit_pending(self) -> None:
        """Admit as the parent does, then seed the admitted slots' device
        histories (``run`` under ``FASTLLAMA_PIPELINE=1`` admits outside
        :meth:`step` too)."""
        before = [r is not None for r in self.slot_req]
        super()._admit_pending()
        newly = [b for b, r in enumerate(self.slot_req)
                 if r is not None and not before[b]]
        if newly:
            self._write_history(newly)
            self._io_dirty = True

    def _pipelined_stretch(self) -> None:
        """The parent's stretch of plain chunks (JAX's engine inherits it
        the same way); plain chunks keep neither the history nor the
        device pending/pos, so both are rebuilt before the next spec
        chunk, as after :meth:`step`'s own plain chunks."""
        ran = self.pipelined_chunks
        super()._pipelined_stretch()
        if self.pipelined_chunks != ran:
            self._hist_stale = True
            self._io_dirty = True

    def step(self) -> bool:
        self._admit_pending()

        live = self._live_slots()
        if not live:
            return bool(self.queue)

        D = self.width
        greedy = all(self.slot_req[b].temperature <= 0.0 for b in live)
        room = self.S - int(self.pos.max()) - 1
        # the longest remaining request bounds the rounds: a finished
        # slot's overshoot rows are discarded on the host
        max_budget = max(self.slot_req[b].max_new_tokens
                         - len(self.slot_req[b].output_tokens) for b in live)

        def plan_R(D):
            # rows [pos, pos + R*D) must fit below S - 1
            R = min(self.R, room // D, max(1, -(-max_budget // D)))
            if self.ec.qos_chunk and self.queue:
                # the parent's TTFT bound: while requests queue, at most
                # ~qos_chunk emitted tokens per slot per chunk
                R = min(R, max(1, self.ec.qos_chunk // D))
            return max(R, 0)

        R = plan_R(D)
        use_spec = R >= 1
        if use_spec and self._tuner is not None:
            arm = self._tuner.choose()
            if self.mesh is not None:
                # the tuner reads a clock: every rank takes rank 0's arm
                from fastllama_tpu_torch.parallel.distributed import agree
                arm = agree(arm)
            use_spec = arm != 0
            if use_spec and arm not in (1, D) and plan_R(arm) >= 1:
                # the chosen width, if its block fits the room
                D, R = arm, plan_R(arm)
        if not use_spec:
            # plain chunks: near the context limit (R < 1) they keep the
            # generation contract; under the tuner they are the measured win
            tok0 = self.stats.decode_tokens
            dt = self._plain_chunk(live)
            self.arm_chunks[0] += 1
            if self._tuner is not None and R >= 1:
                self._tuner.record(0, self.stats.decode_tokens - tok0, dt)
            # plain chunks do not keep the history: rebuild it lazily
            # before the next spec chunk
            self._hist_stale = True
            self._io_dirty = True
            return bool(self.queue) or bool(self._live_slots())

        tok0 = self.stats.decode_tokens
        dt = self._run_spec_chunk(live, D, R, greedy)
        if self._tuner is not None:
            # recorded under the width that ran; the chunk's seconds end at
            # its one fetch
            self._tuner.record(D, self.stats.decode_tokens - tok0, dt)
        return bool(self.queue) or bool(self._live_slots())

    def _run_spec_chunk(self, live, D: int, R: int, greedy: bool) -> float:
        """One chunk of R speculative rounds at width D over every slot,
        its tokens emitted for the ``live`` slots; returns its seconds
        (from the first launch to the one fetch), also added to
        ``stats.decode_s``."""
        if self._hist_stale:
            self._resync_history()
            self._hist_stale = False
        t0 = time.perf_counter()
        dev = self.device
        if self._io_dirty or self._pend_dev is None:
            self._pend_dev = torch.as_tensor(self.pending, device=dev)
            self._pos_dev = torch.as_tensor(self.pos, device=dev)
            self._temps_dev = torch.as_tensor(self.temps, device=dev)
            self._topps_dev = torch.as_tensor(self.topps, device=dev)
        gs, accs, pend_dev, pos_dev = self._spec_chunk(D, greedy)(
            self._pend_dev, self._pos_dev, self._hist, self._gens,
            self._temps_dev, self._topps_dev, R)
        # one fetch for everything the scheduler needs
        B = self.B
        host = torch.cat([gs.reshape(-1), accs.reshape(-1),
                          pend_dev]).cpu().numpy()
        gs_np = host[:R * B * D].reshape(R, B, D)
        accs_np = host[R * B * D:R * B * (D + 1)].reshape(R, B)
        pend_np = host[R * B * (D + 1):]
        dt = time.perf_counter() - t0
        self.stats.decode_s += dt

        for b in live:
            for r in range(R):
                if self.slot_req[b] is None:
                    break
                a = int(accs_np[r, b])
                self.spec_drafted += D - 1
                self.spec_accepted += a
                for t in gs_np[r, b, :a + 1]:
                    if self.slot_req[b] is None:
                        break
                    self._emit(b, int(t))
        # mirror the device positions, park freed and idle slots
        adv = accs_np.sum(axis=0) + R                 # (B,)
        self.pos = np.minimum(self.pos + adv.astype(np.int32),
                              self.S - 1).astype(np.int32)
        self.pending = pend_np.astype(np.int32)
        freed = False
        for b in range(self.B):
            if self.slot_req[b] is None:
                freed = freed or (self.pos[b] != 0 or self.pending[b] != 0)
                self.pos[b] = 0
                self.pending[b] = 0
        if freed:
            self._io_dirty = True                 # the host parked slots
        else:
            self._pend_dev, self._pos_dev = pend_dev, pos_dev
            self._io_dirty = False
        self.arm_chunks[D] += 1
        return dt

    @property
    def acceptance(self) -> float:
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)
