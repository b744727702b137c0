"""Single-stream speculative decoding (port of
``fastllama_tpu/runtime/speculative.py``).

A round drafts D tokens cheaply, then verifies them with one target
``forward`` over D rows, so the weights are read once for up to D emitted
tokens.  Two drafters:

* **Model draft** (``draft=`` a second, smaller :class:`Engine` on the same
  vocab, such as one made by ``models.llama.truncate_params`` or
  ``requantize_params``): D autoregressive ``forward`` steps at T = 1 on
  its own cache.
* **Prompt lookup** (``draft=None``): the tokens that followed the most
  recent earlier occurrence of the trailing n-gram of the history (prompt
  and generated tokens), by ``spec_batching.ngram_draft_batched`` at B = 1.

Round (verify width D): the drafter feeds x_0 = pending, x_i = y_{i-1} and
writes its rows pos..pos+D-1 (the last step only writes x_{D-1}'s row);
the target verifies [pending, y_0..y_{D-2}] at positions pos..pos+D-1,
giving rows g_0..g_{D-1}.  Greedy accepts the longest prefix with
y_i == g_i (a of them) and emits g_0..g_a; sampled rounds run the
speculative-sampling rule (:func:`accept_sampled`), which keeps the
emitted stream distributed as plain sampling from the target.  Both caches
and the position advance by a + 1; rows past it are stale and masked by
position.  At temperature 0 the output equals plain greedy decoding for
any draft: acceptance changes only the speed.

A chunk of R rounds is a Python loop that never reads the device: the
pending token, the position and the token history stay device tensors, and
``forward`` writes the cache rows at device positions (``pos=None``).  Two
chunks are in flight: each chunk's (R, D) tokens and (R,) accepted counts
are copied to pinned host memory behind a CUDA event
(``batching.to_host``), and chunk k+1 is queued before chunk k is read.
The host keeps a lower bound of the position and sizes each chunk so that
every block it may write fits ``max_seq_len`` (the room rule); where no
D-row block fits, plain decode steps finish the generation.  The JAX
package's TPU-only ``s_bound`` bucket has no counterpart: K2 reads the
position on the device.

On a mesh of ranks (``EngineConfig.mesh``; the draft on the same mesh)
every step runs per rank through ``Engine``'s mesh path: the draft's
steps through ``Engine._step`` (``models/batched.decode_step``), the
verify through ``Engine._verify`` (``spec_decode_step``: K2s and
``spec_write`` on the rank's heads).  The logits are gathered over the
whole vocabulary and every rank seeds the same generator, so every rank
drafts, accepts and samples the same tokens, as the JAX engine's one
program does on its mesh.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fastllama_tpu_torch.loaders.tokenizer import StreamDecoder
from fastllama_tpu_torch.ops import sampling
from fastllama_tpu_torch.runtime.batching import to_host
from fastllama_tpu_torch.runtime.engine import Engine, GenerationStats
from fastllama_tpu_torch.runtime.spec_batching import (_accepted,
                                                       ngram_draft_batched)

PIPE = 2                # chunks in flight


@dataclasses.dataclass
class SpecStats(GenerationStats):
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0

    @property
    def acceptance(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0


def _ngram_draft(history: np.ndarray, n: int, width: int) -> np.ndarray:
    """Prompt-lookup drafting on the host: the ``width`` tokens that
    followed the most recent earlier occurrence of the trailing ``n``-gram.
    Returns (width,) int32, zeros where there is no match (they are
    rejected)."""
    L = len(history)
    if L < n + 1:
        return np.zeros(width, np.int32)
    tail = history[L - n:]
    for s in range(L - n - 1, -1, -1):          # newest match wins
        if np.array_equal(history[s:s + n], tail):
            seg = history[s + n:s + n + width]
            out = np.zeros(width, np.int32)
            out[:len(seg)] = seg
            return out
    return np.zeros(width, np.int32)


def accept_sampled(p_rows: torch.Tensor, q_rows: torch.Tensor,
                   ys: torch.Tensor, u: torch.Tensor, u_rej: torch.Tensor,
                   u_bonus: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The speculative-sampling rule over leading batch dims (...).

    p_rows, q_rows (..., D, V): the target's and the drafter's
    distributions at each verified row; ys (..., D) the drafts; u (...,
    D-1), u_rej and u_bonus (..., V) uniform noise.  Draft y_i is accepted
    iff u_i·q_i(y_i) < p_i(y_i); at the first rejection, row a, the emitted
    token is drawn from norm(max(p_a - q_{min(a, D-2)}, 0)), or from p_a
    where that sums to <= 1e-9; when every draft passes, a bonus token is
    drawn from row D-1.  Returns (emit (..., D) int32: ys with row a
    replaced by the drawn token, a (...) int32)."""
    D, V = p_rows.shape[-2:]
    ys_l = ys.to(torch.long)
    head = ys_l[..., :D - 1, None]
    py = p_rows[..., :D - 1, :].gather(-1, head)[..., 0]
    qy = q_rows[..., :D - 1, :].gather(-1, head)[..., 0]
    a = torch.cumprod((u * qy < py).to(torch.int32), dim=-1).sum(dim=-1)
    a_l = a.to(torch.long)

    def row(rows, i):
        return rows.gather(-2, i[..., None, None].expand(*i.shape, 1, V)
                           )[..., 0, :]

    pa = row(p_rows, a_l)
    resid = torch.clamp(pa - row(q_rows, torch.clamp(a_l, max=D - 2)),
                        min=0.0)
    resid = torch.where(resid.sum(dim=-1, keepdim=True) > 1e-9, resid, pa)
    t_rej = sampling._gumbel_argmax(torch.log(resid + 1e-30), u_rej)
    t_bonus = sampling._gumbel_argmax(
        torch.log(p_rows[..., D - 1, :] + 1e-30), u_bonus)
    t_last = torch.where(a_l < D - 1, t_rej, t_bonus)
    emit = torch.where(torch.arange(D, device=ys.device) == a_l[..., None],
                       t_last[..., None], ys_l)
    return emit.to(torch.int32), a.to(torch.int32)


@dataclasses.dataclass
class _Stream:
    """The device state one generation carries from round to round."""

    tcache: object
    dcache: object
    pending: torch.Tensor          # (1,) int32
    pos: torch.Tensor              # (1,) int32, the pending token's row
    hist: Optional[torch.Tensor]   # (max_seq_len + D,) int32, n-gram only


class SpeculativeEngine:
    """Speculative decoding over a target :class:`Engine`.

    ``draft``: a second Engine on the same vocab and device; None selects
    the n-gram drafter (``ngram`` tokens of lookup).  ``width``: rows
    verified a round (D), 1..D tokens emitted a round; ``rounds_per_call``:
    rounds a chunk (R)."""

    def __init__(self, engine: Engine, draft: Optional[Engine] = None,
                 width: int = 8, ngram: int = 3, rounds_per_call: int = 8):
        if width < 2:
            raise ValueError("speculation needs width >= 2")
        if draft is not None:
            if draft.config.vocab_size != engine.config.vocab_size:
                raise ValueError("draft vocab must match the target's")
            if draft.device != engine.device:
                raise ValueError(f"draft on {draft.device}, target on "
                                 f"{engine.device}")
            # a one-rank mesh runs the one-card path: it pairs with none
            meshes = [e.mesh.shape if e._spmd else None
                      for e in (draft, engine)]
            if meshes[0] != meshes[1]:
                raise ValueError(f"draft on mesh {meshes[0]}, target on "
                                 f"{meshes[1]}")
        self.engine = engine
        self.draft = draft
        self.width = width
        self.ngram = ngram
        self.rounds_per_call = max(1, rounds_per_call)

    # -- one round -------------------------------------------------------------

    def _draft_model(self, st: _Stream, positions, noise, temperature,
                     topp):
        """D draft steps at T = 1 from the pending token.  Returns (ys (D,)
        int32, q_rows (D, V) or None when greedy)."""
        dr, D = self.draft, self.width
        tok, ys, qs = st.pending, [], []
        for k in range(D):
            lg = dr._step(tok, None, st.dcache, positions[k:k + 1])
            if noise is None:
                tok = torch.argmax(lg, dim=-1)
            else:
                q = sampling.nucleus_dist(lg[0], temperature, topp)
                tok = sampling._gumbel_argmax(torch.log(q + 1e-30),
                                              noise[k]).reshape(1)
                qs.append(q)
            ys.append(tok)
        ys = torch.cat(ys).to(torch.int32)
        return ys, (torch.stack(qs) if qs else None)

    def _round(self, st: _Stream, sampled: bool, temperature: float,
               topp: float, gen: Optional[torch.Generator]) -> torch.Tensor:
        """Draft, verify, accept and commit one round on the device.
        Returns (D + 1,) int32: the round's D candidate tokens (the first
        a + 1 emitted), then a."""
        eng, D = self.engine, self.width
        V = eng.config.vocab_size
        dev = st.pos.device
        ar = torch.arange(D, dtype=torch.int32, device=dev)
        positions = st.pos + ar
        noise = None
        if sampled:
            extra = D * V if self.draft is not None else 0
            noise = torch.rand(D - 1 + 2 * V + extra, generator=gen,
                               device=dev)
        if self.draft is not None:
            ys, q_rows = self._draft_model(
                st, positions,
                None if noise is None else noise[2 * V + D - 1:].view(D, V),
                temperature, topp)
        else:
            ys = ngram_draft_batched(st.hist[None], st.pos + 1, self.ngram,
                                     D)[0]
            q_rows = None
        batch = torch.cat([st.pending, ys[:D - 1]])
        lg = eng._verify(batch, positions, st.tcache)
        if sampled:
            if q_rows is None:                  # n-gram: q is one-hot
                q_rows = torch.zeros((D, V), dtype=torch.float32, device=dev
                                     ).scatter_(1, ys[:, None].to(torch.long),
                                                1.0)
            p_rows = sampling.nucleus_dist(lg, temperature, topp)
            emit, a = accept_sampled(p_rows, q_rows, ys, noise[:D - 1],
                                     noise[D - 1:D - 1 + V],
                                     noise[D - 1 + V:D - 1 + 2 * V])
            a = a.reshape(1)
        else:
            emit = torch.argmax(lg, dim=-1).to(torch.int32)
            a = _accepted((ys[:D - 1] == emit[:D - 1])[None])
        st.pending = emit.gather(0, a.to(torch.long))
        if st.hist is not None:
            # the emitted tokens land after the old pending one; rows past
            # the accepted prefix lie beyond the history's new length, so
            # the drafter never reads them
            start = torch.clamp(st.pos + 1, 0, st.hist.shape[0] - D)
            st.hist.index_copy_(0, (start + ar).to(torch.long), emit)
        st.pos = st.pos + a + 1
        return torch.cat([emit, a])

    def _chunk(self, st: _Stream, R: int, sampled: bool, temperature: float,
               topp: float, gen) -> torch.Tensor:
        """R rounds with no host sync.  Returns (R, D + 1) int32 on the
        device, a row a round as :meth:`_round` gives it."""
        return torch.stack([self._round(st, sampled, temperature, topp, gen)
                            for _ in range(R)])

    # -- generation ------------------------------------------------------------

    def _start(self, tokens: List[int], temperature: float, topp: float,
               seed: int) -> Tuple[_Stream, int, torch.Generator]:
        """Prefill the target, and the draft model on the same prompt; draw
        the first token.  Returns (the stream's device state, the first
        token, the generator every later draw takes its noise from)."""
        eng, D = self.engine, self.width
        dev = eng.device
        tcache = eng.new_cache()
        last_logits = eng._prefill(tokens, eng._bucket(len(tokens)), tcache,
                                   0)
        gen = eng._generator(seed)
        pending = int(sampling.sample(last_logits, gen, temperature, topp))
        dcache = None
        if self.draft is not None:
            dr = self.draft
            dcache = dr.new_cache()
            dr._prefill(tokens, dr._bucket(len(tokens)), dcache, 0)
        hist = None
        if self.draft is None:
            hbuf = np.zeros(eng.config.max_seq_len + D, np.int32)
            hbuf[:len(tokens) + 1] = list(tokens) + [pending]
            hist = torch.as_tensor(hbuf, device=dev)
        st = _Stream(tcache, dcache,
                     torch.tensor([pending], dtype=torch.int32, device=dev),
                     torch.tensor([len(tokens)], dtype=torch.int32,
                                  device=dev), hist)
        return st, pending, gen

    def generate(self, prompt, max_new_tokens: int = 512,
                 stop_tokens: Optional[Sequence[int]] = None,
                 callback=None, temperature: float = 0.0, topp: float = 0.9,
                 seed: int = 128391297) -> Tuple[List[int], SpecStats]:
        """Speculative generation with ``Engine.generate``'s contract:
        returns the generated ids (prompt excluded) and stats;
        ``callback(text, token)`` runs for each emitted token that is not a
        stop token, and returning False stops.  Temperature 0 verifies by
        argmax equality; above it the accept/residual rule keeps the output
        distributed as plain sampling from the target."""
        sampled = temperature > 0.0
        eng, D = self.engine, self.width
        cfg = eng.config
        tokens = (eng.encode(prompt) if isinstance(prompt, str)
                  else list(prompt))
        if not tokens:
            raise ValueError("empty prompt")
        if len(tokens) >= cfg.max_seq_len:
            raise ValueError(f"prompt too long: {len(tokens)} >= "
                             f"{cfg.max_seq_len}")
        if stop_tokens is None:
            stop_tokens = (0, eng.tokenizer.eos_token_id)
        stop_set = set(int(t) for t in stop_tokens)
        max_new_tokens = min(max_new_tokens, cfg.max_seq_len - len(tokens))
        stats = SpecStats(prompt_tokens=len(tokens))

        stream = StreamDecoder(eng.tokenizer) if callback is not None \
            else None
        out: List[int] = []
        prev = tokens[-1]

        def emit(tok: int) -> bool:
            nonlocal prev
            out.append(tok)
            ok = True
            if callback is not None and tok not in stop_set:
                ok = callback(stream.piece(tok, prev), tok) is not False
            prev = tok
            return ok

        t0 = time.perf_counter()
        st, pending, gen = self._start(tokens, temperature, topp, seed)
        stats.prefill_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        if not emit(pending) or pending in stop_set:
            stats.output_tokens = len(out)
            stats.decode_s = time.perf_counter() - t0
            return out, stats

        dev = eng.device
        seq_cap = cfg.max_seq_len if self.draft is None else \
            min(cfg.max_seq_len, self.draft.config.max_seq_len)
        R = self.rounds_per_call
        pos_lb = len(tokens)      # host lower bound, exact once all is read
        inflight = deque()        # (host rows, event), queued and unread
        stop = False

        def dispatch() -> bool:
            # every queued round advances pos by at most D, so this bounds
            # the position of every chunk in flight; the last chunk shrinks
            # so that a nearly full context still speculates.  Every queued
            # round emits at least one token, so no more rounds are queued
            # than the tokens still needed, plus one: where each round
            # emits one token, that one is read and counted in the stats,
            # as the JAX engine counts the round that finds the budget
            # spent
            queued = sum(h.shape[0] for h, _ in inflight)
            r_fit = (seq_cap - pos_lb - queued * D) // D
            r_need = max_new_tokens - len(out) - queued + 1
            if min(r_fit, r_need) < 1:
                return False
            rows = self._chunk(st, min(R, r_fit, r_need), sampled,
                               temperature, topp, gen)
            inflight.append(to_host(rows))
            return True

        def consume() -> None:
            nonlocal stop, pos_lb
            rows, ev = inflight.popleft()
            if ev is not None:
                ev.synchronize()
            for row in rows.tolist():
                a = int(row[D])
                stats.rounds += 1
                stats.drafted += D - 1
                stats.accepted += a
                pos_lb += a + 1
                for t in row[:a + 1]:
                    if len(out) >= max_new_tokens:
                        stop = True
                        break
                    if not emit(int(t)) or int(t) in stop_set:
                        stop = True
                        break
                if stop:
                    break

        while not stop and len(out) < max_new_tokens:
            while len(inflight) < PIPE and dispatch():
                pass
            if not inflight:
                break
            consume()
        # unread chunks only wrote rows past the stop: dropped.  Out of room
        # for a D-row block, plain decode steps finish the generation; every
        # queued chunk has been read here, so pos_lb is the position
        tok = None if stop else int(st.pending)
        while tok is not None and len(out) < max_new_tokens \
                and pos_lb < cfg.max_seq_len:
            lg = eng._step(torch.tensor([tok], device=dev), pos_lb,
                           st.tcache)
            tok = int(sampling.sample(lg[0], gen, temperature, topp))
            pos_lb += 1
            if not emit(tok) or tok in stop_set:
                break

        stats.output_tokens = len(out)
        stats.decode_s = time.perf_counter() - t0
        return out, stats
