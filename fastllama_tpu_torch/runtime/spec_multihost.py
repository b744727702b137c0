"""Batched speculation across hosts (port of
``fastllama_tpu/runtime/spec_multihost.py``): the lockstep multi-host
engine (``runtime/multihost.py``) running speculative rounds instead of
plain decode chunks (``runtime/spec_batching.py``).

Lockstep protocol additions (everything else is the parent's):

* the plan vector grows two fields, appended last: SPECR, the host's cap
  on speculative rounds this chunk (its longest remaining budget over the
  width, ``qos_chunk``-bounded while requests queue), and the host's vote
  for speculation (its ``SpecAutoTuner``'s choice, the host lead's); the
  fleet runs ``R = min(rounds_per_chunk, min over hosts of SPECR,
  room // D)`` rounds, room from the fleet's max position, and
  speculates only when every host votes for it (``spec_multihost.py:
  143-167``);
* near the context limit (no D-row block fits fleet-wide), or when a host
  votes against, every host runs the parent's plain round in the same
  round: greedy outputs equal plain serving's.

Each host's rounds are ``SpecBatchedEngine``'s: ``build_spec_chunk`` over
``ngram_draft_batched`` drafts and ``models/batched.spec_decode_step``
(K2s, ``spec_write``) on the host's view of the mesh, with its per-slot
device history and generators.  The JAX engine serves plain decode on a
multi-device mesh without ``spmd_kernels`` (``spec_multihost.py:89-94``);
the port speculates there too, on its one mesh path.
"""
from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from fastllama_tpu_torch.config import EngineConfig, ModelConfig
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
from fastllama_tpu_torch.models.llama import LlamaParams
from fastllama_tpu_torch.parallel import distributed
from fastllama_tpu_torch.parallel.sharding import Mesh
from fastllama_tpu_torch.runtime.multihost import (_PLAN_GREEDY, _PLAN_LIVE,
                                                   MultiHostEngine, _load)
from fastllama_tpu_torch.runtime.spec_batching import (SpecAutoTuner,
                                                       SpecBatchedEngine)


class MultiHostSpecEngine(MultiHostEngine):
    """MultiHostEngine whose decode rounds run batched speculation.

    ``width``: verify rows per slot per round (1 pending + width-1 n-gram
    drafts); ``ngram``: lookup n-gram length; ``rounds_per_chunk``: rounds
    per chunk; ``spec_auto``: each host's ``SpecAutoTuner`` (spec or plain
    at this width) votes through the plan."""

    def __init__(self, config: ModelConfig, params: LlamaParams,
                 tokenizer: Tokenizer,
                 engine_config: Optional[EngineConfig] = None,
                 decode_chunk: int = 16, mesh: Optional[Mesh] = None,
                 width: int = 4, ngram: int = 3, rounds_per_chunk: int = 8,
                 spec_auto: bool = True, device=None, *,
                 sharded: bool = False):
        super().__init__(config, params, tokenizer, engine_config,
                         decode_chunk, mesh, device, sharded=sharded)
        if width < 2:
            raise ValueError("speculation needs width >= 2")
        self.width = width
        self.ngram = ngram
        self.R = max(1, rounds_per_chunk)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.arm_chunks = collections.Counter()
        self._tuner = SpecAutoTuner() if spec_auto else None
        # SpecBatchedEngine's device state: per-slot history (prompt and
        # emitted tokens, the pending one included), pending/pos/temps/topps
        # kept on the device between spec chunks
        self._hist = torch.zeros((self.B, self.S + width + 1),
                                 dtype=torch.int32, device=self.device)
        self._io_dirty = True
        self._hist_stale = False
        self._pend_dev = self._pos_dev = None
        self._temps_dev = self._topps_dev = None

    @staticmethod
    def load_spec(ckpt_path: str, tokenizer_path: str = "", file_type=None,
                  qtype=None, engine_config: Optional[EngineConfig] = None,
                  decode_chunk: int = 16, mesh: Optional[Mesh] = None,
                  width: int = 4, ngram: int = 3, rounds_per_chunk: int = 8,
                  spec_auto: bool = True,
                  device=None) -> "MultiHostSpecEngine":
        """A multi-host speculative engine on a checkpoint file (see
        ``MultiHostEngine.load``)."""
        ec, cfg, params, tok = _load(ckpt_path, tokenizer_path, file_type,
                                     qtype, engine_config, mesh, device)
        return MultiHostSpecEngine(cfg, params, tok, ec, decode_chunk, mesh,
                                   width, ngram, rounds_per_chunk, spec_auto,
                                   device, sharded=True)

    # one host's rounds are the single-host engine's
    _set_history = SpecBatchedEngine._set_history
    _write_history = SpecBatchedEngine._write_history
    _resync_history = SpecBatchedEngine._resync_history
    _spec_chunk = SpecBatchedEngine._spec_chunk
    _run_spec_chunk = SpecBatchedEngine._run_spec_chunk
    acceptance = SpecBatchedEngine.acceptance

    def _local_plan(self) -> np.ndarray:
        """The parent's plan, then SPECR and the vote (last, so that the
        parent's column offsets hold)."""
        plan = super()._local_plan()
        specr = self.R
        live = [r for r in self.slot_req if r is not None]
        if live:
            budget = max(r.max_new_tokens - len(r.output_tokens)
                         for r in live)
            specr = max(1, -(-budget // self.width))
        if self.ec.qos_chunk and self.queue:
            specr = min(specr, max(1, self.ec.qos_chunk // self.width))
        vote = 1
        if self._tuner is not None:
            # a measured rate: the host lead's vote
            vote = int(self._tuner.choose())
            if self._host_group is not None:
                vote = distributed.agree(vote, self._host_group)
        return np.concatenate([plan, np.asarray([specr, vote], np.int64)])

    def step(self) -> bool:
        before = [r is not None for r in self.slot_req]
        plans = self._gather_plans()
        self._run_admissions(plans)
        newly = [b for b, r in enumerate(self.slot_req)
                 if r is not None and not before[b]]
        if newly:
            self._write_history(newly)
            self._io_dirty = True
        if not plans[:, _PLAN_LIVE].any():
            return False

        D = self.width
        # R and the spec/plain choice from the gathered plans alone
        R = min(self.R, int(plans[:, -2].min()),
                max(0, self.S - 1 - self._plans_max_pos(plans)) // D)
        use_spec = R >= 1 and bool(plans[:, -1].min())
        tok0 = self.stats.decode_tokens
        if not use_spec:
            # plain rounds: near the context limit they keep the
            # generation contract; under the tuners they are the fleet's
            # measured choice
            dt = self._decode_round(plans)
            self.arm_chunks[0] += 1
            if self._tuner is not None and R >= 1:
                self._tuner.record(0, self.stats.decode_tokens - tok0, dt)
            self._hist_stale = True
            self._io_dirty = True
            return bool(self.queue) or bool(self._live_slots())
        live = self._live_slots()
        if live:
            dt = self._run_spec_chunk(
                live, D, R, bool(plans[:, _PLAN_GREEDY].all()))
            if self._tuner is not None:
                self._tuner.record(1, self.stats.decode_tokens - tok0, dt)
        return bool(self.queue) or bool(self._live_slots())
