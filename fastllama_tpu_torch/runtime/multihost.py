"""Multi-host continuous batching (port of
``fastllama_tpu/runtime/multihost.py``): per-host admission over the
mesh's 'data' axis, tensor parallelism over 'model' within a host.

A host is a data coordinate.  The port runs one process a card
(``parallel/``), and the ranks that share a 'data' index form that host's
'model' group; the JAX package runs one process a host, its 'model' axis
the process's chips (``multihost.py:112-138``).  Under torchrun the
default mesh is ``data = WORLD_SIZE / LOCAL_WORLD_SIZE``, ``model =
LOCAL_WORLD_SIZE`` (``parallel/distributed.default_mesh_spec``).  Each
host owns ``max_batch_size`` cache slots, on its ranks, and admits its own
clients' prompts: every rank of a host is given the same submissions.

Lockstep protocol, field for field the JAX engine's:

* each :meth:`step` starts with one all-gather of every rank's plan vector
  (:meth:`_local_plan`: live flag, chunk bound, greedy flag, max position,
  then per-bucket counts of full prefills and of prefix hits) over a gloo
  group on the host (``parallel/distributed.control_group``: under NCCL a
  plan costs no device sync); every rank takes the same decisions from the
  host leads' rows (model coordinate 0): hit waves first, then one
  admission wave per bucket with fleet-wide demand, largest first
  (``_ADMIT_CAP``, ``_HIT_CAP``), then one decode chunk of K = the min over
  hosts, greedy when every host is;
* a row carries a digest of its rank's submissions, and a host whose
  ranks' rows differ raises RuntimeError naming the host and its ranks,
  on every rank at once (no rank waits in a later collective);
* :meth:`run` ends when no host has work (one all-gathered flag a step);
  :meth:`global_stats` sums the hosts' counters and takes the max of
  their times, one row a host.

Where the port departs from the JAX engine:

* the steps run per host: ``models/batched.py``'s ``prefill_many``,
  ``decode_step`` and ``prefill_into_slot_at`` (and ``spec_decode_step``,
  ``runtime/spec_multihost.py``) on the host's view of the mesh
  (``parallel/sharding.host_mesh``: 'data' of size 1, the host's 'model'
  group), with the same kernels as on one card at the shard shapes.  No
  collective of a step crosses hosts; the only traffic between hosts is
  the plan all-gather, the run flag and the stats, the scaling model of
  ``multihost.py:40-49``;
* no sink slot (``multihost.py:165-170``): the JAX engine pads each wave
  into a reserved slot so that every host issues the same SPMD program;
  here a host with nothing in a fleet-wide wave, or no live slot in a
  decode chunk, skips its launch;
* no downgrade: one mesh path, always on the kernels (JAX serves its
  GSPMD jnp path without ``spmd_kernels``, ``multihost.py:185-189``);
  ``spmd_kernels`` is accepted and changes nothing;
* sampled slots draw from per-request generators seeded by
  ``batching._fold_seed``, as in ``BatchedEngine`` (JAX's ``[seed,
  counter]`` threefry keys have no torch counterpart);
* a clock-driven choice (a deadline's expiry; the speculative tuner's
  vote) is the host lead's, agreed over the host's 'model' group;
* the prefix cache stays host-local, as in JAX: ``BatchedEngine``'s
  rolling-hash index and tail path, one call a hit, on the host's view.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Optional, Sequence

import numpy as np

from fastllama_tpu_torch.config import EngineConfig, ModelConfig
from fastllama_tpu_torch.loaders.tokenizer import Tokenizer
from fastllama_tpu_torch.models.llama import LlamaParams
from fastllama_tpu_torch.parallel import distributed
from fastllama_tpu_torch.parallel.sharding import (DATA_AXIS, MODEL_AXIS,
                                                   Mesh, host_mesh,
                                                   make_mesh)
from fastllama_tpu_torch.runtime.batching import (BatchedEngine, BatchStats,
                                                  Request)

# lockstep plan vector layout: one row a host; the fixed fields are
# followed by a per-bucket admission histogram and a per-bucket prefix-hit
# histogram (multihost.py:76-81)
_PLAN_LIVE = 0       # 1 if the host has live slots after admission
_PLAN_KMAX = 1       # the host's max safe decode-chunk length
_PLAN_GREEDY = 2     # 1 if all the host's live and admitted requests are greedy
_PLAN_MAXPOS = 3     # the host's max position after its planned hit admissions
_PLAN_NFIX = 4       # then: NB full-prefill counts, NB prefix-hit counts

# admissions a host per wave, and prefix hits a host per hit wave (the JAX
# engine's compile-key bounds, multihost.py:88-102, kept so that the waves
# follow the same schedule)
_ADMIT_CAP = 16
_HIT_CAP = 4


def _fold_digest(digest: int, req: Request) -> int:
    """The running digest of a rank's submissions, ``req`` folded in."""
    h = hashlib.blake2b(digest_size=8)
    h.update(repr((digest, req.prompt_tokens, req.max_new_tokens,
                   req.temperature, req.topp, req.seed, req.stop_tokens,
                   req.priority, req.deadline_s)).encode())
    return int.from_bytes(h.digest(), "little", signed=True)


def _mesh_spec(mesh: Mesh) -> str:
    return f"data={mesh.shape[DATA_AXIS]},model={mesh.shape[MODEL_AXIS]}"


class MultiHostEngine(BatchedEngine):
    """Continuous batching across the hosts of a mesh of ranks.

    Each host calls :meth:`submit` with its own clients' prompts (every
    rank of the host the same) and every rank drives :meth:`step` /
    :meth:`run` in lockstep.  ``mesh``: the world's mesh (default
    ``engine_config.mesh``, else one host a machine); ``device=None``: the
    rank's device from ``parallel.distributed.initialize`` (the card
    without a process group).  ``sharded``: ``params`` are this rank's
    shard already (the load entry points build them so)."""

    def __init__(self, config: ModelConfig, params: LlamaParams,
                 tokenizer: Tokenizer,
                 engine_config: Optional[EngineConfig] = None,
                 decode_chunk: int = 16, mesh: Optional[Mesh] = None,
                 device=None, *, sharded: bool = False):
        ec = engine_config or EngineConfig()
        if mesh is None:
            mesh = make_mesh(ec.mesh or distributed.default_mesh_spec())
        self.world_mesh = mesh
        self.n_hosts = mesh.shape[DATA_AXIS]
        self.host = mesh.index(DATA_AXIS)
        self.lead = mesh.index(MODEL_AXIS) == 0
        ec = dataclasses.replace(ec, mesh=_mesh_spec(mesh))
        if mesh.size > 1:
            # fused layouts only on a one-device mesh (multihost.py:140-156)
            ec = dataclasses.replace(ec, fuse_weights=False)
        super().__init__(config, params, tokenizer, ec, decode_chunk, device,
                         sharded=sharded)
        self._host_group = (self.mesh.group(MODEL_AXIS)
                            if self.mesh.shape[MODEL_AXIS] > 1 else None)
        if distributed.is_multiprocess():
            distributed.control_group()
        # admission-wave bucket levels (ascending; S is always last)
        self._buckets = sorted({min(b, self.S) for b in ec.prefill_buckets
                                if b <= self.S} | {self.S})
        self._planned_hits = {}
        self._digest = 0

    def _open_mesh(self, ec: EngineConfig, device):
        """The steps run on the host's view of the mesh."""
        from fastllama_tpu_torch.device import resolve_device
        if device is None:
            device = distributed.rank_device()
        return host_mesh(self.world_mesh), resolve_device(device)

    @staticmethod
    def load(ckpt_path: str, tokenizer_path: str = "", file_type=None,
             qtype=None, engine_config: Optional[EngineConfig] = None,
             decode_chunk: int = 16, mesh: Optional[Mesh] = None,
             device=None) -> "MultiHostEngine":
        """A multi-host engine on a checkpoint file: each rank builds its
        shard alone on its device (see ``BatchedEngine.load``)."""
        ec, cfg, params, tok = _load(ckpt_path, tokenizer_path, file_type,
                                     qtype, engine_config, mesh, device)
        return MultiHostEngine(cfg, params, tok, ec, decode_chunk, mesh,
                               device, sharded=True)

    # -- scheduling ------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 256,
               temperature: float = 0.0, topp: float = 0.9,
               seed: int = 128391297,
               stop_tokens: Optional[Sequence[int]] = None,
               callback=None, priority: int = 0,
               deadline_s: float = 0.0) -> Request:
        """Queue one of this host's jobs (ids are unique across hosts)."""
        req = super().submit(prompt, max_new_tokens, temperature, topp, seed,
                             stop_tokens, callback, priority, deadline_s)
        req.id = (self._next_id - 1) * self.n_hosts + self.host
        self._digest = _fold_digest(self._digest, req)
        return req

    def _late(self) -> set:
        """The host lead's expiries, agreed every round over the host's
        'model' group (unconditionally: ranks given different submissions
        must reach the plan gather, which names them, and not wait here)."""
        now = time.perf_counter()
        late = {r.id for r in self.queue
                if r.deadline_s > 0 and now - r.submit_s > r.deadline_s}
        if self._host_group is None:
            return late
        return distributed.agree(late, self._host_group)

    def _local_plan(self) -> np.ndarray:
        """This host's plan vector (``multihost.py:569-642``)."""
        self._qos_queue_pass()
        NB = len(self._buckets)
        plan = np.zeros(_PLAN_NFIX + 2 * NB, np.int64)
        free = self._free_slots()
        # the whole backlog this round, bounded by free slots
        take = min(len(free), len(self.queue))
        # prefix hits plan into the second bank (counts by tail bucket),
        # remembered so that admission takes exactly what was planned
        self._planned_hits = {}
        hit_ids = set()
        if self._prefix_enabled:
            for i in range(take):
                req = self.queue[i]
                donor, plen = self._prefix_lookup(req.prompt_tokens)
                if donor is not None:
                    tb = self._bucket(len(req.prompt_tokens) - plen)
                    self._planned_hits.setdefault(tb, []).append(
                        (req, donor, plen))
                    hit_ids.add(req.id)
                    plan[_PLAN_NFIX + NB + self._buckets.index(tb)] += 1
        for i in range(take):
            req = self.queue[i]
            if req.id not in hit_ids:
                b = self._bucket(len(req.prompt_tokens))
                plan[_PLAN_NFIX + self._buckets.index(b)] += 1
        live = self._live_slots()
        plan[_PLAN_LIVE] = int(bool(live) or take > 0)
        if live:
            kmax = min(self.decode_chunk,
                       min(self.S - 1 - int(self.pos[i]) for i in live),
                       max(r.max_new_tokens - len(r.output_tokens)
                           for r in (self.slot_req[i] for i in live)))
            if self.ec.qos_chunk and self.queue:
                # requests wait on a full batch: cap the fleet's chunk
                kmax = min(kmax, self.ec.qos_chunk)
            plan[_PLAN_KMAX] = max(1, kmax)
        else:
            plan[_PLAN_KMAX] = self.decode_chunk
        # GREEDY covers the requests this plan admits too: the chunk after
        # the admission waves uses the gathered flag (multihost.py:619-626)
        plan[_PLAN_GREEDY] = int(
            all(self.slot_req[i].temperature <= 0.0 for i in live) and
            all(self.queue[i].temperature <= 0.0 for i in range(take)))
        # MAXPOS bounds the position after this plan's hit admissions;
        # full prefills are bounded by their wave's bucket (_plans_max_pos)
        maxpos = max((int(self.pos[i]) for i in live), default=0)
        for hits in self._planned_hits.values():
            for req, _donor, _plen in hits:
                maxpos = max(maxpos, len(req.prompt_tokens))
        plan[_PLAN_MAXPOS] = maxpos
        return plan

    def _gather_plans(self) -> np.ndarray:
        """One all-gather of every rank's plan (and submissions' digest);
        returns the host leads' plans, (n_hosts, plan length).  Raises
        RuntimeError on every rank when a host's ranks disagree."""
        plan = self._local_plan()
        rows = distributed.allgather_rows(
            np.concatenate([[self._digest], plan]).astype(np.int64))
        mp = self.world_mesh.shape[MODEL_AXIS]
        rows = rows.reshape(self.n_hosts, mp, -1)
        for d in range(self.n_hosts):
            if any(not np.array_equal(rows[d, m], rows[d, 0])
                   for m in range(1, mp)):
                raise RuntimeError(
                    f"host {d}: its ranks {list(range(d * mp, (d + 1) * mp))}"
                    f" disagree on their submissions or plans (every rank of "
                    f"a host must be given the same submissions)")
        return rows[:, 0, 1:]

    def _admit_wave(self, a: int, bucket: int) -> None:
        """One fleet-wide (a, bucket) admission wave: this host admits up
        to ``a`` of its queued requests of this bucket (none: it skips the
        launch)."""
        free = self._free_slots()
        items = []
        kept = deque()
        while self.queue and len(items) < min(len(free), a):
            req = self.queue.popleft()
            if self._bucket(len(req.prompt_tokens)) == bucket:
                items.append((req, free[len(items)]))
            else:
                kept.append(req)
        kept.extend(self.queue)
        self.queue = kept
        if items:
            self._run_wave(bucket, items)

    def _admit_hit_wave(self, bucket: int, idx0: int, k: int) -> None:
        """One fleet-wide hit wave: this host admits its planned hits
        [idx0, idx0 + k) of tail bucket ``bucket``, one tail call each."""
        free = iter(self._free_slots())
        for req, donor, plen in self._planned_hits.get(bucket, [])[
                idx0:idx0 + k]:
            self.queue.remove(req)
            self._admit_prefix_hit(req, next(free), donor, plen)

    def _run_admissions(self, plans: np.ndarray) -> None:
        """The fleet's planned admissions as waves every rank derives from
        the gathered plans (``multihost.py:784-814``)."""
        NB = len(self._buckets)
        # hit waves first (donors are live at plan time), k hits a host
        for j in range(NB - 1, -1, -1):
            h = int(plans[:, _PLAN_NFIX + NB + j].max())
            w = 0
            while w < h:
                k = min(1 << (h - w - 1).bit_length(), _HIT_CAP)
                self._admit_hit_wave(self._buckets[j], w, k)
                w += k
        # one wave per bucket with fleet-wide demand, largest first, until
        # the whole fleet's demand is drained
        for j in range(NB - 1, -1, -1):
            d = int(plans[:, _PLAN_NFIX + j].max())
            while d > 0:
                a = min(1 << (d - 1).bit_length(), _ADMIT_CAP)
                self._admit_wave(a, self._buckets[j])
                d -= a

    def _plans_max_pos(self, plans: np.ndarray) -> int:
        """The fleet's max position after this round's admissions, from
        the gathered plans alone (``multihost.py:816-827``)."""
        NB = len(self._buckets)
        max_pos = int(plans[:, _PLAN_MAXPOS].max())
        for j in range(NB):
            if plans[:, _PLAN_NFIX + j].max() > 0:
                max_pos = max(max_pos, self._buckets[j])
        return max_pos

    def step(self) -> bool:
        """One lockstep round across all hosts: True while this host still
        has work."""
        plans = self._gather_plans()
        self._run_admissions(plans)
        if not plans[:, _PLAN_LIVE].any():
            return False
        self._decode_round(plans)
        return bool(self.queue) or bool(self._live_slots())

    def _decode_round(self, plans: np.ndarray) -> float:
        """One decode chunk of the fleet's K (the exact min over hosts),
        greedy when every host is; a host with no live slot skips it.
        Returns its seconds."""
        K = max(1, int(plans[:, _PLAN_KMAX].min()))
        greedy = bool(plans[:, _PLAN_GREEDY].all())
        live = self._live_slots()
        if not live:
            return 0.0
        return self._plain_chunk(live, (K, greedy))

    def run(self) -> BatchStats:
        """Drain every host's queue (steps while any host has work).
        ``FASTLLAMA_PIPELINE`` is not read, as JAX's ``run`` does not
        (``multihost.py:900-907``): the lockstep rounds run as without
        it."""
        while True:
            more = self.step()
            flags = distributed.allgather_rows(
                np.asarray([int(more or bool(self.queue))], np.int64))
            if not flags.any():
                return self.stats

    def global_stats(self) -> BatchStats:
        """The fleet's aggregate, one row a host (its lead's): counters
        summed, times the max (the hosts run in lockstep, so the max is the
        fleet's wall clock).  Every rank must call it."""
        s = self.stats
        counts = distributed.allgather_rows(np.asarray(
            [s.completed, s.total_prompt_tokens, s.total_output_tokens,
             s.decode_tokens, s.prefix_hits, s.prefix_rows_reused,
             s.rejected], np.int64))
        times = distributed.allgather_rows(
            np.asarray([s.decode_s, s.prefill_s], np.float64))
        mp = self.world_mesh.shape[MODEL_AXIS]
        c = counts.reshape(self.n_hosts, mp, -1)[:, 0].sum(axis=0)
        t = times.reshape(self.n_hosts, mp, -1)[:, 0].max(axis=0)
        return BatchStats(
            completed=int(c[0]), total_prompt_tokens=int(c[1]),
            total_output_tokens=int(c[2]), decode_tokens=int(c[3]),
            prefix_hits=int(c[4]), prefix_rows_reused=int(c[5]),
            rejected=int(c[6]), decode_s=float(t[0]), prefill_s=float(t[1]))


def _load(ckpt_path, tokenizer_path, file_type, qtype, engine_config, mesh,
          device):
    """(engine config with its mesh, config, this rank's shard of the
    parameters, tokenizer) for the multi-host load entry points."""
    from fastllama_tpu_torch.loaders.registry import (FileType,
                                                      resolve_and_build)
    ec = engine_config or EngineConfig()
    if mesh is not None:
        ec = dataclasses.replace(ec, mesh=_mesh_spec(mesh))
    elif not ec.mesh:
        ec = dataclasses.replace(ec, mesh=distributed.default_mesh_spec())
    cfg, params, tok = resolve_and_build(
        ckpt_path, tokenizer_path, file_type or FileType.UNKNOWN, qtype, ec,
        device)
    return ec, cfg, params, tok
