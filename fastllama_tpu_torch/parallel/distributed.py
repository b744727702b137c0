"""Process-group initialization (port of
``fastllama_tpu/parallel/distributed.py``).

One process a rank, every rank running the same program: the engines take
the same decisions on the same submissions, in lockstep, and the only
traffic between ranks is the collectives of ``parallel/spmd_step.py`` (and
:func:`agree` for the few scheduler choices that read a clock).  The
multi-host engines (``runtime/multihost.py``) add host-side control data,
the plan vectors, the run flag and the stats, gathered over
:func:`control_group` by :func:`allgather_rows`.  Failure
is initialize-or-die, as in the JAX package, with one difference: where
JAX keeps going single-process when its runtime refuses to start, the
port raises.

Usage, one process a card under ``torchrun``::

    from fastllama_tpu_torch.parallel import distributed
    distributed.initialize()                # RANK, WORLD_SIZE, ... from torchrun
    mesh = distributed.global_mesh("data=2,model=4")

or with explicit arguments (``init_method="tcp://localhost:PORT"``, the
world size, the rank, the backend and the rank's device).  Without
arguments and without torchrun's variables it is a no-op, so the same
serving script runs on one card.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from fastllama_tpu_torch.device import resolve_device
from fastllama_tpu_torch.utils.logging import log_info

_rank_device: Optional[torch.device] = None
_control = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_multiprocess() -> bool:
    return is_initialized() and dist.get_world_size() > 1


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device: Optional[Union[str, torch.device]] = None
               ) -> Optional[torch.device]:
    """Join a ``torch.distributed`` process group; returns this rank's
    device (None for the no-op).

    Arguments not given come from torchrun's variables (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` as ``env://``).  The
    rank's device is ``device`` or ``cuda:{LOCAL_RANK}``; with neither it
    raises.  ``backend`` defaults to ``nccl`` for a CUDA rank and ``gloo``
    for a CPU rank.  A call in a process already in a group returns its
    device.  Anything that goes wrong raises: there is no single-process
    fallback."""
    global _rank_device
    if is_initialized():
        return _rank_device
    explicit = (init_method is not None or world_size is not None
                or rank is not None)
    if not explicit and not ("RANK" in os.environ
                             and "WORLD_SIZE" in os.environ):
        log_info("distributed.initialize: single-process run (no-op)")
        return None
    if rank is None:
        rank = int(_env("RANK"))
    if world_size is None:
        world_size = int(_env("WORLD_SIZE"))
    if init_method is None:
        _env("MASTER_ADDR")
        _env("MASTER_PORT")
        init_method = "env://"
    if device is None:
        if "LOCAL_RANK" not in os.environ:
            raise ValueError("distributed.initialize: pass device= or set "
                             "LOCAL_RANK (torchrun sets it)")
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if dev.type == "cuda":
        # DeviceMesh and NCCL take the current device as the rank's
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    _rank_device = dev
    log_info(f"distributed: rank {rank}/{world_size} on {dev} ({backend})")
    return dev


def _env(name: str) -> str:
    if name not in os.environ:
        raise ValueError(f"distributed.initialize: {name} is not set; pass "
                         f"the arguments explicitly or run under torchrun")
    return os.environ[name]


def rank_device() -> Optional[torch.device]:
    """The device :func:`initialize` gave this rank (None before it)."""
    return _rank_device


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    global _rank_device, _control
    if is_initialized():
        dist.destroy_process_group()
    _rank_device = None
    _control = None


def agree(value, group=None):
    """The ``value`` of the first rank of ``group`` (None: the world) on
    every rank of it (a picklable object; identity outside a multi-rank
    group and on a group of one rank).  The engines take a scheduler
    choice that reads a clock (a deadline, the speculative tuner's arm)
    through it, so that every rank takes the same; the multi-host engines
    over a host's 'model' group, whose first rank is the host's lead."""
    if not is_multiprocess():
        return value
    src = 0
    if group is not None:
        if dist.get_world_size(group) == 1:
            return value
        src = dist.get_global_rank(group, 0)
    box = [value]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def control_group():
    """A gloo group over every rank of the world, for host-side control
    data (the multi-host engines' plans, run flag and stats): CPU
    tensors, so that under NCCL a plan costs no device sync and no copy.
    The world group itself where its backend is gloo; otherwise a group
    made on first use, which every rank reaches in the same order (the
    engines' constructors)."""
    global _control
    if _control is None:
        _control = (dist.group.WORLD if dist.get_backend() == "gloo"
                    else dist.new_group(backend="gloo"))
    return _control


def allgather_rows(row: np.ndarray) -> np.ndarray:
    """Every rank's ``row`` (a 1-D numpy array of one length and dtype on
    every rank) in rank order, (world, n), gathered over
    :func:`control_group`; ``row[None]`` outside a multi-rank group."""
    row = np.ascontiguousarray(row)
    if not is_multiprocess():
        return row[None].copy()
    t = torch.from_numpy(row)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t, group=control_group())
    return torch.stack(parts).numpy()


def default_mesh_spec() -> str:
    """The multi-host layout of the world: 'data=H,model=M' with M =
    ``LOCAL_WORLD_SIZE`` (torchrun's ranks on this machine: one process a
    card) and H = ``WORLD_SIZE`` / M, a host a machine, as the JAX
    package's data = process count, model = local device count
    (``multihost.py:293-296``).  Without ``LOCAL_WORLD_SIZE`` every rank
    is on one host."""
    world = dist.get_world_size() if is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < 1 or world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE {local} does not divide the "
                         f"world of {world} ranks")
    return f"data={world // local},model={local}"


def global_mesh(spec: str = ""):
    """The mesh over every rank of the group ('data' outermost, so that a
    host boundary falls between data shards and the per-layer all-reduces
    of the 'model' axis stay within a host)."""
    from fastllama_tpu_torch.parallel.sharding import make_mesh
    return make_mesh(spec)


def free_port() -> int:
    """A free TCP port on localhost, for a process group's address."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(rank, fn, world, port, outdir, args, join, device, backend):
    import pickle
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)        # several ranks share the host
    if join:
        initialize(f"tcp://localhost:{port}", world, rank, backend=backend,
                   device=device)
    else:
        # torchrun's variables, for an entry point that joins by itself
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        out = fn(rank, *args)
    finally:
        shutdown()
    with open(os.path.join(outdir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(fn, world: int, *args, join: bool = True,
              device: Union[str, torch.device] = "cpu",
              backend: Optional[str] = None,
              timeout: float = 120.0) -> list:
    """``fn(rank, *args)`` on ``world`` ranks spawned on this host, each a
    process that joins a group on a free localhost port on ``device`` with
    ``backend`` (or, ``join=False``, finds torchrun's variables set for
    an entry point that joins by itself); their results (picklable) in
    rank order.  ``fn`` must be importable by the children (a module's
    function).  A rank that raises or exits non-zero fails the call, and
    so does one still running after ``timeout`` seconds; no rank is left
    running."""
    import pickle
    import shutil
    import tempfile
    import time

    import torch.multiprocessing as mp
    outdir = tempfile.mkdtemp()
    try:
        ctx = mp.start_processes(
            _spawned, args=(fn, world, free_port(), outdir, args, join,
                            str(device), backend),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__} on {world} ranks "
                                       f"ran past {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        out = []
        for r in range(world):
            with open(os.path.join(outdir, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
