"""The port's device timer.

On a card, a short kernel finishes before Python has queued the next one,
so CUDA events around back-to-back calls would time the host.
:func:`time_ms` first holds the device in a sleep kernel longer than the
host takes to queue all the calls (measured on a dry pass), so the timed
calls run back to back on the device; the timed region ends with a sync.
On the CPU (the tests) it reads the host clock: a CPU number, never a
device one.
"""
from __future__ import annotations

import time

import torch


def time_ms(fn, iters: int = 20, warmup: int = 3, device=None) -> float:
    """ms per call of ``fn`` (after ``warmup`` calls) on ``device`` (None:
    the current CUDA device)."""
    if device is not None and torch.device(device).type == "cpu":
        for _ in range(warmup):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - h0
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    # cycles at 2 GHz, above the H100's top SM clock: the sleep lasts at
    # least this long
    torch.cuda._sleep(int((2 * host_s + 2e-3) * 2e9))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def in_turns(fns, iters: int = 20):
    """Device ms of each of ``fns`` (key -> callable), timed in turns: each
    in order, then each in the reverse order, the two readings averaged, so
    that a drift of the card's clock falls on every version alike."""
    got = {k: 0.0 for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            got[k] += time_ms(fns[k], iters=iters) / 2
    return got
