"""Sustained device-memory read bandwidth of the card, as a reduction
reaches it (port of ``tools/hbm_peak.py``): the denominator of the qmm
sweep's efficiency.

A reduction (``torch.sum`` to f32) streams a resident bf16 buffer; each
buffer (128, 512 and 1024 MB) exceeds the H100's 50 MB L2, so every launch
reads device memory.  Timed with CUDA events after a warm-up, the device
held so that the launches run back to back (:mod:`.timing`); each timed
region ends with a sync.  The best of three timings per buffer is kept;
the probe's result is the best buffer's GB/s.

Run on the card:  python3 -m fastllama_tpu_torch.tools.hbm_peak
Env:  HBM_MB=128,512,1024 (buffer sizes), HBM_ITERS=16
``--device cpu`` runs it on the host (a CPU number, for the tests).
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from fastllama_tpu_torch.device import resolve_device
from fastllama_tpu_torch.tools.timing import time_ms

DEFAULT_MB = (128, 512, 1024)


def read_gbs(mb: int, iters: int = 16, device=None) -> float:
    """GB/s of ``torch.sum`` over an ``mb`` MB bf16 buffer (best of three
    timings of ``iters`` reductions)."""
    dev = resolve_device(device)
    n = mb * 2 ** 20 // 2
    x = torch.randn(n, dtype=torch.bfloat16, device=dev)
    best = min(time_ms(lambda: torch.sum(x, dtype=torch.float32),
                       iters=iters, warmup=2, device=dev)
               for _ in range(3))
    del x
    return n * 2 / (best * 1e-3) / 1e9


def measure(mbs=DEFAULT_MB, iters: int = 16, device=None, log=None):
    """[(mb, GB/s)] for each buffer, logged as the JAX probe logs them."""
    out = []
    for mb in mbs:
        gbs = read_gbs(mb, iters, device)
        out.append((mb, gbs))
        if log is not None:
            log(f"buffer {mb:5d} MB, {iters} iters: {gbs:7.1f} GB/s "
                f"sustained read")
    return out


def peak_gbs(mbs=None, iters=None, device=None, log=None) -> float:
    """The best GB/s over the buffers (``HBM_MB``, ``HBM_ITERS`` when not
    given)."""
    if mbs is None:
        mbs = [int(v) for v in os.environ.get(
            "HBM_MB", ",".join(map(str, DEFAULT_MB))).split(",")]
    if iters is None:
        iters = int(os.environ.get("HBM_ITERS", "16"))
    return max(g for _, g in measure(mbs, iters, device, log))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (host clock)")
    print(f"device: {name}", flush=True)
    best = peak_gbs(device=dev, log=lambda s: print(s, flush=True))
    print(f"best: {best:.1f} GB/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
