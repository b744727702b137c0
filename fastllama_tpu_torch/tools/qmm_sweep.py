"""Steady-state bandwidth sweep of the dequant-matmul (port of
``tools/qmm_sweep.py``): ``qmatmul_pallas`` at the LLaMA2-7B decode
shapes, each split-K count and each mode (standard K1/K1p and groupdot),
in GB/s of weight and scale bytes and as a share of the card's measured
read bandwidth.  At T <= 128 the standard variants run K1/K1p's pipelined
mode (``qmm.qmm_mode``) and the groupdot variants its groupdot
instantiation (``qmm.groupdot_kernel``), each split count through its own
plan (the same explicit-split rule for both).

The weights rotate over enough copies (three times the L2 cache in all)
that every launch finds its weight cold in L2, as a decode step finds each
layer's; a 4096x4096 INT8 weight (16.8 MB and 1 MB of f32 scales) would
otherwise sit in L2 and read above the bound.  Each variant is timed with
:func:`~fastllama_tpu_torch.tools.timing.time_ms` (device time).  A
variant that raises is reported as a failure on stderr and the sweep goes
on; the kernel itself never gives way to the plain version.

Run on the card:  python3 -m fastllama_tpu_torch.tools.qmm_sweep
Env: SWEEP_SHAPES=4096x4096,4096x12288,4096x22016,11008x4096 (IxO; at
int4 11008 is padded to 11264, as the INT4 serving shape is), SWEEP_T=1,
SWEEP_ITERS=100, SWEEP_QUANT=int8|int4, SWEEP_SCALE_DTYPE=float32|bfloat16,
SWEEP_PEAK_GBS (unset: the ``hbm_peak`` probe runs once).
``--device cpu`` runs it on the host (a CPU number, for the tests).
Prints one line per variant on stderr and the JSON list of
``{shape, variant, gbs, eff}`` on stdout.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

from fastllama_tpu_torch.config import QuantType
from fastllama_tpu_torch.device import resolve_device, torch_dtype
from fastllama_tpu_torch.ops.kernels import qmm
from fastllama_tpu_torch.quant.groupquant import QArray
from fastllama_tpu_torch.tools.timing import time_ms

SHAPES_7B = ((4096, 4096), (4096, 12288), (4096, 22016), (11008, 4096))
INT4_HIDDEN = {11008: 11264}         # the INT4 serving shape's padded w2
MAX_SPLITS = 16                      # the auto rule's own cap
GS = 64


def default_shapes(quant: str):
    if quant == "int4":
        return [(INT4_HIDDEN.get(I, I), O) for I, O in SHAPES_7B]
    return list(SHAPES_7B)


def weight_bytes(I: int, O: int, quant: str, scale_itemsize: int,
                 gs: int = GS) -> int:
    """Weight plus scale bytes, the JAX sweep's count
    (``tools/qmm_sweep.py:109-111``)."""
    wbytes = I * O // 2 if quant == "int4" else I * O
    return wbytes + I * O // gs * scale_itemsize


def make_weights(I: int, O: int, quant: str, scale_dtype, copies: int,
                 device):
    """``copies`` (I, O) weights made on the device: random int8 values (any
    byte of a packed INT4 weight) and constant 0.01 group scales, as the
    JAX sweep makes them."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    packed = quant == "int4"
    rows, lo = (I // 2, -128) if packed else (I, -127)
    qt = QuantType.INT4 if packed else QuantType.INT8
    out = []
    for _ in range(copies):
        data = torch.randint(lo, 128, (rows, O), generator=gen, device=dev,
                             dtype=torch.int8)
        s = torch.full((I // GS, O), 0.01, dtype=scale_dtype, device=dev)
        out.append(QArray(data, s, qt, GS, group_axis=-2, packed=packed))
    return out


def variants(w: QArray, T: int, explicit: bool = True):
    """[(label, groupdot, splits)]: the auto split and every split count
    that fits this weight (:func:`qmm.split_plan`, up to 16), each in
    standard and groupdot mode."""
    I = 2 * w.data.shape[0] if w.packed else w.data.shape[0]
    counts = [None]
    if explicit:
        for s in range(1, MAX_SPLITS + 1):
            try:
                qmm.split_plan(T, I, w.data.shape[1], w, torch.bfloat16, s)
            except ValueError:
                continue
            counts.append(s)
    out = []
    for gd in (False, True):
        for s in counts:
            label = "auto" if s is None else f"splits{s}"
            out.append((("groupdot_" if gd else "") + label, gd, s))
    return out


def sweep(shapes, T: int = 1, quant: str = "int8", scale_dtype="float32",
          iters: int = 100, peak: float = None, device=None,
          explicit: bool = True, log=None):
    """Time every variant of every (I, O) shape; returns the JSON rows.
    ``peak``: the GB/s that ``eff`` divides by."""
    dev = resolve_device(device)
    sdt = torch_dtype(scale_dtype)
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    l2 = (torch.cuda.get_device_properties(dev).L2_cache_size
          if dev.type == "cuda" else 0)
    results = []
    for I, O in shapes:
        nbytes = weight_bytes(I, O, quant, sdt.itemsize)
        copies = max(2, math.ceil(3 * l2 / nbytes))
        ws = make_weights(I, O, quant, sdt, copies, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        x = torch.randn((T, I), generator=gen, device=dev).to(torch.bfloat16)
        turn = [0]

        def nxt():
            turn[0] = (turn[0] + 1) % copies
            return ws[turn[0]]
        for label, gd, s in variants(ws[0], T, explicit):
            try:
                ms = time_ms(lambda: qmm.qmatmul_pallas(
                    x, nxt(), groupdot=gd, splits=s), iters=iters,
                    warmup=3, device=dev)
            except Exception as e:          # noqa: BLE001 - sweep goes on
                log(f"# {I}x{O} {label}: FAIL {type(e).__name__}: {e}")
                continue
            gbs = nbytes / (ms * 1e-3) / 1e9
            eff = gbs / peak
            log(f"# {I}x{O} T={T} {label}: {gbs:7.1f} GB/s  "
                f"({eff * 100:4.1f}% of {peak:.0f})")
            results.append({"shape": f"{I}x{O}", "variant": label,
                            "gbs": round(gbs, 1), "eff": round(eff, 3)})
        del ws
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    quant = os.environ.get("SWEEP_QUANT", "int8")
    if quant not in ("int8", "int4"):
        raise ValueError(f"SWEEP_QUANT {quant!r}: int8 or int4")
    T = int(os.environ.get("SWEEP_T", "1"))
    iters = int(os.environ.get("SWEEP_ITERS", "100"))
    shapes = ([tuple(int(v) for v in s.split("x"))
               for s in os.environ["SWEEP_SHAPES"].split(",")]
              if os.environ.get("SWEEP_SHAPES") else default_shapes(quant))
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (host clock)")
    print(f"# device: {name}", file=sys.stderr, flush=True)
    peak = os.environ.get("SWEEP_PEAK_GBS")
    if peak is None:
        from fastllama_tpu_torch.tools.hbm_peak import peak_gbs
        peak = peak_gbs(device=dev, log=lambda s: print(
            f"# {s}", file=sys.stderr, flush=True))
    peak = float(peak)
    print(f"# peak {peak:.1f} GB/s", file=sys.stderr, flush=True)
    print(json.dumps(sweep(shapes, T, quant,
                           os.environ.get("SWEEP_SCALE_DTYPE", "float32"),
                           iters, peak, dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
