"""Design calls of K1/K1p's prefill mode (``qmm_wgmma_kernel`` in
``csrc/qmm_prefill.cu``), timed on the card in turns.

Builds ``qmm_prefill.cu`` once for each variant of its tuning macros
(``PF_STAGES`` and ``PF_STAGES_P4``, the ring's depth for K1 and K1p;
``PF_DIAG`` 1, a diagnostic that leaves out the dequant's
arithmetic and whose output is wrong; ``PF_SETMAXNREG`` 0, a diagnostic
without the register hand-over, whose wgmma ptxas serializes), every
``nvcc`` started together, into ``build/prefill_design/<variant>/``, and
times the variants at the readings of ``chip_smoke.py``'s phase 5 (one 7B
layer's four projections, bf16 x, f32 scales, INT8 at T = 2048, 512 and
256 and packed INT4 (hidden 11264) at T = 2048 and 512, layers rotating
over 2 so that a launch finds its weight cold in L2; a reading named
twice is taken twice, for the spread), in turns, beside the kernel
the wrapper runs (``build``), ``qmm_bf16_kernel``'s loop on the same calls
(``loop``) and ``torch.matmul`` on pre-dequantized bf16 weights
(``library``).  Every variant's output but ``PF_DIAG``'s is held against
the plain version (1e-2 x max|ref|) before it is timed, and each
build's registers, spills and ptxas performance notes are reported.

Run on the card:  python3 -m fastllama_tpu_torch.tools.prefill_design
Options: ``--variants base,ns4`` (default: all of ``VARIANTS``),
``--readings int8_T2048,int4_T2048`` (default: all of ``READINGS``),
``--iters N`` (timed calls a reading, default 10), ``--out FILE`` (the
JSON record, also printed on stdout).  Progress goes to stderr.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from fastllama_tpu_torch.config import QuantType
from fastllama_tpu_torch.ops.kernels import _build
from fastllama_tpu_torch.ops.kernels import qmm
from fastllama_tpu_torch.quant.groupquant import (QDTYPE, QArray, dequantize,
                                                  pack_int4_rows)
from fastllama_tpu_torch.tools.timing import in_turns

SOURCE = _build.CSRC / "qmm_prefill.cu"
OUT_DIR = _build.BUILD_ROOT.parent / "prefill_design"
MACROS = ("PF_STAGES", "PF_STAGES_P4", "PF_DIAG", "PF_SETMAXNREG")
# name -> the macros' values, in the order of MACROS
VARIANTS = {
    "base": (5, 4, 0, 1),              # the source's defaults
    "ns4": (4, 4, 0, 1),               # four stages for K1 too
    "p4ns5": (5, 5, 0, 1),             # five stages for K1p too
    "diag": (5, 4, 1, 1),              # diagnostic: no dequant arithmetic
    "no_setmaxnreg": (5, 4, 0, 0),     # diagnostic: 168 registers
}
# name -> (packed, T)
READINGS = {"int8_T2048": (False, 2048), "int4_T2048": (True, 2048),
            "int8_T512": (False, 512), "int8_T256": (False, 256),
            "int4_T512": (True, 512)}
LAYER = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
         "w2": (11008, 4096)}
INT4_HIDDEN = {11008: 11264, 22016: 22528}


def diagnostic(name: str) -> bool:
    """A variant whose output is wrong (no dequant arithmetic)."""
    return VARIANTS[name][2] != 0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_variants(names):
    """{name: (loaded library, ptxas report)} of each variant, all nvcc
    processes started together, and with them the wrapper's own build
    (``_build.build``)."""
    procs = {}
    for name in names:
        out = OUT_DIR / name
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS,
             *(f"-D{m}={v}" for m, v in zip(MACROS, VARIANTS[name])),
             "-o", str(out / "libqmm_prefill.so"), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build()
    libs = {}
    for name, p in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
        libs[name] = (ctypes.CDLL(str(OUT_DIR / name / "libqmm_prefill.so")),
                      ptxas_report(text))
    return libs


def ptxas_report(text: str) -> dict:
    """{template arguments: (registers, spill line)} of the
    ``qmm_wgmma_kernel`` instantiations of a ``-Xptxas -v`` log, and its
    performance notes (``notes``: ptxas's C75xx lines, such as wgmma
    serialized)."""
    lines = text.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*qmm_wgmma_kernel"
                      r"I(\S*?)EEv", line)
        if m:
            near = lines[i + 1:i + 6]
            used = next(t for t in near if "registers" in t)
            spill = next((t for t in near if "spill" in t), "")
            out[m.group(1)] = (
                int(re.search(r"Used (\d+) registers", used).group(1)),
                spill.strip())
    out["notes"] = [t.strip() for t in lines if "(C75" in t]
    return out


def rand_weight(gen, shape, packed: bool, dev) -> QArray:
    """(…, I, O) INT8 weight, or packed INT4, of random values and random
    positive f32 group scales, 64 rows a group."""
    qmax = 7 if packed else 127
    data = torch.empty(shape, dtype=QDTYPE[QuantType.INT8], device=dev)
    data.random_(-qmax - packed, qmax + 1, generator=gen)
    sshape = (*shape[:-2], shape[-2] // 64, shape[-1])
    s = (torch.rand(sshape, generator=gen, device=dev) + 0.5) * (0.02 / qmax)
    if packed:
        return QArray(pack_int4_rows(data), s, QuantType.INT4, 64,
                      group_axis=-2, packed=True)
    return QArray(data, s, QuantType.INT8, 64, group_axis=-2)


def rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--readings", default=",".join(READINGS))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("prefill_design: no CUDA device available")
        return 2
    names = args.variants.split(",")
    dev = torch.device("cuda")
    libs = build_variants(names)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    rec = {"device": torch.cuda.get_device_name(0), "card": card,
           "variants": {n: {"macros": dict(zip(MACROS, VARIANTS[n])),
                            "ptxas": r} for n, (_, r) in libs.items()},
           "readings": {}}
    for n, v in rec["variants"].items():
        log(f"{n}: {v['ptxas']}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1616)
    bf16, nl = torch.bfloat16, 2
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % nl
        return layer[0]
    weights = {}
    for i, key in enumerate(args.readings.split(",")):
        packed, T = READINGS[key]
        if key in rec["readings"]:      # a repeated reading
            key = f"{key}#{i}"
        if packed not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            shapes = {n: ((INT4_HIDDEN.get(I, I), INT4_HIDDEN.get(O, O))
                          if packed else (I, O))
                      for n, (I, O) in LAYER.items()}
            ws = {n: rand_weight(gen, (nl, *sh), packed, dev)
                  for n, sh in shapes.items()}
            weights[packed] = (shapes, ws, {n: dequantize(w, bf16)
                                            for n, w in ws.items()})
        shapes, ws, wds = weights[packed]
        xs = {n: torch.randn((T, I), generator=gen, device=dev).to(bf16)
              for n, (I, _) in shapes.items()}

        def run(one):
            def f():
                lyr = rot()
                for n in shapes:
                    one(n, lyr)
            return f
        fns = {n: run(lambda n, lyr, lib=lib: qmm._launch_prefill(
            xs[n], ws[n][lyr], None, None, 1e-5, lib=lib))
            for n, (lib, _) in libs.items()}
        fns["build"] = run(lambda n, lyr: qmm.qmatmul_pallas_indexed(
            xs[n], ws[n], lyr))
        fns["loop"] = run(lambda n, lyr: qmm._launch(
            xs[n], ws[n][lyr], bf16, mode="loop"))
        fns["library"] = run(lambda n, lyr: torch.matmul(xs[n], wds[n][lyr]))
        errs = {}
        for n in list(libs) + ["build"]:
            lib = libs[n][0] if n in libs else None
            for name in shapes:
                got = (qmm._launch_prefill(xs[name], ws[name][0], None, None,
                                           1e-5, lib=lib) if lib else
                       qmm.qmatmul_pallas_indexed(xs[name], ws[name], 0))
                e = rel(got, qmm.qmm_fused_plain(xs[name], ws[name][0]))
                errs[n] = max(errs.get(n, 0.0), e)
            if errs[n] > 1e-2 and not (n in libs and diagnostic(n)):
                raise RuntimeError(f"{key} {n}: error {errs[n]:.3e}")
        ms = in_turns(fns, iters=args.iters)
        flops = sum(2 * T * I * O for I, O in shapes.values())
        rec["readings"][key] = {
            "ms": ms, "rel_err": errs, "gflop": flops / 1e9,
            "tflop_s": {n: flops / t / 1e9 for n, t in ms.items()}}
        log(f"{key}: " + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()))
    text = json.dumps(rec)
    if args.out:
        os.makedirs(Path(args.out).parent, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
