"""Design calls of K1/K1p's prefill mode (``qmm_wgmma_kernel`` in
``csrc/qmm_prefill.cu``) and of its wide mode (``qmm_wgmma_wide_kernel``,
f32 compute), timed on the card in turns.

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

The wide variants (``WIDE_VARIANTS``: ``PF_WIDE_STAGES``, the most
stages its ring takes; ``G32_VARIANTS``: ``PF_WIDE_G32_PARTIALS``, how the
G32 kernel keeps a stage's two parts' partials) are timed at the wide
readings (the same layer at f32 compute, f32 x and scales, T = 2048, 512
and 256, 64 rows a group, T = 512 and 2048 at 128 rows a group: half the
folds, and at 32 rows a group: the G32 kernel, a fold a 32-row part)
beside the wrapper's kernel (``build``), ``qmm_f32_kernel`` on the same
calls (``f32_kernel``) and ``torch.matmul`` on pre-dequantized f32
weights (``library``; ``allow_tf32`` off), each held to 1e-4 x max|ref|
first.  A bf16 reading times the bf16 variants named in ``--variants``, a
wide reading the wide ones.

Run on the card:  python3 -m fastllama_tpu_torch.tools.prefill_design
Options: ``--variants base,ns4,wbase`` (default: all of ``VARIANTS``,
``WIDE_VARIANTS`` and ``G32_VARIANTS``), ``--readings int8_T2048,wide_T512`` (default: all of
``READINGS`` and ``WIDE_READINGS``),
``--iters N`` (timed calls a reading, default 10), ``--out FILE`` (the
JSON record, also printed on stdout).  Progress goes to stderr.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
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
WIDE_MACROS = ("PF_WIDE_STAGES",)
# name -> the wide macros' values, in the order of WIDE_MACROS
WIDE_VARIANTS = {
    "wbase": (8,),                     # the source's default (3 stages)
    "wns2": (2,),                      # two stages
}
# the wide mode's G32 kernel (gs 32, 96): name -> PF_WIDE_G32_PARTIALS, how
# it keeps a stage's two 32-row parts' partials (timed at the wide
# readings too)
G32_VARIANTS = {
    "g32one": (1,),                    # the source's default: one, folded
                                       # after each part's drain
    "g32two": (2,),                    # one a part, one drain a stage
}
# name -> (packed, T)
READINGS = {"int8_T2048": (False, 2048), "int4_T2048": (True, 2048),
            "int8_T512": (False, 512), "int8_T256": (False, 256),
            "int4_T512": (True, 512)}
# name -> (T, group size), at f32 compute (INT8, f32 x and scales)
WIDE_READINGS = {"wide_T2048": (2048, 64), "wide_T512": (512, 64),
                 "wide_T256": (256, 64), "wide_T512_gs128": (512, 128),
                 "wide_T2048_gs128": (2048, 128),
                 "wide_T2048_gs32": (2048, 32), "wide_T512_gs32": (512, 32)}
LAYER = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
         "w2": (11008, 4096)}
INT4_HIDDEN = {11008: 11264, 22016: 22528}


def diagnostic(name: str) -> bool:
    """A variant whose output is wrong (no dequant arithmetic)."""
    return VARIANTS[name][2] != 0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def macros(name: str):
    """The -D flags of a variant, bf16 (``VARIANTS``) or wide
    (``WIDE_VARIANTS``); the other kind's macros keep the source's
    defaults."""
    if name in WIDE_VARIANTS:
        return [f"-D{m}={v}" for m, v in zip(WIDE_MACROS,
                                              WIDE_VARIANTS[name])]
    if name in G32_VARIANTS:
        return [f"-DPF_WIDE_G32_PARTIALS={G32_VARIANTS[name][0]}"]
    return [f"-D{m}={v}" for m, v in zip(MACROS, VARIANTS[name])]


def build_variants(names):
    """{name: (loaded library, ptxas report)} of each variant, all nvcc
    processes started together, and with them the wrapper's own build
    (``_build.build``)."""
    procs = {}
    for name in names:
        out = OUT_DIR / name
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *macros(name),
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
    ``qmm_wgmma_kernel`` instantiations of a ``-Xptxas -v`` log (those of
    ``qmm_wgmma_wide_kernel`` keyed ``wide:<arguments>``, the G32 kernels'
    ``g32_<arguments>`` and ``wide:g32_<arguments>``), and its
    performance notes (``notes``: ptxas's C75xx lines, such as wgmma
    serialized)."""
    lines = text.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*qmm_wgmma_(wide_)?"
                      r"(g32_)?kernelI(\S*?)EEv", line)
        if m:
            near = lines[i + 1:i + 6]
            used = next(t for t in near if "registers" in t)
            spill = next((t for t in near if "spill" in t), "")
            out[("wide:" if m.group(1) else "") + (m.group(2) or "")
                + m.group(3)] = (
                int(re.search(r"Used (\d+) registers", used).group(1)),
                spill.strip())
    out["notes"] = [t.strip() for t in lines if "(C75" in t]
    return out


def rand_weight(gen, shape, packed: bool, dev, gs: int = 64) -> QArray:
    """(…, I, O) INT8 weight, or packed INT4, of random values and random
    positive f32 group scales, ``gs`` rows a group."""
    qmax = 7 if packed else 127
    data = torch.empty(shape, dtype=QDTYPE[QuantType.INT8], device=dev)
    data.random_(-qmax - packed, qmax + 1, generator=gen)
    sshape = (*shape[:-2], shape[-2] // gs, shape[-1])
    s = (torch.rand(sshape, generator=gen, device=dev) + 0.5) * (0.02 / qmax)
    if packed:
        return QArray(pack_int4_rows(data), s, QuantType.INT4, gs,
                      group_axis=-2, packed=True)
    return QArray(data, s, QuantType.INT8, gs, group_axis=-2)


def rel(got, want) -> float:
    """max|got - want| / max|want|; infinite where got is not finite."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return math.inf
    return float((g - w).abs().max() / w.abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants",
                    default=",".join([*VARIANTS, *WIDE_VARIANTS,
                                      *G32_VARIANTS]))
    ap.add_argument("--readings",
                    default=",".join([*READINGS, *WIDE_READINGS]))
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
           "variants": {n: {"macros": macros(n), "ptxas": r}
                        for n, (_, r) in libs.items()},
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
        if key in WIDE_READINGS:
            name = key if key not in rec["readings"] else f"{key}#{i}"
            rec["readings"][name] = r = wide_reading(
                *WIDE_READINGS[key], {n: lib for n, (lib, _) in libs.items()
                                      if n in WIDE_VARIANTS
                                      or n in G32_VARIANTS}, gen, rot,
                args.iters)
            log(f"{name}: " + ", ".join(f"{n} {t:.4f}"
                                        for n, t in r["ms"].items()))
            continue
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
            for n, (lib, _) in libs.items() if n in VARIANTS}
        fns["build"] = run(lambda n, lyr: qmm.qmatmul_pallas_indexed(
            xs[n], ws[n], lyr))
        fns["loop"] = run(lambda n, lyr: qmm._launch(
            xs[n], ws[n][lyr], bf16, mode="loop"))
        fns["library"] = run(lambda n, lyr: torch.matmul(xs[n], wds[n][lyr]))
        errs = {}
        for n in [v for v in libs if v in VARIANTS] + ["build"]:
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
    weights.clear()
    text = json.dumps(rec)
    if args.out:
        os.makedirs(Path(args.out).parent, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


def wide_reading(T: int, gs: int, libs: dict, gen, rot,
                 iters: int) -> dict:
    """The wide variants ``libs`` (name: library) at one 7B layer, f32 x
    and scales, T rows, ``gs`` rows a group, in turns with the wrapper's kernel, qmm_f32_kernel
    and ``torch.matmul`` on f32 weights; each held to 1e-4 x max|ref|
    first (a variant that misses it is reported and not timed; the
    wrapper's kernel raises)."""
    dev, f32, nl = torch.device("cuda"), torch.float32, 2
    ws = {n: rand_weight(gen, (nl, *sh), False, dev, gs)
          for n, sh in LAYER.items()}
    wds = {n: dequantize(w, f32) for n, w in ws.items()}
    xs = {n: torch.randn((T, I), generator=gen, device=dev)
          for n, (I, _) in LAYER.items()}

    def run(one):
        def f():
            lyr = rot()
            for n in LAYER:
                one(n, lyr)
        return f
    fns = {v: run(lambda n, lyr, lib=lib: qmm._launch_prefill(
        xs[n], ws[n][lyr], None, None, 1e-5, lib=lib, wide=True))
        for v, lib in libs.items()}
    fns["build"] = run(lambda n, lyr: qmm.qmatmul_pallas_indexed(
        xs[n], ws[n], lyr, f32))
    fns["f32_kernel"] = run(lambda n, lyr: qmm._launch(
        xs[n], ws[n][lyr], f32, mode="wide"))
    fns["library"] = run(lambda n, lyr: torch.matmul(xs[n], wds[n][lyr]))
    errs = {}
    for v in list(libs) + ["build"]:
        for n in LAYER:
            got = (qmm._launch_prefill(xs[n], ws[n][0], None, None, 1e-5,
                                       lib=libs[v], wide=True)
                   if v in libs else
                   qmm.qmatmul_pallas_indexed(xs[n], ws[n], 0, f32))
            e = rel(got, qmm.qmm_fused_plain(xs[n], ws[n][0], f32))
            errs[v] = max(errs.get(v, 0.0), e)
        if errs[v] > 1e-4 and v == "build":
            raise RuntimeError(f"wide T={T} {v}: error {errs[v]:.3e}")
    wrong = [v for v in libs if errs[v] > 1e-4]
    for v in wrong:                       # reported, not timed
        log(f"wide T={T} {v}: error {errs[v]:.3e}, not timed")
        del fns[v]
    ms = in_turns(fns, iters=iters)
    flops = sum(2 * T * I * O for I, O in LAYER.values())
    return {"ms": ms, "rel_err": errs, "gflop": flops / 1e9,
            "tflop_s_3_passes": {n: 3 * flops / t / 1e9
                                 for n, t in ms.items()}}


if __name__ == "__main__":
    sys.exit(main())
