"""Design calls of K1's wide mode on the ring (``qmm_pipe_wide_kernel`` in
``csrc/qmm.cu``), timed on the card in turns.

Builds ``qmm.cu`` once for each variant of its tuning macros
(``QMM_WIDE_STAGES48`` and ``QMM_WIDE_MIN_BLOCKS48``, the ring's depth
and the least blocks an SM at 48 rows;
``QMM_WIDE_PLANES``, the planes of f32 x multiplied: fewer than 3 is a
diagnostic of what the passes cost, which misses the reference's
accuracy and is not held to it; with ``--quant int16`` the INT16
instantiation's ``QMM_WIDE16_STAGES48``, ``QMM_WIDE16_MIN_BLOCKS48`` and
``QMM_WIDE16_SPLIT48``, one or two passes over x's planes a k-step at
48 rows,
``VARIANTS16``), every ``nvcc`` started together, into
``build/wide_pipe_design/<variant>/``, and times the variants at the
readings of ``chip_smoke.py``'s phase 5 (INT8: f32 x and compute, f32
scales; INT16: bf16 x and compute as the engines call it, f32 scales,
and a reading on f32 x at T=48: one 7B layer's four projections at T=48,
1 and 128, layers rotating over 4 so every launch finds its weight cold
in L2, and the classifier at T=48), in turns, beside the kernel the
wrapper runs (``build``) and ``qmm_f32_kernel`` on the same calls
(``f32_kernel``).
Every variant's output but a diagnostic one's is held against the plain
version (1e-4 x max|ref|) before it is timed (a diagnostic's error is
recorded), and each build's registers and spills of the wide
instantiations are reported.

Run on the card:  python3 -m fastllama_tpu_torch.tools.wide_pipe_design
Options: ``--quant int16`` (default int8), ``--variants base,ns3``
(default: all of ``VARIANTS``, or ``VARIANTS16`` at INT16), ``--Ts
48,1,128``, ``--iters N`` (timed calls a reading, default 20), ``--out
FILE`` (the JSON record, also printed on stdout).  Progress goes to
stderr.
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
from fastllama_tpu_torch.quant.groupquant import QDTYPE, QArray
from fastllama_tpu_torch.tools.timing import in_turns

SOURCE = _build.CSRC / "qmm.cu"
OUT_DIR = _build.BUILD_ROOT.parent / "wide_pipe_design"
MACROS = ("QMM_WIDE_STAGES48", "QMM_WIDE_MIN_BLOCKS48", "QMM_WIDE_PLANES")
# name -> the macros' values, in the order of MACROS
VARIANTS = {
    "base": (2, 3, 3),         # the source's defaults
    "ns3": (3, 2, 3),          # three stages, 2 blocks an SM at 48 rows
    "ns2_min2": (2, 2, 3),     # the two-stage ring without the third block
    "planes2": (2, 3, 2),      # diagnostic: two planes of x
    "planes1": (2, 3, 1),      # diagnostic: one plane (one bf16 pass)
}


# the INT16 instantiation's macros and variants (the other macros at the
# source's defaults)
MACROS16 = ("QMM_WIDE16_STAGES48", "QMM_WIDE16_MIN_BLOCKS48",
            "QMM_WIDE16_SPLIT48")
VARIANTS16 = {
    "w16_base": (2, 3, 1),       # the source's defaults: two passes
    "w16_ns3_min3": (3, 3, 1),   # three stages, 3 blocks an SM (bf16 x)
    "w16_ns3_min2": (3, 2, 1),   # three stages, 2 blocks
    "w16_one_pass": (3, 2, 0),   # both weight planes in one pass
    "w16_one_pass_ns3_min3": (3, 3, 0),   # (spills 16 bytes)
    "w16_one_pass_ns2_min3": (2, 3, 0),   # (spills 20 bytes)
}


def diagnostic(name: str) -> bool:
    """A variant that multiplies fewer than three planes of x."""
    return name in VARIANTS and VARIANTS[name][2] < 3


def macro_flags(name: str) -> list:
    """The ``-D`` flags of a variant of ``VARIANTS`` or ``VARIANTS16``."""
    pairs = (zip(MACROS, VARIANTS[name]) if name in VARIANTS
             else zip(MACROS16, VARIANTS16[name]))
    return [f"-D{m}={v}" for m, v in pairs]


# one 7B layer's projections (I, O), and the classifier
LAYER = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w13": (4096, 22016),
         "w2": (11008, 4096)}
CLASSIFIER = (4096, 32000)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_variants(names):
    """{name: (loaded library, {wide instantiation: (registers, spill
    line)})} of each variant, all nvcc processes started together, and
    with them the wrapper's own build (``_build.build``)."""
    procs = {}
    for name in names:
        out = OUT_DIR / name
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *macro_flags(name),
             "-o", str(out / "libqmm.so"), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build()
    libs = {}
    for name, p in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
        libs[name] = (ctypes.CDLL(str(OUT_DIR / name / "libqmm.so")),
                      ptxas_wide(text))
    return libs


def ptxas_wide(text: str) -> dict:
    """{template arguments: (registers, spill line)} of the
    ``qmm_pipe_wide_kernel`` instantiations in a ``-Xptxas -v`` log."""
    lines = text.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*qmm_pipe_wide_kernel"
                      r"I(\S*?)EEv", line)
        if m:
            near = lines[i + 1:i + 6]
            used = next(t for t in near if "registers" in t)
            spill = next((t for t in near if "spill" in t), "")
            out[m.group(1)] = (
                int(re.search(r"Used (\d+) registers", used).group(1)),
                spill.strip())
    return out


def rand_int8(gen, shape, dev) -> QArray:
    """(…, I, O) INT8 weight of random values and random positive f32
    group scales, 64 rows a group."""
    data = torch.empty(shape, dtype=QDTYPE[QuantType.INT8], device=dev)
    data.random_(-127, 128, generator=gen)
    sshape = (*shape[:-2], shape[-2] // 64, shape[-1])
    s = (torch.rand(sshape, generator=gen, device=dev) + 0.5) * (0.02 / 127)
    return QArray(data, s, QuantType.INT8, 64, group_axis=-2)


def rand_int16(gen, shape, dev) -> QArray:
    """(…, I, O) INT16 weight of random values in [-5792, 5792] and random
    positive f32 group scales, 64 rows a group."""
    qf = QuantType.INT16.factor
    data = torch.empty(shape, dtype=QDTYPE[QuantType.INT16], device=dev)
    data.random_(-qf, qf + 1, generator=gen)
    sshape = (*shape[:-2], shape[-2] // 64, shape[-1])
    s = (torch.rand(sshape, generator=gen, device=dev) + 0.5) * (0.02 / qf)
    return QArray(data, s, QuantType.INT16, 64, group_axis=-2)


def rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quant", choices=("int8", "int16"), default="int8")
    ap.add_argument("--variants", default=None)
    ap.add_argument("--Ts", default="48,1,128")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("wide_pipe_design: no CUDA device available")
        return 2
    int16 = args.quant == "int16"
    names = (args.variants or ",".join(VARIANTS16 if int16
                                       else VARIANTS)).split(",")
    dev = torch.device("cuda")
    libs = build_variants(names)
    rec = {"device": torch.cuda.get_device_name(0), "quant": args.quant,
           "variants": {n: {"macros": macro_flags(n), "ptxas": r}
                        for n, (_, r) in libs.items()}, "readings": {}}
    for n, v in rec["variants"].items():
        log(f"{n}: registers {({k: r for k, (r, _) in v['ptxas'].items()})}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1515)
    f32, nl = torch.float32, 4
    rand = rand_int16 if int16 else rand_int8
    # INT16 at the engines' bf16 compute on bf16 x; INT8 wide at f32
    xdt = cdt = torch.bfloat16 if int16 else f32
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % nl
        return layer[0]
    ws = {n: rand(gen, (nl, *shape), dev) for n, shape in LAYER.items()}
    readings = [(f"layer_T{T}", T, xdt) for T in
                (int(t) for t in args.Ts.split(","))]
    readings.append(("classifier_T48", 48, xdt))
    if int16:
        readings.append(("layer_T48_f32x", 48, f32))
    for key, T, xd in readings:
        if key.startswith("classifier"):
            wc = rand(gen, (1, *CLASSIFIER), dev)
            calls = {"classifier": (torch.randn(
                (T, CLASSIFIER[0]), generator=gen, device=dev).to(xd), wc)}
        else:
            calls = {n: (torch.randn((T, I), generator=gen,
                                     device=dev).to(xd), ws[n])
                     for n, (I, _) in LAYER.items()}

        def run(one):
            def f():
                lyr = rot() % calls[next(iter(calls))][1].data.shape[0]
                for x, w in calls.values():
                    one(x, w[lyr])
            return f
        def ring(x, w, lib):
            return qmm._launch_pipe(x, w, None, None, 1e-5, None,
                                    qmm.wide_pipe_mode(w), lib=lib)
        fns = {n: run(lambda x, w, lib=lib: ring(x, w, lib))
               for n, (lib, _) in libs.items()}
        fns["build"] = run(lambda x, w: qmm.qmatmul_pallas(x, w, cdt))
        fns["f32_kernel"] = run(lambda x, w: qmm._launch(x, w, cdt,
                                                        mode="wide"))
        errs, tol = {}, 1e-4 if xd == f32 else 1e-2
        for n in list(libs) + ["build"]:
            lib = libs[n][0] if n in libs else None
            for x, w in calls.values():
                got = (ring(x, w[0], lib) if lib
                       else qmm.qmatmul_pallas(x, w[0], cdt))
                e = rel(got, qmm.qmm_plain(x, w[0], cdt))
                errs[n] = max(errs.get(n, 0.0), e)
            if errs[n] > tol and not (n in libs and diagnostic(n)):
                raise RuntimeError(f"{key} {n}: error {errs[n]:.3e}")
        ms = in_turns(fns, iters=args.iters)
        rec["readings"][key] = {"ms": ms, "rel_err": errs}
        log(f"{key}: " + ", ".join(f"{n} {t:.4f}" for n, t in ms.items()))
    text = json.dumps(rec)
    if args.out:
        os.makedirs(Path(args.out).parent, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
