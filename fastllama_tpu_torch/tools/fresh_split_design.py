"""Design calls of K2's fresh and stats split mode
(``csrc/flash_decode_fresh.cu``), timed on the card in turns.

Builds ``flash_decode_fresh.cu`` once for each variant of its tuning
macros (``FRESH_SPLIT_INT8_BYTES``, ``FRESH_SPLIT_LOADS``,
``FRESH_SPLIT_PF``, ``FRESH_SPLIT_MIN_BLOCKS``), every ``nvcc`` started
together, into ``build/fresh_split_design/<variant>/``, and times the
variants at the readings of ``chip_smoke.py``'s phase 5 (7B heads, int8
cache, bf16 q, layers rotating over 4 so that L2 stays cold), in turns,
beside the kernel the wrapper runs (``build``), K2s's split mode at T = 1
on the same inputs (``spec_t1``: its query rows padded to RP = 2) and
the tiled kernel.  Each variant (and ``build``) is also timed at every
split count of ``--nsplits`` and warps a block of ``--warps`` ("auto":
the wrapper's ``split_count`` and ``split_block_warps``; a forced split
count takes a 16-row least chunk), keyed ``<variant>:ns<n>:nw<w>``.
Every timed call's output is held against the plain version (1e-2 x
max|ref|, bf16 q) before it is timed, and each build's registers and
spills at the 7B instantiation (int8 cache, hs 128, hgs 1) are
reported.

Run on the card:  python3 -m fastllama_tpu_torch.tools.fresh_split_design
Options: ``--variants base,io16,...`` (default: all of ``VARIANTS``),
``--nsplits auto,1,2`` and ``--warps auto,8`` (default: auto only),
``--iters N`` (timed calls a reading, default 50), ``--out FILE`` (the
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

from fastllama_tpu_torch.ops.kernels import _build
from fastllama_tpu_torch.ops.kernels import flash_decode as fd
from fastllama_tpu_torch.tools.timing import in_turns

SOURCE = _build.CSRC / "flash_decode_fresh.cu"
OUT_DIR = _build.BUILD_ROOT.parent / "fresh_split_design"
MACROS = ("FRESH_SPLIT_INT8_BYTES", "FRESH_SPLIT_LOADS", "FRESH_SPLIT_PF",
          "FRESH_SPLIT_MIN_BLOCKS")
# name -> the four macros' values, in the order of MACROS
VARIANTS = {
    "base": (8, 2, 1, 1),      # the source's defaults: the card's choice
    "u1": (8, 1, 1, 1),        # the first cut: 1 row a lane a step
    "u3": (8, 3, 1, 1),
    "u4": (8, 4, 1, 1),
    "u4_nopf": (8, 4, 0, 1),   # K2's non-fresh split mode's choice
    "nopf": (8, 2, 0, 1),      # no prefetch of the next step's loads
    "io16_u1": (16, 1, 1, 1),  # 16-byte int8 loads
    "io16_u2": (16, 2, 1, 1),
    "io16_u4": (16, 4, 1, 1),
    "minb2": (8, 2, 1, 2),     # launch bounds: 2 blocks of 8 warps an SM
    "minb4": (8, 2, 1, 4),
}
# (key, B, S, pos: an int for every slot or None for mixed, stats)
READINGS = (
    ("B48_S512_pos107", 48, 512, 107, False),
    ("B48_S512_pos107_stats", 48, 512, 107, True),
    ("B48_S512_mixed", 48, 512, None, False),
    ("B12_S2048_pos2040", 12, 2048, 2040, False))
TOL = 1e-2
KERNEL_7B = "flash_decode_fresh_split_kernelIaLi128ELi1E"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def defines(values) -> list:
    """The nvcc ``-D`` flags of one variant."""
    return [f"-D{m}={v}" for m, v in zip(MACROS, values)]


def build_variants(names):
    """{name: (loaded library, registers, spill line)} of each variant,
    all nvcc processes started together, and with them the wrapper's own
    build (``_build.build``)."""
    procs = {}
    for name in names:
        out = OUT_DIR / name
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *defines(VARIANTS[name]),
             "-o", str(out / "libfresh.so"), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build()
    libs = {}
    for name, p in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
        libs[name] = (ctypes.CDLL(str(OUT_DIR / name / "libfresh.so")),
                      *ptxas_7b(text))
    return libs


def ptxas_7b(text: str):
    """(registers, spill line) of the 7B instantiation in a ``-Xptxas -v``
    log."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if re.search(r"Compiling entry function '\S*" + KERNEL_7B, line):
            near = lines[i + 1:i + 6]
            used = next(t for t in near if "registers" in t)
            spill = next((t for t in near if "spill" in t), "")
            return (int(re.search(r"Used (\d+) registers", used).group(1)),
                    spill.strip())
    raise RuntimeError(f"no {KERNEL_7B} in the build log")


def rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--nsplits", default="auto")
    ap.add_argument("--warps", default="auto")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("fresh_split_design: no CUDA device available")
        return 2
    names = args.variants.split(",")
    dev = torch.device("cuda")
    libs = build_variants(names)
    rec = {"device": torch.cuda.get_device_name(0), "variants": {
        n: {"macros": dict(zip(MACROS, VARIANTS[n])), "registers_7b": r,
            "spill_7b": sp} for n, (_, r, sp) in libs.items()},
        "readings": {}}
    log(f"registers at {KERNEL_7B}: "
        f"{ {n: v['registers_7b'] for n, v in rec['variants'].items()} }")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1313)
    bf16 = torch.bfloat16
    H, n_kv, hs, L = 32, 32, 128, 4
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % L
        return layer[0]
    for B, S in ((48, 512), (12, 2048)):
        shape = (L, B, n_kv, S, hs)
        ck = torch.empty(shape, dtype=torch.int8, device=dev).random_(
            -127, 128, generator=gen)
        cv = torch.empty_like(ck).random_(-127, 128, generator=gen)
        ks = torch.rand(shape[:-1], generator=gen, device=dev) * 0.05
        vs = torch.rand(shape[:-1], generator=gen, device=dev) * 0.05
        q = torch.randn((B, H, 1, hs), generator=gen, device=dev).to(bf16)
        kn = torch.randn((B, n_kv, hs), generator=gen, device=dev).to(bf16)
        vn = torch.randn((B, n_kv, hs), generator=gen, device=dev).to(bf16)
        for key, b, s, p, stats in READINGS:
            if (b, s) != (B, S):
                continue
            pos = (torch.randint(0, S, (B,), generator=gen, device=dev,
                                 dtype=torch.int32) if p is None
                   else torch.full((B,), p, dtype=torch.int32, device=dev))

            def base(pos=pos):
                return (q, ck, cv, pos, rot(), ks, vs)
            fns = {}
            for n, lib in [(n, v[0]) for n, v in libs.items()] + [
                    ("build", None)]:
                for ns in args.nsplits.split(","):
                    for nw in args.warps.split(","):
                        plan = (None, fd.SPLIT_MIN_CHUNK) if ns == "auto" \
                            else (int(ns), 16)
                        key_n = n if (ns, nw) == ("auto", "auto") \
                            else f"{n}:ns{ns}:nw{nw}"
                        fns[key_n] = (
                            lambda lib=lib, plan=plan, nw=nw:
                            fd._split_launch(
                                *base(), *plan,
                                None if nw == "auto" else int(nw),
                                k_new=kn, v_new=vn, stats=stats, lib=lib))
            fns["tiled"] = lambda: fd._launch(*base(), kn, vn, stats)
            if not stats:
                fns["spec_t1"] = lambda: fd._spec_split_launch(
                    *base(), kn[:, :, None], vn[:, :, None], None, None)
            errs = {}
            for n, fn in fns.items():
                lyr = layer[0]
                got = fn()
                want = fd.flash_decode_plain(q, ck, cv, pos, (lyr + 1) % L,
                                             ks, vs, kn, vn, stats=stats)
                got = got[0] if stats else got
                want = want[0] if stats else want
                errs[n] = rel(got.reshape(want.shape), want)
                if errs[n] > TOL:
                    raise RuntimeError(f"{key} {n}: error {errs[n]:.3e}")
            ms = in_turns(fns, iters=args.iters)
            rec["readings"][key] = {
                "ms": ms, "rel_err": errs,
                "plan": dict(zip(("nsplit", "nw"),
                                 fd.fresh_split_plan(q, ck)))}
            log(f"{key}: " + ", ".join(f"{n} {t:.4f}"
                                       for n, t in ms.items()))
        del ck, cv, ks, vs
        torch.cuda.empty_cache()
    text = json.dumps(rec)
    if args.out:
        os.makedirs(Path(args.out).parent, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
