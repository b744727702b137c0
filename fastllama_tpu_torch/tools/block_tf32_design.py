"""Design calls of K2b's split-TF32 mode (``csrc/flash_block_tf32.cu``),
timed on the card in turns.

Builds ``flash_block_tf32.cu`` once for each variant of its tuning macros
(``FLASH_BLOCK_TF32_TK``, ``_STAGES``, ``_CHAINS``), every
``nvcc`` started together, into ``build/block_tf32_design/<variant>/``,
and times the variants at the f32 readings of ``chip_smoke.py``'s phase 5
(7B heads, B=48, S=512, start 256, T in {32, 256}: bf16 q over an f32
cache, f32 q over an int8 cache, f32 q over an f32 cache; layers rotating
over 4), in turns, beside the kernel the wrapper runs (``build``) and the
CUDA-core f32 mode (``cuda_core``).  Every variant's output is held
against the plain version (1e-4 x max|ref| for f32 q, 1e-2 for bf16 q)
before it is timed, and each build's registers and spills at the 7B
instantiations (hs 128) are reported.

Run on the card:  python3 -m fastllama_tpu_torch.tools.block_tf32_design
Options: ``--variants base,tk64,...`` (default: all of ``VARIANTS``),
``--Ts 32,256``, ``--iters N`` (timed calls a reading, default 20),
``--out FILE`` (the JSON record, also printed on stdout).  Progress goes
to stderr.
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

SOURCE = _build.CSRC / "flash_block_tf32.cu"
OUT_DIR = _build.BUILD_ROOT.parent / "block_tf32_design"
MACROS = ("FLASH_BLOCK_TF32_TK", "FLASH_BLOCK_TF32_STAGES",
          "FLASH_BLOCK_TF32_CHAINS")
# name -> the macros' values, in the order of MACROS
VARIANTS = {
    "base": (32, 2, 1),        # the source's defaults
    "tk64": (64, 2, 1),        # 64-row tiles: one block an SM at f32
    "ns3": (32, 3, 1),         # three stages
    "ch2": (32, 2, 2),         # even and odd k-steps in chains apart
    "tk64_ch2": (64, 2, 2),
}
# (key, q dtype, cache dtype)
READINGS = (("bf16q_f32cache", "bfloat16", "float32"),
            ("f32q_int8cache", "float32", "int8"),
            ("f32q_f32cache", "float32", "float32"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def defines(values) -> list:
    """The nvcc ``-D`` flags of one variant."""
    return [f"-D{m}={v}" for m, v in zip(MACROS, values)]


def build_variants(names):
    """{name: (loaded library, {7B instantiation: (registers, spill
    line)})} of each variant, all nvcc processes started together, and
    with them the wrapper's own build (``_build.build``)."""
    procs = {}
    for name in names:
        out = OUT_DIR / name
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *defines(VARIANTS[name]),
             "-o", str(out / "libtf32.so"), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build()
    libs = {}
    for name, p in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{text}")
        libs[name] = (ctypes.CDLL(str(OUT_DIR / name / "libtf32.so")),
                      ptxas_hs128(text))
    return libs


def ptxas_hs128(text: str) -> dict:
    """{template arguments: (registers, spill line)} of the hs 128
    instantiations in a ``-Xptxas -v`` log."""
    lines = text.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*flash_block_tf32_kernel"
                      r"I(\S*Li128E\S*?)EEv", line)
        if m:
            near = lines[i + 1:i + 6]
            used = next(t for t in near if "registers" in t)
            spill = next((t for t in near if "spill" in t), "")
            out[m.group(1)] = (
                int(re.search(r"Used (\d+) registers", used).group(1)),
                spill.strip())
    return out


def rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--Ts", default="32,256")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("block_tf32_design: no CUDA device available")
        return 2
    names = args.variants.split(",")
    dev = torch.device("cuda")
    libs = build_variants(names)
    rec = {"device": torch.cuda.get_device_name(0), "variants": {
        n: {"macros": dict(zip(MACROS, VARIANTS[n])), "ptxas_hs128": r}
        for n, (_, r) in libs.items()}, "readings": {}}
    for n, v in rec["variants"].items():
        log(f"{n}: registers at hs 128 "
            f"{ {k: r for k, (r, _) in v['ptxas_hs128'].items()} }")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1414)
    B, L, H, n_kv, hs, S, start, slot = 48, 4, 32, 32, 128, 512, 256, 5
    layer = [0]

    def rot():
        layer[0] = (layer[0] + 1) % L
        return layer[0]
    for key, qname, cname in READINGS:
        qdt, cdt = getattr(torch, qname), getattr(torch, cname)
        shape = (L, B, n_kv, S, hs)
        if cdt == torch.int8:
            ck = torch.empty(shape, dtype=cdt, device=dev).random_(
                -127, 128, generator=gen)
            cv = torch.empty_like(ck).random_(-127, 128, generator=gen)
            ks = torch.rand(shape[:-1], generator=gen, device=dev) * 0.05
            vs = torch.rand(shape[:-1], generator=gen, device=dev) * 0.05
        else:
            ck = torch.randn(shape, generator=gen, device=dev)
            cv = torch.randn(shape, generator=gen, device=dev)
            ks = vs = None
        tol = 1e-4 if qdt == torch.float32 else 1e-2
        for T in (int(t) for t in args.Ts.split(",")):
            q = torch.randn((H, T, hs), generator=gen, device=dev).to(qdt)
            kn = torch.randn((n_kv, T, hs), generator=gen, device=dev).to(qdt)
            vn = torch.randn((n_kv, T, hs), generator=gen, device=dev).to(qdt)

            def base():
                return (q, ck, cv, slot, rot(), start, ks, vs, kn, vn)
            fns = {n: (lambda lib=lib: fd._block_launch("tf32", *base(),
                                                          lib=lib))
                   for n, (lib, _) in libs.items()}
            fns["build"] = lambda: fd.flash_block_attend(*base())
            fns["cuda_core"] = lambda: fd._block_launch("f32", *base())
            errs = {}
            for n, fn in fns.items():
                lyr = layer[0]
                got = fn()
                want = fd.flash_block_plain(q, ck, cv, slot, (lyr + 1) % L,
                                            start, ks, vs, kn, vn)
                errs[n] = rel(got, want)
                if errs[n] > tol:
                    raise RuntimeError(f"{key} T={T} {n}: error "
                                       f"{errs[n]:.3e}")
            ms = in_turns(fns, iters=args.iters)
            rec["readings"][f"{key}_T{T}"] = {"ms": ms, "rel_err": errs}
            log(f"{key} T={T}: " + ", ".join(f"{n} {t:.4f}"
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
