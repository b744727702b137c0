"""Build and load the port's CUDA kernels.

Every ``fastllama_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, all
compilers started together, on first use.  The libraries go to
``build/torch_kernels/<hash>/`` at the root of the checkout (listed in
``.gitignore``), keyed on a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads at once.  Libraries are loaded
with ``ctypes``; each launch function returns ``cudaGetLastError()``.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_built: Dict[str, Path] = {}


def nvcc() -> str:
    """The nvcc of $CUDA_HOME, /usr/local/cuda, or the PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def nvcc_version() -> str:
    return subprocess.run([nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (one nvcc each, in parallel) unless the hashed
    build directory already holds them; returns that directory.  Raises
    with the compiler's output when a source does not build."""
    with _lock:
        if "dir" in _built:
            return _built["dir"]
        out = BUILD_ROOT / _digest()
        srcs = _sources()
        if not all((out / f"lib{s.stem}.so").is_file() for s in srcs):
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
            cc = nvcc()
            t0 = time.perf_counter()
            procs = []
            for s in srcs:
                with open(tmp / f"{s.stem}.log", "w") as log_f:
                    procs.append((s, subprocess.Popen(
                        [cc, *NVCC_FLAGS, "-o", str(tmp / f"lib{s.stem}.so"),
                         str(s)], stdout=log_f, stderr=subprocess.STDOUT)))
            secs = {}
            while len(secs) < len(procs):       # each source's seconds
                for s, p in procs:
                    if s not in secs and p.poll() is not None:
                        secs[s] = time.perf_counter() - t0
                time.sleep(0.05)
            logs, failed = [], []
            for s, p in procs:
                text = (tmp / f"{s.stem}.log").read_text()
                logs.append(f"== {s.name} (rc {p.returncode}, "
                            f"{secs[s]:.1f} s)\n{text}")
                if p.returncode != 0:
                    failed.append(s.name)
            (tmp / "build.log").write_text("\n".join(logs))
            if failed:
                raise RuntimeError(f"nvcc failed for {failed}:\n"
                                   + "\n".join(logs))
            try:
                os.rename(tmp, out)
            except OSError:                # another process finished first
                shutil.rmtree(tmp, ignore_errors=True)
        _built["dir"] = out
        return out


def build_log() -> str:
    """nvcc's output of the build in use (``-Xptxas -v``: registers,
    shared memory and spills of each kernel)."""
    return (build() / "build.log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build() / f"lib{name}.so"))
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` from a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
