"""ctypes binding to the repo's host tokenizer library (port of
``fastllama_tpu/loaders/native.py``).

``csrc/ftl_native.cpp`` at the root of the checkout is compiled by the
host's C++ compiler, on first use, into ``build/native/<hash>/`` (listed
in ``.gitignore``), keyed on a hash of the source and flags.  Everything
has a pure-Python fallback (``loaders/tokenizer.py``): without a compiler
the tokenizer runs its own merge loop, which defines the same tokens.
This is host code; no device work hides behind the fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "csrc" / "ftl_native.cpp"
BUILD_ROOT = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None
_lock = threading.Lock()
_tried = False


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libftl_native.so"


def build() -> Optional[Path]:
    """Compile the library if it is not there yet (into a temporary name,
    then renamed, so concurrent processes never load half a file).
    Returns its path, or None without a source or a compiler."""
    if not SOURCE.is_file():
        return None
    so = library_path()
    if so.is_file():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.flt_tokenizer_new.restype = ctypes.c_void_p
        lib.flt_tokenizer_new.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_char_p]
        lib.flt_tokenizer_free.argtypes = [ctypes.c_void_p]
        lib.flt_tokenizer_encode.restype = ctypes.c_int64
        lib.flt_tokenizer_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class NativeEncoder:
    """Native greedy-BPE encoder; raises ImportError if the library is
    unavailable (callers keep the Python path as fallback)."""

    def __init__(self, index_texts: List[str], scores: List[float],
                 bos_token_id: int, conn_tag: str = "▁"):
        lib = _load()
        if lib is None:
            raise ImportError("libftl_native.so unavailable")
        self._lib = lib
        blobs = [t.encode("utf-8") for t in index_texts]
        offsets = [0]
        for b in blobs:
            offsets.append(offsets[-1] + len(b))
        texts = b"".join(blobs)
        n = len(blobs)
        off_arr = (ctypes.c_int64 * (n + 1))(*offsets)
        sc_arr = (ctypes.c_float * n)(*[float(s) for s in scores])
        self._handle = lib.flt_tokenizer_new(
            texts, off_arr, sc_arr, n, conn_tag.encode("utf-8"))
        self._bos = bos_token_id

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.flt_tokenizer_free(self._handle)
            self._handle = None

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        raw = text.encode("utf-8")
        max_out = len(raw) + 2
        out = (ctypes.c_int32 * max_out)()
        n = self._lib.flt_tokenizer_encode(
            self._handle, raw, len(raw), self._bos, 1 if add_bos else 0,
            out, max_out)
        if n < 0:
            raise RuntimeError("native encode overflow")
        return list(out[:n])
