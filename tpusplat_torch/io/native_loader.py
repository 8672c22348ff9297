"""The C++ reader of PLY vertex records, ``native/ply_loader.cpp``, bound
with ctypes (counterpart of ``tpusplat/io/native_loader.py``).

The text header is parsed in Python (:mod:`tpusplat_torch.io.ply`); this
reads the binary body with large buffered reads. The library is built at
first use with the flags of ``native/Makefile`` (``$CXX``, default ``g++``)
into ``build/tpusplat_torch/`` at the repo root, named by a hash of the
source and flags, so a checkout that holds only the source builds it. A
failed build or load raises: the caller asked for the native reader and
never silently gets the numpy one. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "ply_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpusplat_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_libs: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libtpusplat_io-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native PLY reader: cannot run {cmd[0]!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native PLY reader: {' '.join(cmd)} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds each write their own tmp
    return out


def _load() -> ctypes.CDLL:
    with _lock:
        path = library_path()
        lib = _libs.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.tps_read_records
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_void_p]
            _libs[path] = lib
        return lib


def read_records(path, body_offset: int, num_vertices: int, nfloats: int) -> np.ndarray:
    """[num_vertices, nfloats] float32 records of the binary body at
    ``body_offset``. Raises if the library cannot be built or the file
    holds fewer records."""
    lib = _load()
    out = np.empty((num_vertices, nfloats), np.float32)
    got = lib.tps_read_records(os.fsencode(path), body_offset, num_vertices, nfloats,
                               out.ctypes.data_as(ctypes.c_void_p))
    if got != num_vertices:
        raise OSError(f"native PLY read failed: got {got} of {num_vertices} records")
    return out
