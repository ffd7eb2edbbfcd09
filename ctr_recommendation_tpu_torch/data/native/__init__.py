"""ctypes binding for the native submission writer, ``submission.cc``: the
prediction CSV formatted with ``std::to_chars`` (the shortest decimal that
reads back to the same float32) on several threads, and a single-entry zip
deflated with zlib. The submission half of the JAX package's
``data/native/__init__.py``; its sequence padding needs no copy, since the
port pads with numpy (``data/parquet.py::pad_from_offsets``).

The library is built with g++ at first use into ``_build/`` beside the
source, under a name that carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. Nothing is
built when this module is imported. Where the build or a write fails, the
entry points return False and the caller takes the Python writer
(``inference/submission.py``), which writes the same bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "submission.cc"
BUILD_DIR = SRC.parent / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
GXX_LIBS = ["-lz", "-lpthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libsubmission-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``submission.cc`` unless its library exists. Returns the
    library's path; raises with g++'s output when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native submission writer needs it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC), *GXX_LIBS],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ {SRC.name} failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a process loading it never sees half a file
    return lib


def _load() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None when it cannot be
    built or loaded (tried once a process)."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        lib.submission_write_csv.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.submission_write_csv.restype = ctypes.c_int64
        lib.submission_zip_file.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
        ]
        lib.submission_zip_file.restype = ctypes.c_int64
        _lib = lib
        return _lib


def submission_available() -> bool:
    """Whether the native writer built and loaded."""
    return _load() is not None


def write_csv(
    probs: np.ndarray,
    path: str,
    *,
    id_offset: int = 0,
    append: bool = False,
    n_threads: int = 4,
) -> bool:
    """Write (or append) ``id,prob`` rows, the header first on a fresh file.
    Returns False when the library is unavailable or the write failed; a
    failed append may have left part of its rows in the file."""
    lib = _load()
    if lib is None:
        return False
    probs = np.ascontiguousarray(probs, dtype=np.float32).ravel()
    rc = lib.submission_write_csv(
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(probs), int(id_offset),
        os.fsencode(path), 1 if append else 0, int(n_threads),
    )
    return rc >= 0


def zip_file(src_path: str, zip_path: str, arcname: str, level: int = 1) -> bool:
    """Zip one file into a fresh archive; False when the caller must fall back."""
    lib = _load()
    if lib is None:
        return False
    rc = lib.submission_zip_file(
        os.fsencode(src_path), os.fsencode(zip_path), arcname.encode(), int(level))
    return rc >= 0
