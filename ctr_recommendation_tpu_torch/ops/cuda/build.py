"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds; where nvcc has
``--split-compile``, each source's optimisation also runs on every core:
the SASRec encoder's sources, whose attention kernels are unrolled for
three head depths, build in half the time). Libraries land in ``csrc/_build/``
under a name that carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. Nothing is built or
loaded when this module is imported: the first launch builds what it needs,
and ``build`` compiles several sources at once, one ``nvcc`` each, in
parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
KERNELS = ("interaction", "interaction_bwd", "scoring", "sasrec_encoder", "sasrec_encoder_bwd",
           "table_grad", "tower")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's ptxas report (registers, shared memory, spills) per built source
ptxas_log: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


_split: list[str] | None = None


def _flags() -> list[str]:
    """NVCC_FLAGS, and ``--split-compile=0`` (as many threads as cores)
    where this nvcc takes it."""
    global _split
    if _split is None:
        help_text = subprocess.run([_nvcc(), "--help"], capture_output=True, text=True).stdout
        _split = ["--split-compile=0"] if "--split-compile" in help_text else []
    return NVCC_FLAGS + _split


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(_flags()).encode())
    for dep in (src, *sorted(CSRC.glob("*.cuh"))):
        h.update(dep.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile the named sources that have no current library, all at once.
    Returns seconds per source built; raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(), "-o", str(tmp), str(src)]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib, time.perf_counter(),
        )
    seconds, failed = {}, []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        ptxas_log[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _, path = _target(name)
            if not path.exists():
                build((name,))
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def check(rc: int, what: str) -> None:
    """Raise when a C launcher returned a cudaError_t other than 0."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel failed to launch: cudaError_t {rc}")
