"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` has a plain C interface and becomes its own
shared library, compiled for Hopper (``sm_90a``) at first use into
``<repo>/build/kernels/`` (listed in ``.gitignore``), under a name keyed by a
hash of the source, every header (``*.cuh``) under ``csrc/`` and the flags,
so an edited source or header is rebuilt and an unchanged one is reused.  A
missing ``nvcc`` or a failed build raises: nothing falls back to another path.

:func:`build_all` starts one ``nvcc`` per source together and waits for all,
so a fresh checkout builds in the time of its slowest kernel.
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
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: kernel name → source file under csrc/
SOURCES = {
    "flash_attention": "flash_attention.cu",
    "ssd_scan": "ssd_scan.cu",
    "rglru_scan": "rglru_scan.cu",
    "ssd_scan_bwd": "ssd_scan_bwd.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

CUDA_NVCC = "/usr/local/cuda/bin/nvcc"    # used when nvcc is not on PATH

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name → {"seconds": build wall time or 0.0 if cached, "log": nvcc output}
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or CUDA_NVCC
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {CUDA_NVCC}; the "
                           "port's CUDA kernels are built on the machine with the card")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[tuple]:
    """Start nvcc for ``name`` unless its library is already built."""
    out = _target(name)
    if out.exists():
        build_info[name] = {"seconds": 0.0, "log": "cached: " + out.name}
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, proc, tmp, out, time.perf_counter()


def _finish(job: tuple) -> None:
    name, proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)                      # atomic: readers never see a partial .so
    build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}


def build_all(names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Build every named kernel (default: all), one nvcc each, in parallel."""
    names = list(SOURCES) if names is None else names
    with _lock:
        jobs = [j for j in (_start(n) for n in names if n not in _libs) if j]
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:         # wait for the others, then raise
                errors.append(e)
        if errors:
            raise errors[0]
    return {n: build_info[n] for n in names if n in build_info}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]
