"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface, at first use, into ``csrc/_build/`` (listed in
.gitignore), and is loaded with ctypes. Only the repository's sources
are compiled. The library file name carries a hash of the source and of
the shared ``csrc/*.cuh`` headers, so an edited kernel is rebuilt;
concurrent builds each write a private temp file and rename it into
place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, nvcc's stderr: ptxas register / spill report)
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    # the shared headers are hashed too: an edit there rebuilds every kernel
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    per source, all started together. Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    outs = {}
    for name in names:
        src, out = _target(name)
        outs[name] = out
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        _, err = proc.communicate()
        BUILD_LOG[name] = (time.perf_counter() - t0, err)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{err}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _LOADED:
        path = build([name])[name]
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
