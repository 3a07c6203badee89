"""Build and load the port's native libraries: the CUDA kernels and the
host code.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface; each ``csrc/<name>.cpp`` (host code, such as
the OBJ writer ``mesh_native.cpp``) with the host C++ compiler (``$CXX``,
else ``g++``). Both happen at first use, into ``csrc/_build/`` (listed in
.gitignore), and the library is loaded with ctypes. Only the
repository's sources are compiled. The library file name carries a hash
of the source, of the shared ``csrc/*.cuh`` headers (CUDA sources) and of
the compiler and its flags, so an edited source is rebuilt; concurrent
builds each write a private temp file and rename it into place. A
missing compiler or a failed build raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_LOADED: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, the compiler's stderr: for nvcc ptxas' register /
# spill report)
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _cxx() -> str:
    name = os.environ.get("CXX") or "g++"
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"host C++ compiler {name!r} not found ($CXX or "
                           "g++): the port's host library is built with it")
    return path


def _command(name: str) -> Tuple[Path, List[str], bytes]:
    """(source, compiler and flags, extra bytes to hash) of ``name``."""
    cu = CSRC / f"{name}.cu"
    if cu.exists():
        # the shared headers are hashed too: an edit there rebuilds
        # every kernel
        headers = b"".join(p.read_bytes()
                           for p in sorted(CSRC.glob("*.cuh")))
        return cu, [_nvcc(), *NVCC_FLAGS], headers
    return CSRC / f"{name}.cpp", [_cxx(), *CXX_FLAGS], b""


def _target(name: str) -> Tuple[Path, List[str], Path]:
    src, cmd, extra = _command(name)
    digest = hashlib.sha256(src.read_bytes() + extra
                            + " ".join(cmd).encode()).hexdigest()
    return src, cmd, BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named library that is not built yet, one compiler
    process per source, all started together. Raises on a failed
    build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    outs = {}
    for name in names:
        src, cmd, out = _target(name)
        outs[name] = out
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [*cmd, "-o", str(tmp), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), tmp, out, time.perf_counter())

    def finish(name):
        # one thread a compiler drains its pipes and times it alone
        proc, tmp, out, t0 = procs[name]
        _, err = proc.communicate()
        BUILD_LOG[name] = (time.perf_counter() - t0, err)
        if proc.returncode != 0:
            return f"{name}:\n{err}"
        os.replace(tmp, out)
        return None

    with ThreadPoolExecutor(max_workers=max(1, len(procs))) as ex:
        failed = [f for f in ex.map(finish, list(procs)) if f]
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _LOADED:
        path = build([name])[name]
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
