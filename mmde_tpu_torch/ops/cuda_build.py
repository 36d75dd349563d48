"""Build and bind the package's CUDA sources.

Each `csrc/*.cu` file exposes a plain C interface (no PyTorch headers), is
compiled by nvcc for sm_90a into a shared library under
`mmde_tpu_torch/_build/` the first time it is needed, and is loaded with
ctypes. The library name carries a hash of the sources, the headers under
`csrc/` (`*.cuh`) and the flags, so an edited source or header rebuilds and
a stale library is never picked up.

Nothing here runs at import time: machines without nvcc can import every
module of the package and only fail when a kernel is actually requested.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "--split-compile=0",   # optimise the kernels on every core
              "-Xptxas", "-v"]     # registers / spills go to the build log

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> {"path", "seconds" (0.0 when an existing build was reused), "log"}
BUILD_LOG: Dict[str, dict] = {}


def find_nvcc() -> str:
    """Path of nvcc, from CUDA_HOME / CUDA_PATH, /usr/local/cuda, or PATH."""
    cands: List[str] = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked at CUDA_HOME, CUDA_PATH, /usr/local/cuda and "
        "PATH); the CUDA kernels of mmde_tpu_torch are built from source at "
        "first use and need the CUDA toolkit")


def nvcc_version() -> str:
    out = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[-1] if out.strip() else ""


def load_library(name: str, sources: Sequence[str],
                 defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/) into one shared library and
    return it as a ctypes.CDLL. `defines` ("NAME=VALUE") go to nvcc as -D
    flags (a tool's variant of a source is a library of its own, under its
    own `name`). Built once per (sources, flags) content."""
    if name in _LIBS:
        return _LIBS[name]
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    headers = sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                     if f.endswith(".cuh"))
    flags = list(NVCC_FLAGS) + [f"-D{d}" for d in defines]
    h = hashlib.sha256()
    for p in paths + headers:
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    seconds, log = 0.0, ""
    if not os.path.isfile(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [find_nvcc()] + flags + ["-o", tmp] + paths
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.time() - t0
        log = (proc.stdout + proc.stderr).strip()
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"nvcc failed for {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, lib_path)   # atomic: concurrent processes both win
    lib = ctypes.CDLL(lib_path)
    _LIBS[name] = lib
    BUILD_LOG[name] = {"path": lib_path, "seconds": seconds, "log": log}
    return lib


def load_libraries(specs: Mapping[str, Tuple[Sequence[str], Sequence[str]]]
                   ) -> Dict[str, ctypes.CDLL]:
    """`load_library` for several {name: (sources, defines)} at once, one
    nvcc process per library, all started together (a thread each: the
    work is in the subprocesses)."""
    with ThreadPoolExecutor(max_workers=max(len(specs), 1)) as pool:
        futs = {n: pool.submit(load_library, n, src, defines)
                for n, (src, defines) in specs.items()}
        return {n: f.result() for n, f in futs.items()}
