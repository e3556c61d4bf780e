"""Build the CUDA sources in ``csrc/`` into shared libraries at first use.

Each source becomes its own library with a plain C interface, loaded with
``ctypes``: every pointer and the stream go in as ``c_void_p``.  ``nvcc``
compiles for ``sm_90a`` into ``build/repro_torch/<hash>/`` at the
repository root (or ``$REPRO_TORCH_BUILD_DIR``), keyed by a hash of the
source and the flags, so an edited source never loads a stale library.
:func:`build_all` starts one ``nvcc`` per source, all at once.  Nothing is
built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("ternary_matmul.cu", "paged_attention.cu", "cim_mac.cu",
           "threefry.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}
BUILD_INFO: dict = {}       # source -> {path, seconds, cached, log}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "repro_torch"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "are built at first use on a machine with the "
                           "CUDA toolkit")
    return found


def _flags(verbose: bool) -> list:
    return [*NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ())]


def _lib_path(source: str) -> Path:
    # -Xptxas -v changes the report, not the binary: it is not hashed
    h = hashlib.sha256((CSRC / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return (build_dir() / h.hexdigest()[:16]
            / f"lib{Path(source).stem}.so")


def build_all(verbose: bool = False) -> dict:
    """Compile every source not built yet, one ``nvcc`` each, all
    started together; returns {source: library path}.  ``verbose`` adds
    ``-Xptxas -v`` and keeps the compiler's report in ``BUILD_INFO``."""
    paths = {s: _lib_path(s) for s in SOURCES}
    procs = {}
    t0 = time.monotonic()
    for src, lib in paths.items():
        if lib.exists():
            BUILD_INFO[src] = dict(path=str(lib), seconds=0.0, cached=True)
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
        cmd = [nvcc_path(), *_flags(verbose), "-o", str(tmp),
               str(CSRC / src)]
        procs[src] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for src, (cmd, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, paths[src])
        BUILD_INFO[src] = dict(path=str(paths[src]), cached=False,
                               seconds=time.monotonic() - t0, log=log)
    return paths


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use in this
    process."""
    if source not in _LIBS:
        _LIBS[source] = ctypes.CDLL(str(build_all()[source]))
    return _LIBS[source]
