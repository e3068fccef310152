"""Build the CUDA sources under ``dynamo_depth_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout,
where ``<hash>`` is the SHA-256 of the source (and of the headers beside it),
so an edited source is rebuilt and an unchanged one is loaded as it is. The
first call builds every source at once, one ``nvcc`` process per source, all
started together; nothing is built at import time.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("warp", "photometric")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict = {}
build_log: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> list:
    """Build every stale source in parallel; return the names built (empty
    when every library was current)."""
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return list(todo)


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed, with
    ``signatures`` = {function: argtypes} declared (every function returns
    its ``cudaGetLastError()`` as an int). A later call may declare more of
    the library's functions: each is declared at its first call."""
    lib, declared = _libs.get(name, (None, None))
    if lib is None:
        build_all()
        lib, declared = ctypes.CDLL(str(_lib_path(name))), set()
        _libs[name] = (lib, declared)
    for fn in signatures.keys() - declared:
        getattr(lib, fn).argtypes = signatures[fn]
        getattr(lib, fn).restype = ctypes.c_int
        declared.add(fn)
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error (its ``cudaGetLastError``)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
