"""ctypes bindings for the native host data plane (``native/dataplane.cpp``).

The port shares the C++ source with the JAX package and builds its own copy
of the library with ``native/build.sh``, on first use, into
``build/native/libddt_dataplane.so`` at the root of the checkout. Nothing is
written under ``native/``. The build needs the libjpeg and libpng headers;
where they are missing, :func:`available` is False and the datasets decode
with PIL. The library fuses JPEG/PNG decode + antialiased bicubic resize
(PIL-matching cubic a=-0.5 resampling) + horizontal flip + float conversion,
multithreaded without the GIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_BUILD_SCRIPT = _REPO_ROOT / "native" / "build.sh"
BUILD_DIR = _REPO_ROOT / "build" / "native"
LIB_PATH = BUILD_DIR / "libddt_dataplane.so"

_lib = None
_lib_lock = threading.Lock()
build_error: Optional[str] = None  # why the library is unavailable, once known


def _load() -> Optional[ctypes.CDLL]:
    global _lib, build_error
    with _lib_lock:
        if _lib is not None or build_error is not None:
            return _lib
        if not LIB_PATH.exists():
            # Built in a directory of its own and renamed into place, so a
            # process that builds at the same time never loads half a file.
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                proc = subprocess.run(["sh", str(_BUILD_SCRIPT), tmp], capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    build_error = (proc.stdout + proc.stderr).strip() or f"build.sh exited {proc.returncode}"
                    return None
                os.replace(os.path.join(tmp, LIB_PATH.name), LIB_PATH)
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.ddt_version.restype = ctypes.c_int
        lib.ddt_version.argtypes = []
        lib.ddt_decode_resize_batch.restype = ctypes.c_int
        lib.ddt_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        if lib.ddt_version() != 1:
            raise RuntimeError(f"{LIB_PATH}: data plane version {lib.ddt_version()}, expected 1")
        _lib = lib
    return _lib


def available() -> bool:
    """True when the library is built (building it on the first call)."""
    return _load() is not None


def decode_resize_batch(
    paths: List[str], out_h: int, out_w: int, flips: Optional[List[bool]] = None,
    n_threads: int = 0,
) -> np.ndarray:
    """Decode+resize a list of image paths -> (N, out_h, out_w, 3) float32 in
    [0, 1]. Raises RuntimeError on decode failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native data plane unavailable: {build_error}")
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    flip_arr = np.asarray(flips if flips is not None else [0] * n, np.uint8)
    failures = lib.ddt_decode_resize_batch(
        c_paths, n, out_h, out_w,
        flip_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads,
    )
    if failures:
        raise RuntimeError(f"{failures}/{n} images failed to decode")
    return out
