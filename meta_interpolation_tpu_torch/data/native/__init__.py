"""ctypes binding of the input pipeline's C++ preprocessing (prep.cpp).

Counterpart of ``meta_interpolation_tpu/data/native/__init__.py:35-86``:
crop, temporal flip, per-model normalisation and batch assembly of uint8
frames, over a pool of threads. The first call builds ``prep.cpp`` with
``g++ -O3 -march=native -shared -fPIC -pthread`` into ``build/native/`` at
the root of the checkout, once a process (``-march=native`` code must not
run on another machine's CPU, so a library is never reused across
processes), and loads it. Where g++ is missing or fails, :func:`load`
returns None, says so once on stderr, and the loader takes its numpy
path; :data:`FALLBACK` then holds the reason.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "prep.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")
# None until a build is tried; then the loaded library, or False
_lib = None
# why the numpy path is taken (None while the library loads)
FALLBACK: Optional[str] = None


def build() -> ctypes.CDLL:
    """Compile prep.cpp and load it with its C signature; raises on a
    failed build. The file is unlinked once loaded."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="libprep-", suffix=".so",
                                dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", path], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(path)
    finally:
        os.unlink(path)
    p = ctypes.POINTER
    lib.prep_batch.argtypes = [
        p(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        p(ctypes.c_int), p(ctypes.c_int), p(ctypes.c_int),
        p(ctypes.c_float), p(ctypes.c_float), ctypes.c_float,
        p(ctypes.c_float), ctypes.c_int,
    ]
    lib.prep_batch.restype = None
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None (said once) where g++ is
    missing or fails."""
    global _lib, FALLBACK
    if _lib is None:
        try:
            _lib = build()
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", None) or e
            FALLBACK = f"g++ build of {SRC.name} failed: {detail}"
            print(f"\n{'!' * 72}\n[native] WARNING: {FALLBACK}\n"
                  f"         the data loader takes its numpy path (slower "
                  f"decode-to-batch)\n{'!' * 72}\n", file=sys.stderr,
                  flush=True)
            _lib = False
    return _lib or None


def prep_batch(frames_u8: np.ndarray, crop_h: int, crop_w: int,
               oys: np.ndarray, oxs: np.ndarray, flips: np.ndarray,
               mean: np.ndarray, std: np.ndarray, inv255: float = 1.0 / 255.0,
               num_threads: int = 4) -> Optional[np.ndarray]:
    """frames_u8: (B, T, H, W, 3) uint8 → (B, T, crop_h, crop_w, 3) float32
    ((u8·inv255 − mean)/std), or None without the library."""
    lib = load()
    if lib is None:
        return None
    frames_u8 = np.ascontiguousarray(frames_u8, np.uint8)
    b, t, h, w, _ = frames_u8.shape
    out = np.empty((b, t, crop_h, crop_w, 3), np.float32)
    keep = [np.ascontiguousarray(a, np.int32) for a in (oys, oxs, flips)]
    keep += [np.ascontiguousarray(a, np.float32) for a in (mean, std)]
    i32 = ctypes.POINTER(ctypes.c_int)
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.prep_batch(
        frames_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b, t, h, w, crop_h, crop_w,
        *(a.ctypes.data_as(i32) for a in keep[:3]),
        *(a.ctypes.data_as(f32) for a in keep[3:]), ctypes.c_float(inv255),
        out.ctypes.data_as(f32), num_threads)
    return out
