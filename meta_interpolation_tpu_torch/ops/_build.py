"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` into ``build/kernels/lib<name>-<hash>.so`` at the root of the
checkout, then loaded with ``ctypes``. The file name carries a hash of
the source, so an edited source is rebuilt and a built one is reused.
Nothing is compiled when this module is imported: the first launch
builds (or :func:`build` does, for every source at once).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("sepconv", "warp", "flow_projection")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc on the machine with the "
                           "card")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Dict[str, object]]:
    """Compile every source in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together. Returns, per name,
    the build seconds (0 when reused) and the compiler's ``-Xptxas -v``
    report (registers, shared memory, spills). Raises if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    report: Dict[str, Dict[str, object]] = {
        n: {"seconds": 0.0, "log": "reused " + library_path(n).name}
        for n in names if n not in procs}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def dense(t):
    """``t`` contiguous and backed by memory, for a kernel to read.
    Autograd may hand a backward an efficient zero tensor as a cotangent
    (``sgn``'s derivative gives one, so an L1 term reaches a second-order
    backward with it): it has no storage and a null data pointer."""
    import torch
    t = t.contiguous()
    if t._is_zerotensor():
        return torch.zeros(t.shape, dtype=t.dtype, device=t.device)
    return t


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
