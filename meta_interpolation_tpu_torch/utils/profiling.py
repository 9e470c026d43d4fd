"""Tracing and profiling hooks, and the LPIPS hook of ``--lpips``.

Counterpart of ``meta_interpolation_tpu/utils/profiling.py``:
  * :func:`trace` — a context manager around ``torch.profiler.profile``
    (CPU activity, and CUDA when a card is present) that writes a Chrome
    trace, which TensorBoard's profiler plugin and ``chrome://tracing``
    load (``--profile_dir``);
  * :func:`annotate` — a named range in that trace
    (``torch.profiler.record_function``);
  * :class:`StepTimer` — wall-clock steps that wait for the card first;
  * :func:`eval_lpips` — the batch-mean LPIPS distance, with the
    parameters loaded once a process.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str], cuda: Optional[bool] = None):
    """Profile the enclosed block into ``log_dir/trace.json`` (nothing when
    ``log_dir`` is None). ``cuda``: record the card's activity too; by
    default when a card is present."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        print(f"[profile] trace written to {path}")


def annotate(name: str):
    """A named range for trace attribution."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Per-step wall clock that waits for the card before it reads the
    clock: ``stop(result)`` synchronises the device of the first tensor in
    ``result`` (a tensor, or a tuple, list or dict holding them), or
    fetches it to the host when it is not a CUDA tensor."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        leaf = _first_tensor(result)
        if leaf is not None:
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
            else:
                float(leaf.reshape(-1)[0])
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(1, len(self.times))


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree if tree.numel() else None
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            leaf = _first_tensor(t)
            if leaf is not None:
                return leaf
    return None


_LPIPS_PARAMS = None
_LPIPS_ON = {}


def eval_lpips(pred: torch.Tensor, target: torch.Tensor) -> float:
    """The batch-mean LPIPS distance of NCHW ``pred`` and ``target`` in [0,
    1], on their device (reference utils.py:207-211, ``--lpips``). The
    parameters are loaded once a process: the pretrained ones from the
    weights' search path, else the random init from seed 0, with a loud
    warning (``utils/lpips.load_pretrained``)."""
    global _LPIPS_PARAMS
    from . import lpips as lpips_lib
    if _LPIPS_PARAMS is None:
        _LPIPS_PARAMS = lpips_lib.load_pretrained()
        if _LPIPS_PARAMS is None:
            _LPIPS_PARAMS = lpips_lib.init_params(
                torch.Generator().manual_seed(0))
        _LPIPS_ON.clear()
    key = str(pred.device)
    if key not in _LPIPS_ON:
        _LPIPS_ON[key] = lpips_lib.to_device(_LPIPS_PARAMS, pred.device)
    with torch.no_grad():
        return float(lpips_lib.lpips(_LPIPS_ON[key], pred.float(),
                                     target.float()).mean())
