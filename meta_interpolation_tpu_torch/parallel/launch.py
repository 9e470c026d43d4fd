"""Start local ranks from Python, as ``torchrun --standalone`` starts them.

    from meta_interpolation_tpu_torch.parallel.launch import spawn
    spawn(fn, 2, args=(...), timeout=600)   # fn(rank, *args) in 2 ranks

Each rank is a fresh process (the ``spawn`` start method) with
``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` set, so ``mesh.init_distributed`` and
the CLI's ``main`` inside it join one process group on this machine.
``fn`` is sent by its import path: a function of a module, not a lambda.
"""
from __future__ import annotations

import os
import socket
import time
from typing import Callable, Sequence

import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(index: int, fn: Callable, nprocs: int, port: int,
          args: Sequence) -> None:
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index),
                      WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    fn(index, *args)


def spawn(fn: Callable, nprocs: int, args: Sequence = (),
          timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` ranks of one process group
    and wait for them. A rank that raises fails the call (its traceback
    in the error) and the others are stopped; a group that outlasts
    ``timeout`` seconds is killed and raises ``TimeoutError``."""
    context = mp.start_processes(_rank, args=(fn, nprocs, free_port(),
                                              tuple(args)),
                                 nprocs=nprocs, join=False,
                                 start_method="spawn")
    deadline = time.monotonic() + timeout
    while not context.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for proc in context.processes:
                if proc.is_alive():
                    proc.kill()
            for proc in context.processes:
                proc.join(10)
            raise TimeoutError(f"{nprocs} ranks of {fn.__name__} outlasted "
                               f"{timeout:.0f} s and were killed")
