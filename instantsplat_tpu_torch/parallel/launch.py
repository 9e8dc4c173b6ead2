"""Spawn the ranks of a multi-device run (port-only; the JAX package runs
one controller process over every device and needs no launcher).

A CLI asked for `--n_devices N` outside torchrun re-runs itself as N
processes (`python -m <module> <argv>`), each with WORLD_SIZE, RANK,
LOCAL_RANK and the path of a FileStore in a fresh temporary directory
(runtime.STORE_ENV), and waits for all of them. Under torchrun (WORLD_SIZE
already set) the process is a rank already and nothing is spawned.

The device count is checked before anything starts: asking for more CUDA
cards than are visible raises, and `-1` (every local card) on a machine
without one raises. A rank that fails ends the launch: the others are
killed and the launch raises with the failing rank's exit code.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch

from instantsplat_tpu_torch.parallel.runtime import STORE_ENV


def in_group() -> bool:
    """True in a process started as a rank (by torchrun or by `spawn`)."""
    return "WORLD_SIZE" in os.environ


def world_size(n_devices: Optional[int], device="cuda") -> int:
    """--n_devices -> the number of ranks of the run: 0, 1 and None mean
    one device (no mesh, as the JAX package builds none for n <= 1); -1
    means every local card (under torchrun: WORLD_SIZE). Raises when more
    cards are asked for than are visible, and under torchrun when the
    count differs from WORLD_SIZE."""
    n = int(n_devices or 0)
    launched = int(os.environ["WORLD_SIZE"]) if in_group() else None
    if n == -1:
        if launched is not None:
            return launched
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError(
                "--n_devices -1 asks for every local CUDA card, and this "
                "machine has none")
        n = cards
    n = max(n, 1)
    if launched is not None and n != launched and (n > 1 or launched > 1):
        raise RuntimeError(
            f"--n_devices {n} under a launch of WORLD_SIZE={launched}: "
            "pass the launch's size or -1")
    if n > 1 and torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if n > cards and launched is None:
            raise RuntimeError(
                f"--n_devices {n} needs {n} CUDA cards; {cards} visible")
    return n


def spawn(module: str, argv: Sequence[str], n: int,
          timeout: Optional[float] = None, env: Optional[dict] = None,
          cwd: Optional[str] = None) -> None:
    """Run `python -m module argv` as ranks 0..n-1 of one group and wait.

    Rank r gets WORLD_SIZE=n, RANK=r, LOCAL_RANK=r and the FileStore path.
    `timeout` (seconds) bounds the whole launch: past it every rank is
    killed and TimeoutError raised. Any rank's non-zero exit kills the
    others and raises RuntimeError naming the rank and its code."""
    base = dict(os.environ if env is None else env)
    with tempfile.TemporaryDirectory(prefix="instantsplat_ranks_") as tmp:
        procs = []
        try:
            for r in range(n):
                e = dict(base, WORLD_SIZE=str(n), RANK=str(r),
                         LOCAL_RANK=str(r),
                         **{STORE_ENV: os.path.join(tmp, "store")})
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, *argv], env=e, cwd=cwd))
            deadline = None if timeout is None else time.time() + timeout
            while True:
                codes = [p.poll() for p in procs]
                bad = [(r, c) for r, c in enumerate(codes) if c not in
                       (None, 0)]
                if bad:
                    r, c = bad[0]
                    raise RuntimeError(
                        f"rank {r} of {n} ({module}) exited with code {c}")
                if all(c == 0 for c in codes):
                    return
                if deadline is not None and time.time() > deadline:
                    raise TimeoutError(
                        f"{module}: {n} ranks still running after "
                        f"{timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()


def run_ranks(module: str, argv: Optional[Sequence[str]],
              n_devices: Optional[int], device="cuda") -> Optional[int]:
    """The CLIs' entry: -> the run's world size when this process should
    go on as a rank (or as the only process), None after it spawned the
    ranks itself and they all finished."""
    n = world_size(n_devices, device)
    if n > 1 and not in_group():
        spawn(module, sys.argv[1:] if argv is None else list(argv), n)
        return None
    return n
