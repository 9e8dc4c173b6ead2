"""Device-resident loops: one step captured in a CUDA graph and replayed.

The JAX package runs its iteration loops on the device (stage 2's
`make_train_scan` lax.scan, the pose refiner's and the aligner's
fori_loop blocks): the host dispatches a block of iterations and reads
nothing inside it. `StepLoop` is the port's counterpart. Its `step` reads
and writes only tensors that live as long as the loop (the parameters,
the moments, per-iteration tables indexed by a device step counter), so
one captured launch sequence serves every iteration.

On a CUDA device `StepLoop.run(n)` runs the first WARMUP steps eagerly on a
side stream (PyTorch's rule for capturing autograd and lazily initialised
libraries; they are real steps of the loop), captures the next step once
(capture executes nothing) and replays the graph for the rest: one
cudaGraphLaunch per iteration, no host read inside the block. A capture
that fails, or a step that synchronises with the host while it is being
captured, raises naming the loop; nothing falls back to eager steps. On
the CPU the same step runs in a Python loop: that is the plain version,
which the tests hold to the eager loops bit for bit.

The capacity backends' overflow guard (render/driver.py) ORs each call's
overflow flag into the loop's `flags` while a block runs; the flags are
read once, at the block's end, where overflowing signatures are demoted.

Spans (utils/profiling.py): `steploop.warmup` (the eager steps on the side
stream), `steploop.capture`, `steploop.replay` (the replays' launches),
`steploop.loop` (the CPU's Python loop), `steploop.settle` (the overflow
flags' read); the counter `steploop.captures`.

What the loops share:
- `StepTable`: a loop's per-step scalars (learning rates, bias
  corrections, schedule factors) as one float32 device table, read by a
  device step counter that the step advances;
- `StaticInputs`: device buffers that a step reads for data that changes
  from step to step (a pre-training batch); the host copies each step's
  data into them, from pinned memory and asynchronously, before the step
  runs or replays;
- `groups`: the process groups whose collectives a step runs. Captured
  collectives need NCCL; the warm-up steps run them once before the
  capture (a communicator is made on its first collective, which a
  capture cannot hold).
"""

from __future__ import annotations

import gc
from typing import Any, Callable

import numpy as np
import torch

from instantsplat_tpu_torch.utils import profiling

WARMUP = 3  # eager steps on a side stream before a loop's first capture
_SIDE: dict = {}  # device -> the warm-up stream every loop shares


def _side_stream(device) -> torch.cuda.Stream:
    """One side stream per device for every loop's warm-up: the caching
    allocator reuses blocks freed on a stream only on that stream, so a
    new stream per warm-up would allocate anew each time."""
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


def to_device(array, device, dtype=torch.float32) -> torch.Tensor:
    """A host array on `device` without a host sync: through pinned memory
    and an asynchronous copy on a card."""
    t = torch.as_tensor(np.ascontiguousarray(array), dtype=dtype)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class StepTable:
    """A loop's per-step scalars as one float32 table on the device: row i
    holds the scalars of the loop's i-th step. A step reads its row by the
    device counter (`row`) and advances it (`advance`), so no host value is
    frozen into a captured graph."""

    def __init__(self, rows, device):
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:  # one scalar a step
            rows = rows[:, None]
        self.table = to_device(rows, device)
        self.counter = torch.zeros(1, dtype=torch.int64, device=device)

    def __len__(self) -> int:
        return self.table.shape[0]

    def row(self) -> torch.Tensor:
        """This step's scalars, [k] on the device."""
        return self.table.index_select(0, self.counter)[0]

    def advance(self):
        self.counter.add_(1)

    def seek(self, i: int):
        """Point the counter at row i: a device fill, outside any step."""
        self.counter.fill_(i)


class StaticInputs:
    """Device buffers for a nested dict of tensors that a step reads; a
    step never references the host's tensors themselves. `copy_(tree)`
    writes a new tree of the same signature into them: on a card from
    pinned memory with non_blocking=True on the current stream, where the
    loop's replays run after it."""

    def __init__(self, tree, device):
        self.device = torch.device(device)
        self.tree = _map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device=self.device), tree)

    @staticmethod
    def signature(tree) -> tuple:
        """The shapes and dtypes of a tree's tensors, in path order: the
        key of the graph that reads them."""
        out = []
        _map(lambda t: out.append((tuple(t.shape), t.dtype)), tree)
        return tuple(out)

    def copy_(self, tree):
        def put(dst, src):
            if self.device.type == "cuda" and src.device.type == "cpu":
                src = src.pin_memory()
            dst.copy_(src, non_blocking=True)

        _zip(put, self.tree, tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree) if torch.is_tensor(tree) else tree


def _zip(fn, dst, src):
    if isinstance(dst, dict):
        if set(dst) != set(src):
            raise KeyError(f"static inputs hold {sorted(dst)}, given "
                           f"{sorted(src)}")
        for k in dst:
            _zip(fn, dst[k], src[k])
    elif torch.is_tensor(dst):
        fn(dst, src)


def _kernels():
    from instantsplat_tpu_torch.ops.rasterize_pallas import Kernel

    return Kernel.registry


class StepLoop:
    """`step()` run n times: replays of one captured CUDA graph on a card,
    a Python loop on the CPU. `step` returns what the loop reports (a
    tensor or a dict of tensors, the last iteration's after `run`)."""

    replays = 0  # cudaGraphLaunch calls of every loop in the process

    def __init__(self, step: Callable[[], Any], device, name: str,
                 pool=None, groups=()):
        self.step = step
        self.device = torch.device(device)
        self.name = name
        self.pool = pool
        self.groups = [g for g in groups or () if g is not None]
        if self.captured:
            import torch.distributed as dist

            for g in self.groups:
                if dist.get_backend(g) != "nccl":
                    raise RuntimeError(
                        f"{name}: a captured step's collectives need a NCCL "
                        f"group, not {dist.get_backend(g)} (CUDA tensors on "
                        "a host backend synchronise with the host)")
        self.flags: dict = {}  # overflow guard flags (render/driver.py)
        self.graph = None
        self.warm = 0
        self.out = None
        self.per_replay: dict = {}  # Kernel -> launches in one replay

    @property
    def captured(self) -> bool:
        """Replays of a graph (on a card) or a Python loop."""
        return self.device.type == "cuda"

    def reset_graph(self):
        """Drop the graph (its static tensors were re-allocated); the next
        run captures again, without new warm-up steps."""
        self.graph = None
        self.out = None

    def run(self, n: int):
        """Run n steps; -> the last step's outputs."""
        from instantsplat_tpu_torch.render import driver

        for f in self.flags.values():
            f.zero_()
        with driver.recording_overflow(self.flags):
            if self.captured:
                out = self._run(n)
            else:
                with profiling.annotate("steploop.loop"):
                    out = self._loop(n)
        with profiling.annotate("steploop.settle"):
            driver.settle_overflow(self.flags)
        return out

    def _loop(self, n: int):
        out = None
        for _ in range(n):
            out = self.step()
        return out

    def _run(self, n: int):
        out, done = None, 0
        if self.graph is None and self.warm < WARMUP:
            done = min(n, WARMUP - self.warm)
            main = torch.cuda.current_stream(self.device)
            side = _side_stream(self.device)
            side.wait_stream(main)
            with profiling.annotate("steploop.warmup"), \
                    torch.cuda.stream(side):
                out = self._loop(done)
            main.wait_stream(side)
            self.warm += done
        if done == n:
            return out
        if self.graph is None:
            with profiling.annotate("steploop.capture"):
                self._capture()
        with profiling.annotate("steploop.replay"):
            for _ in range(n - done):
                self.graph.replay()
        StepLoop.replays += n - done
        for kernel, k in self.per_replay.items():
            kernel.replayed(k * (n - done))
        return self.out

    def _capture(self):
        for kernel in _kernels():
            kernel.captured = 0
        graph = torch.cuda.CUDAGraph()
        if self.groups:
            # the warm-up's collectives finished: the process group's
            # watchdog then queries no event of theirs during the capture
            torch.cuda.synchronize(self.device)
        # an unreachable graph freed by the cyclic collector while this one
        # captures would destroy it mid-capture, which invalidates the
        # capture: collect now, and not during the capture
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), \
                    torch.cuda.graph(graph, pool=self.pool):
                out = self.step()
        except Exception as e:
            raise RuntimeError(f"{self.name}: CUDA graph capture of one "
                               f"step failed ({type(e).__name__}: {e})") from e
        finally:
            if was_enabled:
                gc.enable()
        self.per_replay = {k: k.captured for k in _kernels() if k.captured}
        self.graph, self.out = graph, out
        profiling.count("steploop.captures")
