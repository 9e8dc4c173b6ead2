"""The program's spans, counters and device marks, and torch.profiler traces
of a region (port of instantsplat_tpu/utils/profiling.py, extended).

- `profile_trace(logdir)`: trace the wrapped region with torch.profiler
  (host activities, and the card's kernels and copies when CUDA is
  available) and write it into `logdir` as a `*.pt.trace.json` file, the
  format of TensorBoard's PyTorch profiler plugin, which Chrome's and
  Perfetto's trace viewers also open.
- `annotate(name)` (`spanned(name)` around a function): the program's
  span. `name` is a constant (no data in
  it). Every span enters `torch.profiler.record_function(name)`, so an
  active trace shows it on the trace's own clock, and adds its host time
  (`time.perf_counter_ns`) to the table under its name, with its parent
  (the enclosing span of this context) and its self time (its host time
  less what its child spans cover). With tracing on (`enable(True)`, off
  by default) a span also records a pair of CUDA events on the current
  stream, without a sync; their device time is resolved when the table
  is next read.
- `count(name, n)`: a counter.
- Device marks (`marking`, `mark`, `mark_grad`): inside a step of a
  device-resident loop (utils/cuda_graphs.StepLoop) the clock at named
  points of the step, written on the device into a [cap, n_marks] int64
  table by the one-thread kernel trace_mark (ops/trace_mark.py), so a
  replayed CUDA graph, which carries no host op, still marks where its
  phases start and end. With tracing off no mark is launched and no hook
  registered. `add_step_marks` turns a block's rows into phase seconds.
- `snapshot()`: the table as plain data; `reset()` empties it.

torch.profiler exists wherever torch does, so nothing degrades to a
no-op: a trace that cannot be written raises.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import logging
import os
import socket
import threading
import time

import numpy as np
import torch

_log = logging.getLogger(__name__)

# the individual spans that snapshot() lists, newest kept (a stage-2
# scene makes a few hundred)
SPAN_LOG = 20_000
# resolve the device times of finished spans once this many wait
_PENDING_RESOLVE = 2048
_clock = time.perf_counter_ns  # the host clock; tests substitute a fake one


@contextlib.contextmanager
def profile_trace(logdir, enabled: bool = True):
    """Trace the wrapped region into `logdir` (made if missing). Launches
    on a card are asynchronous: the card is synchronised before the trace
    stops, so the region's kernels are in it. Disabled, or with no
    logdir, a no-op."""
    if not enabled or not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    # the file name of torch.profiler.tensorboard_trace_handler
    path = os.path.join(str(logdir), f"{socket.gethostname()}_{os.getpid()}"
                        f".{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    _log.info("profiler trace written to %s", path)


class Table:
    """What the spans, counters and marks of a process recorded (spans and
    counters may come from any thread: `lock` guards the updates)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        self.spans: dict = {}  # name -> [count, host ns, child ns]
        self.device: dict = {}  # name -> device seconds resolved
        self.pending: list = []  # (log entry, start event, end event)
        self.counters: dict = {}
        self.phases: dict = {}  # (loop, family, phase) -> [seconds, steps]
        # [name, parent, start s, end s, device s or None]
        self.log = collections.deque(maxlen=SPAN_LOG)

    def add_span(self, name, parent, t0, t1, child, events):
        entry = [name, parent, t0 * 1e-9, t1 * 1e-9, None]
        with self.lock:
            s = self.spans.setdefault(name, [0, 0, 0])
            s[0] += 1
            s[1] += t1 - t0
            s[2] += child
            self.log.append(entry)
            if events is not None:
                self.pending.append((entry, *events))
        if len(self.pending) >= _PENDING_RESOLVE:
            self.resolve(wait=False)

    def count(self, name: str, n: int):
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def resolve(self, wait: bool):
        """Device seconds of the spans whose events have run (all of them
        after a device sync when `wait`; none while a stream captures)."""
        if not self.pending or (not wait and
                                torch.cuda.is_current_stream_capturing()):
            return
        if wait:
            torch.cuda.synchronize()
        left = []
        for entry, start, end in self.pending:
            if not wait and not end.query():
                left.append((entry, start, end))
                continue
            sec = start.elapsed_time(end) * 1e-3
            entry[4] = sec
            self.device[entry[0]] = self.device.get(entry[0], 0.0) + sec
        self.pending = left


_table = Table()
_on = False
# the innermost open span of this context: [name, start ns, child ns,
# parent frame]
_frame: contextvars.ContextVar = contextvars.ContextVar(
    "instantsplat_span", default=None)


def enable(on: bool):
    """Switch tracing on or off for the process: device times of spans and
    the device marks of the loops' steps (graphs captured while it is on
    carry the marks; a loop keys its graphs by it)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def _timing() -> bool:
    """Whether a span records device events now: tracing on, a card in
    use, and the current stream not being captured."""
    return (_on and torch.cuda.is_available() and torch.cuda.is_initialized()
            and not torch.cuda.is_current_stream_capturing())


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def annotate(name: str) -> "_Span":
    """The program's span: `with annotate("train.knn"): ...` (see the
    module docstring)."""
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside annotate(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Span:
    """An open span of `annotate`."""

    __slots__ = ("name", "_rf", "_token", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._start = _event() if _timing() else None
        self._token = _frame.set([self.name, _clock(), 0, _frame.get()])
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        frame = _frame.get()
        _frame.reset(self._token)
        name, t0, child, parent = frame
        if parent is not None:
            parent[2] += t1 - t0
        events = None
        if self._start is not None and _timing():
            events = (self._start, _event())
        _table.add_span(name, parent[0] if parent is not None else None, t0,
                        t1, child, events)
        self._rf.__exit__(*exc)
        return False


def count(name: str, n: int = 1):
    _table.count(name, int(n))


def reset():
    _table.reset()


# --------------------------------------------------------------------------
# device marks inside a loop's step
# --------------------------------------------------------------------------


class StepMarks:
    """The clock at named points (`names`) of each step of a block: row i
    of `times` [cap, len(names)] int64 holds step i's, written where the
    device counter of the loop points. On a card the kernel trace_mark
    writes the device's %globaltimer in stream order; on the CPU the
    host clock is written. A mark never written stays 0."""

    def __init__(self, names, cap: int, device):
        self.names = {n: i for i, n in enumerate(names)}
        self.times = torch.zeros((cap, len(names)), dtype=torch.int64,
                                 device=device)


class _Marking:
    __slots__ = ("marks", "counter", "stream")

    def __init__(self, marks: StepMarks, counter):
        self.marks, self.counter = marks, counter
        self.stream = (torch.cuda.current_stream(marks.times.device)
                       if marks.times.is_cuda else None)

    def mark(self, name: str):
        from instantsplat_tpu_torch.ops import trace_mark

        trace_mark.mark(self.marks.times, self.counter,
                        self.marks.names[name], self.stream)

    def hook(self, name: str):
        """A gradient hook that marks `name` (it runs on autograd's
        thread: it holds what it writes to and on which stream)."""
        def hook(grad):
            self.mark(name)
        return hook


_marking: contextvars.ContextVar = contextvars.ContextVar(
    "instantsplat_marking", default=None)


@contextlib.contextmanager
def marking(marks, counter):
    """Inside, `mark` and `mark_grad` write into `marks` (a StepMarks) at
    row `counter` (a 1-element int64 device tensor). `marks` None: they do
    nothing."""
    if marks is None:
        yield
        return
    token = _marking.set(_Marking(marks, counter))
    try:
        yield
    finally:
        _marking.reset(token)


def mark(name: str):
    """The clock at this point of the step into its row's `name` column."""
    cur = _marking.get()
    if cur is not None:
        cur.mark(name)


def mark_grad(tensor: torch.Tensor, name: str):
    """Mark `name` once the gradient of `tensor` is computed in the
    backward (every op whose backward feeds it has run)."""
    cur = _marking.get()
    if cur is not None and tensor.requires_grad:
        tensor.register_hook(cur.hook(name))


def add_step_marks(loop: str, family: str, rows, names, phases: dict):
    """Add a block's marks to the phase table. rows: [k, len(names)] int64
    clock readings (ns) of the block's k steps; phases: phase -> the (from
    mark, to mark) intervals it covers. A mark that is missing (0) takes
    the next present mark's time, so its interval joins the next one.
    `replay_gap` adds to its intervals (if any) the time from one step's
    last mark to the next step's first. -> {phase: seconds} of the
    block."""
    t = np.asarray(rows, dtype=np.int64).copy()
    for j in range(t.shape[1] - 2, -1, -1):
        t[:, j] = np.where(t[:, j] == 0, t[:, j + 1], t[:, j])
    col = {n: i for i, n in enumerate(names)}
    out = {p: sum(float((t[:, col[b]] - t[:, col[a]]).sum())
                  for a, b in spans) * 1e-9
           for p, spans in phases.items()}
    out["replay_gap"] = out.get("replay_gap", 0.0) + float(
        (t[1:, 0] - t[:-1, -1]).sum()) * 1e-9
    with _table.lock:
        for p, sec in out.items():
            acc = _table.phases.setdefault((loop, family, p), [0.0, 0])
            acc[0] += sec
            acc[1] += t.shape[0]
    return out


# --------------------------------------------------------------------------
# reading the table
# --------------------------------------------------------------------------


def snapshot() -> dict:
    """The table as plain data (the device is synchronised first when
    span events wait):
    - spans: name -> count, host_s, self_s (host_s less the child spans'
      host time), device_s (None where no span of the name was timed);
    - counters: the counters, and the launch counts the program keeps
      elsewhere (`kernel.<name>.launches`, `steploop.replays`);
    - phases: loop -> backend family -> phase -> seconds, steps;
    - log: the individual spans, oldest first (at most SPAN_LOG), each
      [name, parent, start s, end s, device s or None]."""
    from instantsplat_tpu_torch.ops.rasterize_pallas import Kernel
    from instantsplat_tpu_torch.utils.cuda_graphs import StepLoop

    _table.resolve(wait=True)
    spans = {name: dict(count=c, host_s=host * 1e-9,
                        self_s=(host - child) * 1e-9,
                        device_s=_table.device.get(name))
             for name, (c, host, child) in _table.spans.items()}
    counters = dict(_table.counters)
    counters["steploop.replays"] = StepLoop.replays
    for k in Kernel.registry:
        counters[f"kernel.{k.name}.launches"] = k.launches
    phases: dict = {}
    for (loop, family, phase), (sec, steps) in _table.phases.items():
        phases.setdefault(loop, {}).setdefault(family, {})[phase] = dict(
            seconds=sec, steps=steps)
    return dict(enabled=_on, spans=spans, counters=counters, phases=phases,
                log=[list(e) for e in _table.log])
