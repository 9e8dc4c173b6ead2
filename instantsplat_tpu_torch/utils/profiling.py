"""torch.profiler traces of a region (port of
instantsplat_tpu/utils/profiling.py).

- `profile_trace(logdir)`: trace the wrapped region with torch.profiler
  (host activities, and the card's kernels and copies when CUDA is
  available) and write it into `logdir` as a `*.pt.trace.json` file, the
  format of TensorBoard's PyTorch profiler plugin, which Chrome's and
  Perfetto's trace viewers also open.
- `annotate(name)`: a named span inside an active trace
  (`torch.profiler.record_function`).

torch.profiler exists wherever torch does, so nothing degrades to a
no-op: a trace that cannot be written raises.
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import time

import torch

_log = logging.getLogger(__name__)


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


def annotate(name: str):
    """Named span inside an active trace (host timeline)."""
    return torch.profiler.record_function(name)
