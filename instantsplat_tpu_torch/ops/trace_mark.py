"""The clock at a point of a step, for the program's device marks
(utils/profiling.py): `mark(times, counter, slot)` writes
times[counter, slot]. On a CUDA tensor the one-thread kernel trace_mark
(csrc/trace.cu) writes the device's %globaltimer in stream order, so it
marks a phase boundary inside a replayed CUDA graph too; on a CPU tensor
the host clock is written (the CPU runs each op before the next), by an
indexed fill that reads no value on the host."""

from __future__ import annotations

import ctypes
import time

import torch

from instantsplat_tpu_torch.ops.cuda_build import Kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
TRACE_MARK = Kernel("trace_mark", [_P, _P, _I, _I, _I, _P],
                    source="trace.cu")


def mark(times: torch.Tensor, counter: torch.Tensor, slot: int,
         stream=None):
    """times [cap, n] int64, counter [1] int64 on the same device: the
    clock now into times[counter, slot] (a row past cap is not written).
    stream: the CUDA stream to launch on (default: the current one)."""
    if times.dtype != torch.int64 or times.dim() != 2 or not (
            times.is_contiguous() and counter.dtype == torch.int64
            and counter.numel() == 1 and counter.device == times.device):
        raise ValueError("mark: times must be a contiguous [cap, n] int64 "
                         "tensor and counter a [1] int64 tensor beside it")
    cap, n = times.shape
    if not 0 <= slot < n:
        raise ValueError(f"mark: slot {slot} outside [0, {n})")
    if not times.is_cuda:
        times.select(1, slot).index_fill_(0, counter, time.perf_counter_ns())
        return
    stream = stream or torch.cuda.current_stream(times.device)
    # the stream made current, so a call on autograd's thread is counted
    # as captured while that stream captures (Kernel.__call__)
    with torch.cuda.device(times.device), torch.cuda.stream(stream):
        TRACE_MARK(times.data_ptr(), counter.data_ptr(), cap, n, slot,
                   stream.cuda_stream)
