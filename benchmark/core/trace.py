"""The device trace of a traced run: torch.profiler over a window, read back
from its Chrome trace.

Device operations are the trace's kernel, memcpy and memset events (a
CUDA-graph replay's kernels included); host activity is its CPU ops and
user annotations (`torch.profiler.record_function` spans, the program's
own and the benchmark's). Times are seconds.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

from benchmark.core.manifest import layer_patterns

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LABELLED_GAPS = 2000


class Profiler:
    """torch.profiler (CPU + CUDA activities) from `start()` to `stop()`,
    which writes the Chrome trace to `path`. The profiler's per-event
    Python objects are never built: PyTorch's parse of a stage-2 step's
    ~1,800 kernels an iteration takes minutes, and the trace file is all
    that is read."""

    def __init__(self, path: Path):
        self.path = path
        self.prof = None

    def start(self):
        import torch

        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.prof.profiler._parse_kineto_results = lambda *a, **k: []

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    def __init__(self, path: Path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        self.device, self.host, self.spans = [], [], {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append((e["name"], t0, t0 + dur))
            elif cat in HOST_CATS:
                self.host.append((e["name"], t0, t0 + dur))
                if cat == "user_annotation":
                    self.spans.setdefault(e["name"], (t0, t0 + dur))

    def span(self, name: str):
        """(start, end) of the first user annotation called `name`."""
        return self.spans[name]

    def ops_in(self, window):
        a, b = window
        return [(n, max(t0, a), min(t1, b)) for n, t0, t1 in self.device
                if t1 > a and t0 < b]

    def busy(self, window) -> float:
        """Seconds in `window` in which some operation ran on the device."""
        return sum(b - a for a, b in _merged(
            (t0, t1) for _, t0, t1 in self.ops_in(window)))

    def op_seconds(self, window) -> float:
        """Device seconds of every operation in `window`, summed."""
        return sum(t1 - t0 for _, t0, t1 in self.ops_in(window))

    def layer_seconds(self, layer_dir: str, window) -> float:
        """Device seconds of the kernels that layers/<layer_dir>/ names."""
        pats = layer_patterns(layer_dir)
        names = {n for n, _, _ in self.ops_in(window)}
        hit = {n for n in names if any(p.search(n) for p in pats)}
        return sum(t1 - t0 for n, t0, t1 in self.ops_in(window) if n in hit)

    def breakdown(self, window, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps grouped by the most specific host activity under each."""
        by_op: dict = {}
        ops = self.ops_in(window)
        for n, t0, t1 in ops:
            key = n if len(n) <= 120 else n[:117] + "..."
            by_op[key] = by_op.get(key, 0.0) + (t1 - t0)
        busy = _merged((t0, t1) for _, t0, t1 in ops)
        edges = [window[0]] + [x for iv in busy for x in iv] + [window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        names = [h[0] for h in self.host]
        starts = np.array([h[1] for h in self.host])
        ends = np.array([h[2] for h in self.host])
        by_gap: dict = {}
        # the longest gaps, which hold nearly all of the idle time
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
            mid = 0.5 * (a + b)
            under = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = (names[under[np.argmin(ends[under] - starts[under])]]
                    if len(under) else "host (no traced op)")
            name = re.sub(r"\d+", "#", name)
            by_gap[name] = by_gap.get(name, 0.0) + (b - a)

        def top_of(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    [:top]]

        return {"device_ops": top_of(by_op), "idle_gaps": top_of(by_gap)}


def merged_breakdown(parts: list, top: int = 10) -> dict:
    """One breakdown of several windows' (their seconds summed by name)."""
    out = {}
    for key in ("device_ops", "idle_gaps"):
        sums: dict = {}
        for part in parts:
            for name, sec in part[key]:
                sums[name] = sums.get(name, 0.0) + sec
        out[key] = [[k, v] for k, v in sorted(sums.items(),
                                               key=lambda kv: -kv[1])[:top]]
    return out
