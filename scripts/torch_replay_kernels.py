#!/usr/bin/env python3
"""The device kernels in one replay of a captured stage-2 step: the scan
case of tests/test_torch_gpu.py (2,000 Gaussians, 64x48, the dense
backend, SH 0), the second graph the process captures, counted in a
torch.profiler trace of the replay, with the grid of each concatenation
kernel and the commonest names. Needs a CUDA card.

    python3 scripts/torch_replay_kernels.py [<repository root>]

The root (default: this script's repository) may be another checkout, such
as a parent commit unpacked with `git archive`, to compare two versions in
one call. Prints one JSON line."""
import collections
import json
import sys
import tempfile
from pathlib import Path

root = (Path(sys.argv[1]) if len(sys.argv) > 1
        else Path(__file__).resolve().parent.parent).resolve()
sys.path[:0] = [str(root), str(root / "tests")]
import torch  # noqa: E402

from test_torch_gpu import _scan_case  # noqa: E402
from instantsplat_tpu_torch.pipelines.trainer import make_train_scan  # noqa: E402
from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP, StepLoop  # noqa: E402

dev = torch.device("cuda")
g, cam, stacked, opt, state, _, _ = _scan_case(dev, total=300)
loops = []
real = StepLoop._capture
StepLoop._capture = lambda self: (loops.append(self), real(self))[1]
it = 1
for _ in range(2):
    block = make_train_scan(opt, stacked, torch.zeros(3, device=dev), 0.2,
                            "pallas", 256)
    block(g, state, [0] * (WARMUP + 1), range(it, it + WARMUP + 1), 0)
    it += WARMUP + 1
torch.cuda.synchronize()
with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
    loops[-1].graph.replay()
    torch.cuda.synchronize()
path = Path(tempfile.mkdtemp()) / "replay.json"
prof.export_chrome_trace(str(path))
events = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("cat") == "kernel"]
cats = [(e["name"][:60], e.get("args", {}).get("grid")) for e in events
        if "Cat" in e["name"]]
names = collections.Counter(e["name"][:70] for e in events)
print(json.dumps({"root": str(root), "kernels": len(events),
                  "per_replay_hand": {k.name: n for k, n in
                                      loops[-1].per_replay.items()},
                  "cat_kernels": cats, "top": names.most_common(8)}))
