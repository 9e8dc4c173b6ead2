"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json) names its
configuration and traffic; the traffic names the entry under entries/
that sets up, measures for --seconds and checks the outputs against the
plain reference. The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and last `checks`, each number compared beside its limit (also
the last lines of standard error). Without a CUDA card, with fewer cards
than the cell asks for, without the program beside it, or when a JAX
module was loaded, it prints no result and exits non-zero.
"""

import time

T0 = time.perf_counter()  # set-up counts from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "benchmark" / sub)
sys.path.insert(0, str(ROOT))

from benchmark.core import device, manifest  # noqa: E402


def fail(code: int, msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    try:
        cell = manifest.cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        fail(2, f"cannot resolve workload {args.workload!r}: "
                f"{type(e).__name__}: {e}")
    import torch

    if not torch.cuda.is_available():
        fail(3, "no CUDA card: torch.cuda.is_available() is False")
    if torch.cuda.device_count() < cell.chips:
        fail(3, f"{cell.name} needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} visible")
    try:
        import instantsplat_tpu_torch  # noqa: F401  the system under test
    except ImportError as e:
        fail(4, f"the program is not beside the benchmark: {e}")
    name = torch.cuda.get_device_name(0)
    print(f"[bench] card: {device.smi()}", flush=True)
    print(f"[bench] torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    out = cell.entry().run(cell, args.seed, args.seconds, bool(args.trace),
                           T0)

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = manifest.metric_reader(m["name"])(out.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu", "kind": name, "count": cell.chips,
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    if args.trace:
        dev["busy_s"] = out.busy_s
        dev["window_s"] = out.window_s
    found = device.forbidden_modules()
    if found:
        fail(5, f"JAX modules were loaded: {', '.join(found)}")
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if args.trace and out.breakdown is not None:
        result["breakdown"] = out.breakdown
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in out.checks}
    for n, v, lim in out.checks:
        print(f"[bench] check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
