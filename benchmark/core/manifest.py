"""The benchmark's data, found by name: BENCHMARK.json at the checkout's
root names each cell's configuration and traffic; their files, the entry
that drives a traffic mix, the per-layer metric readers and the layers'
kernel-name patterns live under benchmark/ in files of their own."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module file {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json: number compared -> its limit
    end_to_end: list  # BENCHMARK.json's metrics that this cell reports
    per_layer: list

    def entry(self):
        """The module under entries/ that drives this cell's traffic."""
        return load_module(BENCH / "entries" / f"{self.traffic['entry']}.py",
                           f"bench_entry_{self.traffic['entry']}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, manifest_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    man = read_json(manifest_path)
    found = [w for w in man["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {manifest_path}")
    w = found[0]
    configs = {c["name"]: c for c in man["configs"]}
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"],
        config=read_json(ROOT / configs[w["config"]]["file"]),
        traffic=read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=read_json(BENCH / "limits" / f"{name}.json"),
        end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in man["per_layer"] if _applies(m, name)])


def metric_reader(name: str):
    """The `read(record)` of metrics/<name>.py."""
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "bench_metric_" + re.sub(r"\W", "_", name)).read


def layer_patterns(layer_dir: str) -> list:
    """Kernel-name regular expressions of layers/<layer_dir>/*.txt, one a
    line (blank lines and # comments skipped)."""
    pats = []
    for path in sorted((BENCH / "layers" / layer_dir).glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                pats.append(re.compile(line))
    return pats


def layer_dirs() -> list:
    """The layers that layers/ names, one directory each."""
    return sorted(p.name for p in (BENCH / "layers").iterdir() if p.is_dir())
