"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file."""

import json
import re

import pytest

from benchmark.core import manifest

MAN = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["benchmark"]
    assert len(MAN["command"]) <= 32
    assert (manifest.ROOT / MAN["command"][1]).is_file()
    assert (manifest.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_sources():
    names = ([c["name"] for c in MAN["configs"]]
             + [w["name"] for w in MAN["workloads"]]
             + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = [w["name"] for w in MAN["workloads"]]
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_resolves(cell):
    c = manifest.cell(cell)
    assert c.chips in (1, 4)
    assert callable(c.entry().run)
    for m in c.per_layer:
        assert callable(manifest.metric_reader(m["name"]))
    assert c.limits and all(v > 0 for v in c.limits.values())
    configs = {x["name"]: x for x in MAN["configs"]}
    assert configs[c.config_name]["file"].startswith("benchmark/")


def test_every_config_is_used_and_names_its_file():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        assert json.loads((manifest.ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16


def test_layer_patterns_match_the_kernel_names():
    dense = manifest.layer_patterns("compositor")
    names = ["(anonymous namespace)::k2_backward_kernel(float const*, int)",
             "(anonymous namespace)::lists_forward_kernel<4, 64>(float)"]
    assert all(any(p.search(n) for p in dense) for n in names)
    assert not any(p.search("void at::native::vectorized_elementwise_kernel")
                   for p in dense)
    sort = manifest.layer_patterns("sort")
    assert any(p.search("void at_cuda_detail::cub::DeviceRadixSortOnesweep"
                        "Kernel<") for p in sort)


def test_readers_take_every_layer_from_the_record():
    # a layer is a directory under layers/: its seconds reach the record
    # (and leave the unclaimed rest) without an edit to the entry
    layers = manifest.layer_dirs()
    assert {"compositor", "sort"} <= set(layers)
    record = dict(
        prep_s=1.0, prep_window_s=2.0, prep_busy_s=1.5, prep_device_s=1.6,
        block_iterations=10, block_s=0.1, block_busy_s=0.08,
        block_device_s=0.09,
        layer_s={d: dict(prep=0.1, block=0.01) for d in layers + ["new"]},
        block_compositor_ops=1e9, block_compositor_bytes=1e8,
        block_flops=1e10, peaks=dict(fp32_flops=67e12, hbm_bytes=3.35e12))
    rest = manifest.metric_reader("train.torch_kernels_ms")(record)
    assert abs(rest - (0.09 - 0.01 * (len(layers) + 1)) * 100) < 1e-9
    for m in MAN["per_layer"]:
        read = manifest.metric_reader(m["name"])
        assert read(record) is not None
        assert read({}) is None
