"""The trace reader on a hand-made Chrome trace: busy time, a layer's
kernel time by its name files, and the breakdown's idle gaps by the host
op under them."""

import json

from benchmark.core import trace as tr


def _event(name, cat, ts_us, dur_us):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts_us, "dur": dur_us}


def test_busy_layers_and_breakdown(tmp_path):
    events = [
        _event("bench.block", "user_annotation", 0, 100),
        _event("aten::mul", "cpu_op", 10, 30),
        _event("(anonymous namespace)::k1_forward_kernel(float const*)",
               "kernel", 0, 10),
        _event("void at::native::vectorized_elementwise_kernel<4>",
               "kernel", 5, 10),
        _event("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>",
               "kernel", 40, 20),
        _event("Memcpy HtoD", "gpu_memcpy", 90, 5),
        _event("outside", "kernel", 200, 50),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = tr.Trace(path)
    w = t.span("bench.block")
    assert w[0] == 0.0 and abs(w[1] - 100e-6) < 1e-12
    assert abs(t.busy(w) - 40e-6) < 1e-12  # [0, 15] + [40, 60] + [90, 95]
    assert abs(t.op_seconds(w) - 45e-6) < 1e-12
    assert abs(t.layer_seconds("compositor", w) - 10e-6) < 1e-12
    assert abs(t.layer_seconds("sort", w) - 20e-6) < 1e-12
    b = t.breakdown(w)
    assert b["device_ops"][0][0].startswith("void at_cuda_detail")
    gaps = dict(b["idle_gaps"])
    assert abs(gaps["aten::mul"] - 25e-6) < 1e-12  # [15, 40]
    assert abs(gaps["bench.block"] - 35e-6) < 1e-12  # [60, 90], [95, 100]
    merged = tr.merged_breakdown([b, b])
    assert dict(merged["idle_gaps"])["aten::mul"] == 2 * gaps["aten::mul"]
