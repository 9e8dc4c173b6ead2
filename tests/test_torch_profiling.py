"""The port's torch.profiler traces (utils/profiling.py) and
TrainerConfig.profile_dir, on the CPU, as tests/test_components.py holds
the JAX package's: a traced region leaves a trace file with its
`annotate` spans in it, a disabled trace does nothing, and train_joint
traces its second block. Unlike JAX's, nothing degrades to a no-op: a
trace that cannot be written raises.

The program's own table (utils/profiling.py): spans with their parent
and self time on a fake clock, counters, snapshot() and reset(), the
phase table from a block's marks, a make_train_scan block that with
tracing off launches no mark and registers no hook, and train_joint with
tracing on (dense and auto with a re-probe): the iterations counted by
family, the re-probes, and the marks' phases, which on the CPU take the
host clock and cover each block's loop. The card's twin is
tests/test_torch_gpu.py::test_trace_marks_are_the_only_difference."""

import json
import threading

import numpy as np
import pytest
import torch

from instantsplat_tpu_torch.data.scene import read_scene
from instantsplat_tpu_torch.models.camera import stack_cameras
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.ops import trace_mark
from instantsplat_tpu_torch.opt.gaussian_opt import (GaussianOptimizer,
                                                     OptimizationConfig)
from instantsplat_tpu_torch.pipelines import trainer as tr
from instantsplat_tpu_torch.pipelines.trainer import TrainerConfig, train_joint
from instantsplat_tpu_torch.utils import profiling
from instantsplat_tpu_torch.utils.profiling import annotate, profile_trace
from torch_scenes import write_tiny_scene

torch.set_num_threads(2)


def _spans(logdir):
    """{trace file name: the names of its events}."""
    out = {}
    for path in logdir.glob("*.pt.trace.json"):
        events = json.loads(path.read_text())["traceEvents"]
        out[path.name] = {e.get("name") for e in events}
    return out


def test_profile_trace_writes_annotated_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profile_trace(logdir):
        with annotate("golden-matmul"):
            a = torch.ones(64, 64)
            (a @ a).sum()
    (names,) = _spans(logdir).values()
    assert "golden-matmul" in names
    assert any(str(n).startswith("aten::mm") for n in names)

    with profile_trace(None):  # disabled: a clean no-op
        pass
    with profile_trace(tmp_path / "off", enabled=False):
        pass
    assert not (tmp_path / "off").exists()


def test_profile_trace_that_cannot_be_written_raises(tmp_path):
    taken = tmp_path / "a_file"
    taken.write_text("")
    with pytest.raises(OSError):
        with profile_trace(taken):
            pass


def test_train_joint_profile_dir_traces_block_one(tmp_path):
    """Blocks of log_every = 2: block 0 holds iterations 1-2 (on a card
    the warm-up), block 1 iterations 3-4, which alone are traced."""
    root = tmp_path / "scene"
    write_tiny_scene(root)
    info = read_scene(root, 3, device="cpu")
    g = GaussianModel.create_from_pcd(
        info.points, info.colors, max_sh_degree=0, device="cpu",
        cam_poses=GaussianModel.init_cam_poses_from_w2c(info.poses_w2c))
    logdir = tmp_path / "prof"
    _, _, hist = train_joint(
        g, info.cameras, OptimizationConfig(optim_pose=False),
        TrainerConfig(iterations=6, log_every=2, backend="pallas",
                      profile_dir=str(logdir)),
        spatial_lr_scale=info.nerf_radius)
    assert [it for it, _ in hist] == [2, 4, 6]
    assert np.isfinite(hist[-1][1]["loss"])
    (path,) = logdir.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    blocks = [e for e in events if e.get("name") == "train.block"]
    # the span's name is a constant: one `train.block` in the trace is
    # block 1 alone, blocks 0 and 2 are not in it
    assert len(blocks) == 1
    assert not any("train_joint block" in str(e.get("name"))
                   for e in events)


@pytest.fixture
def table(monkeypatch):
    """An empty table on a fake host clock (ns), tracing off at the end."""
    now = [0]
    monkeypatch.setattr(profiling, "_clock", lambda: now[0])
    profiling.reset()
    yield now
    profiling.enable(False)
    profiling.reset()


def test_spans_nest_with_parent_and_self_time(table):
    now = table
    with annotate("a"):
        now[0] = 10
        with annotate("b"):
            now[0] = 30
        now[0] = 35
        with annotate("b"):
            now[0] = 40
            thread = threading.Thread(target=lambda: annotate(
                "c").__enter__().__exit__(None, None, None))
            thread.start()
            thread.join(timeout=10)
            assert not thread.is_alive()
        now[0] = 100
    snap = profiling.snapshot()
    assert snap["spans"]["a"] == dict(count=1, host_s=pytest.approx(100e-9),
                                      self_s=pytest.approx(75e-9),
                                      device_s=None)
    assert snap["spans"]["b"] == dict(count=2, host_s=pytest.approx(25e-9),
                                      self_s=pytest.approx(25e-9),
                                      device_s=None)
    # another thread's span has no parent: the stack is context-local
    assert [e[:2] + e[4:] for e in snap["log"]] == [
        ["b", "a", None], ["c", None, None], ["b", "a", None],
        ["a", None, None]]
    assert [e[2:4] for e in snap["log"]] == [
        pytest.approx([10e-9, 30e-9]), pytest.approx([40e-9, 40e-9]),
        pytest.approx([35e-9, 40e-9]), pytest.approx([0.0, 100e-9])]
    json.dumps(snap)  # plain data


def test_threads_lose_no_update(table):
    """Spans and counters from more threads than cores, switching often:
    every update lands."""
    import os
    import sys

    n_threads, n = 2 * (os.cpu_count() or 4), 500

    def work():
        for _ in range(n):
            profiling.count("x")
            with annotate("s"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = profiling.snapshot()
    assert snap["counters"]["x"] == n_threads * n
    assert snap["spans"]["s"]["count"] == n_threads * n


def test_counters_snapshot_and_reset(table):
    from instantsplat_tpu_torch.ops.rasterize_pallas import K1
    from instantsplat_tpu_torch.utils.cuda_graphs import StepLoop

    profiling.count("x")
    profiling.count("x", 4)
    with annotate("s"):
        pass
    snap = profiling.snapshot()
    assert snap["counters"]["x"] == 5 and not snap["enabled"]
    # the launch counts kept elsewhere are read, not copied
    assert snap["counters"]["steploop.replays"] == StepLoop.replays
    assert snap["counters"]["kernel.k1_forward.launches"] == K1.launches
    profiling.reset()
    snap = profiling.snapshot()
    assert "x" not in snap["counters"] and not snap["spans"]
    assert not snap["log"] and not snap["phases"]


def test_step_marks_make_phases(table):
    names = ("start", "mid", "end")
    phases = {"one": (("start", "mid"),), "two": (("mid", "end"),)}
    # step 1 lacks "mid": its interval joins the next one's
    rows = np.array([[100, 130, 160], [200, 0, 260], [300, 310, 390]])
    got = profiling.add_step_marks("loop", "fam", rows, names, phases)
    assert got == pytest.approx(dict(one=(30 + 60 + 10) * 1e-9,
                                     two=(30 + 0 + 80) * 1e-9,
                                     replay_gap=(40 + 40) * 1e-9))
    profiling.add_step_marks("loop", "fam", rows[:1], names, phases)
    ph = profiling.snapshot()["phases"]["loop"]["fam"]
    assert ph["one"] == pytest.approx(dict(seconds=130e-9, steps=4))
    assert ph["replay_gap"]["steps"] == 4
    # a block's own start mark (row 0 only) opens its first gap
    names = ("block", "start", "end")
    rows = np.array([[90, 100, 160], [0, 200, 260]])
    got = profiling.add_step_marks("loop", "b", rows, names, {
        "work": (("start", "end"),), "replay_gap": (("block", "start"),)})
    assert got == pytest.approx(dict(work=120e-9, replay_gap=(10 + 40) * 1e-9))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("profiling") / "scene"
    write_tiny_scene(root)
    info = read_scene(root, 3, device="cpu")
    g = GaussianModel.create_from_pcd(
        info.points, info.colors, max_sh_degree=1, device="cpu",
        cam_poses=GaussianModel.init_cam_poses_from_w2c(info.poses_w2c))
    return info, g


def _fresh(g0):
    return g0.replace(**{f: getattr(g0, f).clone() for f in PARAM_FIELDS})


def test_untraced_block_launches_no_mark_and_hooks_nothing(tiny, table,
                                                           monkeypatch):
    info, g0 = tiny
    g = _fresh(g0)
    opt = GaussianOptimizer(OptimizationConfig(optim_pose=True),
                            total_iterations=10)
    state = opt.init(g)

    def refused(*a, **k):
        raise AssertionError("traced while tracing is off")

    monkeypatch.setattr(trace_mark, "mark", refused)
    monkeypatch.setattr(torch.Tensor, "register_hook", refused)
    block = tr.make_train_scan(opt, stack_cameras(info.cameras),
                               torch.zeros(3), 0.2, "pallas", 256)
    _, _, metrics = block(g, state, [0, 1, 2], [1, 2, 3], 0)
    assert np.isfinite(float(metrics["loss"]))
    assert not profiling.snapshot()["phases"]
    profiling.enable(True)  # the same block traced does mark
    with pytest.raises(AssertionError, match="tracing is off"):
        block(g, state, [0], [4], 0)


@pytest.mark.parametrize("backend", ["pallas", "auto"])
def test_traced_train_joint_counts_and_marks(tiny, table, monkeypatch,
                                             backend):
    """Blocks of 2; auto probes in blocks 0-3 (iterations 1-8) and
    re-probes at iteration 9 (two timed blocks)."""
    info, g0 = tiny
    monkeypatch.setattr(profiling, "_clock", __import__("time")
                        .perf_counter_ns)
    monkeypatch.setattr(tr, "_REPROBE_EVERY", 4)
    profiling.enable(True)
    iters = 12 if backend == "auto" else 6
    train_joint(_fresh(g0), info.cameras,
                OptimizationConfig(pp_optimizer=True, optim_pose=True),
                TrainerConfig(iterations=iters, log_every=2,
                              backend=backend),
                spatial_lr_scale=info.nerf_radius)
    snap = profiling.snapshot()
    c, spans = snap["counters"], snap["spans"]
    by_family = {k.split(".")[-1]: v for k, v in c.items()
                 if k.startswith("train.iterations.")}
    assert sum(by_family.values()) == iters
    assert spans["train.block"]["count"] == spans["steploop.loop"]["count"]
    assert spans["train.log"]["count"] == iters // 2
    # no capture on the CPU: the card's twin counts them
    assert c.get("steploop.captures", 0) == 0
    if backend == "auto":
        assert set(by_family) == {"pallas", "pallas-tiled"}
        assert c["train.reprobes"] >= 1
        assert spans["train.size_caps"]["count"] >= 1 + c["train.reprobes"]
        assert spans["train.probe"]["count"] >= 5  # sizing + 4 blocks
    else:
        assert by_family == {"pallas": iters}
        assert "train.probe" not in spans and "train.reprobes" not in c
    phases = snap["phases"]["make_train_scan"]
    total = 0.0
    for fam, ph in phases.items():
        assert set(ph) == {"frontend", "raster", "loss", "adam",
                           "replay_gap"}
        assert ph["adam"]["steps"] == by_family[fam]
        assert all(p["seconds"] >= 0 for p in ph.values()), ph
        total += sum(p["seconds"] for p in ph.values())
    # on the CPU the marks take the host clock: every block's phases and
    # gaps cover its loop
    loop_s = spans["steploop.loop"]["host_s"]
    assert total == pytest.approx(loop_s, rel=0.05)


def test_cli_train_trace_writes_the_table(tmp_path):
    """cli.train --trace: tracing on, the table in <model>/trace.json."""
    from instantsplat_tpu_torch.cli import train as cli_train

    root, out = tmp_path / "scene", tmp_path / "out"
    write_tiny_scene(root)
    try:
        cli_train.main(["-s", str(root), "-m", str(out), "--n_views", "3",
                        "--iterations", "4", "--log_every", "2",
                        "--sh_degree", "0", "--backend", "pallas",
                        "--device", "cpu", "--quiet", "--trace"])
    finally:
        profiling.enable(False)
        profiling.reset()
    snap = json.loads((out / "trace.json").read_text())
    assert snap["enabled"]
    assert snap["counters"]["train.iterations.pallas"] == 4
    assert {"train.run", "train.read", "train.init", "train.knn",
            "train.joint", "train.block", "train.write"} <= set(
        snap["spans"])
    assert snap["spans"]["train.run"]["count"] == 1
    adam = snap["phases"]["make_train_scan"]["pallas"]["adam"]
    assert adam["steps"] == 4 and adam["seconds"] > 0
