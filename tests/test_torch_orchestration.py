"""The port's orchestration (cli/run_eval.py, cli/run_infer.py) against
the JAX package's scripts/run_eval.py and scripts/run_infer.py:

- the scheduler cases of tests/test_run_eval_sched.py, on the port's
  module (whose slot pool is CUDA_VISIBLE_DEVICES alone);
- the stage commands equal JAX's (captured through each module's
  run_stage), with the module prefix swapped and `--device` added, and
  each is accepted by the port CLI's parser; `--n_devices` raises;
- `run_eval --skip_init --device cpu` on the tiny scene runs stages 2-5
  as subprocesses: four logs, and results.json within 1e-5 of the same
  stages run in this process; without `--device cpu` and without a card
  the first stage fails and run_eval exits 1, nothing falls back.
"""

import importlib
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from instantsplat_tpu_torch.cli import run_eval, run_infer
from torch_scenes import write_eval_scene

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

ITERS = 3
# the test stage's FPS benchmark renders 1000 times: a small scene
N_PTS, HW = 40, (12, 16)


# --------------------------------------------------------------------------
# the scheduler (tests/test_run_eval_sched.py's cases)
# --------------------------------------------------------------------------


def test_scenes_overlap_and_slots_are_exclusive():
    lock = threading.Lock()
    active = 0
    max_active = 0
    slots_in_use = set()
    seen_slots = []

    def scene(slot):
        nonlocal active, max_active
        with lock:
            assert slot not in slots_in_use  # a slot never runs 2 scenes
            slots_in_use.add(slot)
            active += 1
            max_active = max(max_active, active)
            seen_slots.append(slot)
        time.sleep(0.15)
        with lock:
            active -= 1
            slots_in_use.discard(slot)
        return True

    results = run_eval.schedule_scenes([scene] * 5, n_jobs=2)
    assert results == [True] * 5
    assert max_active == 2          # scenes actually overlapped
    assert set(seen_slots) <= {0, 1}


def test_sequential_default_and_result_order():
    order = []

    def mk(i):
        def f(slot):
            order.append(i)
            return i != 1  # scene 1 "fails"
        return f

    results = run_eval.schedule_scenes([mk(i) for i in range(3)], n_jobs=1)
    assert order == [0, 1, 2]
    assert results == [True, False, True]


def test_slot_environment_pins_devices(monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    env1 = run_eval.slot_environment(0, n_jobs=1)
    assert "CUDA_VISIBLE_DEVICES" not in env1  # single job: untouched env
    assert run_eval.slot_environment(3, n_jobs=4)[
        "CUDA_VISIBLE_DEVICES"] == "3"
    # a parent-set list is a pool to index into
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4, 6")
    assert run_eval.slot_environment(3, n_jobs=4)[
        "CUDA_VISIBLE_DEVICES"] == "6"
    # an operator-set binding of one card wins
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "7")
    assert run_eval.slot_environment(2, n_jobs=4)[
        "CUDA_VISIBLE_DEVICES"] == "7"


# --------------------------------------------------------------------------
# the stage commands against JAX's
# --------------------------------------------------------------------------


def _capture(monkeypatch, module, main, argv):
    """The stage commands `main` runs, each stage reported a success."""
    cmds = []

    def fake_run_stage(cmd, log_path, **kw):
        cmds.append((list(cmd), Path(log_path).name))
        return True

    monkeypatch.setattr(module, "run_stage", fake_run_stage)
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    try:
        main(argv)
    except SystemExit as e:  # scripts/run_infer.py returns instead
        assert e.code in (0, None)
    return cmds


def _swapped(jax_cmds, device):
    return [([c.replace("instantsplat_tpu.cli.", "instantsplat_tpu_torch.cli.")
              for c in cmd] + ["--device", device], log)
            for cmd, log in jax_cmds]


@pytest.mark.parametrize("tool,argv", [
    ("run_eval", ["--data", "d", "--out", "o", "--dataset", "Tanks",
                  "--scenes", "Barn", "Family", "--ckpt_path", "m.pth"]),
    ("run_eval", ["--data", "d", "--out", "o", "--scenes", "s", "--n_views",
                  "6", "--iterations", "200", "--max_pts", "1000",
                  "--optim_test_pose_iter", "50", "--stage_timeout", "60"]),
    ("run_eval", ["--data", "d", "--out", "o", "--scenes", "s",
                  "--skip_init", "--device", "cpu"]),
    ("run_infer", ["--data", "d", "--out", "o", "--scenes", "a", "b",
                   "--n_views", "12", "--iterations", "300", "--ckpt_path",
                   "random:0"]),
    ("run_infer", ["--data", "d", "--out", "o", "--scenes", "a",
                   "--device", "cpu"]),
], ids=["eval", "eval-flags", "eval-skip-init-cpu", "infer", "infer-cpu"])
def test_stage_commands_are_jax_with_the_port_prefix(monkeypatch, tool, argv):
    jmod = importlib.import_module(f"scripts.{tool}")
    port = run_eval if tool == "run_eval" else run_infer
    device = "cpu" if "--device" in argv else "cuda"
    jargv = [a for a in argv if a not in ("--device", "cpu")]
    jax_cmds = _capture(monkeypatch, jmod, lambda _: jmod.main(), jargv)
    ours = _capture(monkeypatch, port, port.main, argv)
    assert ours == _swapped(jax_cmds, device)
    assert all(cmd[:2] == [sys.executable, "-m"] for cmd, _ in ours)
    for cmd, _ in ours:
        assert cmd[2].startswith("instantsplat_tpu_torch.cli.")
        cli = importlib.import_module(cmd[2])
        args = cli.build_parser().parse_args(cmd[3:])
        assert args.device == device


def test_n_devices_raises(monkeypatch):
    """--n_devices passes through to init_geo, train and the test render,
    as in scripts/run_eval.py; a stage asked for more cards than exist
    raises before any rank starts."""
    args = run_eval.parse_args(["--data", "d", "--out", "o", "--scenes",
                                "s", "--n_devices", "2"])
    stages = run_eval.scene_stages(args, "s")[1]
    sharded = [cmd[2].rsplit(".", 1)[1] for cmd, _ in stages
               if cmd[-4:-2] == ["--n_devices", "2"]]
    assert sharded == ["init_geo", "train", "render"]
    assert "--skip_train" in [c for c, _ in stages
                              if "--n_devices" in c][-1]
    from instantsplat_tpu_torch.cli import train as train_cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    train_argv = list(stages[1][0][3:])
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards; 1 visible"):
        train_cli.main(train_argv[:-2])  # its --device cuda default


# --------------------------------------------------------------------------
# stages 2-5 as subprocesses on the CPU
# --------------------------------------------------------------------------


def _stage_argv(out, src, skip_test_fps=False):
    stages = run_eval.scene_stages(
        run_eval.parse_args(["--data", str(src.parent), "--out", str(out),
                             "--scenes", src.name, "--iterations",
                             str(ITERS), "--optim_test_pose_iter", "3",
                             "--skip_init", "--device", "cpu"]),
        src.name)[1]
    argvs = [cmd[3:] for cmd, _ in stages]
    if skip_test_fps:
        argvs = [[a for a in v if a != "--test_fps"] for v in argvs]
    return argvs


def test_run_eval_runs_the_port_stages_on_the_cpu(tmp_path, monkeypatch,
                                                  capsys):
    src = tmp_path / "data" / "scene"
    write_eval_scene(src, n_pts=N_PTS, hw=HW)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    monkeypatch.chdir(REPO)
    with pytest.raises(SystemExit) as e:
        run_eval.main(["--data", str(src.parent), "--out",
                       str(tmp_path / "out"), "--scenes", "scene",
                       "--iterations", str(ITERS), "--optim_test_pose_iter",
                       "3", "--skip_init", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert e.value.code == 0, printed
    out = tmp_path / "out" / "scene" / "3_views"
    logs = sorted(p.name for p in (out / "logs").iterdir())
    assert logs == ["02_train.log", "03_render_train.log",
                    "04_render_test.log", "05_metrics.log"]
    assert (out / "total_fps.json").is_file()

    # the same stages in this process (the FPS benchmark left out: it
    # writes total_fps.json only)
    from instantsplat_tpu_torch.cli import metrics, render, train

    ref = tmp_path / "ref"
    argvs = _stage_argv(ref, src, skip_test_fps=True)
    for main, argv in zip((train.main, render.main, render.main,
                           metrics.main), argvs):
        main(argv)
    got = json.loads((out / "results.json").read_text())
    want = json.loads((ref / "scene" / "3_views" / "results.json")
                      .read_text())
    assert got.keys() == want.keys() == {f"ours_{ITERS}"}
    g, w = got[f"ours_{ITERS}"], want[f"ours_{ITERS}"]
    assert g.keys() == w.keys() and {"PSNR", "SSIM", "ATE"} <= set(g)
    for k in g:
        if w[k] is None:
            assert g[k] is None, k
        else:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    assert np.isfinite(g["PSNR"])


def test_run_eval_without_a_card_exits_1(tmp_path, monkeypatch, capsys):
    """No card is visible to the stages (an empty CUDA_VISIBLE_DEVICES
    hides any): the CUDA default raises in the first stage."""
    src = tmp_path / "data" / "scene"
    write_eval_scene(src, n_pts=N_PTS, hw=HW)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    monkeypatch.chdir(REPO)
    with pytest.raises(SystemExit) as e:
        run_eval.main(["--data", str(src.parent), "--out",
                       str(tmp_path / "out"), "--scenes", "scene",
                       "--iterations", "2", "--skip_init"])
    assert e.value.code == 1
    logs = tmp_path / "out" / "scene" / "3_views" / "logs"
    assert sorted(p.name for p in logs.iterdir()) == ["02_train.log"]
    assert "is_available" in (logs / "02_train.log").read_text()
    assert "FAILED" in capsys.readouterr().out
