"""Whole runs of the gs_sh3 entry on the CPU at a tiny size (the program's
plain path): a sound run comes out correct; the same run with the timed
path broken underneath, or the reference in the program's place computed
wrong (the controls), comes out not correct. And a run without a card
prints no result."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.core import manifest
from conftest import tiny_cell

CELL = "gs_sh3.train_3v"


def _run(cell):
    torch.set_num_threads(4)
    return cell.entry().run(cell, 2**31 + 99, 0.5, False, time.perf_counter(),
                            device="cpu")


def test_sound_run_is_correct():
    out = _run(tiny_cell(CELL))
    assert out.correct, out.checks
    assert out.attempted == 1 and out.failed == 0
    assert out.end_to_end["train_ms_per_iter"] > 0


def test_state_left_unchanged_is_not_correct(monkeypatch):
    from instantsplat_tpu_torch.opt.gaussian_opt import GaussianOptimizer

    monkeypatch.setattr(GaussianOptimizer, "apply_step",
                        lambda self, params, grads, state, scalars: None)
    out = _run(tiny_cell(CELL))
    assert not out.correct
    assert dict((n, v) for n, v, _ in out.checks)["change_gap"] == 1.0


def test_half_of_the_batch_left_out_is_not_correct(monkeypatch):
    from instantsplat_tpu_torch.pipelines import trainer

    full = trainer.photometric_loss

    def half(pred, gt, lambda_dssim=0.2):
        rows = pred.shape[0] // 2
        return full(pred[:rows], gt[:rows], lambda_dssim)

    monkeypatch.setattr(trainer, "photometric_loss", half)
    out = _run(tiny_cell(CELL))
    assert not out.correct


def test_list_kernels_altered_is_not_correct(monkeypatch):
    # the capacity backend's compositor (K3-K6 on the card) alone made
    # wrong: only its split block (the auto probe's, iteration 21) shows it
    from instantsplat_tpu_torch.render import driver

    lists = driver.composite_lists

    def altered(*a, **kw):
        acc, tfin = lists(*a, **kw)
        return acc * 1.05, tfin

    monkeypatch.setattr(driver, "composite_lists", altered)
    out = _run(tiny_cell(CELL))
    assert not out.correct, out.checks


@pytest.mark.parametrize("variant", ["bf16", "half"])
def test_controls_fail_the_limits(variant, tmp_path):
    from benchmark import control

    cell = tiny_cell(CELL)
    entry = cell.entry()
    for seed in (11, 12, 13):
        scene = entry.make_scenes(tmp_path / str(seed), seed, dict(
            cell.traffic, scene_folders=1), cell.config)[0]
        rec = control.variant_record(
            entry, scene, cell.config, "cpu",
            torch.bfloat16 if variant == "bf16" else torch.float32,
            cell.config["height"] // 2 if variant == "half" else None)
        r = entry.readings(rec, cell.config, "cpu")
        assert any(r[k] > lim for k, lim in cell.limits.items()), r


def _no_result(proc):
    return proc.returncode != 0 and not any(
        line.startswith("{") for line in proc.stdout.splitlines())


def test_without_a_card_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "3000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=manifest.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert _no_result(proc), proc.stdout
    assert "no CUDA card" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert _no_result(proc), proc.stdout


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct(cuda):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL, "--seed",
         "3000000001", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=manifest.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
