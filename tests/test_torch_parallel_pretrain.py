"""The port's data-parallel, fully sharded and tensor-parallel MASt3R
against the JAX package's, on the CPU: one gloo group of 2 ranks
(tests/torch_parallel_worker.py's "models2") and a two-rank
`cli.pretrain --fsdp` launch beside a one-process run, started together
by the module fixture.

- DDP and FSDP: two steps of tests/test_parallel.py's FSDP case (batch 4
  at 16x16, warmup 1) against JAX's make_dp_train_step on a 2-device mesh:
  losses within 1e-5 relative, parameters and the first moments within
  1e-5 relative L2 per leaf, the second moments (squared gradients, so
  twice the gradients' relative error) within 2e-5; the images are 32x32,
  four patches: at test_parallel.py's 16x16 every image is one token, the
  attention's q and k get gradients that are zero up to rounding, and
  Adam turns that rounding into whole steps that differ between the
  packages (ROADMAP.md §3, "Adam amplifies rounding"); an accumulating
  FSDP step
  against the one-device step; the FSDP checkpoint read by JAX's
  load_pretrain_checkpoint; an FSDP train_loop resumed from its step-1
  checkpoint continues JAX's two-step trajectory;
- tensor parallelism: cli.pretrain's TINY forward with shard_params_tp
  over 2 ranks against the one-device forward at JAX's tolerance (2e-5 of
  each output's scale);
- pair parallelism: infer_pairs(mesh=) against the same call without a
  mesh at 1e-5;
- cli.pretrain under a two-rank launch with --fsdp: one checkpoint, from
  rank 0, that JAX reads and that holds the one-process run's numbers.
"""

import functools
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from instantsplat_tpu.models import mast3r as jm
from instantsplat_tpu.parallel import make_mesh as jmake_mesh
from instantsplat_tpu.train_dust3r import trainer as jt
from instantsplat_tpu_torch import convert
from instantsplat_tpu_torch.parallel import launch
from instantsplat_tpu_torch.train_dust3r import datasets as td

torch.set_num_threads(2)

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
TIME_LIMIT = 300  # s
JCFG = jm.MASt3RConfig(
    enc_embed_dim=32, enc_depth=1, enc_num_heads=2, dec_embed_dim=32,
    dec_depth=1, dec_num_heads=2, dpt_layer_dims=(8, 8, 8, 8),
    dpt_feature_dim=8, dpt_last_dim=4, patch_size=16)
FAST_COMPILE = {"xla_backend_optimization_level": 0}
TOL = {"params": 1e-5, "m": 1e-5, "v": 2e-5}  # relative L2 per leaf


def _env():
    """Ranks import the port from here and use one thread each."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(TESTS), env.get("PYTHONPATH", "")])
    return env


def _pretrain_argv(root, out):
    return ["-m", "instantsplat_tpu_torch.cli.pretrain", "--tiny",
            "--device", "cpu", "--train_dataset",
            f"PosedMultiViewDataset('{root / 'data'}', resolution=(48, 32), "
            "n_corres=16)", "--criterion", "mast3r_finetune", "--steps",
            "2", "--batch_size", "2", "--num_workers", "0",
            "--warmup_steps", "1", "--lr", "1e-3", "--output_dir", str(out)]


class _Ranks:
    def __init__(self, root):
        self.root, self._out, self._errors = root, None, []
        argv = _pretrain_argv(root, root / "ckpt2")
        self._jobs = [
            threading.Thread(target=self._run, args=(
                launch.spawn, "torch_parallel_worker", [str(root),
                                                        "models2"], 2),
                kwargs=dict(timeout=TIME_LIMIT, env=_env(), cwd=str(TESTS))),
            threading.Thread(target=self._run, args=(
                launch.spawn, argv[1], argv[2:] + ["--fsdp"], 2),
                kwargs=dict(timeout=TIME_LIMIT, env=_env(), cwd=str(root))),
            threading.Thread(target=self._run, args=(
                subprocess.run, [sys.executable]
                + _pretrain_argv(root, root / "ckpt1")),
                kwargs=dict(env=_env(), cwd=str(root), check=True,
                            timeout=TIME_LIMIT, capture_output=True))]
        for j in self._jobs:
            j.start()

    def _run(self, fn, *args, **kw):
        try:
            fn(*args, **kw)
        except Exception as e:  # noqa: BLE001 - re-raised in `out`
            self._errors.append(e)

    @property
    def out(self):
        if self._out is None:
            for j in self._jobs:
                j.join()
            if self._errors:
                raise self._errors[0]
            self._out = dict(np.load(self.root / "models2.npz"))
        return self._out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_models")
    rng = np.random.default_rng(0)
    np.savez(root / "inputs.npz", **{
        "infer/images": rng.random((3, 32, 48, 3)).astype(np.float32),
        "tp/img1": rng.random((2, 32, 48, 3)).astype(np.float32),
        "tp/img2": rng.random((2, 32, 48, 3)).astype(np.float32)})
    td.write_synthetic_scene(root / "data", n_views=4, h=32, w=48)
    return _Ranks(root)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@functools.lru_cache(maxsize=None)
def _jax_state(fsdp):
    """JAX's state and losses after two steps of the FSDP case."""
    from instantsplat_tpu.train_dust3r.trainer import synthetic_batch

    mesh = jmake_mesh(2)
    init, step, shard = jt.make_dp_train_step(
        JCFG, mesh=mesh, fsdp=fsdp, warmup_steps=1, total_steps=4)
    state = init(jm.init_params(JCFG, seed=0))
    batch = shard(synthetic_batch(JCFG, batch=4, h=32, w=32, seed=1))
    step_c = step.lower(state, batch).compile(compiler_options=FAST_COMPILE)
    losses = []
    for _ in range(2):
        state, metrics = step_c(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses


def _named(tree):
    """JAX parameter tree -> the port's {name: array}."""
    return {k: v.numpy() for k, v in convert.mast3r_from_numpy(
        jax.tree.map(np.asarray, tree)).items()}


@pytest.mark.parametrize("tag", ["ddp", "fsdp"])
def test_dp_steps_match_jax(ranks, tag):
    state, losses = _jax_state(tag == "fsdp")
    out = ranks.out
    np.testing.assert_allclose(out[f"dp/{tag}/loss"], losses, rtol=1e-5)
    bad = {}
    for group, tol in TOL.items():
        for name, want in _named(state[group]).items():
            err = _rel_l2(out[f"dp/{tag}/{group}/{name}"], want)
            if err > tol:
                bad[(group, name)] = err
    assert not bad, bad
    if tag == "fsdp":  # the checkpoint: full tensors JAX reads
        loaded = jt.load_pretrain_checkpoint(ranks.root / "fsdp.npz", state)
        assert int(loaded["step"]) == 2
        for group in TOL:
            got = _named(loaded[group])
            for name, want in got.items():
                np.testing.assert_array_equal(
                    want, out[f"dp/fsdp/{group}/{name}"])


def test_fsdp_resume_continues_jax_trajectory(ranks):
    """train_loop with fsdp=True stopped after step 1 and resumed from its
    checkpoint-last.npz by a new model and step function: step 2's loss,
    and the parameters and moments it saves, are JAX's uninterrupted
    second step's."""
    state, losses = _jax_state(True)
    out = ranks.out
    assert out["resume/steps"].tolist() == [2]
    np.testing.assert_allclose(out["resume/loss"], losses[1:], rtol=1e-5)
    saved = jt.load_pretrain_checkpoint(
        ranks.root / "resume" / "checkpoint-last.npz", state)
    assert int(saved["step"]) == 2
    bad = {}
    for group, tol in TOL.items():
        got = _named(saved[group])
        for name, want in _named(state[group]).items():
            err = _rel_l2(got[name], want)
            if err > tol:
                bad[(group, name)] = err
    assert not bad, bad


def test_fsdp_accumulation_matches_one_device(ranks):
    out = ranks.out
    np.testing.assert_allclose(out["dp/accum/loss"], out["dp/accum_one/loss"],
                               rtol=1e-5)
    names = [k[len("dp/accum_one/params/"):] for k in out
             if k.startswith("dp/accum_one/params/")]
    assert names
    for name in names:
        assert _rel_l2(out[f"dp/accum/params/{name}"],
                       out[f"dp/accum_one/params/{name}"]) <= 1e-5, name


def test_tensor_parallel_mast3r_matches_one_device(ranks):
    out = ranks.out
    for side in ("1", "2"):
        for k in ("pts3d", "conf", "desc"):
            want = out[f"tp/one/{side}/{k}"]
            tol = 2e-5 * max(np.abs(want).max(), 1.0)
            np.testing.assert_allclose(out[f"tp/tp/{side}/{k}"], want,
                                       atol=tol, err_msg=f"{side}/{k}")


def test_infer_pairs_pair_parallel_matches_one_device(ranks):
    out = ranks.out
    for k in ("pred_i", "pred_j", "conf_i", "conf_j", "desc_i", "desc_j"):
        assert out[f"infer/mesh/{k}"].shape[0] == 6
        np.testing.assert_allclose(out[f"infer/mesh/{k}"],
                                   out[f"infer/one/{k}"], atol=1e-5,
                                   err_msg=k)


def test_pretrain_cli_two_ranks_fsdp(ranks):
    """cli.pretrain --fsdp launched as two ranks: one checkpoint, the
    global batch's numbers (the one-process run's), read by JAX."""
    ranks.out  # noqa: B018 - waits for the runs
    two = ranks.root / "ckpt2" / "checkpoint-last.npz"
    one = ranks.root / "ckpt1" / "checkpoint-last.npz"
    assert sorted(p.name for p in two.parent.iterdir()) == [
        "checkpoint-last.npz"]
    with np.load(two) as a, np.load(one) as b:
        assert int(a["['step']"]) == 2
        for k in b.files:
            assert _rel_l2(a[k], b[k]) <= 1e-5, k
    from instantsplat_tpu_torch.cli.pretrain import TINY

    cfg = jm.MASt3RConfig(**TINY)
    template = dict(params=jm.init_params(cfg, seed=1))
    got = jt.load_pretrain_checkpoint(two, template)["params"]
    with np.load(two) as a:
        qkv = a["['params']['enc_blocks'][0]['attn']['qkv']['w']"]
    np.testing.assert_array_equal(
        np.asarray(got["enc_blocks"][0]["attn"]["qkv"]["w"]), qkv)
