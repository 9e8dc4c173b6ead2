"""The port's multi-device layer (instantsplat_tpu_torch/parallel/ and its
callers) against the JAX package's, on the CPU.

The port runs one process per device: the module fixture starts one gloo
group of 2 ranks and one of 4 (tests/torch_parallel_worker.py, each rank
with one thread), and a `cli.train --n_devices 2 --device cpu` run, all
at once and under one time limit. The inputs are tests/test_parallel.py's
scenes and sizes, drawn by JAX here and handed over in an npz; JAX
computes its counterparts here, on tests/conftest.py's 8-device CPU mesh
at the same mesh sizes (a 2-device mesh, a 2x2 mesh, a 4-device mesh for
the aligner's area sharding).

Tolerances: the sharded renders and their gradients within 1e-5 of JAX's
sharded result and of the port's one-device result (the depth-sliced
renders against one device at JAX's own 3e-4 / 3e-3, 5e-3 when opaque,
gradients 2e-4); loss curves rtol 1e-4; the refiner 1e-5; the aligner at
test_parallel.py's 1e-5 (loss) / 1e-4 (poses), on the golden aligner
case's noisy pointmaps (exact ones start at the loss's rounding floor,
where two implementations part ways). Every rank must end a sharded run
with identical parameters.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.init import aligner as jal
from instantsplat_tpu.opt import OptimizationConfig as JOptConfig
from instantsplat_tpu.ops.losses import photometric_loss as jloss
from instantsplat_tpu.parallel import make_mesh as jmake_mesh
from instantsplat_tpu.parallel import make_mesh_nd as jmake_mesh_nd
from instantsplat_tpu.parallel import sharding as jsh
from instantsplat_tpu.pipelines import train_pipeline as jpipe
from instantsplat_tpu.pipelines.render_pipeline import (
    refine_poses_sharded as jrefine,
)
from instantsplat_tpu.pipelines.trainer import TrainerConfig as JTrainerCfg
from instantsplat_tpu.pipelines.trainer import train_joint as jtrain_joint
from instantsplat_tpu.render import render as jrender
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS
from instantsplat_tpu_torch.parallel import (
    initialize_runtime,
    launch,
    make_mesh_nd,
)
from test_parallel import make_scene
from torch_init_cases import aligner_case
from torch_scenes import write_tiny_scene

torch.set_num_threads(2)

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
TRAIN_ITERS = 5
REFINE_ITERS = 20
ALIGN_ITERS = 40
TIME_LIMIT = 300  # s, for every spawned group together


def _child_env():
    """Ranks import the port from here and use one thread each."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(TESTS), env.get("PYTHONPATH", "")])
    return env


def _put_scene(inp, key, g, cams, target=None, images=None):
    for f in PARAM_FIELDS:
        inp[f"{key}/{f}"] = np.asarray(getattr(g, f))
    inp[f"{key}/size"] = cams[0].height
    inp[f"{key}/fx"] = float(cams[0].fx)
    inp[f"{key}/views"] = len(cams)
    if target is not None:
        inp[f"{key}/target"] = np.asarray(target)
    if images is not None:
        inp[f"{key}/images"] = np.asarray(images)


def _opaque(g):
    return g.replace(opacity=jnp.full_like(g.opacity, 4.0))


def _jax_inputs():
    """JAX's scenes (tests/test_parallel.py's) and what each case needs,
    -> (npz dict, the JAX objects by key)."""
    inp, objs = {}, {}

    def add(key, g, cams, size, **kw):
        target = jax.random.uniform(jax.random.PRNGKey(5), (size, size, 3))
        _put_scene(inp, key, g, cams, target=target, **kw)
        objs[key] = (g, cams, target)

    add("s40", *make_scene(seed=3), 40)
    add("s42", *make_scene(size=42), 42)
    add("g7", *make_scene(n=100, seed=7), 40)
    g, cams = make_scene(n=120, seed=11)
    add("g11", _opaque(g), cams, 40)
    add("g13", *make_scene(n=100, seed=13), 40)
    add("h19", *make_scene(n=100, seed=19), 40)
    g, cams = make_scene(n=100, seed=19)
    add("h19o", _opaque(g), cams, 40)
    add("h23", *make_scene(n=80, seed=23), 40)

    def renderer(g, cam):
        return jax.jit(lambda pose: jrender(g, cam, pose=pose, chunk=64,
                                            backend="pallas").render)

    # train_joint: test_train_joint_sharded_matches_single's scene
    g, cams = make_scene(n=200, size=32, views=2, seed=11)
    draw = renderer(g, cams[0])
    cams = [c.replace(image=draw(c.pose)) for c in cams]
    init = g.replace(features_dc=g.features_dc + 0.25 * jax.random.normal(
        jax.random.PRNGKey(4), g.features_dc.shape))
    _put_scene(inp, "t11", init, cams, images=[c.image for c in cams])
    objs["t11"] = (init, cams, None)
    # the same, non-degenerate (anisotropic scales, random rotations and
    # opacities), for a comparison of parameters (ROADMAP.md section 3)
    rng = np.random.default_rng(11)
    n = init.xyz.shape[0]
    start = init.replace(
        scaling=init.scaling + jnp.asarray(rng.normal(size=(n, 3)) * 0.3,
                                           jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(n, 4)), jnp.float32),
        opacity=jnp.asarray(rng.normal(size=(n, 1)), jnp.float32))
    _put_scene(inp, "t11s", start, cams, images=[c.image for c in cams])
    objs["t11s"] = (start, cams, None)
    inp["train_iters"] = TRAIN_ITERS

    # refine_poses_sharded: test_refine_poses_sharded_matches_sequential's
    g, cams = make_scene(n=150, size=32, views=1, seed=21)
    rng = np.random.RandomState(3)
    poses0, gts = [], []
    draw = renderer(g, cams[0])
    for _ in range(6):
        true_pose = jnp.asarray(np.array([1, 0, 0, 0, 0, 0, 0])
                                + 0.02 * rng.randn(7), jnp.float32)
        gts.append(draw(true_pose))
        poses0.append(true_pose + 0.01 * jnp.asarray(rng.randn(7),
                                                     jnp.float32))
    _put_scene(inp, "r21", g, cams)
    inp["refine/poses0"] = np.asarray(jnp.stack(poses0))
    inp["refine/gts"] = np.asarray(jnp.stack(gts))
    inp["refine/iters"] = REFINE_ITERS
    objs["r21"] = (g, cams, None)

    preds = aligner_case()
    inp["align/edges"] = np.asarray(preds.edges)
    for k in ("pred_i", "pred_j", "conf_i", "conf_j"):
        inp[f"align/{k}"] = getattr(preds, k)
    inp["align/iters"] = ALIGN_ITERS
    return inp, objs


def _train_cli(root: Path):
    """cli.train --n_devices 2 --device cpu on tests/torch_scenes.py's
    tiny scene; the CLI spawns its two ranks itself."""
    write_tiny_scene(root / "scene")
    subprocess.run(
        [sys.executable, "-m", "instantsplat_tpu_torch.cli.train", "-s",
         str(root / "scene"), "-m", str(root / "model"), "--n_views", "3",
         "--iterations", "3", "--log_every", "1", "--sh_degree", "2",
         "--pp_optimizer", "--optim_pose", "--n_devices", "2", "--device",
         "cpu", "--backend", "pallas"],
        env=_child_env(), cwd=str(root), check=True, timeout=TIME_LIMIT,
        capture_output=True)


class _Ranks:
    """The spawned groups, running in threads while the tests compute
    JAX's side; `out` waits for them and holds rank 0's results."""

    def __init__(self, root, objs):
        self.root, self.objs, self._out, self._errors = root, objs, None, []
        self._jobs = [threading.Thread(target=self._run, args=(
            launch.spawn, "torch_parallel_worker", [str(root), group], n),
            kwargs=dict(timeout=TIME_LIMIT, env=_child_env(),
                        cwd=str(TESTS)))
            for group, n in (("renders2", 2), ("renders4", 4))]
        self._jobs.append(threading.Thread(target=self._run,
                                           args=(_train_cli, root)))
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
            self._out = dict(np.load(self.root / "renders2.npz"))
            self._out.update(np.load(self.root / "renders4.npz"))
        return self._out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    inp, objs = _jax_inputs()
    np.savez(root / "inputs.npz", **inp)
    return _Ranks(root, objs)


def _jax_value_and_grads(fn, g, target, grads=True):
    """(rgb, alpha, depth, {field: grad}) of JAX's render fn(p, pose),
    jitted; the image alone when not `grads`."""
    if not grads:
        rgb, alpha, depth = jax.jit(lambda p: fn(p, p.get_pose(0)))(g)
        return dict(rgb=np.asarray(rgb), alpha=np.asarray(alpha),
                    depth=np.asarray(depth))

    def loss(p):
        rgb, alpha, depth = fn(p, p.get_pose(0))
        return jloss(rgb, target)[0], (rgb, alpha, depth)

    (_, (rgb, alpha, depth)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(g)
    out = dict(rgb=rgb, alpha=alpha, depth=depth)
    out.update({f"grad_{f}": getattr(grads, f) for f in PARAM_FIELDS})
    return {k: np.asarray(v) for k, v in out.items()}


def _close(got, want, prefix, atol, keys=None):
    for k in keys or want:
        np.testing.assert_allclose(got[f"{prefix}/{k}"], want[k], atol=atol,
                                   err_msg=f"{prefix}/{k}")


@pytest.mark.parametrize("axis", ["pixels", "gaussians"])
def test_train_joint_sharded_matches_jax(ranks, axis):
    """train_joint over two ranks on each shard axis: the loss curve
    within rtol 1e-4 of JAX's sharded train_joint; both ranks end with the
    same parameters, bit for bit."""
    init, cams, _ = ranks.objs["t11"]
    _, _, hist = jtrain_joint(
        init, cams, opt_cfg=JOptConfig(optim_pose=True),
        trainer_cfg=JTrainerCfg(iterations=TRAIN_ITERS, backend="pallas",
                                chunk=64, log_every=1, seed=5, n_devices=2,
                                shard_axis=axis))
    out = ranks.out
    np.testing.assert_allclose(out[f"train/{axis}/loss"],
                               [m["loss"] for _, m in hist], rtol=1e-4)
    assert out[f"train/{axis}/spread"] == 0.0


def test_train_joint_mesh_runs_blocks_and_matches_jax_scan(ranks):
    """train_joint over two ranks in one block of TRAIN_ITERS iterations
    takes make_train_scan's path (a StepLoop with the mesh's group, whose
    captured step holds its collectives; no line saying it steps
    eagerly) and
    ends where JAX's sharded make_train_scan block ends, from a
    non-degenerate start: the last loss within 1e-5 relative, every
    parameter at test_torch_scan's block tolerance (rtol 1e-3, atol 1e-5:
    Adam turns the packages' different summation orders into parts of a
    step, 7e-5 on 9 of 600 scales here); both ranks alike, bit for
    bit."""
    init, cams, _ = ranks.objs["t11s"]
    params, _, hist = jtrain_joint(
        init, cams, opt_cfg=JOptConfig(optim_pose=True),
        trainer_cfg=JTrainerCfg(iterations=TRAIN_ITERS, backend="pallas",
                                chunk=64, log_every=TRAIN_ITERS, seed=5,
                                n_devices=2))
    out = ranks.out
    assert "step eagerly" not in str(out["scan/said"])
    assert list(out["scan/loops"]) == ["make_train_scan:1"]
    np.testing.assert_allclose(out["scan/loss"], [hist[-1][1]["loss"]],
                               rtol=1e-5)
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(out[f"scan/{f}"],
                                   np.asarray(getattr(params, f)),
                                   rtol=1e-3, atol=1e-5, err_msg=f)
    assert out["scan/spread"] == 0.0


def test_train_joint_mesh_block_overflow_demotes(ranks):
    """An overflowing "pallas-binned:1:2" in train_joint's mesh blocks:
    the first block renders with the capacity kernels throughout, its end
    demotes the sharded signature once, with the sharding layer's
    warning, and the second block renders with the dense kernels."""
    out = ranks.out
    assert [s.startswith("('sharded',") for s in out["overflow/demoted"]] \
        == [True]
    warned = list(out["overflow/warned"])
    assert len(warned) == 1 and "row block's lists overflow" in warned[0]
    assert list(out["overflow/backends"]) == (["pallas-binned:1:2"] * 3
                                              + ["pallas"] * 3)


def test_refine_poses_sharded_matches_jax(ranks):
    g, cams, _ = ranks.objs["r21"]
    inp = np.load(ranks.root / "inputs.npz")
    poses, losses = jrefine(g, cams[0], jnp.asarray(inp["refine/poses0"]),
                            jnp.asarray(inp["refine/gts"]), jmake_mesh(2),
                            backend="pallas", num_iter=REFINE_ITERS)
    out = ranks.out
    np.testing.assert_allclose(out["refine/poses"], poses, atol=1e-5)
    np.testing.assert_allclose(out["refine/losses"], losses, rtol=1e-4)


@pytest.mark.parametrize("key", ["s40", "s42"])
@pytest.mark.parametrize("backend", ["oracle", "pallas", "pallas-binned"])
def test_sharded_render_matches_jax_and_one_device(ranks, key, backend):
    """Row blocks over two ranks (42 rows: ragged, 21 a rank): image and
    gradients equal JAX's sharded render (the kernel backends; the plain
    "oracle" one is held to JAX through the one-device render's own
    tests) and the port's one-device render."""
    out = ranks.out
    if backend != "oracle":
        g, cams, target = ranks.objs[key]
        want = _jax_value_and_grads(
            lambda p, pose: jsh.sharded_render(
                p, cams[0], jmake_mesh(2), pose=pose, chunk=64,
                backend=backend), g, target)
        _close(out, want, f"rows/{key}/{backend}", 1e-5)
    one = "oracle" if backend == "oracle" else "pallas"
    for k in ["rgb", "alpha", "depth"] + [f"grad_{f}" for f in PARAM_FIELDS]:
        np.testing.assert_allclose(out[f"rows/{key}/{backend}/{k}"],
                                   out[f"one/{key}/{one}/{k}"], atol=1e-5,
                                   err_msg=k)


def test_gaussian_sharded_render_matches_jax(ranks):
    mesh = jmake_mesh(2)
    for key in ("g7", "g11", "g13"):
        g, cams, target = ranks.objs[key]
        want = _jax_value_and_grads(
            lambda p, pose: jsh.gaussian_sharded_render(
                p, cams[0], mesh, pose=pose), g, target,
            grads=key == "g13")
        _close(ranks.out, want, f"gauss/{key}", 1e-5)


def _one_device_tolerances(out, prefix, key, opaque=False):
    """The depth-sliced render against one device at JAX's own
    tolerances: the latch cannot see across slices."""
    tols = ((("rgb", 5e-3), ("alpha", 5e-3)) if opaque else
            (("rgb", 3e-4), ("alpha", 3e-4), ("depth", 3e-3)))
    for k, tol in tols:
        np.testing.assert_allclose(out[f"{prefix}/{key}/{k}"],
                                   out[f"one/{key}/pallas/{k}"], atol=tol,
                                   err_msg=f"{prefix}/{key}/{k}")


def test_gaussian_sharded_render_matches_one_device(ranks):
    out = ranks.out
    _one_device_tolerances(out, "gauss", "g7")
    _one_device_tolerances(out, "gauss", "g11", opaque=True)
    for f in PARAM_FIELDS:  # no ndev x factor
        np.testing.assert_allclose(out[f"gauss/g13/grad_{f}"],
                                   out[f"one/g13/pallas/grad_{f}"],
                                   atol=2e-4, err_msg=f)


def test_hybrid_sharded_render_matches_jax(ranks):
    """2x2 (pix, gauss) mesh: image and gradients equal JAX's hybrid
    render, and the one-device render within JAX's tolerances."""
    mesh = jmake_mesh_nd((2, 2), ("pix", "gauss"))
    for key in ("h19", "h19o", "h23"):
        g, cams, target = ranks.objs[key]
        want = _jax_value_and_grads(
            lambda p, pose: jsh.hybrid_sharded_render(
                p, cams[0], mesh, pose=pose), g, target,
            grads=key == "h23")
        _close(ranks.out, want, f"hybrid/{key}", 1e-5)
    out = ranks.out
    _one_device_tolerances(out, "hybrid", "h19")
    _one_device_tolerances(out, "hybrid", "h19o", opaque=True)
    for f in PARAM_FIELDS:
        np.testing.assert_allclose(out[f"hybrid/h23/grad_{f}"],
                                   out[f"one/h23/pallas/grad_{f}"],
                                   atol=2e-4, err_msg=f)


def _jax_aligner(mesh):
    p = aligner_case()
    al = jal.GlobalAligner(jal.PairPrediction(
        edges=list(p.edges), pred_i=p.pred_i, pred_j=p.pred_j,
        conf_i=p.conf_i, conf_j=p.conf_j))
    al.init_mst(focal_avg=True)
    return al.align(niter=ALIGN_ITERS, mesh=mesh), al.get_im_poses()


@pytest.mark.parametrize("n", [2, 4], ids=["edges", "area"])
def test_aligner_sharded_matches_jax(ranks, n):
    """2 ranks shard the 6 edges; 4 ranks shard the 768 pixels (6 % 4 !=
    0): loss and poses equal JAX's sharded and one-device alignment, and
    every rank ends with the same parameters. The steps run as one
    StepLoop with the mesh's group (on a card its all-reduce is
    captured)."""
    out = ranks.out
    # the sharded steps as one StepLoop with the mesh's group
    assert list(out[f"align{n}/loops"]) == ["align:1"]
    for mesh in (jmake_mesh(n), None):
        loss, poses = _jax_aligner(mesh)
        assert abs(float(out[f"align{n}/loss"]) - loss) < 1e-5
        np.testing.assert_allclose(out[f"align{n}/poses"], poses, atol=1e-4)
    assert out[f"align{n}/spread"] == 0.0


def test_make_mesh_nd_raises_past_the_ranks(ranks):
    for n in (2, 4):
        assert str(ranks.out[f"raises{n}"]) == \
            f"mesh (4, 4) needs 16 devices, have {n}"
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh_nd((2,), ("data",))


def test_mesh_nd_2d_collectives(ranks):
    """("data", "rows") 2x2: a sum over each axis, as JAX's psums."""
    x = np.arange(4.0).reshape(2, 2)
    want = x.sum(1, keepdims=True) + x.sum(0, keepdims=True)
    np.testing.assert_array_equal(ranks.out["mesh2d"], want.reshape(-1))


def test_initialize_runtime_noop_single_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK",
                "INSTANTSPLAT_TORCH_STORE"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_runtime("cpu") is False
    assert initialize_runtime("cuda") is False  # touches no card


def test_train_cli_two_ranks_writes_one_model_jax_loads(ranks):
    """cli.train --n_devices 2 --device cpu: one set of artifacts, from
    rank 0, which the JAX render stage loads."""
    model = ranks.root / "model"
    plys = list(model.glob("point_cloud/*/point_cloud.ply"))
    assert [p.parent.name for p in plys] == ["iteration_3"]
    lines = (model / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 3 * 5  # once per iteration and tag
    assert len((model / "train_time.txt").read_text().splitlines()) == 1
    params, it = jpipe.load_trained(model, -1, sh_degree=2)
    assert it == 3 and np.isfinite(np.asarray(params.xyz)).all()
    poses = np.load(model / "pose" / "ours_3" / "pose_optimized.npy")
    assert poses.shape == (3, 4, 4) and np.isfinite(poses).all()
