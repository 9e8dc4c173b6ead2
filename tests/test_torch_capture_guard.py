"""No host read inside the steps of the device-resident loops.

On a card every StepLoop (utils/cuda_graphs.py) captures one step into a
CUDA graph after WARMUP eager steps; a step that reads a device value on
the host breaks that capture or freezes the value into the graph. Here,
on the CPU, each loop's steps after its warm-up run with `.item()`,
`bool()`, `float()`, `int()`, `.tolist()`, `.cpu()`, `.numpy()` and
`torch.tensor` / `torch.as_tensor` of host data raising
(tests/torch_host_reads.py): stage 2's make_train_scan blocks (dense and
a capacity backend), the pose refiner, the dense aligner, both sparse
alignment phases, the pre-training step (the TINY MASt3R in bf16, two
micro-batches a step, the fine-tuning loss), and train_joint / align
over a 2-rank gloo mesh (tests/torch_parallel_worker.py's `guard2`
group), and the FSDP pre-training step over a one-rank gloo group. Each
test asserts that its loops did run guarded steps.

The `gpu` twin runs the new loops on the card with
torch.cuda.set_sync_debug_mode("error") around every eager step and
every replay, and around whole pre-training steps (one device and FSDP
over a one-rank NCCL group) once captured.
"""

import contextlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from instantsplat_tpu_torch.convert import to_numpy
from instantsplat_tpu_torch.data.scene import read_scene
from instantsplat_tpu_torch.init import sparse_align as sa
from instantsplat_tpu_torch.init.aligner import GlobalAligner, PairPrediction
from instantsplat_tpu_torch.models.camera import Camera
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
from instantsplat_tpu_torch.parallel import launch
from instantsplat_tpu_torch.pipelines import trainer as tr
from instantsplat_tpu_torch.pipelines.render_pipeline import make_pose_refiner
from instantsplat_tpu_torch.render import driver
from instantsplat_tpu_torch.utils import profiling
from instantsplat_tpu_torch.utils.cuda_graphs import WARMUP, StepLoop
from torch_host_reads import HostRead, guarded_loops, no_host_reads
from torch_init_cases import aligner_case, attach_world_desc, sparse_scene
from torch_scenes import H, W, refine_case, write_tiny_scene

torch.set_num_threads(2)

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent


def test_guard_refuses_every_host_read():
    """The guard itself: each read raises inside, none outside."""
    t = torch.ones(2)
    reads = [lambda: t[0].item(), lambda: bool(t[0]), lambda: float(t[0]),
             lambda: int(t[0]), lambda: t.tolist(), lambda: t.cpu(),
             lambda: t.numpy(),
             lambda: torch.tensor(1.0), lambda: torch.as_tensor([1.0])]
    with no_host_reads("here"):
        for read in reads:
            with pytest.raises(HostRead, match="here"):
                read()
        assert torch.as_tensor(t) is t  # a tensor is no host data
    for read in reads:
        read()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("guard") / "scene"
    write_tiny_scene(root)
    info = read_scene(root, 3, device="cpu")
    g = GaussianModel.create_from_pcd(
        info.points, info.colors, max_sh_degree=2, device="cpu",
        cam_poses=GaussianModel.init_cam_poses_from_w2c(info.poses_w2c))
    return info, g


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("backend", ["pallas", "capacity"])
def test_train_scan_blocks_read_nothing(tiny, backend, traced):
    """With tracing on (utils/profiling.enable) the steps' device marks
    and gradient hooks read nothing on the host either."""
    info, g0 = tiny
    g = g0.replace(**{f: getattr(g0, f).clone() for f in PARAM_FIELDS})
    if backend == "capacity":
        backend = driver.capacity_candidate(g, info.cameras[0])
        assert backend is not None
    profiling.reset()
    profiling.enable(traced)
    try:
        with guarded_loops() as guarded:
            tr.train_joint(g, info.cameras,
                           OptimizationConfig(pp_optimizer=True,
                                              optim_pose=True),
                           tr.TrainerConfig(iterations=8, backend=backend,
                                            log_every=8),
                           spatial_lr_scale=info.nerf_radius)
        phases = profiling.snapshot()["phases"]
    finally:
        profiling.enable(False)
        profiling.reset()
    assert guarded == {"make_train_scan": 8 - WARMUP}
    assert bool(phases) == traced


def test_refiner_reads_nothing():
    arrays, M, gt, start = refine_case()
    g = GaussianModel(**{f: torch.tensor(v) for f, v in arrays.items()},
                      max_sh_degree=1)
    cam = Camera.create(M[:3, :3], M[:3, 3], fx=60.0, fy=60.0, height=H,
                        width=W, device="cpu")
    with guarded_loops() as guarded:
        refine = make_pose_refiner(g, cam, num_iter=6)
        refine(start, torch.tensor(gt))
    assert guarded == {"make_pose_refiner": 6 - WARMUP}


def test_dense_aligner_reads_nothing():
    al = GlobalAligner(aligner_case(), device="cpu")
    al.init_mst(focal_avg=True)
    with guarded_loops() as guarded:
        al.align(niter=6)
    assert guarded == {"align": 6 - WARMUP}


def test_sparse_alignment_phases_read_nothing():
    c2w, _, preds = sparse_scene(PairPrediction, n_views=3)
    preds = attach_world_desc(preds, c2w)
    with guarded_loops() as guarded:
        res = sa.sparse_global_alignment(preds, subsample=4, niter1=6,
                                         niter2=6, device="cpu")
    assert np.isfinite(res.loss)
    assert guarded == {"sparse_align coarse": 6 - WARMUP,
                       "sparse_align fine": 6 - WARMUP}


def _pretrain_batch(cfg, seed, h=32, w=48, n_corres=24):
    from instantsplat_tpu_torch.train_dust3r import trainer as tt

    b = tt.synthetic_batch(cfg, batch=2, h=h, w=w, seed=seed)
    rng = np.random.default_rng(100 + seed)
    xy = np.stack([rng.integers(0, w, (2, n_corres)),
                   rng.integers(0, h, (2, n_corres))], -1).astype(np.int32)
    b["gt1"]["corres"] = torch.from_numpy(xy)
    b["gt2"]["corres"] = torch.from_numpy(np.clip(
        xy + rng.integers(-2, 3, xy.shape), 0, [w - 1, h - 1]).astype(
            np.int32))
    b["gt1"]["valid_corres"] = torch.from_numpy(
        rng.random((2, n_corres)) < 0.8)
    return b


def _pretrain_steps(device, n_steps, around_step=contextlib.nullcontext,
                    **mesh):
    """n_steps bf16 pre-training steps of the TINY MASt3R, two
    micro-batches a step, the fine-tuning loss; each step inside
    around_step(i); `mesh` (mesh=, fsdp=) passed to make_dp_train_step.
    -> the losses."""
    from instantsplat_tpu_torch.cli.pretrain import TINY
    from instantsplat_tpu_torch.models import mast3r
    from instantsplat_tpu_torch.train_dust3r import losses, trainer as tt

    cfg = mast3r.MASt3RConfig(**TINY)
    model = mast3r.build_trainable("random:0", cfg, device=device)
    init, step, _ = tt.make_dp_train_step(
        cfg, base_lr=5e-4, warmup_steps=2, total_steps=8,
        loss_fn=losses.mast3r_finetune_loss, accum_iter=2,
        compute_dtype=torch.bfloat16, **mesh)
    state = init(model)
    out = []
    for i in range(n_steps):
        batch = tt.stack_microbatches([_pretrain_batch(cfg, 2 * i + k)
                                       for k in range(2)])
        with around_step(i):
            state, metrics = step(state, batch)
        out.append(metrics["loss"])
    return [float(x) for x in out]


def test_pretrain_step_reads_nothing():
    with guarded_loops() as guarded:
        losses = _pretrain_steps("cpu", 6)
    assert np.all(np.isfinite(losses))
    assert guarded == {"pretrain step": 6 - WARMUP}


@contextlib.contextmanager
def _one_rank_group(device, store):
    """A one-rank process group in this process (gloo on the CPU, NCCL on
    a card) -> its mesh; destroyed on the way out."""
    import torch.distributed as dist

    from instantsplat_tpu_torch.parallel import initialize_runtime, make_mesh

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    initialize_runtime(device, init_method=f"file://{store}", world_size=1,
                       rank=0)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def test_fsdp_pretrain_step_reads_nothing(tmp_path):
    """The FSDP step over a one-rank gloo group (the all-gather into the
    static rows, the reduce-scatter onto the gradient shard, AdamW on the
    shards) runs as the pre-training StepLoop, its steps guarded."""
    with _one_rank_group("cpu", tmp_path / "store") as mesh:
        with guarded_loops() as guarded:
            losses = _pretrain_steps("cpu", 5, mesh=mesh, fsdp=True)
    assert np.all(np.isfinite(losses))
    assert guarded == {"pretrain step": 5 - WARMUP}


def _child_env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(TESTS), env.get("PYTHONPATH", "")])
    return env


def test_mesh_loops_read_nothing(tmp_path):
    """train_joint on each shard axis and align over a 2-rank gloo mesh
    (tests/torch_parallel_worker.py's guard2 group): their blocks run
    guarded on every rank."""
    rng = np.random.default_rng(3)
    n, size = 200, 32
    g = GaussianModel.create_from_pcd(
        rng.normal(size=(n, 3)) * [0.6, 0.6, 0.3] + [0, 0, 4.0],
        rng.uniform(0.1, 0.9, (n, 3)), max_sh_degree=1, device="cpu",
        cam_poses=np.tile([1.0, 0, 0, 0, 0, 0, 0], (2, 1)))
    inp = {f"guard/{f}": v for f, v in to_numpy(g).items()
           if f in PARAM_FIELDS}
    inp.update({"guard/size": size, "guard/fx": 40.0, "guard/views": 2,
                "guard/images": rng.uniform(size=(2, size, size, 3))})
    np.savez(tmp_path / "inputs.npz", **inp)
    launch.spawn("torch_parallel_worker", [str(tmp_path), "guard2"], 2,
                 timeout=300, env=_child_env(), cwd=str(TESTS))
    out = dict(np.load(tmp_path / "guard2.npz"))
    assert out == {"guard/make_train_scan": 2 * (6 - WARMUP),
                   "guard/align": 6 - WARMUP}


# ---- on the card: no synchronisation with the host -------------------------


@contextlib.contextmanager
def _sync_errors(mode="error"):
    prev = torch.cuda.get_sync_debug_mode()
    if prev == 0:
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def _steps_refuse_syncs():
    """Every StepLoop's eager steps (its warm-up) and every replay run
    under set_sync_debug_mode("error"); -> {loop name: replays}."""
    replays: dict = {}
    loop, replay = StepLoop._loop, torch.cuda.CUDAGraph.replay

    def eager(self, n):
        with _sync_errors():
            return loop(self, n)

    def replayed(self):
        with _sync_errors():
            return replay(self)

    real_run = StepLoop._run

    def run(self, n):
        before = StepLoop.replays
        out = real_run(self, n)
        replays[self.name] = replays.get(self.name, 0) + (
            StepLoop.replays - before)
        return out

    StepLoop._loop, StepLoop._run = eager, run
    torch.cuda.CUDAGraph.replay = replayed
    try:
        yield replays
    finally:
        StepLoop._loop, StepLoop._run = loop, real_run
        torch.cuda.CUDAGraph.replay = replay


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_new_loops_make_no_host_sync_on_the_card(cuda, tmp_path):
    """The sparse phases, the pre-training step (whole steps once its
    graph is captured), and train_joint (both shard axes), align and the
    FSDP pre-training step (whole steps too) over a one-rank NCCL mesh:
    no synchronisation in a step, each loop replayed. (On the CPU a
    dispatch mode cannot see every host read in PyTorch's C++: under a
    mode the backward of prod takes its read-free path.)"""
    c2w, _, preds = sparse_scene(PairPrediction, n_views=3)
    preds = attach_world_desc(preds, c2w)
    with _steps_refuse_syncs() as replays:
        res = sa.sparse_global_alignment(preds, subsample=4, niter1=12,
                                         niter2=12, device=cuda)
        assert np.isfinite(res.loss)
        losses = _pretrain_steps(cuda, 8, lambda i: _sync_errors(
            "error" if i > WARMUP else "default"))
        assert np.all(np.isfinite(losses))
    assert replays == {"sparse_align coarse": 12 - WARMUP,
                       "sparse_align fine": 12 - WARMUP,
                       "pretrain step": 8 - WARMUP}

    with _one_rank_group("cuda", tmp_path / "store") as mesh:
        root = tmp_path / "scene"
        write_tiny_scene(root)
        info = read_scene(root, 3, device=cuda)
        with _steps_refuse_syncs() as replays:
            for axis in ("pixels", "gaussians"):
                g = GaussianModel.create_from_pcd(
                    info.points, info.colors, max_sh_degree=2, device=cuda,
                    cam_poses=GaussianModel.init_cam_poses_from_w2c(
                        info.poses_w2c))
                tr.train_joint(g, info.cameras,
                               OptimizationConfig(pp_optimizer=True,
                                                  optim_pose=True),
                               tr.TrainerConfig(iterations=10,
                                                backend="pallas",
                                                log_every=10,
                                                shard_axis=axis),
                               spatial_lr_scale=info.nerf_radius, mesh=mesh)
            al = GlobalAligner(aligner_case(), device=cuda)
            al.init_mst(focal_avg=True)
            al.align(niter=10, mesh=mesh)
            losses = _pretrain_steps(cuda, 8, lambda i: _sync_errors(
                "error" if i > WARMUP else "default"), mesh=mesh, fsdp=True)
            assert np.all(np.isfinite(losses))
        assert replays == {"make_train_scan": 2 * (10 - WARMUP),
                           "align": 10 - WARMUP,
                           "pretrain step": 8 - WARMUP}


def test_step_table_rows_by_the_device_counter():
    """StepTable: row i at counter i, advance, seek back, float32 rows,
    one column for scalar rows, and an empty loop."""
    from instantsplat_tpu_torch.utils.cuda_graphs import StepTable

    tab = StepTable([[s / 3, 2.0 ** -s] for s in range(1, 5)], "cpu")
    assert tab.table.dtype == torch.float32 and len(tab) == 4
    assert tab.row().tolist() == [np.float32(1 / 3), 0.5]
    tab.advance()
    tab.advance()
    assert tab.row().tolist() == [np.float32(1.0), 0.125]
    tab.seek(1)
    assert tab.row()[1].item() == 0.25
    assert StepTable([1.0, 2.0], "cpu").table.shape == (2, 1)
    assert StepTable(np.zeros((0, 3)), "cpu").table.shape == (0, 3)


def test_mesh_capture_needs_nccl(monkeypatch):
    """A step to be captured whose collectives use a host backend raises,
    naming the loop, where the StepLoop is made (no card needed: nothing
    runs); a NCCL group is taken, and a Python loop takes any group."""
    import torch.distributed as dist

    group = object()
    monkeypatch.setattr(dist, "get_backend", lambda g=None: "gloo")
    with pytest.raises(RuntimeError, match="align: .*NCCL group, not gloo"):
        StepLoop(lambda: None, "cuda", "align", groups=[group])
    assert not StepLoop(lambda: None, "cpu", "align",
                        groups=[group]).captured
    monkeypatch.setattr(dist, "get_backend", lambda g=None: "nccl")
    assert StepLoop(lambda: None, "cuda", "align", groups=[group]).captured
