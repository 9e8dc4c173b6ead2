"""One rank of the gloo groups that tests/test_torch_parallel.py and
tests/test_torch_parallel_pretrain.py start (parallel/launch.spawn):

    python -m torch_parallel_worker <dir> <group>

Imports torch and the port only. Reads <dir>/inputs.npz (the pytest
process writes it, JAX's scenes among it), runs every case of <group> on
every rank (each case's collectives need them all) and rank 0 writes
<dir>/<group>.npz. One intra-op thread per rank.
"""

import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

from instantsplat_tpu_torch import convert  # noqa: E402
from instantsplat_tpu_torch.models.camera import Camera  # noqa: E402
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS  # noqa: E402
from instantsplat_tpu_torch.ops.losses import photometric_loss  # noqa: E402
from instantsplat_tpu_torch.parallel import (  # noqa: E402
    gaussian_sharded_render,
    hybrid_sharded_render,
    make_mesh,
    make_mesh_nd,
    runtime,
    sharded_render,
)
from instantsplat_tpu_torch.render.driver import render  # noqa: E402

OUT = None  # the group's directory (main)


def scene(inp, key):
    """(GaussianModel, [Camera]) of the scene `key` of inputs.npz."""
    g = convert.gaussians_from_numpy(
        {f: inp[f"{key}/{f}"] for f in PARAM_FIELDS}, max_sh_degree=1,
        device="cpu")
    size = int(inp[f"{key}/size"])
    images = inp.get(f"{key}/images")
    cams = [Camera.create(np.eye(3), np.zeros(3), fx=float(inp[f"{key}/fx"]),
                          fy=float(inp[f"{key}/fx"]), height=size, width=size,
                          uid=i, device="cpu",
                          image=None if images is None else images[i])
            for i in range(int(inp[f"{key}/views"]))]
    return g, cams


def value_and_grads(fn, g, target):
    """(rgb, alpha, depth, {field: d photometric_loss / d field}) of a
    render fn(g, pose) -> (rgb, alpha, depth) at view 0's learnable pose."""
    for t in g.tensors():
        t.requires_grad_(True)
    rgb, alpha, depth = fn(g, g.get_pose(0))
    loss = photometric_loss(rgb, target)[0]
    grads = torch.autograd.grad(loss, g.tensors(), allow_unused=True)
    for t in g.tensors():
        t.requires_grad_(False)
    out = dict(rgb=rgb, alpha=alpha, depth=depth)
    out.update({f"grad_{f}": torch.zeros_like(t) if d is None else d
                for f, t, d in zip(PARAM_FIELDS, g.tensors(), grads)})
    return {k: v.detach().numpy() for k, v in out.items()}


def one_device(g, cam, backend):
    def fn(p, pose):
        o = render(p, cam, pose=pose, chunk=64, backend=backend)
        return o.render, o.alpha, o.depth
    return fn


def prefixed(prefix, d):
    return {f"{prefix}/{k}": v for k, v in d.items()}


def rank_spread(tensors):
    """Largest difference of the flattened tensors between any two ranks
    (0.0 when every rank holds the same bits)."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(runtime.world_size())]
    torch.distributed.all_gather(parts, flat)
    return float(max((p - parts[0]).abs().max() for p in parts))


# -- the 2-rank render group --------------------------------------------------


def case_sharded_render(inp, mesh):
    out = {}
    for key in ("s40", "s42"):
        g, cams = scene(inp, key)
        target = torch.as_tensor(inp[f"{key}/target"])
        for backend in ("oracle", "pallas", "pallas-binned"):
            def fn(p, pose, backend=backend):
                return sharded_render(p, cams[0], mesh, pose=pose, chunk=64,
                                      backend=backend)
            out.update(prefixed(f"rows/{key}/{backend}",
                                value_and_grads(fn, g, target)))
        for backend in ("oracle", "pallas"):
            out.update(prefixed(f"one/{key}/{backend}", value_and_grads(
                one_device(g, cams[0], backend), g, target)))
    return out


def case_gaussian_render(inp, mesh):
    out = {}
    for key in ("g7", "g11", "g13"):
        g, cams = scene(inp, key)
        target = torch.as_tensor(inp[f"{key}/target"])

        def fn(p, pose):
            return gaussian_sharded_render(p, cams[0], mesh, pose=pose)
        out.update(prefixed(f"gauss/{key}", value_and_grads(fn, g, target)))
        out.update(prefixed(f"one/{key}/pallas", value_and_grads(
            one_device(g, cams[0], "pallas"), g, target)))
    return out


def case_train_joint(inp, mesh):
    from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
    from instantsplat_tpu_torch.pipelines.trainer import (
        TrainerConfig,
        train_joint,
    )

    out = {}
    for axis in ("pixels", "gaussians"):
        g, cams = scene(inp, "t11")
        _, _, hist = train_joint(
            g, cams, opt_cfg=OptimizationConfig(optim_pose=True),
            trainer_cfg=TrainerConfig(
                iterations=int(inp["train_iters"]), backend="pallas",
                chunk=64, log_every=1, seed=5, n_devices=2,
                shard_axis=axis))
        out[f"train/{axis}/loss"] = np.array([m["loss"] for _, m in hist])
        out[f"train/{axis}/spread"] = np.float64(rank_spread(g.tensors()))
        for f in PARAM_FIELDS:
            out[f"train/{axis}/{f}"] = getattr(g, f).numpy()
    return out


def case_train_scan(inp, mesh):
    """train_joint over the mesh in one block of TRAIN_ITERS iterations
    (make_train_scan's path): the loss, the parameters, what it printed
    and the StepLoops it ran."""
    import contextlib
    import io

    from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
    from instantsplat_tpu_torch.pipelines import trainer as tr

    made = []

    class Spy(tr.StepLoop):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append((self.name, len(self.groups)))

    real, tr.StepLoop = tr.StepLoop, Spy
    g, cams = scene(inp, "t11s")
    said = io.StringIO()
    try:
        with contextlib.redirect_stdout(said):
            _, _, hist = tr.train_joint(
                g, cams, opt_cfg=OptimizationConfig(optim_pose=True),
                trainer_cfg=tr.TrainerConfig(
                    iterations=int(inp["train_iters"]), backend="pallas",
                    chunk=64, log_every=int(inp["train_iters"]), seed=5,
                    n_devices=2))
    finally:
        tr.StepLoop = real
    out = {"scan/loss": np.array([m["loss"] for _, m in hist]),
           "scan/said": np.array(said.getvalue()),
           "scan/loops": np.array([f"{n}:{k}" for n, k in made]),
           "scan/spread": np.float64(rank_spread(g.tensors()))}
    for f in PARAM_FIELDS:
        out[f"scan/{f}"] = getattr(g, f).numpy()
    return out


def case_block_overflow(inp, mesh):
    """train_joint over the mesh in two blocks of 3 iterations with an
    overflowing "pallas-binned:1:2": the first block's end demotes the
    sharded signature with the sharding layer's warning, and the second
    block runs the dense kernels. -> the demoted signatures, the
    warnings and each local render's backend, in order."""
    import logging

    from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
    from instantsplat_tpu_torch.parallel import sharding
    from instantsplat_tpu_torch.pipelines import trainer as tr
    from instantsplat_tpu_torch.render import driver

    backends, warned = [], []
    real_rows = sharding.rows_local

    def rows_local(packed, rank, ndev, h, w, backend, chunk):
        backends.append(backend)
        return real_rows(packed, rank, ndev, h, w, backend, chunk)

    class Catch(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    guard, driver._guard = driver._guard, driver._OverflowGuard()
    sharding.rows_local, catch = rows_local, Catch(logging.WARNING)
    driver._log.addHandler(catch)
    g, cams = scene(inp, "t11s")
    try:
        tr.train_joint(
            g, cams, opt_cfg=OptimizationConfig(optim_pose=True),
            trainer_cfg=tr.TrainerConfig(
                iterations=6, backend="pallas-binned:1:2", chunk=64,
                log_every=3, seed=5, n_devices=2))
        demoted = sorted(map(str, driver._guard.demoted))
    finally:
        driver._guard, sharding.rows_local = guard, real_rows
        driver._log.removeHandler(catch)
    return {"overflow/demoted": np.array(demoted),
            "overflow/warned": np.array(warned),
            "overflow/backends": np.array(backends)}


def case_refine(inp, mesh):
    from instantsplat_tpu_torch.pipelines.render_pipeline import (
        refine_poses_sharded,
    )

    g, cams = scene(inp, "r21")
    poses, losses = refine_poses_sharded(
        g, cams[0], inp["refine/poses0"], inp["refine/gts"], mesh,
        backend="pallas", num_iter=int(inp["refine/iters"]))
    return {"refine/poses": poses, "refine/losses": losses}


def case_aligner(inp, mesh):
    from instantsplat_tpu_torch.init.aligner import (
        GlobalAligner,
        PairPrediction,
    )

    preds = PairPrediction(
        edges=[tuple(e) for e in inp["align/edges"].tolist()],
        **{k: inp[f"align/{k}"] for k in ("pred_i", "pred_j", "conf_i",
                                          "conf_j")})
    from instantsplat_tpu_torch.init import aligner

    made = []

    class Spy(aligner.StepLoop):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(f"{self.name}:{len(self.groups)}")

    al = GlobalAligner(preds, device="cpu")
    al.init_mst(focal_avg=True)
    real, aligner.StepLoop = aligner.StepLoop, Spy
    try:
        loss = al.align(niter=int(inp["align/iters"]), mesh=mesh)
    finally:
        aligner.StepLoop = real
    n = runtime.axis(mesh)[2]
    return {f"align{n}/loss": np.float64(loss),
            f"align{n}/loops": np.array(made),
            f"align{n}/poses": al.get_im_poses(),
            f"align{n}/spread": np.float64(rank_spread(
                [torch.as_tensor(v) for v in al.params.values()]))}


def case_mesh_raises(inp, mesh):
    try:
        make_mesh_nd((4, 4), ("data", "rows"))
    except ValueError as e:
        return {f"raises{runtime.world_size()}": np.array(str(e))}
    return {}


# -- the 4-rank group ---------------------------------------------------------


def case_hybrid(inp, mesh):
    mesh2 = make_mesh_nd((2, 2), ("pix", "gauss"))
    out = {}
    for key in ("h19", "h19o", "h23"):
        g, cams = scene(inp, key)
        target = torch.as_tensor(inp[f"{key}/target"])

        def fn(p, pose):
            return hybrid_sharded_render(p, cams[0], mesh2, pose=pose)
        out.update(prefixed(f"hybrid/{key}", value_and_grads(fn, g, target)))
        out.update(prefixed(f"one/{key}/pallas", value_and_grads(
            one_device(g, cams[0], "pallas"), g, target)))
    return out


def case_mesh_2d(inp, mesh):
    """psum over each axis of a ("data", "rows") 2x2 mesh of x[i, j] =
    2 i + j on rank (i, j)."""
    m = make_mesh_nd((2, 2), ("data", "rows"))
    i, j = m.get_local_rank("data"), m.get_local_rank("rows")
    x = torch.tensor([2.0 * i + j])
    a, b = x.clone(), x.clone()
    torch.distributed.all_reduce(a, group=m.get_group("rows"))
    torch.distributed.all_reduce(b, group=m.get_group("data"))
    parts = [torch.empty(1) for _ in range(4)]
    torch.distributed.all_gather(parts, a + b)
    return {"mesh2d": torch.cat(parts).numpy()}


# -- the 2-rank model group ---------------------------------------------------


def case_infer_pairs(inp, mesh):
    from instantsplat_tpu_torch.init.pairs import make_pair_indices
    from instantsplat_tpu_torch.models import mast3r
    from instantsplat_tpu_torch.models.mast3r_infer import infer_pairs
    from torch_init_cases import TINY

    model = mast3r.build_model("random:0", TINY, device="cpu")
    images = inp["infer/images"]
    pairs = make_pair_indices(len(images), "complete", symmetrize=True)
    out = {}
    for tag, m in (("mesh", mesh), ("one", None)):
        pred = infer_pairs(model, images, pairs, batch_size=4, mesh=m)
        for k in ("pred_i", "pred_j", "conf_i", "conf_j", "desc_i",
                  "desc_j"):
            out[f"infer/{tag}/{k}"] = getattr(pred, k)
    return out


def _tiny_cfg():
    from instantsplat_tpu_torch.cli.pretrain import TINY
    from instantsplat_tpu_torch.models import mast3r

    return mast3r.MASt3RConfig(**TINY)


def case_tp(inp, mesh):
    from instantsplat_tpu_torch.models import mast3r
    from instantsplat_tpu_torch.parallel import shard_params_tp

    cfg = _tiny_cfg()
    model = mast3r.build_model("random:0", cfg, device="cpu")
    img1 = torch.as_tensor(inp["tp/img1"])
    img2 = torch.as_tensor(inp["tp/img2"])
    out = {}
    with torch.no_grad():
        for tag in ("one", "tp"):
            if tag == "tp":
                shard_params_tp(model, make_mesh_nd((2,), ("model",)))
            r1, r2 = model(img1, img2)
            for side, r in (("1", r1), ("2", r2)):
                for k in ("pts3d", "conf", "desc"):
                    out[f"tp/{tag}/{side}/{k}"] = r[k].numpy()
    return out


def _dp_cfg():
    from instantsplat_tpu_torch.models import mast3r

    return mast3r.MASt3RConfig(
        enc_embed_dim=32, enc_depth=1, enc_num_heads=2, dec_embed_dim=32,
        dec_depth=1, dec_num_heads=2, dpt_layer_dims=(8, 8, 8, 8),
        dpt_feature_dim=8, dpt_last_dim=4, patch_size=16)


def case_dp_steps(inp, mesh):
    """Two steps of the DDP and the FSDP step (tests/test_parallel.py's
    FSDP case) and an accumulating DDP step against the one-device one;
    the FSDP state saved as a checkpoint."""
    from instantsplat_tpu_torch.models import mast3r
    from instantsplat_tpu_torch.train_dust3r import trainer as tt

    cfg = _dp_cfg()
    kw = dict(warmup_steps=1, total_steps=4)
    batch = tt.synthetic_batch(cfg, batch=4, h=32, w=32, seed=1)
    out = {}
    for tag, m, fsdp in (("ddp", mesh, False), ("fsdp", mesh, True)):
        model = mast3r.build_trainable("random:0", cfg, device="cpu")
        init, step, _ = tt.make_dp_train_step(cfg, mesh=m, fsdp=fsdp, **kw)
        state = init(model)
        losses = []
        for _ in range(2):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        out[f"dp/{tag}/loss"] = np.array(losses)
        full = tt._full_groups(state)
        for group in ("params", "m", "v"):
            for name, t in full[group].items():
                out[f"dp/{tag}/{group}/{name}"] = t.detach().numpy()
        if fsdp:
            tt.save_pretrain_checkpoint(OUT / "fsdp.npz", state)
    # accumulation: two micro-batches of 2 a step, no sync between them
    accum = tt.stack_microbatches([
        tt.synthetic_batch(cfg, batch=2, h=32, w=32, seed=s) for s in (2, 3)])
    for tag, m in (("accum", mesh), ("accum_one", None)):
        model = mast3r.build_trainable("random:0", cfg, device="cpu")
        init, step, _ = tt.make_dp_train_step(cfg, mesh=m, accum_iter=2,
                                              fsdp=m is not None, **kw)
        state, metrics = step(init(model), accum)
        out[f"dp/{tag}/loss"] = np.array([float(metrics["loss"])])
        for name, t in tt._full_groups(state)["params"].items():
            out[f"dp/{tag}/params/{name}"] = t.detach().numpy()
    return out


def case_fsdp_resume(inp, mesh):
    """FSDP through train_loop: one step saved to checkpoint-last.npz,
    then a new model and step function resume it at step 1 and take step
    2 (past the warm-up: the step table's counter is re-seeked); the
    resumed run's history and checkpoint."""
    from instantsplat_tpu_torch.models import mast3r
    from instantsplat_tpu_torch.train_dust3r import trainer as tt

    cfg = _dp_cfg()
    batch = tt.synthetic_batch(cfg, batch=4, h=32, w=32, seed=1)
    kw = dict(warmup_steps=1, total_steps=4, fsdp=True)
    for n in (1, 2):
        model = mast3r.build_trainable("random:0", cfg, device="cpu")
        _, hist = tt.train_loop(model, cfg, iter([batch] * n), mesh=mesh,
                                n_steps=n, output_dir=OUT / "resume", **kw)
    return {"resume/steps": np.array([s for s, _ in hist]),
            "resume/loss": np.array([m["loss"] for _, m in hist])}


def case_guarded_loops(inp, mesh):
    """train_joint (one block a shard axis) and align over the mesh with
    every step after a loop's warm-up refusing host reads
    (torch_host_reads.guarded_loops). -> {loop name: guarded steps}."""
    from torch_host_reads import guarded_loops

    from instantsplat_tpu_torch.init.aligner import GlobalAligner
    from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
    from instantsplat_tpu_torch.pipelines.trainer import (TrainerConfig,
                                                          train_joint)
    from torch_init_cases import aligner_case

    with guarded_loops() as guarded:
        for axis in ("pixels", "gaussians"):
            g, cams = scene(inp, "guard")
            train_joint(g, cams, opt_cfg=OptimizationConfig(
                pp_optimizer=True, optim_pose=True),
                trainer_cfg=TrainerConfig(iterations=6, backend="pallas",
                                          chunk=64, log_every=6,
                                          n_devices=2, shard_axis=axis))
        al = GlobalAligner(aligner_case(), device="cpu")
        al.init_mst(focal_avg=True)
        al.align(niter=6, mesh=mesh)
    return {f"guard/{name}": np.int64(n) for name, n in guarded.items()}


GROUPS = {
    "renders2": [case_sharded_render, case_gaussian_render, case_train_joint,
                 case_train_scan, case_block_overflow, case_refine,
                 case_aligner,
                 case_mesh_raises],
    "renders4": [case_hybrid, case_aligner, case_mesh_2d, case_mesh_raises],
    "models2": [case_infer_pairs, case_tp, case_dp_steps, case_fsdp_resume],
    "guard2": [case_guarded_loops],
}


def main():
    out_dir, group = Path(sys.argv[1]), sys.argv[2]
    runtime.initialize_runtime("cpu")
    inp = dict(np.load(out_dir / "inputs.npz"))
    global OUT
    OUT = out_dir
    mesh = make_mesh()
    results = {}
    for case in GROUPS[group]:
        results.update(case(inp, mesh))
    if runtime.is_main_process():
        np.savez(out_dir / f"{group}.npz", **results)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
