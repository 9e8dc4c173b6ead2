"""Alternative stage-3 CLI: test-pose initialization through the pointmap
model (port of instantsplat_tpu/cli/init_test_pose.py; reference
init_test_pose.py:95-116, the scripted-off stage of run_eval.sh:93-101).

  python -m instantsplat_tpu_torch.cli.init_test_pose -s <scene> -m <out> \\
      --n_views 3 --ckpt_path <mast3r.pth> --focal_avg

Re-runs MASt3R (float32) over the train and test images together,
registers the new cloud onto the stage-1 cloud, and writes the transported
test poses to sparse_{n}/1 (pipelines/init_test_pose_pipeline.py). Runs on
CUDA by default; `--device cpu` runs everything on the CPU.
"""

from __future__ import annotations

from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="test-pose initialization")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--ckpt_path", type=str, default="")
    parser.add_argument("--n_views", type=int, default=3)
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--niter", type=int, default=500)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--schedule", type=str, default="cosine")
    parser.add_argument("--focal_avg", action="store_true")
    parser.add_argument("--batch_size", type=int, default=8)
    # accepted for drop-in compatibility with reference
    # init_test_pose.py:100-114, whose main() never consumes them either:
    # documented no-ops
    parser.add_argument("--min_conf_thr", type=float, default=5)
    parser.add_argument("--llffhold", type=int, default=8)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--conf_aware_ranking", action="store_true")
    parser.add_argument("--co_vis_dsp", action="store_true")
    parser.add_argument("--depth_thre", type=float, default=0.01)
    parser.add_argument("--infer_video", action="store_true")
    return parser


def main(argv=None):
    """-> the seconds of the stage's parts (load, inference, init_mst,
    align, write) and the registration scale."""
    from instantsplat_tpu_torch import resolve_device
    from instantsplat_tpu_torch.models.mast3r_infer import make_pointmap_fn
    from instantsplat_tpu_torch.parallel import initialize_runtime
    from instantsplat_tpu_torch.pipelines.init_test_pose_pipeline import (
        run_init_test_pose)

    args = build_parser().parse_args(argv)
    initialize_runtime(args.device)  # a no-op in a single process
    device = resolve_device(args.device)
    # float32, as the JAX CLI passes no dtype (TF32 is off package-wide)
    pointmap_fn = make_pointmap_fn(args.ckpt_path,
                                   batch_size=args.batch_size, device=device)
    timings = {}
    run_init_test_pose(
        args.source_path, args.model_path, pointmap_fn,
        n_views=args.n_views, image_size=args.image_size,
        niter=args.niter, lr=args.lr, schedule=args.schedule,
        focal_avg=args.focal_avg, device=device, timings=timings)
    print(f"[init_test_pose] done -> "
          f"{args.source_path}/sparse_{args.n_views}/1")
    return timings


if __name__ == "__main__":
    main()
