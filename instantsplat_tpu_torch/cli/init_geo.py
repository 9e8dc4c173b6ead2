"""Stage-1 CLI: geometry initialization, MASt3R -> global alignment (port
of instantsplat_tpu/cli/init_geo.py; reference init_geo.py,
scripts/run_eval.sh:70-77).

  python -m instantsplat_tpu_torch.cli.init_geo -s <scene> -m <out> \\
      --n_views 3 --ckpt_path <mast3r.pth> --focal_avg

`--ckpt_path random[:SEED]` runs the full production model with the JAX
package's random weights of that seed. Runs on CUDA by default;
`--device cpu` runs everything on the CPU.
"""

from __future__ import annotations

from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="geometry initialization")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--ckpt_path", type=str, default="")
    parser.add_argument("--n_views", type=int, default=3)
    parser.add_argument("--image_size", type=int, default=512)
    parser.add_argument("--niter", type=int, default=300)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--schedule", type=str, default="cosine")
    parser.add_argument("--focal_avg", action="store_true")
    parser.add_argument("--conf_aware_ranking", action="store_true")
    parser.add_argument("--co_vis_dsp", action="store_true")
    parser.add_argument("--depth_thre", type=float, default=0.01)
    parser.add_argument("--max_pts", type=int, default=int(150e10),
                        help="confidence-weighted random downsample cap on "
                             "the fused cloud (reference sfm_utils.py:250 "
                             "max_pts_num)")
    parser.add_argument("--infer_video", action="store_true")
    # pairs decoded per batch, clamped to the scene's pair count
    parser.add_argument("--batch_size", type=int, default=24)
    # bf16: matrices and activations in bf16, LayerNorm statistics,
    # softmax accumulation and the head postprocess in f32
    parser.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    # pair-parallel inference and edge-sharded alignment over several
    # devices (0 or 1 = one device, -1 = every local card)
    parser.add_argument("--n_devices", type=int, default=0)
    # accepted for drop-in compatibility with reference init_geo.py:137-144,
    # whose main() never consumes them either: documented no-ops
    parser.add_argument("--min_conf_thr", type=float, default=5)
    parser.add_argument("--llffhold", type=int, default=8)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return parser


def main(argv=None):
    import torch

    from instantsplat_tpu_torch import resolve_device
    from instantsplat_tpu_torch.models.mast3r_infer import make_pointmap_fn
    from instantsplat_tpu_torch.parallel import launch, runtime
    from instantsplat_tpu_torch.pipelines.init_geo_pipeline import (
        run_init_geo)

    args = build_parser().parse_args(argv)
    world = launch.run_ranks("instantsplat_tpu_torch.cli.init_geo", argv,
                             args.n_devices, args.device)
    if world is None:  # the spawned ranks ran the stage
        return None
    runtime.initialize_runtime(args.device)
    device = resolve_device(args.device)
    mesh = None
    if world > 1:
        from instantsplat_tpu_torch.parallel import make_mesh

        mesh = make_mesh(world)
        if runtime.is_main_process():
            print(f"[init_geo] pair-DP inference + edge-sharded alignment "
                  f"over {world} devices", flush=True)
    pointmap_fn = make_pointmap_fn(
        args.ckpt_path, batch_size=args.batch_size, device=device,
        dtype=torch.bfloat16 if args.dtype == "bf16" else None, mesh=mesh)
    aligner = run_init_geo(
        args.source_path, args.model_path, pointmap_fn,
        n_views=args.n_views, image_size=args.image_size,
        niter=args.niter, lr=args.lr, schedule=args.schedule,
        focal_avg=args.focal_avg,
        conf_aware_ranking=args.conf_aware_ranking,
        depth_thre=args.depth_thre, co_vis_dsp=args.co_vis_dsp,
        max_pts=args.max_pts, infer_video=args.infer_video,
        save_all_pts=True, device=device, mesh=mesh)
    if runtime.is_main_process():
        print(f"[init_geo] done -> {args.source_path}/sparse_{args.n_views}")
    return aligner


if __name__ == "__main__":
    main()
