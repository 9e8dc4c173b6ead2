"""Stage-2 CLI: joint Gaussian + pose training on the GPU (port of
instantsplat_tpu/cli/train.py).

  python -m instantsplat_tpu_torch.cli.train -s <scene> -m <out> \\
      --n_views 3 --iterations 1000 --pp_optimizer --optim_pose

Runs on CUDA by default; `--device cpu` runs the plain PyTorch path.
"""

from __future__ import annotations

from argparse import ArgumentParser

from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig
from instantsplat_tpu_torch.pipelines import config as C
from instantsplat_tpu_torch.pipelines.train_pipeline import run_training
from instantsplat_tpu_torch.pipelines.trainer import TrainerConfig


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="joint Gaussian+pose training")
    C.add_group(parser, C.ModelParams,
                abbrevs={"source_path": "s", "model_path": "m",
                         "images": "i", "resolution": "r",
                         "white_background": "w"})
    C.add_group(parser, C.PipelineParams)
    C.add_group(parser, OptimizationConfig)
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--quiet", action="store_true")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    model = C.extract_group(args, C.ModelParams)
    opt = C.make_opt_config(args)
    trainer = TrainerConfig(iterations=args.iterations,
                            white_background=model.white_background,
                            backend=args.backend, log_every=args.log_every)

    def progress(it, m):
        if not args.quiet:
            print(f"[train] iter {it}: loss={m['loss']:.5f} "
                  f"psnr={m['psnr']:.2f}", flush=True)

    params, history = run_training(
        model, opt, trainer,
        save_iterations=args.save_iterations or None,
        checkpoint_iterations=args.checkpoint_iterations,
        progress_cb=progress,
        start_checkpoint=args.start_checkpoint,
        device=args.device)
    print(f"[train] done -> {model.model_path}")
    return params, history


if __name__ == "__main__":
    main()
