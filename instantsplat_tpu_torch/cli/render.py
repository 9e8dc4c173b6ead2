"""Stage-3/4 CLI: render the train, test and interpolated views of a
trained model, with test-time pose refinement (port of
instantsplat_tpu/cli/render.py).

  python -m instantsplat_tpu_torch.cli.render -s <scene> -m <out> \\
      --n_views 3 --iteration 1000 [--skip_train] [--skip_test] \\
      [--infer_video] [--test_fps]

The saved <out>/cfg_args fills in what the command line leaves out. Runs
on CUDA by default; `--device cpu` runs the plain PyTorch path.
"""

from __future__ import annotations

from argparse import ArgumentParser

from instantsplat_tpu_torch.pipelines import config as C
from instantsplat_tpu_torch.pipelines.render_pipeline import run_render


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="render trained scene")
    C.add_group(parser, C.ModelParams,
                abbrevs={"source_path": "s", "model_path": "m",
                         "images": "i", "resolution": "r",
                         "white_background": "w"})
    C.add_group(parser, C.PipelineParams)
    # the reference spells the flag --iterations; accept both
    parser.add_argument("--iteration", "--iterations", dest="iteration",
                        type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--infer_video", action="store_true")
    parser.add_argument("--optim_test_pose_iter", type=int, default=500)
    parser.add_argument("--test_fps", action="store_true")
    # views-data-parallel refinement over several devices: not ported yet
    parser.add_argument("--n_devices", type=int, default=0)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return parser


def main(argv=None):
    args = C.get_combined_args(build_parser(), argv)
    if args.n_devices:
        raise NotImplementedError(
            "--n_devices: pose refinement over several devices is not yet "
            "ported; run with --n_devices 0 (one device)")
    model = C.extract_group(args, C.ModelParams)
    it = run_render(
        model,
        iteration=args.iteration,
        skip_train=args.skip_train,
        skip_test=args.skip_test,
        infer_video=args.infer_video,
        optim_test_pose_iter=args.optim_test_pose_iter,
        test_fps=args.test_fps,
        backend=args.backend,
        device=args.device,
    )
    print(f"[render] done (iteration {it}) -> {model.model_path}")
    return it


if __name__ == "__main__":
    main()
