"""Stage-3/4 CLI: render the train, test and interpolated views of a
trained model, with test-time pose refinement (port of
instantsplat_tpu/cli/render.py).

  python -m instantsplat_tpu_torch.cli.render -s <scene> -m <out> \\
      --n_views 3 --iteration 1000 [--skip_train] [--skip_test] \\
      [--infer_video] [--test_fps]

The saved <out>/cfg_args fills in what the command line leaves out. Runs
on CUDA by default; `--device cpu` runs the plain PyTorch path.
`--n_devices N` refines the test views' poses over N ranks (-1 = every
local card; spawned here unless under torchrun, parallel/launch.py); rank
0 writes the renders.
"""

from __future__ import annotations

from argparse import ArgumentParser

from instantsplat_tpu_torch.parallel import launch, runtime
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
    # views-data-parallel test-pose refinement (0 or 1 = one device, -1 =
    # every local card)
    parser.add_argument("--n_devices", type=int, default=0)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return parser


def main(argv=None):
    args = C.get_combined_args(build_parser(), argv)
    world = launch.run_ranks("instantsplat_tpu_torch.cli.render", argv,
                             args.n_devices, args.device)
    if world is None:  # the spawned ranks ran the stage
        return None
    runtime.initialize_runtime(args.device)
    mesh = None
    if world > 1:
        from instantsplat_tpu_torch.parallel import make_mesh

        mesh = make_mesh(world)
        if runtime.is_main_process():
            print(f"[render] views-DP pose refinement over {world} devices",
                  flush=True)
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
        mesh=mesh,
    )
    if runtime.is_main_process():
        print(f"[render] done (iteration {it}) -> {model.model_path}")
    return it


if __name__ == "__main__":
    main()
