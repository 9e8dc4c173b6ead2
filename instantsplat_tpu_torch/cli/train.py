"""Stage-2 CLI: joint Gaussian + pose training on the GPU (port of
instantsplat_tpu/cli/train.py).

  python -m instantsplat_tpu_torch.cli.train -s <scene> -m <out> \\
      --n_views 3 --iterations 1000 --pp_optimizer --optim_pose

Runs on CUDA by default; `--device cpu` runs the plain PyTorch path.
`--test_iterations` runs the validation sweep over the train views at
those (logged) iterations; `--enable_viewer` serves live renders to a
SIBR viewer on `--ip`/`--port` (render/network_gui.py).

`--n_devices N` shards every render over N ranks (`--shard_axis pixels`
or `gaussians`; -1 = every local card): under torchrun N must equal
WORLD_SIZE (or be -1); otherwise the CLI spawns the N ranks itself
(parallel/launch.py). Rank r trains on cuda:r (NCCL), or on the CPU over
gloo with `--device cpu`; rank 0 writes the artifacts.

`--trace` switches the program's tracing on (utils/profiling.py: device
times of its spans, the device marks of each step's phases) and writes
`profiling.snapshot()` (spans, counters, phase table) to
`<model>/trace.json` when training ends.
"""

from __future__ import annotations

import json
from argparse import ArgumentParser
from pathlib import Path

from instantsplat_tpu_torch.parallel import launch, runtime
from instantsplat_tpu_torch.pipelines import config as C
from instantsplat_tpu_torch.pipelines.train_pipeline import run_training
from instantsplat_tpu_torch.pipelines.trainer import TrainerConfig
from instantsplat_tpu_torch.utils import profiling


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="joint Gaussian+pose training")
    C.add_group(parser, C.ModelParams,
                abbrevs={"source_path": "s", "model_path": "m",
                         "images": "i", "resolution": "r",
                         "white_background": "w"})
    C.add_group(parser, C.PipelineParams)
    C.add_opt_group(parser)
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--log_every", type=int, default=100)
    # renders sharded over several devices (0 or 1 = one device, -1 =
    # every local card)
    parser.add_argument("--n_devices", type=int, default=0)
    parser.add_argument("--shard_axis", choices=["pixels", "gaussians"],
                        default="pixels")
    # SIBR viewer (reference train.py:310: --disable_viewer defaults to
    # True; --enable_viewer serves live renders on --ip/--port)
    parser.add_argument("--enable_viewer", action="store_true")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--quiet", action="store_true")
    # the program's tracing on; its table written to <model>/trace.json
    parser.add_argument("--trace", action="store_true")
    # accepted for drop-in compatibility with reference train.py:305-310
    # and the JAX CLI, which ignore them too: documented no-ops
    parser.add_argument("--disable_viewer", action="store_true", default=True)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    world = launch.run_ranks("instantsplat_tpu_torch.cli.train", argv,
                             args.n_devices, args.device)
    if world is None:  # the spawned ranks ran the stage
        return None
    runtime.initialize_runtime(args.device)
    main_rank = runtime.is_main_process()
    model = C.extract_group(args, C.ModelParams)
    opt = C.make_opt_config(args)
    trainer = TrainerConfig(iterations=args.iterations,
                            white_background=model.white_background,
                            backend=args.backend, log_every=args.log_every,
                            n_devices=world, shard_axis=args.shard_axis)

    def progress(it, m):
        if not args.quiet:
            print(f"[train] iter {it}: loss={m['loss']:.5f} "
                  f"psnr={m['psnr']:.2f}", flush=True)

    if args.trace:
        profiling.enable(True)
    viewer = None
    if args.enable_viewer and main_rank:
        from instantsplat_tpu_torch.render.network_gui import NetworkGUI

        viewer = NetworkGUI()
        viewer.init(args.ip, args.port)
        print(f"[train] viewer listening on {args.ip}:{args.port}",
              flush=True)
    try:
        params, history = run_training(
            model, opt, trainer,
            save_iterations=args.save_iterations or None,
            checkpoint_iterations=args.checkpoint_iterations,
            progress_cb=progress,
            start_checkpoint=args.start_checkpoint,
            testing_iterations=args.test_iterations,
            viewer=viewer,
            device=args.device)
    finally:
        if viewer is not None:
            viewer.close()
    if args.trace and main_rank:
        path = Path(model.model_path) / "trace.json"
        path.write_text(json.dumps(profiling.snapshot()))
        print(f"[train] trace -> {path}")
    if main_rank:
        print(f"[train] done -> {model.model_path}")
    return params, history


if __name__ == "__main__":
    main()
