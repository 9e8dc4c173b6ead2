"""Stage-5 CLI: image and pose metrics (port of
instantsplat_tpu/cli/metrics.py).

  python -m instantsplat_tpu_torch.cli.metrics -m <out> -s <scene> \\
      --n_views 3

Runs on CUDA by default; `--device cpu` computes on the CPU.
"""

from __future__ import annotations

from argparse import ArgumentParser

from instantsplat_tpu_torch.pipelines.metrics_pipeline import run_metrics


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="evaluate renders + poses")
    parser.add_argument("--model_paths", "-m", nargs="+", required=True)
    parser.add_argument("--source_path", "-s", type=str, default=None)
    parser.add_argument("--n_views", type=int, default=None)
    parser.add_argument("--no_pose", action="store_true")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    results = run_metrics(args.model_paths, source_path=args.source_path,
                          n_views=args.n_views, eval_pose=not args.no_pose,
                          device=args.device)
    for scene, methods in results.items():
        for method, vals in methods.items():
            print(f"[metrics] {scene} / {method}: {vals}")
    return results


if __name__ == "__main__":
    main()
