"""Inference orchestrator: init_geo (video) -> train -> interpolated video
(port of scripts/run_infer.py; reference scripts/run_infer.sh:50-83).

Every image is a training view (no split), and the render stage writes the
spline-interpolated novel-view video. Each stage is a subprocess running
the port's CLI with `--device <device>`; its log is under <out>/logs/. A
failed stage ends its scene's chain, and the command exits 1 unless every
scene succeeded.

  python -m instantsplat_tpu_torch.cli.run_infer --data <root> \\
      --out <out> --scenes <s...> --n_views N --ckpt_path <mast3r.pth>
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from instantsplat_tpu_torch.cli.run_eval import CLI, run_stage


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="inference chain")
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--scenes", nargs="+", required=True)
    ap.add_argument("--n_views", type=int, default=3)
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--ckpt_path", default="")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="passed to every stage")
    return ap


def scene_stages(args, scene):
    """[(argv, log name)] of one scene's chain, in order."""
    py = [sys.executable, "-m"]
    src = Path(args.data) / scene
    out = Path(args.out) / scene / f"{args.n_views}_views"
    nv, it = str(args.n_views), str(args.iterations)
    dev = ["--device", args.device]
    return out / "logs", [
        (py + [CLI + "init_geo", "-s", str(src), "-m", str(out),
               "--n_views", nv, "--ckpt_path", args.ckpt_path,
               "--focal_avg", "--infer_video"] + dev, "01_init_geo.log"),
        (py + [CLI + "train", "-s", str(src), "-m", str(out), "--n_views",
               nv, "--iterations", it, "--pp_optimizer", "--optim_pose"]
         + dev, "02_train.log"),
        (py + [CLI + "render", "-s", str(src), "-m", str(out), "--n_views",
               nv, "--iteration", it, "--skip_test", "--infer_video"]
         + dev, "03_render_video.log"),
    ]


def main(argv=None):
    args = build_parser().parse_args(argv)
    n_ok = 0
    for scene in args.scenes:
        logs, stages = scene_stages(args, scene)
        ok = all(run_stage(cmd, logs / name) for cmd, name in stages)
        n_ok += ok
        print(f"== {scene}: {'DONE' if ok else 'FAILED'} ==", flush=True)
    sys.exit(0 if n_ok == len(args.scenes) else 1)


if __name__ == "__main__":
    main()
