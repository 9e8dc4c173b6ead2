"""Demo CLI: reconstruct a scene (if needed) and export viewable 3D
artifacts (port of instantsplat_tpu/cli/demo.py; reference
mast3r/demo.py:111-189 `get_3D_model_from_scene` +
`get_reconstructed_scene`, which serves a glb of pointcloud + camera
frusta through gradio; here the artifacts are written to disk and any
glTF viewer plays the demo widget's part):

  python -m instantsplat_tpu_torch.cli.demo -s <scene_dir> --n_views 3 \\
      [--ckpt_path mast3r.pth] [--outdir <dir>] [--cam_size 0.05]

Outputs under <outdir> (default <scene_dir>/demo_<n>):
  scene.glb     pointcloud + camera frusta (binary glTF 2.0)
  scene.ply     colored points
  preview.png   matplotlib 3D snapshot (skipped, with a printed line,
                where matplotlib is missing)

When sparse_{n}/0 is missing, the port's cli.init_geo runs first. Runs
on CUDA by default and raises without a card; `--device cpu` runs on the
CPU.
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

import numpy as np


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="export demo 3D artifacts")
    parser.add_argument("-s", "--source_path", required=True)
    parser.add_argument("--n_views", type=int, default=3)
    parser.add_argument("--ckpt_path", default="",
                        help="MASt3R checkpoint; triggers init_geo when "
                             "the scene has no sparse_{n} yet")
    parser.add_argument("--outdir", default="")
    parser.add_argument("--cam_size", type=float, default=0.0,
                        help="frustum size (0 = auto, demo.py:116)")
    parser.add_argument("--max_points", type=int, default=500_000)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return parser


def main(argv=None):
    from instantsplat_tpu_torch import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    src = Path(args.source_path)
    sparse = src / f"sparse_{args.n_views}" / "0"
    if not sparse.exists():
        if not args.ckpt_path:
            raise SystemExit(
                f"{sparse} missing and no --ckpt_path given: run "
                "instantsplat_tpu_torch.cli.init_geo first or pass a "
                "checkpoint")
        from instantsplat_tpu_torch.cli.init_geo import main as init_geo_main

        init_geo_main(["-s", str(src), "-m", str(src / "demo_model"),
                       "--n_views", str(args.n_views),
                       "--ckpt_path", args.ckpt_path, "--focal_avg",
                       "--device", args.device])

    from instantsplat_tpu_torch.data import scene as scene_io
    from instantsplat_tpu_torch.eval.viz import SceneViz, auto_cam_size

    info = scene_io.read_scene(src, args.n_views, split="train",
                               load_images=False, device=device)
    poses_c2w = np.stack([np.linalg.inv(m) for m in info.poses_w2c])
    cam_size = args.cam_size or auto_cam_size(poses_c2w)

    viz = SceneViz()
    pts, cols = info.points, info.colors
    if len(pts) > args.max_points:
        sel = np.random.default_rng(0).choice(
            len(pts), args.max_points, replace=False)
        pts, cols = pts[sel], cols[sel]
    viz.add_pointcloud(pts, cols)
    focals = [float(c.fx) for c in info.cameras]
    imsizes = [(int(c.width), int(c.height)) for c in info.cameras]
    viz.add_cameras(poses_c2w, focals=focals, imsizes=imsizes,
                    cam_size=cam_size)

    outdir = Path(args.outdir or src / f"demo_{args.n_views}")
    outdir.mkdir(parents=True, exist_ok=True)
    glb = viz.export_glb(outdir / "scene.glb")
    ply = viz.export_ply(outdir / "scene.ply")
    try:
        png = viz.show(outdir / "preview.png")
    except Exception as e:  # noqa: BLE001 - a missing or broken
        # matplotlib must not fail the export; the skip is printed
        png = None
        print(f"[demo] preview skipped: {e}")
    print(f"demo artifacts: {glb}  {ply}" + (f"  {png}" if png else ""))
    return outdir


if __name__ == "__main__":
    main()
