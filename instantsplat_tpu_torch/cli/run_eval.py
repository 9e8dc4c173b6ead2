"""Evaluation orchestrator: the five-stage chain over a list of scenes
(port of scripts/run_eval.py; reference scripts/run_eval.sh:56-165).

Per scene: init_geo -> train -> render(train) -> render(test, pose
refinement) -> metrics, each stage a subprocess running the port's CLI
(`python -m instantsplat_tpu_torch.cli.<stage> ... --device <device>`),
with its log under <out>/logs/ (01_init_geo.log .. 05_metrics.log). A
failed stage ends its scene's chain; the command exits 1 unless every
scene succeeded.

`--jobs N` runs up to N scene chains at once, each pinned to one card of
the slot pool through CUDA_VISIBLE_DEVICES (slot_environment). With
`--jobs 1` (the default) the environment passes through untouched. On a
machine with one card, `--jobs` above 1 points the later slots at cards
that do not exist, and their stages fail: the pool is the parent's
CUDA_VISIBLE_DEVICES list, or the card indices 0 .. N-1.

  python -m instantsplat_tpu_torch.cli.run_eval --data <root> \\
      --out <root_out> --dataset Tanks --scenes Barn Family --n_views 3 \\
      --ckpt_path <mast3r.pth> [--iterations 1000] [--jobs 4]
"""

from __future__ import annotations

import argparse
import os
import queue
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CLI = "instantsplat_tpu_torch.cli."


def run_stage(cmd, log_path, env=None, timeout=None, retries=0):
    """Run one pipeline stage with its output in `log_path`; with
    `timeout`, kill a stage that runs longer and run it again, up to
    `retries` times. -> True when the stage exited 0."""
    log_path.parent.mkdir(parents=True, exist_ok=True)
    for attempt in range(retries + 1):
        mode = "w" if attempt == 0 else "a"
        with open(log_path, mode) as log:
            t0 = time.time()
            print(f">> {' '.join(cmd)}"
                  + (f" (retry {attempt})" if attempt else ""), flush=True)
            try:
                ret = subprocess.run(cmd, stdout=log,
                                     stderr=subprocess.STDOUT, env=env,
                                     timeout=timeout)
                rc = ret.returncode
            except subprocess.TimeoutExpired:
                rc = -1
                log.write(f"\n== stage timeout after {timeout}s ==\n")
            dt = time.time() - t0
            print(f"   -> {'ok' if rc == 0 else 'FAIL'} "
                  f"({dt:.1f}s, log: {log_path})", flush=True)
            if rc == 0:
                return True
    return False


def slot_environment(slot: int, n_jobs: int) -> dict:
    """Subprocess environment pinning a scene job to one card.

    The reference binds each scene to a free GPU with CUDA_VISIBLE_DEVICES
    (run_eval.sh:52-55). A parent-set CUDA_VISIBLE_DEVICES is a pool to
    index into, not a binding to inherit: inheriting it verbatim would pin
    every concurrent job to the same card(s). With one job the
    environment passes through untouched."""
    env = os.environ.copy()
    if n_jobs > 1:
        pool = env.get("CUDA_VISIBLE_DEVICES")
        if pool:
            visible = [d.strip() for d in pool.split(",") if d.strip()]
            env["CUDA_VISIBLE_DEVICES"] = visible[slot % len(visible)]
        else:
            env["CUDA_VISIBLE_DEVICES"] = str(slot)
    return env


def schedule_scenes(scene_fns, n_jobs):
    """Run scene thunks, at most `n_jobs` at once, each holding one slot id
    from a free pool for its whole stage chain (the scheduler of
    run_eval.sh:145-165 without its 60 s polling loop).

    scene_fns: list of callables f(slot: int) -> bool. Returns the results
    in input order."""
    if n_jobs <= 1:
        return [fn(0) for fn in scene_fns]
    slots: queue.Queue = queue.Queue()
    for s in range(n_jobs):
        slots.put(s)
    results = [None] * len(scene_fns)

    def run(i):
        slot = slots.get()
        try:
            results[i] = scene_fns[i](slot)
        finally:
            slots.put(slot)

    with ThreadPoolExecutor(max_workers=n_jobs) as ex:
        list(ex.map(run, range(len(scene_fns))))
    return results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="five-stage evaluation chain")
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--dataset", default="")
    ap.add_argument("--scenes", nargs="+", required=True)
    ap.add_argument("--n_views", type=int, default=3)
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--ckpt_path", default="")
    ap.add_argument("--max_pts", type=int, default=0,
                    help="cap the fused cloud at this many points "
                         "(confidence-weighted downsample; 0 = no cap — "
                         "reference sfm_utils.py:250 max_pts_num)")
    ap.add_argument("--skip_init", action="store_true",
                    help="scene dirs already contain sparse_{n}")
    ap.add_argument("--jobs", type=int, default=1,
                    help="concurrent scenes (one card slot each)")
    ap.add_argument("--n_devices", type=int, default=0,
                    help="shard ONE scene over this many cards (pair-DP "
                         "init_geo, sharded train renders, views-DP test "
                         "refinement; -1 = every local card)")
    ap.add_argument("--optim_test_pose_iter", type=int, default=500,
                    help="test-time pose refinement iterations per view "
                         "(reference render.py:260)")
    ap.add_argument("--stage_timeout", type=int, default=0,
                    help="kill and retry (once) any stage exceeding this "
                         "many seconds (0 = no watchdog)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="passed to every stage")
    return ap


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def scene_stages(args, scene):
    """[(argv, log name)] of one scene's chain, in order."""
    py = [sys.executable, "-m"]
    src = Path(args.data) / args.dataset / scene / "24_views"
    if not src.exists():
        src = Path(args.data) / args.dataset / scene
    out = Path(args.out) / args.dataset / scene / f"{args.n_views}_views"
    nv, it = str(args.n_views), str(args.iterations)
    dev = ["--device", args.device]
    # as scripts/run_eval.py: init_geo, train and the test render shard
    shard = ["--n_devices", str(args.n_devices)] if args.n_devices else []
    stages = []
    if not args.skip_init:
        stages.append((
            py + [CLI + "init_geo", "-s", str(src), "-m", str(out),
                  "--n_views", nv, "--ckpt_path", args.ckpt_path,
                  "--focal_avg", "--co_vis_dsp", "--conf_aware_ranking"]
            + (["--max_pts", str(args.max_pts)] if args.max_pts else [])
            + shard + dev, "01_init_geo.log"))
    stages += [
        (py + [CLI + "train", "-s", str(src), "-m", str(out), "--n_views",
               nv, "--iterations", it, "--pp_optimizer", "--optim_pose"]
         + shard + dev, "02_train.log"),
        (py + [CLI + "render", "-s", str(src), "-m", str(out), "--n_views",
               nv, "--iteration", it, "--skip_test"] + dev,
         "03_render_train.log"),
        (py + [CLI + "render", "-s", str(src), "-m", str(out), "--n_views",
               nv, "--iteration", it, "--skip_train", "--eval",
               "--test_fps", "--optim_test_pose_iter",
               str(args.optim_test_pose_iter)] + shard + dev,
         "04_render_test.log"),
        (py + [CLI + "metrics", "-m", str(out), "-s", str(src), "--n_views",
               nv] + dev, "05_metrics.log"),
    ]
    return out / "logs", stages


def main(argv=None):
    args = parse_args(argv)

    def make_scene_fn(scene):
        def run_scene(slot: int) -> bool:
            env = slot_environment(slot, args.jobs)
            watchdog = dict(timeout=args.stage_timeout or None,
                            retries=1 if args.stage_timeout else 0)
            logs, stages = scene_stages(args, scene)
            ok = all(run_stage(cmd, logs / name, env=env, **watchdog)
                     for cmd, name in stages)
            print(f"== {scene}: {'DONE' if ok else 'FAILED'} ==", flush=True)
            return ok

        return run_scene

    results = schedule_scenes(
        [make_scene_fn(s) for s in args.scenes], args.jobs)
    n_ok = sum(bool(r) for r in results)
    print(f"== {n_ok}/{len(results)} scenes succeeded ==", flush=True)
    sys.exit(0 if n_ok == len(results) else 1)


if __name__ == "__main__":
    main()
