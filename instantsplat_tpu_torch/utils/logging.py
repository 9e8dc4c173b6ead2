"""Training scalars as JSONL and the validation sweep (port of
instantsplat_tpu/utils/logging.py): `ScalarLogger`, `training_report`
and `make_eval_fn`. The tags and steps are the JAX package's, so a
dashboard reads either package's scalars.jsonl."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch


class ScalarLogger:
    """JSONL scalar writer with an add_scalar-compatible interface: one
    `{"step", "tag", "value", "wall"}` object per line of scalars.jsonl."""

    def __init__(self, log_dir):
        self.path = Path(log_dir) / "scalars.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({
            "step": int(step), "tag": str(tag), "value": float(value),
            "wall": round(time.time() - self._t0, 3),
        }) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def training_report(logger: Optional[ScalarLogger], iteration: int,
                    metrics: dict, testing_iterations=(), eval_fn=None):
    """Log every train scalar under `train/<name>`; at the iterations of
    `testing_iterations` run the validation sweep, eval_fn() ->
    {split: (l1, psnr)}, and log `<split>/loss_viewpoint-{l1,psnr}`.
    Returns the sweep's results, or None when it did not run."""
    if logger is not None:
        for k, v in metrics.items():
            logger.add_scalar(f"train/{k}", v, iteration)
    if eval_fn is not None and iteration in set(testing_iterations):
        results = eval_fn()
        for name, (l1v, psnr_v) in results.items():
            print(f"\n[ITER {iteration}] Evaluating {name}: "
                  f"L1 {l1v:.5f} PSNR {psnr_v:.2f}")
            if logger is not None:
                logger.add_scalar(f"{name}/loss_viewpoint-l1", l1v,
                                  iteration)
                logger.add_scalar(f"{name}/loss_viewpoint-psnr", psnr_v,
                                  iteration)
        return results
    return None


def make_eval_fn(params_ref, cameras_by_split, backend="pallas"):
    """Validation closure over the latest params: `params_ref` is a
    1-element list the trainer keeps pointing at them. Renders camera i of
    each split with the learnable pose i, under no_grad, and returns
    {split: (mean L1, mean PSNR)} of the clipped renders."""
    from instantsplat_tpu_torch.ops.losses import l1_loss, psnr
    from instantsplat_tpu_torch.render.driver import render

    def eval_fn():
        params = params_ref[0]
        out = {}
        with torch.no_grad():
            for name, cams in cameras_by_split.items():
                if not cams:
                    continue
                l1s, psnrs = [], []
                for i, cam in enumerate(cams):
                    img = torch.clamp(render(
                        params, cam, pose=params.get_pose(i),
                        backend=backend).render, 0.0, 1.0)
                    gt = torch.clamp(cam.image, 0.0, 1.0)
                    l1s.append(float(l1_loss(img, gt)))
                    psnrs.append(float(psnr(img, gt)))
                out[name] = (float(np.mean(l1s)), float(np.mean(psnrs)))
        return out

    return eval_fn
