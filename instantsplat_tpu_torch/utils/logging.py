"""Training scalars as JSONL (port of instantsplat_tpu/utils/logging.py:
`ScalarLogger` and `training_report`)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


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
                    metrics: dict):
    """Log every train scalar under `train/<name>`."""
    if logger is not None:
        for k, v in metrics.items():
            logger.add_scalar(f"train/{k}", v, iteration)
