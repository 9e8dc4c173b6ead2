"""The card: its published peaks, what nvidia-smi reads of it, and the
check that no JAX module came into the process."""

from __future__ import annotations

import subprocess
import sys

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAKS = {
    "H100": {"fp32_flops": 67e12, "bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}
FORBIDDEN = ("jax", "jaxlib", "flax", "instantsplat_tpu")


def peaks(device_name: str) -> dict:
    for key, table in PEAKS.items():
        if key in device_name:
            return table
    raise KeyError(f"no published peaks for {device_name!r}")


def smi() -> str:
    """name, power limit, SM clock, power draw and temperature, as
    nvidia-smi reads them (or why it could not)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))
