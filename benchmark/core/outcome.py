"""What an entry hands back to run.py after one run of a cell."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Outcome:
    end_to_end: dict  # end-to-end metric name -> value (untraced run)
    record: dict  # raw readings the per-layer readers take (traced run)
    attempted: int  # scenes or steps the window ran
    failed: int
    checks: list  # (name, value, limit) of the comparison with the reference
    memory_peak_bytes: int
    busy_s: Optional[float] = None  # traced run: device busy seconds
    window_s: Optional[float] = None  # traced run: the traced window
    breakdown: Optional[dict] = None

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(v == v and v <= lim for _, v, lim in self.checks))
