"""A scene's fixed cost in the window: its wall time up to the first log
(iteration 100, read by the host), less 100 iterations at the pace of
iterations 101-1000; the mean over the window's scenes after the first,
which runs traced, or the first where it is the only one (host clock)."""


def read(record):
    return record.get("prep_s")
