"""The share of the traced scene's first window (its start to the first
log at iteration 100: read, KNN, the auto probe, captures) in which no
operation ran on the device (torch.profiler)."""


def read(record):
    if not record.get("prep_window_s"):
        return None
    return 100.0 * (1.0 - record["prep_busy_s"] / record["prep_window_s"])
