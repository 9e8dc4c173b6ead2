"""The share of the traced last whole log block (graph replays between
two synchronisations) in which no operation ran on the device
(torch.profiler)."""


def read(record):
    if not record.get("block_s"):
        return None
    return 100.0 * (1.0 - record["block_busy_s"] / record["block_s"])
