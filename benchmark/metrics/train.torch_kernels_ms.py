"""Device ms an iteration, in the traced last whole log block, of every
device operation that no directory under layers/ claims: PyTorch's own
kernels of the front end, SSIM + L1 and Adam, and copies (device
trace)."""


def read(record):
    if not record.get("block_iterations"):
        return None
    claimed = sum(s["block"] for s in record["layer_s"].values())
    return (record["block_device_s"] - claimed) * 1e3 / record[
        "block_iterations"]
