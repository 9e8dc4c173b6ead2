"""The compositor's share of its roofline in the traced scene's last
block: the least time (the counted operations over the float32 peak, or
the counted bytes over the HBM peak, whichever is larger) over the
compositor kernels' device time. The count is counts/gs_step.py's, on
the contributing pairs of the block's views at the block's start."""


def read(record):
    if not record.get("layer_s", {}).get("compositor", {}).get("block"):
        return None
    pk = record["peaks"]
    least = max(record["block_compositor_ops"] / pk["fp32_flops"],
                record["block_compositor_bytes"] / pk["hbm_bytes"])
    return 100.0 * least / record["layer_s"]["compositor"]["block"]
