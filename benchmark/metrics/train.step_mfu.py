"""The whole step's share of the float32 peak in the traced scene's last
block: counts/gs_step.py's operations of its iterations over the block's
wall time (between two synchronisations)."""


def read(record):
    if not record.get("block_s"):
        return None
    return (100.0 * record["block_flops"] / record["block_s"]
            / record["peaks"]["fp32_flops"])
