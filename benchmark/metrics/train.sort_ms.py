"""Device ms an iteration of the sort kernels (the depth sort, the list
build's key sort; named in layers/sort/) in the traced last whole log
block."""


def read(record):
    if not record.get("block_iterations"):
        return None
    return record["layer_s"]["sort"]["block"] * 1e3 / record["block_iterations"]
