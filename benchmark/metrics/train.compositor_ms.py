"""Device ms an iteration of the compositor kernels (KR, K1-K6, named in
layers/compositor/) in the traced last whole log block."""


def read(record):
    if not record.get("block_iterations"):
        return None
    return (record["layer_s"]["compositor"]["block"] * 1e3
            / record["block_iterations"])
