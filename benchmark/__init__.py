"""The benchmark of instantsplat_tpu_torch on an NVIDIA H100 (see README.md)."""
