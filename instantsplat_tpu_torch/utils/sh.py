"""Real spherical-harmonics constants (degrees 0..4) and RGB <-> DC SH.

Port of instantsplat_tpu/utils/sh.py: the same constants, so ply SH
coefficients round-trip between the two packages.
"""

from __future__ import annotations

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(deg: int) -> int:
    return (deg + 1) ** 2


def rgb_to_sh(rgb):
    """RGB in [0,1] -> DC SH coefficient."""
    return (rgb - 0.5) / C0
