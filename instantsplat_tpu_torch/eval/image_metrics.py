"""Image quality metrics: PSNR, SSIM and LPIPS (VGG) (port of
instantsplat_tpu/eval/image_metrics.py).

PSNR and SSIM are the training ones (ops/losses.py, ops/ssim.py).

LPIPS reproduces the reference lpipsPyTorch module: z-score the inputs
with the LPIPS shift and scale, run the VGG16 feature trunk (13 3x3 convs
with zero 'SAME' padding and ReLU, 2x2 max-pools), tap relu1_2, 2_2, 3_3,
4_3 and 5_3 (after convs 1, 3, 6, 9 and 12), unit-normalise each tap over
its channels (norm + 1e-10), square the difference, apply the learned 1x1
linear heads (no bias), take the spatial mean and sum over the taps.
Images are [H, W, 3] in [0, 1].

The convolutions run in full float32: on a card cuDNN would otherwise
compute them in TF32 (`torch.backends.cudnn.allow_tf32` is True by
default), which keeps about three decimal digits.

Weights: none ship with the repository. `LpipsVGG.from_torch_files` loads
torchvision's vgg16 `features.N.weight` and the richzhang v0.1 heads
`lin{i}.model.1.weight`, both already OIHW, and `lpips()` raises when no
weights were given or set as the default. The metrics stage then reports
`LPIPS: null`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instantsplat_tpu_torch.ops.losses import psnr  # noqa: F401 (re-export)
from instantsplat_tpu_torch.ops.ssim import ssim  # noqa: F401 (re-export)

# VGG16 feature-extractor conv plan up to relu5_3: (out_channels, pool?)
_VGG_PLAN = [
    (64, False), (64, True),
    (128, False), (128, True),
    (256, False), (256, False), (256, True),
    (512, False), (512, False), (512, True),
    (512, False), (512, False), (512, False),
]
# conv indices (0-based into _VGG_PLAN) after which a relu is tapped
_TAPS = [1, 3, 6, 9, 12]
_N_CHANNELS = [64, 128, 256, 512, 512]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)
# conv indices in torchvision's vgg16 `features` Sequential
_TORCHVISION_CONVS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


@contextlib.contextmanager
def _full_float32():
    """cuDNN convolutions in IEEE float32, not TF32, inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class LpipsVGG(nn.Module):
    """VGG16 conv trunk + LPIPS linear heads; weights OIHW."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 3
        for cout, _ in _VGG_PLAN:
            convs.append(nn.Conv2d(cin, cout, 3, padding=1))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ModuleList(
            nn.Conv2d(c, 1, 1, bias=False) for c in _N_CHANNELS)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    @classmethod
    def from_arrays(cls, conv_w, conv_b, lin_w, device="cuda") -> "LpipsVGG":
        """conv_w [cout, cin, 3, 3], conv_b [cout] (13 each) and lin_w
        [1, c, 1, 1] (5) arrays, OIHW."""
        model = cls()
        with torch.no_grad():
            for conv, w, b in zip(model.convs, conv_w, conv_b, strict=True):
                conv.weight.copy_(torch.tensor(np.array(w, np.float32)))
                conv.bias.copy_(torch.tensor(np.array(b, np.float32)))
            for lin, w in zip(model.lins, lin_w, strict=True):
                lin.weight.copy_(torch.tensor(np.array(w, np.float32)))
        return model.to(device).eval().requires_grad_(False)

    @classmethod
    def from_torch_files(cls, vgg_path, lin_path, device="cuda"):
        """torchvision vgg16 features + richzhang v0.1 vgg.pth heads."""
        vgg_sd = torch.load(vgg_path, map_location="cpu", weights_only=True)
        if hasattr(vgg_sd, "state_dict"):
            vgg_sd = vgg_sd.state_dict()
        conv_w, conv_b = [], []
        for li in _TORCHVISION_CONVS:
            for key in (f"features.{li}.weight", f"{li}.weight"):
                if key in vgg_sd:
                    conv_w.append(vgg_sd[key].numpy())
                    conv_b.append(vgg_sd[key.replace("weight",
                                                     "bias")].numpy())
                    break
            else:
                raise KeyError(f"vgg conv {li} not found in {vgg_path}")
        lin_sd = torch.load(lin_path, map_location="cpu", weights_only=True)
        lin_w = []
        for i in range(len(_TAPS)):
            for key in (f"lin{i}.model.1.weight", f"{i}.1.weight",
                        f"lin.{i}.1.weight"):
                if key in lin_sd:
                    lin_w.append(lin_sd[key].numpy())
                    break
            else:
                raise KeyError(f"lin head {i} not found in {lin_path}")
        return cls.from_arrays(conv_w, conv_b, lin_w, device=device)

    @classmethod
    def random(cls, seed=0, device="cuda") -> "LpipsVGG":
        """Random weights (architecture and parity checks only): the same
        numbers as the JAX package's LpipsVGG.random(seed)."""
        rng = np.random.default_rng(seed)
        conv_w, conv_b, cin = [], [], 3
        for cout, _ in _VGG_PLAN:
            w = (rng.standard_normal((3, 3, cin, cout)).astype(np.float32)
                 * np.sqrt(2.0 / (9 * cin)))
            conv_w.append(w.transpose(3, 2, 0, 1))
            conv_b.append(np.zeros(cout, np.float32))
            cin = cout
        lin_w = [rng.random((1, 1, c, 1)).astype(np.float32)
                 .transpose(3, 2, 0, 1) for c in _N_CHANNELS]
        return cls.from_arrays(conv_w, conv_b, lin_w, device=device)

    def _features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x [N, 3, H, W] z-scored -> unit-normalised taps."""
        out, h = [], x
        for i, conv in enumerate(self.convs):
            h = F.relu(conv(h))
            if i in _TAPS:
                norm = torch.sqrt(torch.sum(h * h, dim=1, keepdim=True))
                out.append(h / (norm + 1e-10))
            if _VGG_PLAN[i][1]:
                h = F.max_pool2d(h, 2, 2)
        return out

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """LPIPS distance (0-dim) between [H, W, 3] images in [0, 1]."""
        def prep(img):
            return (img.permute(2, 0, 1)[None] - self.shift) / self.scale

        with _full_float32():
            total = 0.0
            for a, b, lin in zip(self._features(prep(x)),
                                 self._features(prep(y)), self.lins):
                total = total + torch.mean(lin((a - b) ** 2), dim=(1, 2, 3))
        return total[0]


_DEFAULT: Optional[LpipsVGG] = None


def set_default_lpips(model: Optional[LpipsVGG]):
    global _DEFAULT
    _DEFAULT = model


def default_lpips() -> Optional[LpipsVGG]:
    return _DEFAULT


def lpips(x: torch.Tensor, y: torch.Tensor,
          model: Optional[LpipsVGG] = None) -> torch.Tensor:
    """LPIPS of two [H, W, 3] images in [0, 1] with `model`, else the
    default set by set_default_lpips; raises when there is neither."""
    model = model if model is not None else _DEFAULT
    if model is None:
        raise RuntimeError(
            "LPIPS weights unavailable: none ship with the repository. "
            "Load them with LpipsVGG.from_torch_files(vgg16 features, "
            "lpips vgg.pth) and pass them or set_default_lpips(...).")
    with torch.no_grad():
        return model(x, y)
