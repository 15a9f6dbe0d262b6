"""Sky segmentation UNet (``mav_detection_tpu.models.sky_segmentation``):
binary sky masks for ``Dataset.get_sky_segmentation`` where a sequence has
no precomputed HRNet mask.

NCHW throughout. The 2x nearest upsample of the decoder is a repeat of each
pixel (``jax.image.resize(..., "nearest")`` at an exact 2x), the pooling is
2x2/2 VALID, and ``sky_mask`` edge-pads the frame to a multiple of 8 and
crops the logits back. The frame goes in as the dataset gives it (BGR
uint8): the checkpoint was trained on that.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mav_detection_tpu_torch.models.layers import Conv, GroupNorm, init_params
from mav_detection_tpu_torch.utils.device import resolve_device


class ConvBlock(nn.Module):
    """Two (3x3 conv, GroupNorm, relu) stages."""

    def __init__(self, cin: int, features: int) -> None:
        super().__init__()
        groups = min(8, features)
        self.conv1 = Conv(cin, features, 3)
        self.norm1 = GroupNorm(groups, features)
        self.conv2 = Conv(features, features, 3)
        self.norm2 = GroupNorm(groups, features)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x, dtype), dtype))
        return F.relu(self.norm2(self.conv2(x, dtype), dtype))


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class SkyUNet(nn.Module):
    """(b, 3, h, w) image, h and w multiples of 8 -> (b, h, w) sky logits."""

    def __init__(self, base: int = 24) -> None:
        super().__init__()
        self.down1 = ConvBlock(3, base)
        self.down2 = ConvBlock(base, base * 2)
        self.down3 = ConvBlock(base * 2, base * 4)
        self.bottom = ConvBlock(base * 4, base * 8)
        self.up3 = ConvBlock(base * 12, base * 4)
        self.up2 = ConvBlock(base * 6, base * 2)
        self.up1 = ConvBlock(base * 3, base)
        self.head = Conv(base, 1, 1)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        x = x.to(torch.float32) / 127.5 - 1.0
        c1 = self.down1(x, dtype)
        c2 = self.down2(F.max_pool2d(c1, 2), dtype)
        c3 = self.down3(F.max_pool2d(c2, 2), dtype)
        c4 = self.bottom(F.max_pool2d(c3, 2), dtype)
        c5 = self.up3(torch.cat([_up2(c4), c3], 1), dtype)
        c6 = self.up2(torch.cat([_up2(c5), c2], 1), dtype)
        c7 = self.up1(torch.cat([_up2(c6), c1], 1), dtype)
        return self.head(c7, torch.float32)[:, 0]


def sky_logits(model: SkyUNet, images: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(b, h, w, 3) frames on the model's device -> (b, h, w) logits; edge
    pads to multiples of 8 and crops back."""
    b, h, w = images.shape[:3]
    x = images.permute(0, 3, 1, 2).to(torch.float32)
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode="replicate")
    with torch.no_grad():
        return model(x, dtype)[:, :h, :w]


def sky_mask(model: SkyUNet, image: Union[np.ndarray, torch.Tensor],
             device: Union[str, torch.device] = "cuda",
             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(h, w, 3) frame -> (h, w) bool sky mask on ``device``, where the
    model's weights must lie."""
    dev = resolve_device(device)
    if model.head.weight.device.type != dev.type:
        raise ValueError(f"sky_mask on {dev}: the model's weights are on "
                         f"{model.head.weight.device}")
    img = torch.as_tensor(np.asarray(image) if not isinstance(image, torch.Tensor)
                          else image).to(dev)
    return sky_logits(model, img[None], dtype)[0] > 0.0


def create_sky_model(generator: Optional[torch.Generator] = None) -> SkyUNet:
    """A SkyUNet with Flax's default initialisers drawn from ``generator``
    (seed 0 when none is given), on the CPU."""
    model = SkyUNet()
    init_params(model, generator if generator is not None
                else torch.Generator().manual_seed(0))
    return model


def sky_loss(model: SkyUNet, images: torch.Tensor, mask_gt: torch.Tensor,
             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The reference's balanced sigmoid cross-entropy of each example:
    (b, h, w, 3) images in [0, 255] (h, w multiples of 8) and (b, h, w) sky
    masks -> (b,) losses. Positives and negatives each weigh 1 / their
    count (at least 1)."""
    logits = model(images.permute(0, 3, 1, 2), dtype)
    labels = mask_gt.to(torch.float32)
    per_px = (torch.clamp(logits, min=0) - logits * labels
              + torch.log1p(torch.exp(-torch.abs(logits))))
    pos = torch.clamp(labels.sum(dim=(1, 2), keepdim=True), min=1.0)
    neg = torch.clamp((1 - labels).sum(dim=(1, 2), keepdim=True), min=1.0)
    w = labels / pos + (1 - labels) / neg
    return torch.sum(per_px * w, dim=(1, 2))
