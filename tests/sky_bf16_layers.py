"""The SkyUNet's bf16 forward layer by layer, card against CPU.

A diagnostic of the port's bf16 convolutions, run on a machine with a
card (it imports no jax):

    python tests/sky_bf16_layers.py

On the draws of ``tests/test_torch_cuda_kernels.py::
test_train_step_on_card_matches_cpu`` (64x96, b=2, ``draw_scenes(...,
manual_seed(3))``) and the shipped weights, it prints one JSON line: for
each ConvBlock and the head, the largest difference between the card's and
the CPU's output relative to the CPU's largest magnitude, and each side's
loss (``cli.train.sky_batch_loss``), twice: with ``models.layers.Conv`` as
it is (the bias added to the convolution's bf16 result, as Flax adds it)
and with the bias fused into the convolution, one rounding (the port's form
before; oneDNN on the CPU rounds once there, cuDNN adds the bias after).
"""
import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mav_detection_tpu_torch.cli.train import sky_batch_loss  # noqa: E402
from mav_detection_tpu_torch.data.synthgen import draw_scenes, generate_batch  # noqa: E402
from mav_detection_tpu_torch.models import layers, pretrained  # noqa: E402
from mav_detection_tpu_torch.models.sky_segmentation import SkyUNet  # noqa: E402

BLOCKS = ("down1", "down2", "down3", "bottom", "up3", "up2", "up1", "head")


def fused_bias_forward(self, x, dtype):
    """``Conv.forward`` with the bias inside ``conv2d`` (one rounding)."""
    h, w = x.shape[-2:]
    top, bottom = layers.same_pads(h, self.k, self.stride)
    left, right = layers.same_pads(w, self.k, self.stride)
    x = F.pad(x.to(dtype), (left, right, top, bottom))
    return F.conv2d(x, self.weight.to(dtype), self.bias.to(dtype), self.stride)


def forward(dev, sc) -> tuple:
    """(per-block outputs on the CPU, the bf16 loss) of one forward on
    ``dev``."""
    model = SkyUNet()
    model.load_state_dict(pretrained.load_sky_params())
    model = model.to(dev)
    outs = {}
    hooks = [getattr(model, name).register_forward_hook(
        lambda m, a, o, name=name: outs.__setitem__(name, o.detach().float().cpu()))
        for name in BLOCKS]
    with torch.no_grad():
        loss = float(sky_batch_loss(model, sc, torch.bfloat16))
    for h in hooks:
        h.remove()
    return outs, loss


def compare(dev, ref=torch.device("cpu")) -> dict:
    """Both forms of the bias, ``dev`` against ``ref``."""
    draws = draw_scenes(2, 64, 96, generator=torch.Generator().manual_seed(3))
    res = {}
    for form in ("bias after the bf16 result", "bias fused"):
        patch = (mock.patch.object(layers.Conv, "forward", fused_bias_forward)
                 if form == "bias fused" else contextlib.nullcontext())
        with patch:
            (card, lc), (cpu, lh) = (
                forward(d, generate_batch(2, 64, 96, draws=draws, device=d))
                for d in (dev, ref))
        res[form] = {
            "loss_card": lc, "loss_cpu": lh, "loss_rel": abs(lc - lh) / abs(lh),
            "blocks_rel": {b: float((card[b] - cpu[b]).abs().max() / cpu[b].abs().max())
                           for b in BLOCKS}}
    return res


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from mav_detection_tpu_torch.utils.device import resolve_device

    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      **compare(resolve_device("cuda"))}))
