"""Device resolution for the port's entry points.

Entry points default to the card. Asking for ``"cuda"`` without one raises:
nothing carries on on the CPU unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Validate ``device`` and, for the card, pin fp32 matmuls to full fp32.

    The reference runs every Farneback matmul at ``precision="highest"``; on
    Hopper a float32 product may otherwise run in TF32 (about three decimal
    digits). Both switches are set off here, for matmuls and for cuDNN.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
