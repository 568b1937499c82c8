"""Device resolution for the port's entry points.

Entry points run on the card: ``device=None`` means CUDA, and raises when
no card is present.  Only an explicit ``device="cpu"`` (the CPU tests) runs
on the host.  Nothing here moves work to the CPU by itself.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); else the given device.

    A CUDA device also turns TF32 off for matmuls and cuDNN: the f32 path
    (patch-embed Conv2d, the 3³ Conv3d, the ConvTranspose3d) must run in
    true f32, and cuDNN defaults to TF32 for convolutions.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's entry points run on the card; "
                "pass device='cpu' explicitly to run on the host"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
