"""LPIPS perceptual metric (VGG16 / AlexNet feature backbones), PyTorch.

Port of ``generativedensification_tpu/eval/lpips.py``: the input shifted
and scaled by the lpips ScalingLayer constants, the backbone's feature maps
at the standard taps (VGG16 relu1_2, relu2_2, relu3_3, relu4_3, relu5_3;
AlexNet's five convs), each unit-normalized over its channels, the squared
difference weighted by the 1x1 non-negative calibration head, its spatial
mean, summed over the taps.  The convolutions are
``torch.nn.functional.conv2d`` (the JAX package computes them with
``lax.conv``, no Pallas kernel).

Weights come from an .npz in the JAX package's key layout, written by
``tools/convert_lpips.py``: ``conv{i}/kernel`` (kh, kw, I, O), transposed
here to torch's (O, I, kh, kw), ``conv{i}/bias``, ``lin{i}/kernel`` (C,),
``shift`` / ``scale`` (3,).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
# conv indices (counting convs only) after whose relu features are tapped
_VGG_TAPS = (1, 3, 6, 9, 12)

_ALEX_CFG = [
    # (out, kernel, stride, pad)
    (64, 11, 4, 2),
    ("M",),
    (192, 5, 1, 2),
    ("M",),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
N_TAPS = 5


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


def _layers(net: str):
    """(kind, stride, pad, tapped) per layer: 'conv' or 'pool'."""
    if net == "vgg":
        out, ci = [], 0
        for v in _VGG_CFG:
            if v == "M":
                out.append(("pool", 0, 0, False))
            else:
                out.append(("conv", 1, 1, ci in _VGG_TAPS))
                ci += 1
        return out
    if net == "alex":
        return [("pool", 0, 0, False) if spec[0] == "M"
                else ("conv", spec[2], spec[3], True) for spec in _ALEX_CFG]
    raise ValueError(f"net must be vgg|alex, got {net}")


def load_lpips(path: str, net: str = "vgg", device=None):
    """``f(pred, gt) -> scalar`` LPIPS from the .npz at ``path``; inputs
    (H, W, 3) or (N, H, W, 3) in [-1, 1], the batch mean.  The weights live
    on ``device`` (``None``: the card)."""
    layers = _layers(net)
    dev = resolve_device(device)
    data = dict(np.load(path))
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    shift = T(data["shift"]).reshape(1, 3, 1, 1)
    scale = T(data["scale"]).reshape(1, 3, 1, 1)
    n_convs = sum(kind == "conv" for kind, *_ in layers)
    convs = [(T(np.transpose(data[f"conv{i}/kernel"], (3, 2, 0, 1))),
              T(data[f"conv{i}/bias"])) for i in range(n_convs)]
    lins = [T(data[f"lin{i}/kernel"]).reshape(-1) for i in range(N_TAPS)]

    def features(x):
        feats, ci = [], 0
        for kind, stride, pad, tapped in layers:
            if kind == "pool":
                x = F.max_pool2d(x, 2, 2)
                continue
            w, b = convs[ci]
            x = F.relu(F.conv2d(x, w, b, stride=stride, padding=pad))
            if tapped:
                feats.append(x)
            ci += 1
        return feats

    @torch.no_grad()
    def lpips(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        if pred.dim() == 3:
            pred, gt = pred[None], gt[None]
        nchw = lambda a: a.to(dev, torch.float32).permute(0, 3, 1, 2)
        fx = features((nchw(pred) - shift) / scale)
        fy = features((nchw(gt) - shift) / scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            v = torch.einsum("nchw,c->nhw", d, lins[i])
            total = total + v.mean(dim=(1, 2))
        return total.mean()

    return lpips
