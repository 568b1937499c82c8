"""Evaluation metrics with the reference's definitions, PyTorch.

Port of ``generativedensification_tpu/eval/metrics.py``: PSNR over [0, 1]
images, SSIM (pytorch_msssim semantics), masked depth abs-error and
accuracy at a threshold, MS-SSIM, and LPIPS from converted weights
(``eval/lpips.py``): ``lpips_fn`` reads the .npz named by its argument or by
``LPIPS_WEIGHTS_NPZ`` and raises without one, as the JAX package's does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..train.loss import ms_ssim, ssim


def psnr_img(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log(mse) / torch.log(torch.tensor(10.0, device=mse.device))


def ssim_img(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """NHWC or HWC in [0, 1]."""
    if pred.dim() == 3:
        pred, gt = pred[None], gt[None]
    return ssim(pred, gt)


def ms_ssim_img(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """NHWC or HWC in [0, 1]."""
    if pred.dim() == 3:
        pred, gt = pred[None], gt[None]
    return ms_ssim(pred, gt)


def abs_error(pred_depth, gt_depth, mask):
    """Masked |pred - gt| (numpy)."""
    mask = np.asarray(mask)
    return np.abs(np.asarray(pred_depth)[mask] - np.asarray(gt_depth)[mask])


def acc_threshold(pred_depth, gt_depth, mask, threshold):
    """Per masked pixel, 1 where |err| < threshold (numpy)."""
    return (abs_error(pred_depth, gt_depth, mask) < threshold).astype(np.float32)


_LPIPS_CACHE = {}


def lpips_fn(net: str = "vgg", weights_path: str | None = None, device=None):
    """``f(pred, gt) -> scalar`` LPIPS, inputs HWC or NHWC in [-1, 1].

    Needs converted pretrained weights (VGG16 / AlexNet features and the
    linear calibration): ``weights_path`` or the env var
    ``LPIPS_WEIGHTS_NPZ`` names an .npz written by ``tools/convert_lpips.py``.
    A ``{net}`` in the name is replaced by ``net``, so that one setting names
    both files the evaluation reads (``lpips_{net}.npz``); one file holds one
    backbone's keys.  ``device=None`` means the card."""
    path = weights_path or os.environ.get("LPIPS_WEIGHTS_NPZ")
    if path is not None:
        path = path.replace("{net}", net)
    if path is None or not os.path.exists(path):
        raise NotImplementedError(
            f"LPIPS ({net}) needs pretrained feature weights, which are not in "
            "the repository and cannot be downloaded here: run "
            "tools/convert_lpips.py where torchvision and the lpips weights "
            "exist, then set LPIPS_WEIGHTS_NPZ (ROADMAP: what waits on files "
            "not in the repository)")
    key = (net, os.path.abspath(path), str(device))
    if key not in _LPIPS_CACHE:
        from .lpips import load_lpips

        _LPIPS_CACHE[key] = load_lpips(path, net, device)
    return _LPIPS_CACHE[key]
