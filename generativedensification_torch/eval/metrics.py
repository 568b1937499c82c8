"""Evaluation metrics with the reference's definitions, PyTorch.

Port of ``generativedensification_tpu/eval/metrics.py``: PSNR over [0, 1]
images, SSIM (pytorch_msssim semantics), masked depth abs-error and
accuracy at a threshold.  LPIPS needs pretrained feature weights that are
not in the repository; ``lpips_fn`` raises as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..train.loss import ssim


def psnr_img(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log(mse) / torch.log(torch.tensor(10.0, device=mse.device))


def ssim_img(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """NHWC or HWC in [0, 1]."""
    if pred.dim() == 3:
        pred, gt = pred[None], gt[None]
    return ssim(pred, gt)


def abs_error(pred_depth, gt_depth, mask):
    """Masked |pred - gt| (numpy)."""
    mask = np.asarray(mask)
    return np.abs(np.asarray(pred_depth)[mask] - np.asarray(gt_depth)[mask])


def acc_threshold(pred_depth, gt_depth, mask, threshold):
    """Per masked pixel, 1 where |err| < threshold (numpy)."""
    return (abs_error(pred_depth, gt_depth, mask) < threshold).astype(np.float32)


def lpips_fn(net: str = "vgg", weights_path: str | None = None):
    """LPIPS needs converted pretrained weights (VGG16 / AlexNet features
    and the linear calibration), which the repository does not hold."""
    raise NotImplementedError(
        f"LPIPS ({net}) needs pretrained feature weights, which are not in "
        "the repository and cannot be downloaded here; the port's LPIPS "
        "arrives with ROADMAP queue 1 (eval and tools), once converted "
        "weights are in the repository")
