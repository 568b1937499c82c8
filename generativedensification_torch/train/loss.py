"""SSIM in exact f32, PyTorch.

Port of the single-scale part of ``generativedensification_tpu/train/
loss.py`` (pytorch_msssim semantics: gaussian window 11, sigma 1.5,
K = (0.01, 0.03), valid padding).  The blur is the shift-and-add f32 form
of ``_blur``, not a convolution: a cuDNN convolution may run in TF32 and
then loses the E[x²] - E[x]² cancellation.  MS-SSIM and the training
losses arrive with ROADMAP slice 4.
"""

from __future__ import annotations

import torch


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-padding gaussian filter over the H and W axes of an
    NHWC tensor: k shifted slices times their weight, summed in order."""
    k = win.shape[0]
    for axis in (1, 2):
        n = x.shape[axis] - k + 1
        y = win[0] * x.narrow(axis, 0, n)
        for t in range(1, k):
            y = y + win[t] * x.narrow(axis, t, n)
        x = y
    return x


def _ssim_and_cs(img1, img2, data_range=1.0, win_size=11, k=(0.01, 0.03)):
    """Mean SSIM and contrast sensitivity over an NHWC batch."""
    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    C1 = (k[0] * data_range) ** 2
    C2 = (k[1] * data_range) ** 2
    win = _gaussian_window(win_size).to(img1.device)

    mu1 = _blur(img1, win)
    mu2 = _blur(img2, win)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1 = _blur(img1 * img1, win) - mu1_sq
    sigma2 = _blur(img2 * img2, win) - mu2_sq
    sigma12 = _blur(img1 * img2, win) - mu12

    cs_map = (2 * sigma12 + C2) / (sigma1 + sigma2 + C2)
    ssim_map = ((2 * mu12 + C1) / (mu1_sq + mu2_sq + C1)) * cs_map
    return ssim_map.mean(), cs_map.mean()


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Single-scale SSIM, NHWC in [0, data_range] (pytorch_msssim.ssim)."""
    return _ssim_and_cs(img1, img2, data_range)[0]
