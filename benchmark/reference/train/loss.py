"""Training losses in exact f32: the benchmark's frozen copy of the port's
``train/loss.py`` (one process: every batch mean is ``torch.mean``).

MSE + 0.5 · (1 − MS-SSIM) per prefix ('', '_fine'), pytorch_msssim
semantics (gaussian window 11, sigma 1.5, K = (0.01, 0.03), valid padding,
five scales with the standard weights, ReLU-clamped values), and the 2DGS
terms on the coarse prefix when ``rend_dist`` is present: active · (1000 ·
distortion + 0.2 · normal error), active = step > 1000.  The blur is the
shift-and-add f32 form (a cuDNN convolution may run in TF32 and lose the
E[x²] − E[x]² cancellation); the 2×2 downsample is the plain average.
"""

from __future__ import annotations

import math

import torch

MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


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


def _ssim_and_cs(img1, img2, data_range=1.0, win_size=11, k=(0.01, 0.03),
                 mean=torch.mean):
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
    return mean(ssim_map), mean(cs_map)


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Single-scale SSIM, NHWC in [0, data_range] (pytorch_msssim.ssim)."""
    return _ssim_and_cs(img1, img2, data_range)[0]


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """avg_pool 2×2 stride 2, zero-padded to even (pytorch_msssim)."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        x = torch.nn.functional.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    s = ((x[:, 0::2, 0::2] + x[:, 0::2, 1::2]) + x[:, 1::2, 0::2]) + x[:, 1::2, 1::2]
    return 0.25 * s


def ms_ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
            weights: tuple = MSSSIM_WEIGHTS, mean=torch.mean) -> torch.Tensor:
    """Multi-scale SSIM (NHWC).  Uses as many of the requested scales as the
    resolution supports (each needs min(H, W) / 2^(level-1) >= 11 for the
    valid window); truncated weights are renormalized."""
    levels = len(weights)
    min_side = min(img1.shape[1], img1.shape[2])
    while levels > 1 and (min_side >> (levels - 1)) < 11:
        levels -= 1
    if levels < len(weights):
        total = sum(weights[:levels])
        weights = tuple(w_ / total for w_ in weights[:levels])
    w = torch.tensor(weights, dtype=torch.float32, device=img1.device)
    vals = []
    for i in range(levels):
        s, cs = _ssim_and_cs(img1, img2, data_range, mean=mean)
        vals.append(s if i == levels - 1 else cs)
        if i < levels - 1:
            img1 = _downsample2(img1)
            img2 = _downsample2(img2)
    vals = torch.relu(torch.stack(vals))
    return torch.prod(vals ** w)


def psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


class Losses:
    """``Losses()(batch, output, step)`` -> (loss, scalar stats).

    ``step`` is the micro-step counter of the train state (it gates the
    2DGS terms); ``mean`` reduces a per-rank tensor to the global-batch
    mean (``torch.mean`` in one process)."""

    def __init__(self, ssim_levels: int = 5, mean=torch.mean):
        self.weights = MSSSIM_WEIGHTS[:ssim_levels]
        self.mean = mean

    def __call__(self, batch, output, step):
        stats = {}
        loss = 0.0
        B, V, H, W, _ = batch["tar_rgb"].shape
        tar = batch["tar_rgb"].permute(0, 2, 1, 3, 4).reshape(B, H, V * W, 3)

        for prex in ("", "_fine"):
            if f"acc_map{prex}" not in output:
                continue
            img = output[f"image{prex}"]
            mse = self.mean((img - tar) ** 2)
            loss = loss + mse
            stats[f"mse{prex}"] = mse.detach()
            stats[f"psnr{prex}"] = psnr(mse.detach())
            s = ms_ssim(img, tar, weights=self.weights, mean=self.mean)
            stats[f"ssim{prex}"] = s.detach()
            loss = loss + 0.5 * (1.0 - s)

            if f"rend_dist{prex}" in output and prex == "":
                active = float(int(step) > 1000)
                dist = self.mean(output[f"rend_dist{prex}"])
                stats[f"distortion{prex}"] = dist.detach()
                rn = output[f"rend_normal{prex}"]
                dn = output[f"depth_normal{prex}"]
                acc = output[f"acc_map{prex}"].detach()
                nerr = self.mean((1.0 - (rn * dn).sum(-1)) * acc)
                stats[f"normal{prex}"] = nerr.detach()
                loss = loss + active * (1000.0 * dist + 0.2 * nerr)

        return loss, stats
