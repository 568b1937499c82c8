"""A plain AdamW with global-norm clipping and gradient accumulation, as
the release trains (``configs/base.yaml``: AdamW, lr 4e-4 after a linear
warm-up of 1,000 updates from 1e-10 and 1e-4 after it, betas (0.9, 0.95),
eps 1e-8, weight decay 0.05 on matrices and kernels only, the gradient
clipped to a global norm of 0.5, ``accumulate_grad_batches`` micro-steps a
update), written out from the published update rule:

    g   = mean of the k micro-step gradients          (accumulation)
    g   = g · 0.5 / |g|  where |g| >= 0.5            (global clip)
    m   = b1 · m + (1 − b1) · g
    v   = b2 · v + (1 − b2) · g²
    u   = (m / (1 − b1^t)) / (sqrt(v / (1 − b2^t)) + eps) + wd · p   (wd: ndim >= 2)
    p   = p − lr(t − 1) · u

t counts updates from 1, and the learning rate is read at the updates
taken before this one.  A parameter that received no gradient takes a
zero one.  Each micro-step's gradient is added to a running mean,
acc += (g − acc) / (n + 1), and the k-th applies the update.
"""

from __future__ import annotations

import torch


def learning_rate(updates: int, base: float = 4e-4, warmup: int = 1000,
                  after: float = 1e-4, initial: float = 1e-10) -> float:
    """The rate of the update that follows ``updates`` updates."""
    if updates > warmup:
        return after
    return initial + (base - initial) * min(updates / warmup, 1.0)


class AdamW:
    def __init__(self, params, lr: float = 4e-4, betas=(0.9, 0.95), eps: float = 1e-8,
                 weight_decay: float = 0.05, warmup: int = 1000, clip: float = 0.5,
                 accumulate: int = 1):
        self.params = list(params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.weight_decay, self.warmup, self.clip = weight_decay, warmup, clip
        self.accumulate = accumulate
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.micro = 0       # micro-steps since the last update
        self.updates = 0

    @torch.no_grad()
    def step(self) -> None:
        """Take this micro-step's gradients (and clear them); on the k-th,
        update the parameters."""
        n = self.micro
        for i, p in enumerate(self.params):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            self.acc[i] = self.acc[i] + (g - self.acc[i]) / (n + 1)
            p.grad = None
        self.micro = (n + 1) % self.accumulate
        if self.micro:
            return
        norm = torch.sqrt(sum((a.double() ** 2).sum() for a in self.acc))
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        t = self.updates + 1
        b1, b2 = self.betas
        lr = learning_rate(self.updates, self.lr, self.warmup)
        for i, p in enumerate(self.params):
            g = self.acc[i] * scale
            self.m[i] = b1 * self.m[i] + (1 - b1) * g
            self.v[i] = b2 * self.v[i] + (1 - b2) * g * g
            u = (self.m[i] / (1 - b1 ** t)) / (torch.sqrt(self.v[i] / (1 - b2 ** t)) + self.eps)
            if p.dim() >= 2:
                u = u + self.weight_decay * p
            p.sub_(lr * u)
            self.acc[i] = torch.zeros_like(p)
        self.updates = t
