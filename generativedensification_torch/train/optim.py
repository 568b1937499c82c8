"""The optimizer of the train step, PyTorch: the JAX package's optax chain.

Port of ``generativedensification_tpu/train/optim.py``:

    optax.chain(clip_by_global_norm(0.5),
                adamw(warmup_then_constant(4e-4), b1=0.9, b2=0.95, eps=1e-8,
                      weight_decay=0.05, mask=ndim >= 2))

wrapped in ``optax.MultiSteps(every_k=accumulate)`` when accumulating.  It
differs from ``torch.optim.AdamW`` + ``clip_grad_norm_`` in ways that move
the numbers, so it is written out:

  * the clip scales by max_norm / norm only when norm >= max_norm (no
    ``+ 1e-6`` in the divisor);
  * the schedule is read at the update count starting from 0, so the first
    update uses 1e-10, and the count advances per update, not per
    micro-step;
  * weight decay is added to the Adam direction before the learning rate
    scales both (decoupled, optax's order), on tensors with ndim >= 2 only;
  * accumulation keeps a running mean of the micro-step gradients
    (acc += (g − acc) / (n + 1)); the k-th call applies clip and AdamW to
    that mean, the others change no parameter;
  * a parameter without a gradient takes a zero gradient, as every JAX
    leaf has one: its moments decay and its weight decays.

The schedule and the bias corrections are f32 scalars computed on the
host and passed as Python floats (exactly their f32 values), so a step
copies nothing to the device and never waits for it.
"""

from __future__ import annotations

import torch


def warmup_then_constant(base_lr: float, warmup_iters: int = 1000,
                         constant_lr: float = 1e-4, initial_lr: float = 1e-10):
    """Linear warmup from ``initial_lr`` to ``base_lr`` over
    ``warmup_iters`` updates, then a constant ``constant_lr`` (the f32
    arithmetic of the JAX schedule)."""

    def schedule(count: int) -> torch.Tensor:
        f32 = torch.float32
        frac = torch.clamp(torch.tensor(count, dtype=f32) / warmup_iters, max=1.0)
        warm = torch.tensor(initial_lr, dtype=f32) + \
            torch.tensor(base_lr - initial_lr, dtype=f32) * frac
        return warm if count <= warmup_iters else torch.tensor(constant_lr, dtype=f32)

    return schedule


class OptaxAdamW(torch.optim.Optimizer):
    """clip_by_global_norm + masked AdamW + MultiSteps, as the JAX optax
    chain computes them.

    ``step(skip_zero_grad=False)``: with ``skip_zero_grad`` a parameter
    whose micro-step gradient is identically zero gets no update (its
    moments still update) — the coarse-only rule of the JAX train step."""

    def __init__(self, params, lr: float = 4e-4, betas=(0.9, 0.95),
                 eps: float = 1e-8, weight_decay: float = 0.05,
                 warmup_iters: int = 1000, grad_clip: float = 0.5,
                 accumulate: int = 1):
        defaults = dict(betas=betas, eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)
        self.schedule = warmup_then_constant(lr, warmup_iters)
        self.grad_clip = grad_clip
        self.accumulate = accumulate
        self.mini_step = 0   # micro-steps since the last update
        self.count = 0       # updates applied (the Adam and schedule count)

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def state_dict(self):
        """The moments and the accumulator of every parameter, and the two
        counters (a checkpoint needs both to resume bitwise)."""
        return dict(super().state_dict(), mini_step=self.mini_step,
                    count=self.count)

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.mini_step = int(state_dict.pop("mini_step"))
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def step(self, closure=None, skip_zero_grad: bool = False):
        if closure is not None:
            raise ValueError("OptaxAdamW takes no closure")
        params = self._params()
        grads = {p: torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params}
        n = self.mini_step
        for p, g in grads.items():
            st = self.state[p]
            if "acc" not in st:
                st["acc"] = torch.zeros_like(p)
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
            if self.accumulate > 1:
                st["acc"] = st["acc"] + (g - st["acc"]) / (n + 1)
            else:
                st["acc"] = g
        self.mini_step = (n + 1) % self.accumulate
        if self.mini_step:
            return None

        acc = [self.state[p]["acc"] for p in params]
        g_norm = torch.sqrt(sum(torch.sum(a * a) for a in acc))
        keep = g_norm < self.grad_clip
        count = self.count + 1
        lr = float(self.schedule(self.count))
        f32 = torch.float32
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            bc1 = float(1.0 - torch.tensor(b1, dtype=f32) ** count)
            bc2 = float(1.0 - torch.tensor(b2, dtype=f32) ** count)
            for p in group["params"]:
                st = self.state[p]
                a = st["acc"]
                g = torch.where(keep, a, (a / g_norm) * self.grad_clip)
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
                u = (st["mu"] / bc1) / (torch.sqrt(st["nu"] / bc2) + eps)
                if p.dim() >= 2:
                    u = u + wd * p
                u = -lr * u
                if skip_zero_grad:
                    u = torch.where(torch.any(grads[p] != 0), u,
                                    torch.zeros_like(u))
                p.add_(u)
                if self.accumulate > 1:
                    st["acc"] = torch.zeros_like(a)
        self.count = count
        return None


def make_optimizer(net, lr: float = 4e-4, beta1: float = 0.9, beta2: float = 0.95,
                   weight_decay: float = 0.05, warmup_iters: int = 1000,
                   grad_clip: float = 0.5, accumulate: int = 1) -> OptaxAdamW:
    """The JAX ``make_optimizer`` over a module's parameters."""
    return OptaxAdamW(net.parameters(), lr=lr, betas=(beta1, beta2),
                      weight_decay=weight_decay, warmup_iters=warmup_iters,
                      grad_clip=grad_clip, accumulate=accumulate)
