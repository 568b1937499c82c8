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

Each stage of a step is one multi-tensor pass (``torch._foreach_*``) over
the lists of every parameter, its gradient and its state: a few kernel
launches per pass on the card, where a loop over the leaves launched a
few kernels per leaf.  The state stays per parameter (``state[p]``, updated
in place) and the parameters stay the module's own tensors.
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


def global_norm(tensors) -> torch.Tensor:
    """optax's ``global_norm``, the square root of the sum of every
    element's square, as a 0-d tensor on the tensors' device: one norm per
    tensor in a multi-tensor pass, then the norm of those."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


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
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        states = [self.state[p] for p in params]
        for p, st in zip(params, states):
            if "acc" not in st:
                st["acc"] = torch.zeros_like(p)
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
        n = self.mini_step
        if self.accumulate > 1:
            acc = [st["acc"] for st in states]
            torch._foreach_add_(acc, torch._foreach_sub(grads, acc), alpha=1 / (n + 1))
        else:
            acc = grads
            for st, g in zip(states, grads):
                st["acc"] = g
        self.mini_step = (n + 1) % self.accumulate
        if self.mini_step:
            return None

        g_norm = global_norm(acc)
        keep = g_norm < self.grad_clip
        # (a / norm) * clip past the clip; kept, a / 1 * 1 is a, bit for bit
        clipped = torch._foreach_div(acc, torch.where(keep, 1.0, g_norm))
        torch._foreach_mul_(clipped, torch.where(keep, 1.0, self.grad_clip))
        count = self.count + 1
        lr = float(self.schedule(self.count))
        f32 = torch.float32
        first = 0
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, wd = group["eps"], group["weight_decay"]
            bc1 = float(1.0 - torch.tensor(b1, dtype=f32) ** count)
            bc2 = float(1.0 - torch.tensor(b2, dtype=f32) ** count)
            last = first + len(group["params"])
            ps, g = params[first:last], clipped[first:last]
            mu = [st["mu"] for st in states[first:last]]
            nu = [st["nu"] for st in states[first:last]]
            first = last
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            u = torch._foreach_div(mu, bc1)
            torch._foreach_div_(u, den)
            del den
            mats = [j for j, p in enumerate(ps) if p.dim() >= 2]
            if mats:
                torch._foreach_add_([u[j] for j in mats], [ps[j] for j in mats], alpha=wd)
            if skip_zero_grad:
                # where, not a product, so that a NaN u is dropped too; a
                # leaf with no gradient is known on the host
                live = [j for j, p in enumerate(ps) if p.grad is not None]
                moves = (torch.stack(torch._foreach_norm([ps[j].grad for j in live], 1)) != 0
                         if live else [])
                u = [torch.where(nz, u[j], 0.0) for nz, j in zip(moves, live)]
                ps = [ps[j] for j in live]
            if ps:
                torch._foreach_add_(ps, u, alpha=-lr)
        if self.accumulate > 1:
            torch._foreach_zero_(acc)
        self.count = count
        return None


def make_optimizer(net, lr: float = 4e-4, beta1: float = 0.9, beta2: float = 0.95,
                   weight_decay: float = 0.05, warmup_iters: int = 1000,
                   grad_clip: float = 0.5, accumulate: int = 1) -> OptaxAdamW:
    """The JAX ``make_optimizer`` over a module's parameters."""
    return OptaxAdamW(net.parameters(), lr=lr, betas=(beta1, beta2),
                      weight_decay=weight_decay, warmup_iters=warmup_iters,
                      grad_clip=grad_clip, accumulate=accumulate)
