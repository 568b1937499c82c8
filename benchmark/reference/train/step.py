"""One plain training micro-step: the network forward (coarse and fine) in
training mode with the step's generator, the loss, autograd's backward and
the optimizer's micro-step."""

from __future__ import annotations

import torch

from .loss import Losses


def micro_step(net, opt, batch: dict, gen: torch.Generator, step: int,
               losses: Losses | None = None) -> dict:
    """Returns the micro-step's ``loss`` and ``overflow`` (0-d tensors)."""
    net.train()
    out = net(batch, with_fine=True, generator=gen)
    loss, _ = (losses or Losses())(batch, out, step)
    loss.backward()
    opt.step()
    return {"loss": loss.detach(), "overflow": out["overflow"].sum().to(torch.float32)}
