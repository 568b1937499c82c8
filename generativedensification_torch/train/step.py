"""The train and eval steps, PyTorch.

Port of ``generativedensification_tpu/train/step.py``: forward (coarse +
fine) in training mode -> loss -> autograd backward -> the coarse-only
zero-update rule -> the optimizer -> stats.

Data parallelism replaces the JAX ``shard_train_step`` (parameters
replicated, the batch split on its leading axis, GSPMD's gradient
all-reduce): when ``torch.distributed`` is initialized with more than one
process (NCCL on cards, gloo on the CPU; the caller passes address, world
size and rank to ``init_process_group``), every process runs the step on
its own samples, every batch mean of the loss is the mean over the global
batch (``global_mean``), and the gradients are summed across processes
before the optimizer, so that each process holds the gradient of the JAX
package's global-batch loss.  Averaging per-process losses and gradients,
as DDP does, would be another loss: MS-SSIM takes the batch mean inside
each level's power.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist

from .loss import Losses
from .state import TrainState


def _data_parallel(group=None) -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size(group) > 1)


def global_mean(group=None):
    """The mean over the global batch of a per-process tensor (every
    process holds an equal share): its value is the all-reduced mean, its
    gradient with respect to this process's elements 1 / (world · n), so
    that the summed gradients of all processes are those of the global
    mean."""
    world = dist.get_world_size(group)

    def mean(t: torch.Tensor) -> torch.Tensor:
        local = t.mean()
        total = local.detach().clone()
        dist.all_reduce(total, group=group)
        return total / world + (local - local.detach()) / world

    return mean


def _all_reduce_grads(params, group=None) -> None:
    """Sum every parameter's gradient over the processes, in one flat
    buffer (a parameter without a gradient contributes zeros)."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off: off + n].view_as(p).clone()
        off += n


def make_train_step(net, optimizer, losses: Losses | None = None,
                    with_fine: bool = True, group=None):
    """``train_step(state, batch) -> (state, stats)``: one micro-step.

    ``stats`` holds 0-d tensors on the device (no host sync): ``loss``,
    ``grad_norm`` (of this micro-step's gradients), ``overflow`` (pairs the
    static budgets dropped) and the per-prefix ``mse`` / ``psnr`` /
    ``ssim`` (and the 2DGS ``distortion`` / ``normal``)."""
    losses = losses or Losses()
    dp = _data_parallel(group)
    if dp:
        losses = copy.copy(losses)
        losses.mean = global_mean(group)
    params = list(net.parameters())

    def train_step(state: TrainState, batch):
        net.train()
        optimizer.zero_grad(set_to_none=True)
        out = net(batch, with_fine=with_fine, generator=state.generator)
        loss, stats = losses(batch, out, state.step)
        loss.backward()
        overflow = out["overflow"].sum().to(torch.float32)
        if dp:
            _all_reduce_grads(params, group)
            dist.all_reduce(overflow, group=group)
        grad_norm = torch.sqrt(sum(torch.sum(p.grad * p.grad)
                                   for p in params if p.grad is not None))
        # Coarse-only phase: the fine-stage parameters get no gradient and
        # no update (their moments still update, as the JAX step's do).
        optimizer.step(skip_zero_grad=not with_fine)
        state.step += 1
        stats = dict(stats, loss=loss.detach(), grad_norm=grad_norm,
                     overflow=overflow)
        return state, stats

    return train_step


def make_eval_step(net, losses: Losses | None = None, with_fine: bool = True):
    """``eval_step(batch) -> (outputs, stats)`` in evaluation mode, without
    gradients; the 2DGS terms are active (step past 1000)."""
    losses = losses or Losses()

    def eval_step(batch):
        net.eval()
        with torch.no_grad():
            out = net(batch, with_fine=with_fine)
            loss, stats = losses(batch, out, 10 ** 9)
        return out, dict(stats, loss=loss)

    return eval_step
