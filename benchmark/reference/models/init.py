"""Flax-default parameter initializers, drawn from a ``torch.Generator``.

The port starts from seeded random weights (there are no pretrained weights
in the repository), with the same distributions as the JAX package's
modules: ``lecun_normal`` (truncated normal, std sqrt(1/fan_in)) for Dense
and Conv kernels, zeros for biases, ones/zeros for LayerNorm, and the
per-parameter normal / xavier initializers the JAX modules name.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    gen: torch.Generator) -> None:
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    nn.init.uniform_(w, -lim, lim, generator=gen)


def normal_(w: torch.Tensor, std: float, gen: torch.Generator) -> None:
    nn.init.normal_(w, 0.0, std, generator=gen)


def init_module_(module: nn.Module, gen: torch.Generator) -> None:
    """Flax defaults for every Linear / Conv / LayerNorm under ``module``
    (modules with their own initializers override afterwards)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, gen)
        elif isinstance(m, (nn.Conv2d, nn.Conv3d)):
            lecun_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.ConvTranspose3d):
            # flax fan_in of a (kd, kh, kw, in, out) kernel: receptive * in
            lecun_normal_(m.weight, m.weight.shape[0] * m.weight[0, 0].numel(), gen)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            continue
        else:
            continue
        if m.bias is not None:
            nn.init.zeros_(m.bias)


def remat_call(fn, *args):
    """``fn(*args)``; while autograd records, under activation
    checkpointing (``torch.utils.checkpoint``, non-reentrant), as the JAX
    modules' ``nn.remat``: the block's activations are recomputed in the
    backward instead of kept. Only for blocks that draw no random numbers,
    which a recompute would draw again."""
    if torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
