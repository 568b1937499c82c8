"""Per-scene Gaussian finetuning (the ``infer.finetuning`` path), PyTorch.

Port of ``generativedensification_tpu/eval/finetune.py``: take the
feed-forward fine Gaussians (or a fresh point-cloud init anchored by the
k-NN scale), then run a few hundred Adam steps of the render MSE against
the source views with per-attribute learning rates: xyz, f_dc, f_rest
(``feature_lr / 20``), opacity, scaling, rotation, the reference's
``get_params`` grouping.

The renders go through ``splat/rasterizer.py::rasterize`` and so through
kernel #1 (``composite_fwd``) forward and kernel #2 in ``noabs`` mode
(``CompositeTiles.backward``) backward, one each per source view and step.
Adam is ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) with the
roundings of the JAX ``_ft_step`` as XLA compiles it, so that a step
matches it: each moment update and the parameter update are one fused
multiply-add (rounded once; emulated through f64 here), ``(m / bc1) / den``
is ``m / (bc1 · den)``, the square root is correctly rounded, and
``b**count`` is XLA's f32 power (``exp(count · log b)`` rounded once to
f32).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.activations import inverse_sigmoid
from ..core.knn import mean_knn_sq_dist
from ..splat.rasterizer import rasterize

RGB2SH_C0 = 0.28209479177387814
B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adam's defaults
f32 = lambda x: float(np.float32(x))    # a Python float's f32 value


def init_from_pcd(points: torch.Tensor, colors: torch.Tensor, sh_degree: int = 1) -> dict:
    """Fresh per-scene Gaussian params from a point cloud
    (``create_from_pcd``): DC SH from RGB, k-NN-anchored log scales,
    identity rotations, opacity 0.1."""
    n = points.shape[0]
    n_sh = (sh_degree + 1) ** 2
    dev = points.device
    d2 = torch.clamp(mean_knn_sq_dist(points), min=1e-7)
    rotation = torch.zeros((n, 4), device=dev)
    rotation[:, 0] = 1.0
    return {
        "xyz": points.to(torch.float32),
        "sh_dc": ((colors - 0.5) / RGB2SH_C0)[:, None, :],
        "sh_rest": torch.zeros((n, n_sh - 1, 3), device=dev),
        "opacity": inverse_sigmoid(0.1 * torch.ones((n, 1), device=dev)),
        "scaling": torch.log(torch.sqrt(d2))[:, None].repeat(1, 3),
        "rotation": rotation,
    }


def params_from_gaussians(xyz, shs, opacity_raw, scaling_raw, rotation) -> dict:
    """Wrap feed-forward fine Gaussians as finetunable params."""
    return {
        "xyz": xyz,
        "sh_dc": shs[:, :1],
        "sh_rest": shs[:, 1:],
        "opacity": opacity_raw.reshape(-1, 1),
        "scaling": scaling_raw,
        "rotation": rotation,
    }


def learning_rates(position_lr: float = 1.6e-5, feature_lr: float = 2.5e-3,
                   opacity_lr: float = 0.05, scaling_lr: float = 5e-3,
                   rotation_lr: float = 1e-3) -> tuple:
    """The six (attribute, learning rate) groups."""
    return (
        ("xyz", position_lr),
        ("sh_dc", feature_lr),
        ("sh_rest", feature_lr / 20.0),
        ("opacity", opacity_lr),
        ("scaling", scaling_lr),
        ("rotation", rotation_lr),
    )


def init_state(params: dict) -> dict:
    """optax.adam's state: the count and both moments of every attribute."""
    return {"count": 0, **{k: {"mu": torch.zeros_like(v), "nu": torch.zeros_like(v)}
                           for k, v in params.items()}}


def ft_loss(p: dict, cams, gt_images, bgs, sh_degree: int, raster_kw: dict):
    """Mean squared error of the V source-view renders against
    ``gt_images`` (V, H, W, 3); returns (loss, overflow summed over the
    views)."""
    shs = torch.cat([p["sh_dc"], p["sh_rest"]], dim=1)
    outs = [rasterize(p["xyz"], shs, torch.sigmoid(p["opacity"][:, 0]),
                      torch.exp(p["scaling"]), p["rotation"], cams[j], bgs[j],
                      sh_degree, **raster_kw)
            for j in range(gt_images.shape[0])]
    imgs = torch.stack([o.image for o in outs])
    overflow = sum(o.overflow for o in outs)
    return torch.mean((imgs - gt_images) ** 2), overflow


def ft_step(p: dict, state: dict, cams, gt_images, bgs, *, sh_degree: int,
            lrs: tuple, raster_kw: dict):
    """One Adam step of the render MSE: updates ``p`` and ``state`` in
    place; returns the loss before the update and the renders' overflow
    (device tensors: nothing waits for the card)."""
    leaves = [p[k].detach().requires_grad_(True) for k, _ in lrs]
    q = dict(zip([k for k, _ in lrs], leaves))
    loss, overflow = ft_loss(q, cams, gt_images, bgs, sh_degree, raster_kw)
    adam_update(p, torch.autograd.grad(loss, leaves), state, lrs)
    return loss.detach(), overflow


def _fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a · b + c rounded once to f32 (f32 a, b and c: the f64 product is
    exact)."""
    return (a.double() * b + c.double()).float()


def bias_correction(b: float, count: int) -> float:
    """optax's ``1 - b**count`` in f32, the power as XLA computes it."""
    return f32(1.0 - f32(math.exp(count * math.log(f32(b)))))


@torch.no_grad()
def adam_update(p: dict, grads, state: dict, lrs: tuple) -> dict:
    """optax.adam per attribute group (``grads`` in the order of ``lrs``):
    updates the moments, adds mu_hat / (sqrt(nu_hat) + eps) · (−lr) to
    ``p``, and returns those updates (each rounded to f32)."""
    state["count"] += 1
    bc1 = bias_correction(B1, state["count"])
    bc2 = bias_correction(B2, state["count"])
    updates = {}
    for (k, lr), g in zip(lrs, grads):
        st = state[k]
        st["mu"] = _fma(g, f32(1 - B1), B1 * st["mu"])
        st["nu"] = _fma(g * g, f32(1 - B2), B2 * st["nu"])
        # optax's (mu / bc1) / (sqrt(nu / bc2) + eps), reassociated as XLA
        # compiles it; the square root correctly rounded (the CPU's
        # vectorized torch.sqrt is not)
        root = torch.sqrt((st["nu"] / bc2).double()).float()
        d = st["mu"] / (bc1 * (root + EPS))
        updates[k] = d * f32(-lr)
        p[k] = _fma(d, f32(-lr), p[k])
    return updates


def finetune(params: dict, cams, gt_images: torch.Tensor, bgs: torch.Tensor,
             sh_degree: int = 1, steps: int = 500, position_lr: float = 1.6e-5,
             feature_lr: float = 2.5e-3, opacity_lr: float = 0.05,
             scaling_lr: float = 5e-3, rotation_lr: float = 1e-3,
             raster_kw: dict | None = None):
    """``steps`` Adam steps over ``params`` against the V source views
    (``cams`` a batched ``Camera``, ``gt_images`` (V, H, W, 3), ``bgs``
    (V, 3)); returns (the finetuned params, the last step's loss)."""
    raster_kw = raster_kw or {}
    lrs = learning_rates(position_lr, feature_lr, opacity_lr, scaling_lr,
                         rotation_lr)
    p = {k: v.detach() for k, v in params.items()}
    state = init_state(p)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        loss, _ = ft_step(p, state, cams, gt_images, bgs, sh_degree=sh_degree,
                          lrs=lrs, raster_kw=raster_kw)
    return p, float(loss)
