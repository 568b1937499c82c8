"""Seeded weights, made on the network's device in two draws.

Every parameter of a Generative Densification network gets the
distribution of the reference's initializers (Flax defaults): a truncated
normal of std sqrt(1 / fan_in) for Dense and Conv kernels, Xavier uniform
for the Gaussian heads, the named normals of the positional and view
embeddings, zeros for biases and ones / zeros for LayerNorm.  One uniform
draw on a ``torch.Generator`` of the device covers every truncated normal
and uniform leaf, one normal draw every normal leaf, taken in the order of
``named_parameters``: the same seed gives the same weights to the program
and to the reference, which have the same parameter names.
"""

from __future__ import annotations

import math

import torch

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978
# the Gaussian heads initialised Xavier uniform (GaussianDecoder)
_XAVIER = ("coarse_fc0", "coarse_fc1", "coarse_out", "fine_fc0", "fine_out")


def _rule(cls: str, child: str, pname: str, p: torch.Tensor,
          parent: torch.nn.Module | None):
    """(kind, scale) of one parameter of a module of class ``cls``: kind is
    trunc, normal, xavier, zeros or ones."""
    if cls == "LayerNorm" or cls == "PDNorm":
        return ("ones", 1.0) if pname == "weight" else ("zeros", 0.0)
    if pname == "bias":
        return ("zeros", 0.0)
    if cls == "Linear":
        if type(parent).__name__ == "GaussianDecoder" and child in _XAVIER:
            fan_in, fan_out = p.shape[1], p.shape[0]
            return ("xavier", math.sqrt(6.0 / (fan_in + fan_out)))
        return ("trunc", math.sqrt(1.0 / p.shape[1]) / _TRUNC_STD)
    if cls in ("Conv2d", "Conv3d"):
        return ("trunc", math.sqrt(1.0 / p[0].numel()) / _TRUNC_STD)
    if cls == "ConvTranspose3d":
        return ("trunc", math.sqrt(1.0 / (p.shape[0] * p[0, 0].numel())) / _TRUNC_STD)
    if cls == "NeighborConvCPE":
        return ("trunc", math.sqrt(1.0 / (27 * p.shape[1])) / _TRUNC_STD)
    if cls == "VisionTransformer":
        return ("zeros", 0.0) if pname == "cls_token" else ("normal", 0.02)
    if cls == "VolTransformer" and pname == "pos_embed":
        return ("normal", p.shape[-1] ** -0.5)
    if cls == "Network" and pname == "view_embed":
        return ("normal", p.shape[-1] ** -0.5)
    raise ValueError(f"no initializer for {cls}.{pname} {tuple(p.shape)}")


def leaves(net: torch.nn.Module) -> list:
    """(name, parameter, kind, scale) of every parameter, in
    ``named_parameters`` order."""
    modules = dict(net.named_modules())
    rules = {}
    for mname, mod in modules.items():
        parent_name, _, child = mname.rpartition(".")
        parent = modules.get(parent_name) if mname else None
        for pname, p in mod.named_parameters(recurse=False):
            full = f"{mname}.{pname}" if mname else pname
            # the top module is the network, whatever subclass holds it
            cls = type(mod).__name__ if mname else "Network"
            rules[full] = _rule(cls, child, pname, p, parent)
    return [(n, p, *rules[n]) for n, p in net.named_parameters()]


@torch.no_grad()
def fill(net: torch.nn.Module, seed: int) -> None:
    """Overwrite every parameter of ``net`` from ``seed``."""
    items = leaves(net)
    dev = items[0][1].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % (1 << 63))
    n_uni = sum(p.numel() for _, p, k, _ in items if k in ("trunc", "xavier"))
    n_nrm = sum(p.numel() for _, p, k, _ in items if k == "normal")
    uni = torch.rand(n_uni, generator=gen, device=dev, dtype=torch.float32)
    nrm = torch.randn(n_nrm, generator=gen, device=dev, dtype=torch.float32)
    # truncated normal on [-2, 2] by the inverse CDF, as torch's trunc_normal_
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    tn = (torch.erfinv((2.0 * (lo + (hi - lo) * uni) - 1.0).clamp(-1 + 1e-7, 1 - 1e-7))
          * math.sqrt(2.0)).clamp(-2.0, 2.0)
    iu = inr = 0
    for _, p, kind, scale in items:
        n = p.numel()
        if kind == "trunc":
            p.copy_(tn[iu:iu + n].view_as(p) * scale)
            iu += n
        elif kind == "xavier":
            p.copy_((uni[iu:iu + n].view_as(p) * 2.0 - 1.0) * scale)
            iu += n
        elif kind == "normal":
            p.copy_(nrm[inr:inr + n].view_as(p) * scale)
            inr += n
        elif kind == "ones":
            p.fill_(1.0)
        else:
            p.zero_()
