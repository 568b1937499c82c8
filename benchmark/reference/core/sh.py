"""Real spherical harmonics, Cartesian closed form, PyTorch.

Port of ``generativedensification_tpu/core/sh.py``; two conventions:

* ``rsh_cart`` — the torch-spherical-harmonics layout used for ray-direction
  conditioning (index of Y_l^m is ``l*(l+1) + m``, Condon-Shortley phase).
* ``eval_sh_color`` — the 3DGS rasterizer's SH→RGB evaluation (view
  direction, +0.5, clamped at 0).
"""

from __future__ import annotations

import math

import torch

MAX_RSH_DEGREE = 8


def rsh_cart(xyz: torch.Tensor, degree: int = 3) -> torch.Tensor:
    """All real SH up to ``degree`` (0..8) on the unit sphere: (..., 3) ->
    (..., (degree+1)**2), by the azimuthal (x + iy)^m recurrence and the
    three-term Legendre recurrence in z (see the JAX module for the
    derivation)."""
    if not 0 <= degree <= MAX_RSH_DEGREE:
        raise ValueError(f"degree must be in [0, {MAX_RSH_DEGREE}], got {degree}")
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    ones = torch.ones_like(x)

    C = [ones]
    S = [torch.zeros_like(x)]
    for m in range(1, degree + 1):
        C.append(x * C[m - 1] - y * S[m - 1])
        S.append(x * S[m - 1] + y * C[m - 1])

    A: dict = {}
    dfact = 1.0
    for m in range(degree + 1):
        if m > 0:
            dfact *= 2 * m - 1
        A[(m, m)] = ((-1.0) ** m * dfact) * ones
        if m + 1 <= degree:
            A[(m + 1, m)] = (2 * m + 1) * z * A[(m, m)]
        for l in range(m + 2, degree + 1):
            A[(l, m)] = (
                (2 * l - 1) * z * A[(l - 1, m)] - (l + m - 1) * A[(l - 2, m)]
            ) / (l - m)

    sqrt2 = math.sqrt(2.0)
    comps = []
    for l in range(degree + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            n_lm = math.sqrt(
                (2 * l + 1) / (4.0 * math.pi)
                * math.factorial(l - am) / math.factorial(l + am)
            )
            if m == 0:
                comps.append(n_lm * A[(l, 0)])
            elif m > 0:
                comps.append(sqrt2 * n_lm * A[(l, am)] * C[am])
            else:
                comps.append(sqrt2 * n_lm * A[(l, am)] * S[am])
    return torch.stack(comps, dim=-1)


def sh_dim(degree: int) -> int:
    return (degree + 1) ** 2


_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def eval_sh_color(shs: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """3DGS SH→RGB: ``max(result + 0.5, 0)``.

    shs: (..., (degree+1)**2, 3); dirs: (..., 3) unnormalized view
    directions (mean - campos).  Returns (..., 3).
    """
    d = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    basis = []
    if degree >= 1:
        basis += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        basis += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    channels = []
    for c in range(3):
        acc = _C0 * shs[..., 0, c]
        for k, b in enumerate(basis):
            acc = acc + b * shs[..., k + 1, c]
        channels.append(acc)
    return torch.clamp(torch.stack(channels, dim=-1) + 0.5, min=0.0)
