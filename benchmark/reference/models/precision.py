"""The bf16 compute policy: Flax's ``dtype=`` written out per layer.

The JAX package (``models/network.py:128-131``) keeps every parameter in
f32 and computes its transformers and MLPs in ``compute_dtype`` (the
reference's ``precision="bf16-mixed"``): a Flax ``Dense`` / ``Conv`` with
``dtype=bfloat16`` casts its input and its f32 kernel to bf16, multiplies
with a bf16 result and adds the bias in bf16; a ``LayerNorm`` with that
dtype computes its statistics and affine in f32 and returns bf16; the
attention logits are bf16 products kept in f32
(``preferred_element_type``), and the softmax runs in f32.  These helpers
round where those layers round: on the CPU each is bitwise its Flax layer
but for the few elements whose f32 sums the two packages order
differently (``tests/test_torch_bf16.py``).  ``torch.autocast`` would
round elsewhere (its LayerNorm returns f32, some of its products stay
f32).  XLA by default drops some of these roundings when it compiles JAX
(``xla_allow_excess_precision``); compiled without that, JAX rounds where
its modules say, and the port's bf16 agrees with it to the contract of
ROADMAP queue 3.  With ``dtype`` f32 each helper calls the layer as
before, so the f32 path is unchanged bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=dtype)`` over ``layer``'s f32 parameters."""
    if dtype == F32:
        return layer(x.to(F32))
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def conv(layer: nn.Conv2d | nn.Conv3d, x: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Conv(dtype=dtype)`` over ``layer``'s f32 parameters
    (channels-first ``x``)."""
    if dtype == F32:
        return layer(x.to(F32))
    y = layer._conv_forward(x.to(dtype), layer.weight.to(dtype), None)
    if layer.bias is None:
        return y
    return y + layer.bias.to(dtype).view(-1, *([1] * (y.dim() - 2)))


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.LayerNorm(dtype=dtype)``: f32 statistics and affine, the
    result in ``dtype``."""
    return layer(x.to(F32)).to(dtype)


def logits_f32(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(equation, a, b)`` with an f32 result: a product of two bf16
    values is exact in f32, so this is the JAX einsum with
    ``preferred_element_type=float32`` (the attention logits)."""
    return torch.einsum(equation, a.to(F32), b.to(F32))


def weak(value: float, x: torch.Tensor) -> float:
    """A Python scalar as JAX's weak typing applies it to ``x``: rounded to
    ``x``'s dtype first (f32 keeps what torch uses anyway)."""
    return torch.tensor(value, dtype=x.dtype).item()


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax's ``nn.gelu`` (the tanh form).  In f32 the fused torch op; in
    bf16 ``jax.nn.gelu`` op by op, each op and constant rounded to bf16 as
    XLA rounds it (the fused op would round once)."""
    if x.dtype == F32:
        return F.gelu(x, approximate="tanh")
    c, k = weak(math.sqrt(2 / math.pi), x), weak(0.044715, x)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))
