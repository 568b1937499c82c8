"""Weight bridge: the JAX package's Flax parameter tree -> the port's
``state_dict``.

The port's sub-module names follow the Flax tree, so the bridge renames
(``block{i}`` -> ``blocks.{i}``, ``layer{i}`` -> ``layers.{i}``, the
densifier stages ``dec{s}`` -> ``stages.{s}``, ``scale`` -> ``weight``,
``kernel`` -> ``weight``) and converts layouts:

  * Dense ``(in, out)``                      -> ``(out, in)``
  * DenseGeneral q/k/v kernel ``(in, H, Dh)`` -> ``(H·Dh, in)``, bias
    ``(H, Dh)`` -> ``(H·Dh,)``; out kernel ``(H, Dh, C)`` -> ``(C, H·Dh)``
  * Conv ``(kh, kw, I, O)`` -> ``(O, I, kh, kw)``; Conv3d likewise
  * ConvTranspose ``(kd, kh, kw, I, O)`` -> ``(I, O, kd, kh, kw)`` with all
    three spatial axes FLIPPED: flax's ``ConvTranspose`` (default
    ``transpose_kernel=False``) correlates the stride-dilated input with
    the kernel as stored, torch's ``ConvTranspose3d`` with the kernel
    mirrored
  * the CPE's submanifold-conv kernel ``(27, C_in, C_out)`` keeps its
    layout (the port contracts it the same way)
  * LayerNorm ``scale`` -> ``weight``; PDNorm's per-condition ``scale`` and
    ``bias`` ``(n_conditions, C)`` keep their shapes; other leaves
    (positional and view embeddings, the CLS token) keep theirs too.

The inverse direction — a torch checkpoint into Flax — lives in the JAX
package (``utils/torch_convert.py``); its ConvTranspose3d mapping has no
flip (ROADMAP queue 3), so do not reuse it for the port.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_QKV = {"query", "key", "value", "q", "k", "v"}


def _name(part: str) -> str:
    m = re.fullmatch(r"(block|layer|dec)(\d+)", part)
    if not m:
        return part
    return f"{'stages' if m.group(1) == 'dec' else m.group(1) + 's'}.{m.group(2)}"


def _convert_leaf(path: tuple, value: np.ndarray):
    """(torch leaf name, array) for one Flax leaf at ``path``."""
    leaf, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if leaf == "scale":
        return "weight", value
    if leaf == "bias":
        return "bias", value.reshape(-1) if parent in _QKV else value
    if leaf != "kernel":
        return leaf, value
    if parent == "cpe":                                   # (27, C_in, C_out)
        return "weight", value
    if value.ndim == 2:                                   # Dense
        return "weight", value.T
    if value.ndim == 3 and parent in _QKV:                # (in, H, Dh)
        return "weight", value.reshape(value.shape[0], -1).T
    if value.ndim == 3:                                   # out: (H, Dh, C)
        return "weight", value.reshape(-1, value.shape[-1]).T
    if value.ndim == 4:                                   # Conv2d
        return "weight", value.transpose(3, 2, 0, 1)
    if value.ndim == 5 and parent == "deconv":            # ConvTranspose3d
        return "weight", value.transpose(3, 4, 0, 1, 2)[:, :, ::-1, ::-1, ::-1]
    if value.ndim == 5:                                   # Conv3d
        return "weight", value.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unhandled kernel at {'/'.join(path)}: {value.shape}")


def state_dict_from_flax(params) -> dict[str, torch.Tensor]:
    """Flax parameter tree (nested dicts of arrays, without the top-level
    ``"params"`` key) -> port ``state_dict`` (float32 CPU tensors)."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if hasattr(v, "items"):
                walk(v, path + (k,))
                continue
            name, arr = _convert_leaf(path + (k,), np.asarray(v, np.float32))
            key = ".".join([_name(p) for p in path] + [name])
            out[key] = torch.from_numpy(np.array(arr, np.float32))   # own copy

    walk(params, ())
    return out
