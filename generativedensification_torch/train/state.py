"""The train state, PyTorch.

Port of the ``TrainState`` of ``generativedensification_tpu/train/state.py``:
the micro-step counter, the network (its parameters), the optimizer (its
moments and counters) and the ``torch.Generator`` that every random draw of
a train step comes from (the JAX state's PRNG key).  Checkpoint save and
restore are not ported yet (ROADMAP slice 5).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    step: int                    # micro-steps taken (gates the 2DGS terms)
    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator   # on the network's device


def create_train_state(net, optimizer, seed: int = 0, rank: int = 0) -> TrainState:
    """A state at step 0 whose generator lives on the network's device,
    seeded with ``seed + rank`` (each data-parallel rank draws its own
    masks for its own samples)."""
    dev = next(net.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed + rank)
    return TrainState(step=0, net=net, optimizer=optimizer, generator=gen)
