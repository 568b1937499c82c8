"""The train state and its checkpoints, PyTorch.

Port of ``generativedensification_tpu/train/state.py``: the ``TrainState``
(the micro-step counter, the network and its parameters, the optimizer with
its moments, counters and accumulation buffers, and the ``torch.Generator``
that every random draw of a train step comes from: the JAX state's PRNG
key), and checkpoints in place of orbax's ``CheckpointManager``: one
directory per micro-step under the checkpoint directory, ``{dir}/{step}/
state.pt`` written with ``torch.save``, so that ``latest_step`` finds the
newest as orbax does.  Under ``torch.distributed`` every process calls
``save_checkpoint`` (each process's generator is gathered) and only rank 0
writes.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..data.pipeline import process_rank

STATE_FILE = "state.pt"


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


def _step_file(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, str(int(step)), STATE_FILE)


def latest_step(ckpt_dir: str) -> int | None:
    """The largest step with a complete checkpoint in ``ckpt_dir``, or
    ``None``."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir)
             if d.isdigit() and os.path.isfile(_step_file(ckpt_dir, int(d)))]
    return max(steps) if steps else None


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int) -> None:
    """Write ``state`` as ``{ckpt_dir}/{step}/state.pt``: the parameters,
    the optimizer's state dict (moments, accumulator, counters), every
    process's generator state and the micro-step.  The file is written
    under a temporary name and renamed, so a cut save leaves no
    checkpoint that ``latest_step`` would pick."""
    rank, world = process_rank()
    gens = [state.generator.get_state()]
    if world > 1:
        gens = [None] * world
        dist.all_gather_object(gens, state.generator.get_state())
        if rank != 0:
            return
    path = _step_file(ckpt_dir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    blob = {"step": int(state.step), "params": state.net.state_dict(),
            "optimizer": state.optimizer.state_dict(), "generators": gens}
    torch.save(blob, path + ".tmp")
    os.replace(path + ".tmp", path)


def _load(ckpt_dir: str, step: int | None) -> dict:
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    return torch.load(_step_file(ckpt_dir, step), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(ckpt_dir: str, state: TrainState,
                       step: int | None = None) -> TrainState:
    """Load the checkpoint of ``step`` (``None``: the latest) into
    ``state`` in place: parameters, optimizer, this process's generator
    (a rank the checkpoint has no generator for keeps its own) and the
    micro-step.  Returns ``state``."""
    blob = _load(ckpt_dir, step)
    state.net.load_state_dict(blob["params"])
    state.optimizer.load_state_dict(blob["optimizer"])
    rank, _ = process_rank()
    if rank < len(blob["generators"]):
        state.generator.set_state(blob["generators"][rank])
    state.step = int(blob["step"])
    return state


def restore_params(ckpt_dir: str, step: int | None = None) -> dict:
    """The parameters of a training checkpoint alone, as a ``state_dict``
    on the CPU (the evaluation loads training checkpoints without an
    optimizer)."""
    return _load(ckpt_dir, step)["params"]
