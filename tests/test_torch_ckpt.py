"""The port's checkpoints (``train/state.py``): save and restore bit for
bit (parameters, the AdamW moments and counters, the accumulation buffers,
the generator, the micro-step), the params-only restore, ``latest_step``,
a resumed micro-step bitwise the uninterrupted one, and two processes
(gloo) sharding a loader and saving each one's generator.  The counterparts
of the JAX package's ``tests/test_train.py::TestCheckpointRoundtrip``."""

import os
import socket

import pytest
import torch
import torch.multiprocessing as mp

from generativedensification_torch.data.synthetic import make_probe_batch
from generativedensification_torch.models import network as tnet
from generativedensification_torch.train.optim import make_optimizer
from generativedensification_torch.train.state import (
    create_train_state,
    latest_step,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)
from generativedensification_torch.train.step import make_train_step
from test_torch_fine import FINE

torch.set_num_threads(1)


def _tiny_state(seed=0):
    """A small module and an accumulating optimizer advanced by one update
    and one more micro-step, so that moments, counters and the accumulator
    are all non-trivial."""
    torch.manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.LayerNorm(3))
    opt = make_optimizer(net, accumulate=2)
    state = create_train_state(net, opt, seed=3)
    for k in range(3):
        for p in net.parameters():
            p.grad = torch.full_like(p, 0.1 * (k + 1))
        opt.step()
    torch.rand(5, generator=state.generator)
    state.step = 7
    return state


def _optimizer_tensors(opt):
    return [(k, v) for st in opt.state.values() for k, v in sorted(st.items())]


def test_save_restore_bitwise(tmp_path):
    state = _tiny_state()
    assert state.optimizer.mini_step == 1 and state.optimizer.count == 1
    ckpt = str(tmp_path / "ckpts")
    save_checkpoint(ckpt, state, 7)
    assert latest_step(ckpt) == 7
    fresh = _tiny_state(seed=1)
    fresh.optimizer.mini_step, fresh.optimizer.count = 0, 5
    fresh.generator.manual_seed(99)
    fresh.step = 0
    restored = restore_checkpoint(ckpt, fresh)
    assert restored is fresh and restored.step == 7
    for a, b in zip(state.net.parameters(), restored.net.parameters()):
        assert torch.equal(a, b)
    ta, tb = _optimizer_tensors(state.optimizer), _optimizer_tensors(restored.optimizer)
    assert [k for k, _ in ta] == [k for k, _ in tb] and {k for k, _ in ta} == {"acc", "mu", "nu"}
    for (_, a), (_, b) in zip(ta, tb):
        assert torch.equal(a, b)
    assert (restored.optimizer.mini_step, restored.optimizer.count) == (1, 1)
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    assert torch.equal(torch.rand(4, generator=restored.generator),
                       torch.rand(4, generator=state.generator))


def test_params_only_restore_and_latest_step(tmp_path):
    """The evaluation's restore: the parameters alone, no optimizer."""
    state = _tiny_state()
    ckpt = str(tmp_path / "ckpts")
    assert latest_step(ckpt) is None
    with pytest.raises(FileNotFoundError):
        restore_params(ckpt)
    save_checkpoint(ckpt, state, 7)
    first = {k: v.clone() for k, v in state.net.state_dict().items()}
    with torch.no_grad():
        for p in state.net.parameters():
            p.add_(1.0)
    save_checkpoint(ckpt, state, 12)
    os.makedirs(os.path.join(ckpt, "30"))          # no state.pt: not a step
    assert latest_step(ckpt) == 12
    params = restore_params(ckpt)
    assert set(params) == set(first)
    for k, v in state.net.state_dict().items():
        assert torch.equal(params[k], v)
    for k, v in restore_params(ckpt, step=7).items():
        assert torch.equal(v, first[k])


def _train_setup(seed):
    cfg = tnet.NetworkConfig(**FINE, drop_path=0.3)    # drop-path and shuffling draw
    net = tnet.Network(cfg, device="cpu", seed=seed)
    opt = make_optimizer(net, accumulate=2)
    return net, opt, create_train_state(net, opt, seed=seed)


def test_resumed_micro_step_is_bitwise(tmp_path):
    """Three micro-steps straight through against one micro-step, a save, a
    restore into a network from other weights, and two more: the same
    losses and the same parameters, bit for bit, under deterministic
    algorithms (the random draws of drop-path and order shuffling come from
    the restored generator)."""
    batch = make_probe_batch(1, 4, 64, 64, 2, seed=0, device="cpu")
    ckpt = str(tmp_path / "ckpts")
    torch.use_deterministic_algorithms(True)
    try:
        net, opt, st = _train_setup(0)
        step = make_train_step(net, opt, with_fine=True)
        losses = []
        for i in range(3):
            st, stats = step(st, batch)
            losses.append(float(stats["loss"]))
            if i == 0:
                save_checkpoint(ckpt, st, st.step)
        net2, opt2, st2 = _train_setup(1)
        st2 = restore_checkpoint(ckpt, st2)
        assert st2.step == 1 and opt2.mini_step == 1
        step2 = make_train_step(net2, opt2, with_fine=True)
        resumed = []
        for _ in range(2):
            st2, stats = step2(st2, batch)
            resumed.append(float(stats["loss"]))
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed == losses[1:] and st2.step == st.step == 3
    assert opt.count == opt2.count == 1
    for (k, a), b in zip(net.named_parameters(), net2.parameters()):
        assert torch.equal(a, b), k


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, world, port, ckpt, out):
    import torch.distributed as dist

    from generativedensification_torch.data.pipeline import BatchLoader
    from test_torch_data import _Fake, _ids

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        loader = BatchLoader(_Fake(8), 2, shuffle=False)
        net = torch.nn.Linear(2, 2)
        state = create_train_state(net, make_optimizer(net), seed=5, rank=rank)
        state.step = 3
        save_checkpoint(ckpt, state, 3)
        dist.barrier()
        mine = state.generator.get_state().clone()
        state.generator.manual_seed(1234)
        restore_checkpoint(ckpt, state)
        out.put((rank, loader.process_index, loader.process_count, _ids(loader),
                 torch.equal(state.generator.get_state(), mine)))
    finally:
        dist.destroy_process_group()


def test_two_processes_shard_and_checkpoint(tmp_path):
    """Under ``torch.distributed`` (two gloo processes) a loader takes its
    rank and world size from the process group and its round-robin shard;
    every process calls ``save_checkpoint``, rank 0 writes one file that
    holds both generators, and each process restores its own."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    ckpt = str(tmp_path / "ckpts")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, 2, port, ckpt, out)) for r in (0, 1)]
    for p in procs:
        p.start()
    res = sorted(out.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert [r[1:3] for r in res] == [(0, 2), (1, 2)]
    assert res[0][3] == [[0, 2], [4, 6]] and res[1][3] == [[1, 3], [5, 7]]
    assert all(r[4] for r in res)
    assert os.listdir(ckpt) == ["3"] and os.listdir(os.path.join(ckpt, "3")) == ["state.pt"]
    blob = torch.load(os.path.join(ckpt, "3", "state.pt"), weights_only=True)
    assert len(blob["generators"]) == 2 and blob["step"] == 3
