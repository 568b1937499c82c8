"""The optimizer's multi-tensor passes against its per-leaf loop.

``OptaxAdamW.step`` runs each stage of the optax chain (accumulation, the
global norm and the clip, the moments, the direction, the decay of the
matrices, the learning rate) as one ``torch._foreach_*`` pass over every
parameter.  ``PerLeaf`` below is the loop over the leaves that it replaced,
written out: the reference here, on the CPU at small sizes (accumulation of
1, 2 and 3 micro-steps, the coarse-only rule, a leaf without a gradient, an
empty leaf, a NaN update that the rule drops) and on the card (``gpu``
marker; skips without one) at the full network's leaves, where one
accumulation micro-step and one update each launch at most
``MAX_LAUNCHES`` kernels and never synchronise the host.  The optax chain
itself is the reference of ``tests/test_torch_train.py``.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_optim.py
"""

import pytest
import torch

from generativedensification_torch.models.network import Network, NetworkConfig
from generativedensification_torch.tools import scenes
from generativedensification_torch.train.optim import (
    OptaxAdamW,
    global_norm,
    warmup_then_constant,
)

torch.set_num_threads(1)

# kernels a step of the full network may launch: about 15 multi-tensor
# passes of ~10 launches each (the loop launched ~9,600 an update, ~1,450
# an accumulation micro-step)
MAX_LAUNCHES = 200


class PerLeaf:
    """The per-leaf arithmetic of ``OptaxAdamW.step``: one leaf at a time,
    each product and sum as its own operation."""

    def __init__(self, params, lr=4e-4, betas=(0.9, 0.95), eps=1e-8,
                 weight_decay=0.05, warmup_iters=1000, grad_clip=0.5, accumulate=1):
        self.params = list(params)
        self.schedule = warmup_then_constant(lr, warmup_iters)
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.grad_clip, self.accumulate = grad_clip, accumulate
        self.state = {p: {k: torch.zeros_like(p) for k in ("acc", "mu", "nu")}
                      for p in self.params}
        self.mini_step = self.count = 0

    @torch.no_grad()
    def step(self, skip_zero_grad=False):
        grads = {p: torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params}
        n = self.mini_step
        for p, g in grads.items():
            st = self.state[p]
            if self.accumulate > 1:
                st["acc"] = st["acc"] + (g - st["acc"]) / (n + 1)
            else:
                st["acc"] = g
        self.mini_step = (n + 1) % self.accumulate
        if self.mini_step:
            return
        acc = [self.state[p]["acc"] for p in self.params]
        g_norm = torch.sqrt(sum(torch.sum(a * a) for a in acc))
        keep = g_norm < self.grad_clip
        count = self.count + 1
        lr = float(self.schedule(self.count))
        f32 = torch.float32
        bc1 = float(1.0 - torch.tensor(self.b1, dtype=f32) ** count)
        bc2 = float(1.0 - torch.tensor(self.b2, dtype=f32) ** count)
        for p in self.params:
            st = self.state[p]
            a = st["acc"]
            g = torch.where(keep, a, (a / g_norm) * self.grad_clip)
            st["mu"] = (1 - self.b1) * g + self.b1 * st["mu"]
            st["nu"] = (1 - self.b2) * (g * g) + self.b2 * st["nu"]
            u = (st["mu"] / bc1) / (torch.sqrt(st["nu"] / bc2) + self.eps)
            if p.dim() >= 2:
                u = u + self.wd * p
            u = -lr * u
            if skip_zero_grad:
                u = torch.where(torch.any(grads[p] != 0), u, torch.zeros_like(u))
            p.add_(u)
            if self.accumulate > 1:
                st["acc"] = torch.zeros_like(a)
        self.count = count


def leaf_shapes():
    """Mixed shapes: matrices and higher (decayed), vectors and scalars
    (not), an empty leaf."""
    shapes = [(0, 3), ()]
    for i in range(40):
        shapes.append([(i % 9 + 1,), (3, i % 5 + 2), (i % 3 + 1, 4, 2), (2 * i + 1,),
                       (1, 1, 3, i % 4 + 1)][i % 5])
    return shapes


def make_pair(shapes, device, seed, **kw):
    """The same random parameters twice: under ``OptaxAdamW`` and under
    ``PerLeaf``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p0 = [torch.randn(s, generator=gen, device=device) for s in shapes]
    mine = [torch.nn.Parameter(p.clone()) for p in p0]
    theirs = [torch.nn.Parameter(p.clone()) for p in p0]
    return mine, OptaxAdamW(mine, **kw), theirs, PerLeaf(theirs, **kw)


def feed(params, grads):
    for p, g in zip(params, grads):
        p.grad = None if g is None else g.clone()


def draw_grads(params, gen, i, missing=()):
    """Micro-step ``i``'s gradients: under the clip on every third, leaf 2
    zero on every fourth (for the coarse-only rule), ``None`` at
    ``missing``."""
    scale = 1e-3 if i % 3 == 0 else 1.0
    out = []
    for j, p in enumerate(params):
        g = scale * torch.randn(p.shape, generator=gen, device=p.device)
        if j == 2 and i % 4 == 1:
            g = torch.zeros_like(g)
        out.append(None if j in missing else g)
    return out


def leaf_gap(a, b) -> float:
    """max |a − b| / max |b| (0 for an empty or all-zero leaf that
    matches)."""
    if not b.numel():
        return 0.0
    d = float((a - b).detach().abs().max())
    return d / max(float(b.detach().abs().max()), 1e-30) if d else 0.0


def state_gap(opt, ref, mine, theirs, key) -> float:
    """max |Δ| of state ``key`` over every leaf / its largest reference
    value: where ``b1 · mu`` and ``(1 − b1) · g`` cancel, the last bits of
    the clip's norm, summed in another order, are more than 1e-6 of a small
    leaf's own values."""
    ours = [opt.state[p][key] for p in mine if p.numel()]
    refs = [ref.state[q][key] for q in theirs if q.numel()]
    d = max(float((a - b).abs().max()) for a, b in zip(ours, refs))
    return d / max(max(float(b.abs().max()) for b in refs), 1e-30) if d else 0.0


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("accumulate", [1, 2, 3])
def test_matches_per_leaf_loop(accumulate, skip):
    """Four updates' micro-steps (a warm-up of 2 updates, so both schedule
    branches run), one leaf never with a gradient: every parameter within
    1e-6 of its largest value after every micro-step, the moments and the
    accumulator within 1e-6 of their largest value, the state the same
    tensors across micro-steps with accumulation."""
    shapes = leaf_shapes()
    mine, opt, theirs, ref = make_pair(shapes, "cpu", 0, warmup_iters=2,
                                       accumulate=accumulate)
    p0 = [p.detach().clone() for p in mine]
    gen = torch.Generator().manual_seed(1)
    held = {}
    for i in range(4 * accumulate):
        grads = draw_grads(mine, gen, i, missing=(5,))
        feed(mine, grads)
        feed(theirs, grads)
        opt.step(skip_zero_grad=skip)
        ref.step(skip_zero_grad=skip)
        for j, (p, q) in enumerate(zip(mine, theirs)):
            assert leaf_gap(p, q) <= 1e-6, (i, j)
        for k in ("acc", "mu", "nu"):
            assert state_gap(opt, ref, mine, theirs, k) <= 1e-6, (i, k)
            for j, p in enumerate(mine):
                if accumulate > 1 or k != "acc":
                    assert held.setdefault((j, k), opt.state[p][k]) is opt.state[p][k]
    assert opt.count == ref.count == 4
    assert max(float((p.detach() - q).abs().max()) for p, q in zip(mine[2:], p0[2:])) > 1e-4


def test_coarse_only_rule_drops_a_nan_update():
    """With ``skip_zero_grad`` a leaf whose gradient is all zero keeps its
    value even where its update is NaN (a NaN first moment); without the
    rule the NaN reaches the parameter; a leaf with a gradient moves."""
    for skip in (True, False):
        params = [torch.nn.Parameter(torch.ones(3, 2)), torch.nn.Parameter(torch.ones(4))]
        opt = OptaxAdamW(params, warmup_iters=1)
        params[0].grad, params[1].grad = torch.zeros(3, 2), torch.full((4,), 0.1)
        opt.step()                                      # state, lr 1e-10
        opt.state[params[0]]["mu"].fill_(float("nan"))
        before = [p.detach().clone() for p in params]
        opt.step(skip_zero_grad=skip)                   # lr 4e-4
        assert torch.equal(params[0], before[0]) == skip
        assert bool(params[0].isnan().all()) != skip
        assert float((params[1].detach() - before[1]).abs().min()) > 1e-4


def test_global_norm_matches_sum_of_squares():
    """``global_norm`` (the train step's ``grad_norm`` and the clip's norm)
    within 1e-6 of the square root of the summed squares."""
    gen = torch.Generator().manual_seed(2)
    ts = [torch.randn(s, generator=gen) * (1 + k % 4) for k, s in enumerate(leaf_shapes())]
    want = torch.sqrt(sum(torch.sum(t.double() * t.double()) for t in ts))
    got = global_norm(ts)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) / float(want) - 1) <= 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the launch count and the host syncs are the card's")
    return torch.device("cuda")


def card_kernels(prof) -> int:
    """Kernels a profiled region launched (copies and sets left out)."""
    n = 0
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", lambda: False)()
                and not e.name().startswith(("Memcpy", "Memset"))):
            n += 1
    return n


def watched_step(opt, **kw) -> int:
    """``opt.step(**kw)`` under the profiler and
    ``set_sync_debug_mode("error")``; the kernels it launched."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step(**kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return card_kernels(prof)


@pytest.mark.gpu
def test_full_network_step_on_card(cuda_device):
    """The training network's leaves (484, 133 M values at the release
    widths) with accumulation 2: after a first update, one accumulation
    micro-step and one update (lr 4e-4) each launch at most
    ``MAX_LAUNCHES`` kernels and synchronise the host nowhere; every
    parameter within 1e-6 of its largest value of ``PerLeaf``'s, the moments
    within 1e-5 of their largest value (the loop adds its 484 leaf sums of
    squares one after another in f32, ~1e-6 from the norm of the leaf
    norms on random sums, up to 484 · 2^-24 in the worst case)."""
    cfg = NetworkConfig.from_config(scenes.fine_config())
    shapes = [p.shape for p in Network(cfg, device="meta").parameters()]
    mine, opt, theirs, ref = make_pair(shapes, cuda_device, 0, warmup_iters=1,
                                       accumulate=2)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    p1 = None
    launches = []
    for i in range(4):
        grads = draw_grads(mine, gen, i + 1)
        feed(mine, grads)
        feed(theirs, grads)
        if i < 2:
            opt.step()
        else:
            p1 = p1 or [p.detach().clone() for p in mine]
            launches.append(watched_step(opt))
        ref.step()
    print(f"{len(shapes)} leaves, {sum(p.numel() for p in mine)} values; "
          f"kernels: accumulation {launches[0]}, update {launches[1]}")
    assert max(launches) <= MAX_LAUNCHES, launches
    for j, (p, q) in enumerate(zip(mine, theirs)):
        assert leaf_gap(p, q) <= 1e-6, j
    for k in ("mu", "nu"):
        assert state_gap(opt, ref, mine, theirs, k) <= 1e-5, k
    assert max(float((p.detach() - q).abs().max()) for p, q in zip(mine, p1)) > 1e-4
