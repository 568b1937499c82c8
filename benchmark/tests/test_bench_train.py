"""The train runner on the CPU at a tiny size: the train cell found by name,
a tiny train cell added as data, the result line of a sound run, the
numbers compared and the faults they catch, the reference AdamW against
the program's optimizer, the control's arithmetic, and each train metric's
reader on hand-made readings.

    python -m pytest benchmark/tests/test_bench_train.py -q
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import time
import types
from pathlib import Path

import pytest
import torch

from benchmark.harness import counting, spec, train
from benchmark.tests.test_bench_harness import TINY_MODEL

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
CPU = torch.device("cpu")
SEED = 2**31 + 20241018
# f32 at the tiny size: the program and the reference then differ by the
# compositors' rounding alone (sound readings: loss 8e-8, grad 1.2e-6,
# update 5e-5, coarse maps 6e-7, selection gradients 2e-7), so that a fault
# of 5% stands out
TINY_TRAIN = {"mask_pool": 192, "compute_dtype": "float32", "batch_size": 2,
              "accumulate_grad_batches": 2, "lr": 4e-4, "beta1": 0.9, "beta2": 0.95,
              "warmup_iters": 1000, "weight_decay": 0.05, "gradient_clip_val": 0.5,
              "start_fine": -1}
TINY_TRAFFIC = {"runner": "train", "batch": 2, "views_in": 2, "views_total": 4,
                "image_size": 64, "fov": 0.8, "radius": [1.7, 2.1],
                "elevation": [0.1, 0.5], "trace_from": 1000, "trace_steps": 2}
LIMITS = {"loss": 1e-5, "grad": 1e-4, "update": 5e-4, "update1": 1e-1, "sel_gap": 1e-3,
          "grid_moved": 1e-3, "coarse_maps": 1e-5, "sel_abs": 1e-5}
CONFIG = {"model": dict(TINY_MODEL, compute_dtype="float32", drop_path=0.3,
                        renderer="3dgs"),
          "train": TINY_TRAIN}


@pytest.fixture
def own_budgets(monkeypatch):
    """The tiny model renders with its own budgets: the warm-up budgets'
    8,192 slots a tile make a tiny micro-step ~15 s on the CPU."""
    monkeypatch.setattr(train, "budgets", lambda config: {})


def tiny_checkout(tmp_path: Path) -> tuple:
    """A benchmark folder holding the repository's metric readers and a
    tiny train cell added as data only: its configuration, traffic and
    limits."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir()
    (bench / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (bench / "traffic" / "tiny_train.json").write_text(json.dumps(TINY_TRAFFIC))
    (bench / "limits" / "tiny.train.json").write_text(json.dumps(LIMITS))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec_ = dict(real)
    spec_["configs"] = real["configs"] + [
        {"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
         "reduced": [], "why": "test"}]
    spec_["workloads"] = real["workloads"] + [
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny_train", "chips": 1,
         "why": "test"}]
    add = lambda ms: [dict(m, workloads=m["workloads"] + ["tiny.train"])
                      if "train.3dgs" in m.get("workloads", ()) else m for m in ms]
    spec_["end_to_end"] = add(real["end_to_end"])
    spec_["per_layer"] = add(real["per_layer"])
    return spec_, bench


def run_tiny(tmp_path, seconds=0.5):
    spec_, bench = tiny_checkout(tmp_path)
    cell = spec.Cell(tmp_path, spec_, "tiny.train", bench)
    return spec.run_cell(cell, SEED, seconds, False, CPU, time.time())


# ------------------------------------------------------------ cells as data


def test_the_train_cell_finds_its_files_by_name():
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    from benchmark.reference.models.network import NetworkConfig as RefConfig
    from generativedensification_torch.models.network import NetworkConfig

    cell = spec.Cell(ROOT, real, "train.3dgs")
    assert cell.traffic["runner"] == "train"
    assert set(cell.limits) == set(train.NUMBERS)
    assert cell.config["train"]["batch_size"] == cell.traffic["batch"] == 3
    for fields in (NetworkConfig, RefConfig):
        kw = train.network_kwargs(cell.config, [f.name for f in dataclasses.fields(fields)])
        assert kw["compute_dtype"] == "bfloat16" and kw["mask_pool"] == 49152
    assert train.budgets(cell.config) == dict(
        max_tiles=9, enum_tiles=16, max_per_tile=8192, pair_budget=0.0)
    names = {m["name"] for m in cell.end_to_end}
    assert names == {"train_samples_per_s", "peak_mem_gib", "setup_s"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert per_layer == {"fwd_ms.train", "bwd_ms.train", "optim_ms.train",
                         "data_wait_ms.train", "composite_bwd_roofline.train",
                         "device_idle_pct.train", "mfu.train", "pairs_dropped.train"}
    for n in names | per_layer:
        assert callable(spec.reader(n))
    for w in ("serve.3dgs", "serve.2dgs"):
        assert "train_samples_per_s" not in {m["name"] for m in spec.Cell(ROOT, real, w).end_to_end}


# ------------------------------------------------------------- result line


@pytest.mark.usefixtures("own_budgets")
def test_a_sound_tiny_run_is_correct(tmp_path):
    out = run_tiny(tmp_path)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 2 and out["attempted"] % 2 == 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert out["metrics"]["train_samples_per_s"]["unit"] == "samples/s"
    assert {k: lim for k, (_, lim) in out["checks"].items()} == LIMITS
    json.dumps(out, allow_nan=False)


# --------------------------------------------------------- faults caught


def _optim():
    return train._program("train.optim")


@pytest.mark.usefixtures("own_budgets")
@pytest.mark.parametrize("fault", ["lr", "unchanged"])
def test_a_wrong_update_fails_update(tmp_path, monkeypatch, fault):
    """The learning rate 5% high, or a step that leaves the weights as they
    were."""
    optim = _optim()
    if fault == "lr":
        real = optim.warmup_then_constant
        monkeypatch.setattr(optim, "warmup_then_constant",
                            lambda *a, **k: (lambda c, s=real(*a, **k): s(c) * 1.05))
    else:
        step = optim.OptaxAdamW.step

        def still(self, *a, **k):
            before = [p.detach().clone() for p in self._params()]
            step(self, *a, **k)
            with torch.no_grad():
                for p, b in zip(self._params(), before):
                    p.copy_(b)

        monkeypatch.setattr(optim.OptaxAdamW, "step", still)
    out = run_tiny(tmp_path)
    assert out["correct"] is False
    v, lim = out["checks"]["update"]
    assert v > lim
    if fault == "unchanged":
        assert v > 0.5


@pytest.mark.usefixtures("own_budgets")
def test_a_wrong_gradient_fails_grad(tmp_path):
    """The compositor backward's colour gradient 5% high (``--fault
    colour``)."""
    undo = train._colour_fault()
    try:
        out = run_tiny(tmp_path)
    finally:
        undo()
    assert out["correct"] is False
    v, lim = out["checks"]["grad"]
    assert v > lim


@pytest.mark.usefixtures("own_budgets")
def test_half_the_batch_left_out_fails_loss():
    nums = train.readings(CONFIG, TINY_TRAFFIC, SEED, CPU, fault="half")
    assert nums["loss"] > LIMITS["loss"] and nums["grad"] > LIMITS["grad"]


@pytest.mark.usefixtures("own_budgets")
def test_a_non_finite_loss_counts_as_failed(tmp_path, monkeypatch):
    """A loss that turns non-finite in the window: every micro-step from it
    on fails (its update spreads it), and no sample counts."""
    loss = train._program("train.loss")
    real = loss.Losses.__call__
    checked = 2 * TINY_TRAIN["accumulate_grad_batches"]     # set-up's micro-steps

    def nan_later(self, batch, output, step):
        value, stats = real(self, batch, output, step)
        return (value * math.nan if step >= checked else value), stats

    monkeypatch.setattr(loss.Losses, "__call__", nan_later)
    out = run_tiny(tmp_path)
    assert out["failed"] == out["attempted"] >= 2
    assert out["metrics"]["train_samples_per_s"]["value"] == 0.0


class _Renders(torch.nn.Module):
    """A network whose forward renders in the given ``order``: True for a
    render given the selection targets, False for one without."""

    def __init__(self, order):
        super().__init__()
        self.order = order

    def _render_all(self, batch, cams_all, gs, valid, sel_gt=None):
        return {"image": torch.zeros(1)}

    def forward(self):
        for with_sel in self.order:
            self._render_all(None, None, None, None, 1 if with_sel else None)


@pytest.mark.parametrize("order", [[True, False], [False, True], [True, False, False], [True]])
def test_the_check_follows_only_the_render_structure_it_knows(order):
    """One coarse render with the selection targets, then one fine, in each
    forward; any other pattern stops the run with the reason, rather than
    take one stage's renders for the other's."""
    net = _Renders(order)
    maps = train.CoarseMaps(net)
    try:
        if order == [True, False]:
            net()
            assert len(maps.take()) == 1
        else:
            with pytest.raises(RuntimeError, match="render structure changed"):
                net()
    finally:
        maps.remove()
    assert "_render_all" not in vars(net)
    with pytest.raises(RuntimeError, match="structure changed: no topk_split"):
        train.Choices(types.ModuleType("elsewhere"))


# ------------------------------------------------------ the plain reference


def test_reference_adamw_equals_the_program_optimizer():
    """Three updates of two micro-steps each on a handful of tensors, the
    clip on and off, weight decay on the matrices only."""
    from benchmark.reference.train.adamw import AdamW

    gen = torch.Generator().manual_seed(5)
    shapes = [(4, 3), (3,), (2, 2, 2), (5,)]
    init = [torch.randn(s, generator=gen) for s in shapes]
    a = [torch.nn.Parameter(t.clone()) for t in init]
    b = [torch.nn.Parameter(t.clone()) for t in init]
    prog = _optim().OptaxAdamW(a, lr=4e-2, warmup_iters=2, accumulate=2)
    ref = AdamW(b, lr=4e-2, warmup=2, accumulate=2)
    for i in range(6):
        scale = 0.01 if i < 2 else 10.0           # under the clip, then over it
        for pa, pb in zip(a, b):
            g = torch.randn(pa.shape, generator=gen) * scale
            pa.grad, pb.grad = g.clone(), g.clone()
        prog.step()
        prog.zero_grad(set_to_none=True)
        ref.step()
    assert prog.count == ref.updates == 3
    for pa, pb, t in zip(a, b, init):
        assert not torch.equal(pa, t)
        torch.testing.assert_close(pa, pb, rtol=1e-6, atol=1e-7)


def test_the_control_rounds_products_below_the_policy():
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
    w = torch.randn(16, 4, generator=torch.Generator().manual_seed(2))
    with train.LowPrecision():
        bf = x.bfloat16() @ w.bfloat16()
        f32 = x @ w
        f64 = x.double() @ w.double()
    assert not torch.equal(bf, x.bfloat16() @ w.bfloat16())
    want = x.bfloat16().float() @ w.bfloat16().float()
    torch.testing.assert_close(f32, want)
    assert torch.equal(f64, x.double() @ w.double())


def test_flops_by_dtype_counts_forward_and_backward():
    lin = torch.nn.Linear(4, 8, bias=False)
    x = torch.ones(3, 4)
    f = counting.flops_by_dtype(lambda: lin(x).sum().backward())
    assert f == {"torch.float32": 2 * (2 * 3 * 4 * 8)}
    assert counting.seconds_at_peak({"torch.bfloat16": 989e12, "torch.float32": 67e12}) == 2.0


# ------------------------------------------------------- the metric readers


def test_each_train_metric_reads_hand_made_readings():
    r = {"attempted": 10, "failed": 2, "samples_per_step": 3, "window_s": 4.0,
         "spans_ms": {"step": 900.0, "fwd": 400.0, "optim": 20.0},
         "data_wait_ms": 1.5, "pairs_dropped": 12.0,
         "trace": {"busy_s": 3.0, "window_s": 4.0,
                   "by_name": {"void composite_bwd_kernel<1>": 0.5, "other": 2.0}},
         "launch_costs": [("composite_bwd", 3.35e9, 0), ("composite_fwd", 1, 1)],
         "traced_requests": 4,
         "flops_by_dtype": {"torch.bfloat16": 989e12 * 0.01, "torch.float32": 67e12 * 0.02}}
    read = lambda n: spec.reader(n)(r)
    assert read("train_samples_per_s") == 8 * 3 / 4.0
    assert read("fwd_ms.train") == 400.0 and read("optim_ms.train") == 20.0
    assert read("bwd_ms.train") == 480.0
    assert read("data_wait_ms.train") == 1.5
    assert read("pairs_dropped.train") == 12.0
    assert read("device_idle_pct.train") == pytest.approx(25.0)
    # 3.35e9 bytes at 3.35e12 B/s: 1 ms a micro-step, 4 traced, over 0.5 s
    assert read("composite_bwd_roofline.train") == pytest.approx(0.8)
    assert read("mfu.train") == pytest.approx(100.0 * 0.03 * 8 / 4.0)
    empty = {"attempted": 0, "failed": 0, "window_s": 1.0}
    for n in ("fwd_ms.train", "bwd_ms.train", "composite_bwd_roofline.train",
              "device_idle_pct.train", "mfu.train", "pairs_dropped.train"):
        assert spec.reader(n)(empty) is None
