"""The port's train CLI (``generativedensification_torch.train.train``) on
the CPU at a tiny synthetic configuration: ``main`` trains at the config
defaults (bf16 compute policy, fused selection, ``start_fine`` -1,
accumulation 2, the overflow-free warmup budgets first) with finite losses,
validates, writes its checkpoint, and a second ``main`` resumes it at the
saved micro-step with the saved parameters bit for bit; ``rand_views_at``
is the JAX function's sequence, and the warm and tight step variants drive
one set of parameters."""

import dataclasses

import numpy as np
import pytest
import torch

from generativedensification_tpu.train.train import rand_views_at as j_rand_views_at
from generativedensification_torch.config import load_config
from generativedensification_torch.data.synthetic import make_probe_batch
from generativedensification_torch.models import network as tnet
from generativedensification_torch.splat import kernels
from generativedensification_torch.train import train as cli
from generativedensification_torch.train.state import latest_step
from test_eval import TINY

torch.set_num_threads(1)

SCENES = 4


def _overrides(tmp_path, *extra):
    ds = [f"{g}.{k}" for g in ("train_dataset", "test_dataset") for k in (
        "dataset_name=synthetic", "img_size=[64,64]", f"n_scenes={SCENES}",
        "n_gaussians=128")]
    return TINY + ds + [
        "train.batch_size=1", "train.n_epoch=1", "train.limit_train_batches=1.0",
        "train.limit_val_batches=0.25", f"logger.dir={tmp_path}", "exp_name=tiny",
        "tpu.overflow_warmup_steps=2", "tpu.warmup_max_per_tile=512",
        "tpu.overflow_alarm=off", *extra]


@pytest.mark.parametrize("seed", [0, 5])
def test_rand_views_at_matches_jax(seed):
    got = [cli.rand_views_at(seed, s) for s in range(200)]
    assert got == [j_rand_views_at(seed, s) for s in range(200)]
    assert set(got) == {2, 3, 4}


def test_warm_and_tight_variants_share_parameters():
    """A step variant is the network with its ``cfg`` replaced for the call:
    the warmup budgets (pair budget off) inside, the tight ones after, and
    the same parameter tensors throughout."""
    cfg = load_config(overrides=TINY)
    net = tnet.Network(tnet.NetworkConfig.from_config(cfg), device="cpu")
    tight = net.cfg
    params = list(net.parameters())
    warm = dataclasses.replace(tight, **cli.warmup_budgets(cfg))
    assert (warm.max_tiles, warm.enum_tiles, warm.max_per_tile, warm.pair_budget) == (
        9, 16, 8192, 0.0)
    batch = make_probe_batch(1, 4, 64, 64, 2, seed=0, device="cpu")
    with torch.no_grad():
        with cli.network_config(net, warm) as v:
            assert v is net and net.cfg is warm
            assert all(a is b for a, b in zip(v.parameters(), params))
            ov_warm = int(net(batch)["overflow"].sum())
        assert net.cfg is tight
        ov_tight = int(net(batch)["overflow"].sum())
    assert all(a is b for a, b in zip(net.parameters(), params))
    assert ov_warm < ov_tight        # the warm budgets drop fewer pairs
    surfel = load_config(overrides=TINY + ["tpu.renderer=2dgs"])
    assert cli.warmup_budgets(surfel)["max_per_tile"] == 16384


def test_main_trains_validates_and_resumes(tmp_path, monkeypatch):
    """``main`` for one epoch of 4 micro-steps (2 optimizer updates) at the
    defaults, scalars logged every 2 micro-steps; then a ``main`` with
    ``model.ckpt_path`` and no epochs restores the checkpoint, the
    evaluation serves it (``infer.ckpt_path``), and one more epoch
    continues from its step (NaN guard on, one micro-step profiled)."""
    monkeypatch.setattr(cli, "LOG_EVERY", 2)
    logs = []
    real_log = cli.ScalarLog

    def capture(cfg, rank=0):
        logs.append(real_log(cfg, rank))
        return logs[-1]

    monkeypatch.setattr(cli, "ScalarLog", capture)
    cfg = load_config(overrides=_overrides(tmp_path))
    assert cfg.tpu.compute_dtype == "bfloat16" and cfg.train.accumulate_grad_batches == 2
    kernels.reset_launch_counts()
    state = cli.main(cfg, device="cpu")
    assert not any(kernels.launch_counts.values())   # CPU: no launch
    assert state.step == SCENES and state.optimizer.count == 2
    assert state.net.cfg.dtype == torch.bfloat16
    train = [s for p, _, s in logs[0].history if p == "train"]
    val = [s for p, _, s in logs[0].history if p == "val"]
    assert [st for p, st, _ in logs[0].history if p == "train"] == [2, 4]
    assert len(val) == 1 and np.isfinite(val[0]["loss"])
    for s in train:
        assert np.isfinite(s["loss"]) and s["samples_per_s"] > 0 and s["lr"] > 0
    ckpt = tmp_path / "tiny" / "ckpts"
    assert latest_step(str(ckpt)) == SCENES

    resumed = cli.main(load_config(overrides=_overrides(
        tmp_path, f"model.ckpt_path={ckpt}", "train.n_epoch=0")), device="cpu")
    assert resumed.step == SCENES and resumed.optimizer.count == 2
    for (k, a), b in zip(state.net.named_parameters(), resumed.net.parameters()):
        assert torch.equal(a, b), k
    # the evaluation serves a directory of these checkpoints
    from generativedensification_torch.eval import evaluation as teval

    nets = []
    real_net = teval.Network
    monkeypatch.setattr(teval, "Network", lambda *a, **k: nets.append(
        real_net(*a, **k)) or nets[-1])
    res = teval.main(teval.config_from_args(TINY + [
        "infer.dataset.dataset_name=synthetic", "infer.dataset.n_scenes=1",
        "infer.dataset.img_size=[64,64]", "infer.dataset.n_group=2",
        "infer.save_images=0", f"infer.save_folder={tmp_path / 'eval'}",
        f"infer.ckpt_path={ckpt}"]), device="cpu")
    assert np.isfinite(res["mean"]["psnr"])
    for (k, a), b in zip(state.net.named_parameters(), nets[0].parameters()):
        assert torch.equal(a, b), k

    # one more epoch from the checkpoint, under tpu.nan_check, with the
    # profiler tracing micro-step 5
    monkeypatch.setattr(cli, "PROFILE_STEP", SCENES + 1)
    more = cli.main(load_config(overrides=_overrides(
        tmp_path, f"model.ckpt_path={ckpt}", "exp_name=more", "tpu.nan_check=true",
        f"tpu.profile_dir={tmp_path / 'trace'}")), device="cpu")
    assert more.step == 2 * SCENES and more.optimizer.count == 4
    assert latest_step(str(tmp_path / "more" / "ckpts")) == 2 * SCENES
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
