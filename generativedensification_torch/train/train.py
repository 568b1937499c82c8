"""Training entry point, PyTorch.

    python -m generativedensification_torch.train.train [base.yaml ...] [key=value ...]
    torchrun --nproc_per_node=N -m generativedensification_torch.train.train ...

Port of ``generativedensification_tpu/train/train.py``: the same config
surface (the defaults of ``config/defaults.py``, then yaml files, then
dotted overrides) and schedule (epochs cut by ``limit_train_batches``,
validation every ``check_val_every_n_epoch`` epochs on ``limit_val_batches``
of the test set, a checkpoint every ``ckpt_every_n_epoch`` epochs and after
the last), with the loop's parts in the JAX order: the ``start_fine``
switch, ``use_rand_views``, the overflow-free warmup budgets for the first
``tpu.overflow_warmup_steps`` micro-steps (pair budget off), the scalar log
every 20 micro-steps with ``lr`` and the loader-attached ``samples_per_s``,
the overflow alarm, image panels every ``logger.image_interval`` steps,
TensorBoard (tensorboardX) or wandb when installed, resume from
``model.ckpt_path``, ``tpu.nan_check`` and a ``torch.profiler`` trace of
micro-step 20 into ``tpu.profile_dir``.  That trace shows the forward's
``gd.*`` ranges (``utils/tracing.py``: the encoder, the volume transformer,
each densifier stage, and each render's projection, binning, compositor and
selection backward) beside the ``aten::`` ops.

It runs on the card (``device=None``); the tests pass ``device="cpu"``.
Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` in the environment) every process trains
on its own card, loads its own round-robin shard of ``train.batch_size``
samples per micro-step, and ``train/step.py`` sums the gradients of the
global batch; only rank 0 logs and writes checkpoints.

A step variant of JAX (``Network(dataclasses.replace(net_cfg, **over))``
driven with the same parameter tree) is here the same module with its
``cfg`` replaced for the call (``network_config``): budgets and source-view
count are read at forward time, and the parameters stay the module's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import load_config
from ..data import BatchLoader, build_dataset
from ..data.pipeline import process_rank, to_device_batch
from ..models.network import Network, NetworkConfig
from ..utils.debugging import maybe_profile, nan_guard
from ..utils.device import resolve_device
from .loss import Losses
from .optim import make_optimizer
from .state import create_train_state, restore_checkpoint, save_checkpoint
from .step import make_eval_step, make_train_step

# The train and eval steps consume only tar_rgb, tar_c2w, tar_w2c, tar_ixt,
# tar_rays_down, fovx, fovy, near_far and bg_color; the full-resolution
# rays, masks, normals and depths of the loaders feed the evaluation CLI's
# side outputs, and moving them to the device every step is waste.
_DROP_KEYS = ("tar_rays", "tar_msk", "tar_nrm", "tar_dep")
LOG_EVERY = 20          # micro-steps per scalar log (and per samples/s window)
PROFILE_STEP = 20       # the micro-step traced into tpu.profile_dir


def rand_views_at(seed: int, step: int) -> int:
    """Per-step source-view count in {2, 3, 4} (reference
    network.py:777-779).  Stateless — derived from (seed, step) so a
    checkpoint resume replays the identical sequence from any step."""
    return 2 + int(
        np.random.default_rng((seed + 17) * 1_000_003 + step).integers(0, 3)
    )


def warmup_budgets(cfg) -> dict:
    """The overflow-free budgets of the first ``tpu.overflow_warmup_steps``
    micro-steps: measured from random init per renderer (2DGS surfels have
    larger random-init footprints), overridable by ``tpu.warmup_*``, pair
    budget off."""
    is_2dgs = cfg.tpu.get("renderer", "3dgs") == "2dgs"
    mt, et, mpt = (16, 25, 16384) if is_2dgs else (9, 16, 8192)
    return dict(
        max_tiles=int(cfg.tpu.get("warmup_max_tiles") or mt),
        enum_tiles=int(cfg.tpu.get("warmup_enum_tiles") or et),
        max_per_tile=int(cfg.tpu.get("warmup_max_per_tile") or mpt),
        pair_budget=0.0,
    )


@contextlib.contextmanager
def network_config(net: Network, cfg: NetworkConfig):
    """Run ``net`` with ``cfg`` in place of its own (a step variant)."""
    own = net.cfg
    net.cfg = cfg
    try:
        yield net
    finally:
        net.cfg = own


class ScalarLog:
    """Scalars and image panels to TensorBoard (tensorboardX) or wandb
    (``logger.name``), whichever is installed; off on ranks > 0 and where
    neither is.  ``history`` keeps every logged (prefix, step, scalars)."""

    def __init__(self, cfg, rank: int = 0):
        self.history: list[tuple[str, int, dict]] = []
        self.tb = self.wandb = None
        if rank != 0:
            return
        if cfg.logger.get("name", "tensorboard") == "wandb":
            try:
                import wandb

                wandb.init(project=cfg.logger.get("project", "gd_tpu"),
                           name=cfg.exp_name, config=dict(cfg))
                self.wandb = wandb
            except Exception as e:      # not installed, no login, offline
                print(f"[train] wandb unavailable ({e}); falling back to TB")
        if self.wandb is None:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            self.tb = SummaryWriter(os.path.join(cfg.logger.dir, cfg.exp_name, "tb"))

    @property
    def enabled(self) -> bool:
        return bool(self.tb or self.wandb)

    def scalars(self, prefix: str, scalars: dict, step: int) -> None:
        self.history.append((prefix, step, dict(scalars)))
        if self.wandb:
            self.wandb.log({f"{prefix}/{k}": v for k, v in scalars.items()}, step=step)
        elif self.tb:
            for k, v in scalars.items():
                self.tb.add_scalar(f"{prefix}/{k}", v, step)

    def panel(self, batch_np: dict, out: dict, step: int) -> None:
        """gt / coarse / fine panel of sample 0 (reference system.py:42-43
        and vis.py)."""
        from ..utils.vis import make_panel

        B, V, H, W, _ = batch_np["tar_rgb"].shape
        gt = batch_np["tar_rgb"][0].transpose(1, 0, 2, 3).reshape(H, V * W, 3)
        host = lambda t: t[0].float().cpu().numpy()
        panel = make_panel(gt, host(out["image"]),
                           host(out.get("image_fine", out["image"])),
                           depth=host(out["depth"])[..., 0])
        if self.wandb:
            self.wandb.log({"train/panel": self.wandb.Image(panel)}, step=step)
        elif self.tb:
            self.tb.add_image("train/panel", panel.transpose(2, 0, 1), step)

    def close(self) -> None:
        if self.tb:
            self.tb.close()


def _say(rank: int, msg: str) -> None:
    if rank == 0:
        print(msg, flush=True)


def main(cfg, device=None):
    """Train per ``cfg``; returns the final ``TrainState``.  ``device=None``
    trains on the card (this process's card under ``torchrun``)."""
    t_start = time.time()
    dev = resolve_device(device)
    rank, world = process_rank()
    _say(rank, f"[train] {world} process(es) on {dev}")

    train_ds = build_dataset(cfg.train_dataset, device=dev)
    val_ds = build_dataset(cfg.test_dataset, device=dev)
    batch_size = int(cfg.train.batch_size)
    global_batch = batch_size * world
    train_loader = BatchLoader(train_ds, batch_size, shuffle=True,
                               epoch_fraction=cfg.train.limit_train_batches)
    val_loader = BatchLoader(val_ds, batch_size, shuffle=False,
                             epoch_fraction=cfg.train.limit_val_batches)

    net_cfg = NetworkConfig.from_config(cfg)
    net = Network(net_cfg, device=dev, seed=int(cfg.tpu.seed))
    losses = Losses()
    n_params = sum(p.numel() for p in net.parameters())
    _say(rank, f"[train] {n_params / 1e6:.1f}M parameters, "
               f"compute dtype {net_cfg.compute_dtype}")
    opt = make_optimizer(
        net, lr=cfg.train.lr, beta1=cfg.train.beta1, beta2=cfg.train.beta2,
        weight_decay=cfg.train.weight_decay, warmup_iters=cfg.train.warmup_iters,
        grad_clip=cfg.train.get("gradient_clip_val", 0.5),
        accumulate=cfg.train.get("accumulate_grad_batches", 1))
    state = create_train_state(net, opt, seed=int(cfg.tpu.seed), rank=rank)

    ckpt_dir = os.path.join(cfg.logger.dir, cfg.exp_name, "ckpts")
    if cfg.model.ckpt_path:
        state = restore_checkpoint(cfg.model.ckpt_path, state)
        _say(rank, f"[train] resumed from {cfg.model.ckpt_path} @ step {state.step}")

    # step variants per (fine, n_views, warm): start_fine >= 0 switches the
    # fine stage on past that step; use_rand_views draws 2-4 source views
    # per step; the first overflow_warmup_steps micro-steps bin with the
    # warmup budgets, then the tight ones
    start_fine = cfg.train.start_fine
    use_rand_views = bool(cfg.train.get("use_rand_views", False))
    warmup_steps = int(cfg.tpu.get("overflow_warmup_steps", 0))
    steps: dict = {}

    def get_train_step(fine: bool, n_views: int, warm: bool = False):
        key = (fine, n_views, warm)
        if key not in steps:
            over = {}
            if n_views != net_cfg.n_views:
                over["n_views"] = n_views
            if warm:
                over.update(warmup_budgets(cfg))
            cfg_v = dataclasses.replace(net_cfg, **over)
            fn = make_train_step(net, opt, losses, with_fine=fine)

            def step_fn(state, batch, fn=fn, cfg_v=cfg_v):
                with network_config(net, cfg_v):
                    return fn(state, batch)

            steps[key] = nan_guard(step_fn, enabled=bool(cfg.tpu.nan_check))
        return steps[key]

    eval_step = make_eval_step(net, losses, with_fine=True)
    log = ScalarLog(cfg, rank)
    profile_dir = cfg.tpu.profile_dir

    def device_batch(batch_np):
        return to_device_batch(
            {k: v for k, v in batch_np.items() if k not in _DROP_KEYS}, dev)

    step = state.step
    t_win = time.time()
    for epoch in range(cfg.train.n_epoch):
        for batch_np in train_loader:
            batch = device_batch(batch_np)
            fine_now = start_fine < 0 or step > start_fine
            v_now = (rand_views_at(cfg.tpu.seed, step) if use_rand_views
                     else net_cfg.n_views)
            train_step = get_train_step(fine_now, v_now, step < warmup_steps)
            with maybe_profile(profile_dir if step == PROFILE_STEP else None):
                state, stats = train_step(state, batch)
            step += 1
            if step % LOG_EVERY == 0:
                s = {k: float(v) for k, v in stats.items()}
                s["lr"] = float(opt.schedule(step))
                # loader-attached wall throughput over the window (the first
                # window absorbs the warm-up; later windows are the end-to-end
                # rate with host loading and transfer)
                now = time.time()
                s["samples_per_s"] = LOG_EVERY * global_batch / max(now - t_win, 1e-9)
                t_win = now
                msg = " ".join(f"{k}={v:.4g}" for k, v in sorted(s.items()))
                _say(rank, f"[epoch {epoch} step {step}] {msg}")
                log.scalars("train", s, step)
                # overflow alarm: dropped (Gaussian, tile) pairs silently zero
                # those pairs' gradients, so healthy training has none;
                # tpu.overflow_alarm "warn" (default) | "raise" | "off" (the
                # yaml override parser reads a bare off as False)
                alarm = cfg.tpu.get("overflow_alarm", "warn")
                if alarm and alarm != "off" and s.get("overflow", 0.0) > 0:
                    msg = (
                        f"[train] OVERFLOW ALARM @ step {step}: "
                        f"{s['overflow']:.0f} live pairs dropped by the "
                        "static budgets (gradients silently zeroed). "
                        + ("Still in warmup budgets — raise "
                           "tpu.warmup_max_tiles/warmup_max_per_tile."
                           if step <= warmup_steps else
                           "Raise tpu.overflow_warmup_steps or the tight "
                           "budgets (tpu.max_tiles/max_per_tile/pair_budget).")
                    )
                    if alarm == "raise":
                        raise RuntimeError(msg)
                    _say(rank, msg)
            if step % int(cfg.logger.get("image_interval", 1000)) == 0 and log.enabled:
                out, _ = eval_step(batch)
                log.panel(batch_np, out, step)

        # validation: the mean of each metric over the validation slice
        if (epoch + 1) % cfg.train.check_val_every_n_epoch == 0:
            accum, n = {}, 0
            for batch_np in val_loader:
                _, stats = eval_step(device_batch(batch_np))
                for k, v in stats.items():
                    accum[k] = accum.get(k, 0.0) + float(v)
                n += 1
            if n:
                means = {k: v / n for k, v in accum.items()}
                _say(rank, f"[val epoch {epoch}] " + " ".join(
                    f"{k}={v:.4g}" for k, v in sorted(means.items())))
                log.scalars("val", means, step)

        ckpt_every = int(cfg.train.get("ckpt_every_n_epoch", 2))
        if (epoch + 1) % ckpt_every == 0 or epoch == cfg.train.n_epoch - 1:
            save_checkpoint(ckpt_dir, state, step)
            _say(rank, f"[train] checkpoint @ step {step} -> {ckpt_dir}")

    log.close()
    _say(rank, f"[train] done in {(time.time() - t_start) / 60:.1f} min")
    return state


def init_distributed() -> None:
    """Start ``torch.distributed`` from ``torchrun``'s environment (NCCL on
    cards, each process on its ``LOCAL_RANK`` card; gloo on the CPU); a
    single process (no ``WORLD_SIZE`` above 1) starts nothing."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        world_size=world, rank=int(os.environ["RANK"]))


def cli(args: list[str] | None = None):
    args = sys.argv[1:] if args is None else args
    yamls = [a for a in args if a.endswith((".yaml", ".yml"))]
    overrides = [a for a in args if "=" in a and not a.endswith((".yaml", ".yml"))]
    cfg = load_config(yamls, overrides)
    init_distributed()
    try:
        main(cfg)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    cli()
