"""The quality regression: overfit the tiny network on one synthetic scene.

Port of ``tests/test_overfit.py``, the JAX package's standing substitute
for scoring the released checkpoints (none offline): the tiny full pipeline
(coarse, selection, densifier, fine render) trains on one procedurally
rendered 64² scene and must raise image quality, with budgets that drop
nothing.  Three cases, each at that file's configuration, step count,
learning rate, warmup and thresholds:

- ``3dgs``: 90 steps; the coarse PSNR rises by more than 1.5 dB from step
  4 and ends above 14 dB;
- ``2dgs``: the surfel renderer past micro-step 1000 (distortion and
  normal terms on), 25 steps; the fine PSNR rises by more than 1 dB from
  step 4, the regularizer terms finite;
- ``residual``: ``enable_residual_attribute=True``, 30 steps at warmup
  10; the fine PSNR rises by more than 0.5 dB from step 2.

Weights are seeded (``Network(cfg, seed=0)``), so the trajectory is the
port's own, not JAX's.  ``tests/test_torch_overfit.py`` runs the cases on
the CPU, ``chip_smoke.py`` on the card.
"""

from __future__ import annotations

import math
import time

TINY = dict(
    n_views=2, encoder_backbone="tiny_test", n_groups=(4,), n_offset_groups=8,
    num_layers=1, num_heads=4, view_embed_dim=8, embedding_dim=32,
    vol_feat_reso=4, vol_embedding_reso=8, vol_embedding_out_dim=16, k_num=96,
    dec_depths=(1, 1), dec_channels=(32, 48), dec_num_head=(4, 6),
    dec_patch_size=(48, 48), drop_path=0.0, non_leaf_ratio=(0.75,),
    upscale_factor=(2, 4),
    # geometry-proof budgets: the 64 px image has 4 x 4 tiles of 16 px, so
    # max_tiles=16 bins any splat exactly; max_per_tile bounds the tile's
    # occupancy (the 2DGS distortion weight grows early surfels over every
    # tile, so the surfel cases allow the whole coarse set)
    mask_pool=192, tile_size=16, max_tiles=16, max_per_tile=1024,
)

# case -> (config changes, steps, warmup, first step read, start micro-step,
# the PSNR prefix that must rise, the rise it needs, a final floor or None)
CASES = {
    "3dgs": (dict(), 90, 20, 4, 0, "psnr", 1.5, 14.0),
    "2dgs": (dict(max_per_tile=4096, renderer="2dgs"), 25, 20, 4, 2000,
             "psnr_fine", 1.0, None),
    "residual": (dict(max_per_tile=4096, enable_residual_attribute=True), 30, 10,
                 2, 0, "psnr_fine", 0.5, None),
}
LR = 2e-3


def scene_batch(device):
    """One 64² synthetic scene (2 views per group, 96 Gaussians), as
    ``tests/test_overfit.py::_scene_batch`` builds it."""
    from ..config.confignode import ConfigNode
    from ..data.pipeline import collate, to_device_batch
    from ..data.synthetic import SyntheticDataset

    ds = SyntheticDataset(ConfigNode(dict(img_size=[64, 64], n_group=2, n_scenes=1,
                                          n_gaussians=96)), device=device)
    return to_device_batch(collate([ds[0]]), device)


def run_case(name: str, device=None, batch=None) -> dict:
    """Train one case on ``batch`` (``scene_batch(device)`` if None);
    returns its PSNR trajectory, the last step's stats, the seconds, and
    the names of the failed checks (``finite``, ``rise``, ``floor``,
    ``regularizers``, ``overflow``; empty when the case passes)."""
    from ..models.network import Network, NetworkConfig
    from ..train.loss import Losses
    from ..train.optim import make_optimizer
    from ..train.state import create_train_state
    from ..train.step import make_train_step

    changes, steps, warmup, first_at, step0, key, rise, floor = CASES[name]
    net = Network(NetworkConfig(**{**TINY, **changes}), device=device, seed=0)
    if batch is None:
        batch = scene_batch(device)
    opt = make_optimizer(net, lr=LR, warmup_iters=warmup, accumulate=1)
    state = create_train_state(net, opt, seed=0)
    state.step = step0
    step = make_train_step(net, opt, Losses(ssim_levels=2), with_fine=True)
    trace = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, stats = step(state, batch)
        trace.append(float(stats[key]))
    seconds = time.perf_counter() - t0
    stats = {k: float(v) for k, v in stats.items()}
    first, final = trace[first_at], trace[-1]
    checks = {
        "finite": all(math.isfinite(stats[k]) for k in ("psnr", "psnr_fine")),
        "rise": final - first > rise,
        "floor": floor is None or final > floor,
        "regularizers": name != "2dgs" or all(
            math.isfinite(stats.get(k, math.nan)) for k in ("distortion", "normal")),
        "overflow": stats["overflow"] == 0,
    }
    return dict(case=name, steps=steps, key=key, first=first, final=final,
                needs=dict(rise=rise, floor=floor), trace=trace, stats=stats,
                seconds=seconds, failed=[k for k, ok in checks.items() if not ok])
