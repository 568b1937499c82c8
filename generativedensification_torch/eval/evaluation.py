"""Evaluation entry point, PyTorch.

Port of ``generativedensification_tpu/eval/evaluation.py``: per scene, the
serving forward (coarse + fine), metrics on the novel views only
(``eval_novel_view_only`` keeps the columns past ``W * n_views``), per-scene
PSNR = max(fine, coarse), SSIM, optional masked depth metrics, and the
per-scene JSON schema ``{"mean": ..., "scenes": {scene: {...}}}``.

    python -m generativedensification_torch.eval.evaluation [infer.yaml] [key=value ...]

runs on the card; ``tpu.renderer=2dgs`` serves through the 2DGS surfel
renderer, and the network computes in ``tpu.compute_dtype`` (the config
default ``bfloat16``, as the JAX evaluation serves).  ``infer.ckpt_path``
None means seeded weights (``infer.seed``, default 0); a directory is a
training checkpoint of ``train.train`` (``train/state.py::restore_params``,
the latest step).  Not ported yet, each raising with its ROADMAP item: the
reference's Lightning checkpoints (``.ckpt`` / ``.pt`` / ``.pth``),
finetuning (``with_ft``), the orbit video, the mesh, and LPIPS.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..config import ConfigNode, default_infer_config, from_dotlist, load_yaml, merge
from ..data import build_dataset
from ..data.pipeline import collate, to_device_batch
from ..models.network import Network, NetworkConfig
from ..train.state import restore_params
from ..utils.device import resolve_device
from .metrics import abs_error, acc_threshold, lpips_fn, psnr_img, ssim_img


def _check_supported(icfg) -> None:
    ft_cfg = icfg.get("finetuning", None)
    if ft_cfg and ft_cfg.get("with_ft", False):
        raise NotImplementedError(
            "infer.finetuning.with_ft: per-scene finetuning arrives with "
            "ROADMAP queue 1 (eval and tools)")
    if int(icfg.get("video_frames", 0)) > 0:
        raise NotImplementedError(
            "infer.video_frames: the orbit video arrives with ROADMAP queue 1 "
            "(eval and tools)")
    if bool(icfg.get("save_mesh", False)):
        raise NotImplementedError(
            "infer.save_mesh: TSDF mesh extraction arrives with ROADMAP "
            "queue 1 (eval and tools)")
    if icfg.get("eval_lpips", False):
        lpips_fn("vgg")     # raises: no converted LPIPS weights here
    ckpt = icfg.ckpt_path
    if ckpt not in (None, "None") and not os.path.isdir(ckpt):
        if str(ckpt).endswith((".ckpt", ".pt", ".pth")):
            raise NotImplementedError(
                f"infer.ckpt_path={ckpt!r}: the reference's Lightning "
                "checkpoints arrive with ROADMAP queue 1 (eval and tools); a "
                "directory of train.train checkpoints loads")
        raise FileNotFoundError(ckpt)


def main(cfg: ConfigNode, device=None) -> dict:
    """Evaluate ``cfg.infer``'s dataset; returns (and prints the mean of)
    ``{"mean": {...}, "scenes": {scene: {psnr, psnr_coarse, psnr_fine,
    ssim[, depth_*]}}}``.  ``device=None`` runs on the card."""
    icfg = cfg.infer
    ds_cfg = icfg.dataset
    _check_supported(icfg)
    dev = resolve_device(device)
    dataset = build_dataset(ds_cfg, device=dev)
    os.makedirs(icfg.save_folder, exist_ok=True)

    n_views = cfg.n_views
    eval_depth = list(icfg.get("eval_depth", []) or [])
    net = Network(NetworkConfig.from_config(cfg), device=dev,
                  seed=int(icfg.get("seed", 0)))
    if icfg.ckpt_path not in (None, "None"):
        net.load_state_dict(restore_params(icfg.ckpt_path))
    net.eval()

    per_scene = {}
    n_scenes = min(len(dataset), int(ds_cfg.get("n_scenes", len(dataset))))
    for i in range(n_scenes):
        sample_np = collate([dataset[i]])
        batch = to_device_batch(sample_np, dev)
        # no_grad, not inference_mode: share_selection=False differentiates
        # a render inside the forward
        with torch.no_grad():
            out = net(batch, with_fine=True)

        B, V, H, W, _ = batch["tar_rgb"].shape
        gt = batch["tar_rgb"].permute(0, 2, 1, 3, 4).reshape(1, H, V * W, 3)
        img_c = out["image"]
        img_f = out["image_fine"]
        if icfg.eval_novel_view_only:
            sl = slice(W * n_views, None)
            gt_e, c_e, f_e = gt[:, :, sl], img_c[:, :, sl], img_f[:, :, sl]
        else:
            gt_e, c_e, f_e = gt, img_c, img_f

        psnr_c = float(psnr_img(c_e, gt_e))
        psnr_f = float(psnr_img(f_e, gt_e))
        scene = sample_np["meta"][0]["scene"]
        rec = {
            "psnr": max(psnr_f, psnr_c),
            "psnr_coarse": psnr_c,
            "psnr_fine": psnr_f,
            "ssim": float(ssim_img(f_e, gt_e)),
        }
        if eval_depth and "tar_dep" in sample_np:
            dep_gt = sample_np["tar_dep"][0]        # (V, H, W)
            msk = sample_np["tar_msk"][0] > 0
            dep_pred = out["depth_fine"][0, ..., 0].cpu().numpy().reshape(H, V, W)
            dep_pred = dep_pred.transpose(1, 0, 2)
            nv = slice(n_views, None) if icfg.eval_novel_view_only else slice(None)
            err = abs_error(dep_pred[nv], dep_gt[nv], msk[nv])
            rec["depth_abs_err"] = float(err.mean())
            for t in eval_depth:
                rec[f"depth_acc_{t}"] = float(
                    acc_threshold(dep_pred[nv], dep_gt[nv], msk[nv], t).mean())
        per_scene[scene] = rec

        if i < int(icfg.get("save_images", 8)):
            _save_comparison(icfg.save_folder, scene, gt[0], img_c[0], img_f[0])

    means = {}
    if per_scene:
        keys = next(iter(per_scene.values())).keys()
        means = {k: float(np.mean([v[k] for v in per_scene.values()])) for k in keys}
    result = {"mean": means, "scenes": per_scene}

    metric_path = icfg.get("metric_path", "None")
    if metric_path and metric_path != "None":
        os.makedirs(os.path.dirname(os.path.abspath(metric_path)), exist_ok=True)
        with open(metric_path, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(means, indent=2))
    return result


def _save_comparison(folder, scene, gt, coarse, fine):
    """gt / coarse / fine stacked vertically as an 8-bit binary PPM (no
    image library needed)."""
    img = torch.cat([gt, coarse, fine], dim=0).clamp(0, 1)
    arr = (img.cpu().numpy() * 255).astype(np.uint8)
    with open(os.path.join(folder, f"{scene}.ppm"), "wb") as f:
        f.write(f"P6 {arr.shape[1]} {arr.shape[0]} 255\n".encode())
        f.write(arr.tobytes())


def config_from_args(args: list[str]) -> ConfigNode:
    """infer defaults, then the yaml files, then the dotted overrides."""
    base = default_infer_config()
    yamls = [a for a in args if a.endswith((".yaml", ".yml"))]
    overrides = [a for a in args if "=" in a and not a.endswith((".yaml", ".yml"))]
    nodes = [base, *(load_yaml(p) for p in yamls)]
    if overrides:
        nodes.append(from_dotlist(overrides))
    return merge(*nodes)


if __name__ == "__main__":
    main(config_from_args(sys.argv[1:]))
