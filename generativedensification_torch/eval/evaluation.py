"""Evaluation entry point, PyTorch.

Port of ``generativedensification_tpu/eval/evaluation.py``: per scene, the
serving forward (coarse + fine), optionally per-scene finetuning of the
fine Gaussians against the source views (``infer.finetuning.with_ft``),
metrics on the novel views only (``eval_novel_view_only`` keeps the columns
past ``W * n_views``), per-scene PSNR = max(fine, coarse), SSIM, LPIPS
(``infer.eval_lpips``, from converted weights), optional masked depth
metrics, and the per-scene JSON schema ``{"mean": ..., "scenes": {scene:
{...}}}``; side outputs per scene: the comparison image ``{scene}.png``
(ground truth, coarse, fine), the orbit video ``{scene}_f{j:03d}.png``
(``infer.video_frames``), the TSDF mesh ``{scene}.obj`` and its turntable
``{scene}_mesh{j:03d}.png`` (``infer.save_mesh``,
``infer.mesh_video_frames``).

    python -m generativedensification_torch.eval.evaluation [infer.yaml] [key=value ...]

runs on the card; ``tpu.renderer=2dgs`` serves through the 2DGS surfel
renderer, and the network computes in ``tpu.compute_dtype`` (the config
default ``bfloat16``, as the JAX evaluation serves).  ``infer.ckpt_path``
None means seeded weights (``infer.seed``, default 0); a directory is a
checkpoint of ``train.train`` or ``tools.convert_torch_ckpt``
(``train/state.py::restore_params``, the latest step); a ``.ckpt`` /
``.pt`` / ``.pth`` file is a reference Lightning checkpoint
(``utils/torch_convert.py``).  Finetuning, the video and the mesh render
the fine Gaussians with the 3DGS renderer for both renderers, as the JAX
evaluation does.
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
from ..splat.rasterizer import rasterize
from ..train.state import restore_params
from ..utils.device import resolve_device
from ..utils.image_io import to_uint8, write_png
from .metrics import abs_error, acc_threshold, lpips_fn, psnr_img, ssim_img


def load_params(cfg, net) -> None:
    """Load ``cfg.infer.ckpt_path`` into ``net`` (None keeps its seeded
    weights)."""
    ckpt = cfg.infer.ckpt_path
    if ckpt in (None, "None"):
        return
    if os.path.isdir(ckpt):
        net.load_state_dict(restore_params(ckpt))
    elif str(ckpt).endswith((".ckpt", ".pt", ".pth")):
        from ..utils import torch_convert

        net.load_state_dict(torch_convert.load_torch_network_params(ckpt, net))
    else:
        raise FileNotFoundError(ckpt)


def main(cfg: ConfigNode, device=None) -> dict:
    """Evaluate ``cfg.infer``'s dataset; returns (and prints the mean of)
    ``{"mean": {...}, "scenes": {scene: {psnr, psnr_coarse, psnr_fine,
    ssim[, lpips_vgg, lpips_alex][, depth_*]}}}``.  ``device=None`` runs on
    the card."""
    icfg = cfg.infer
    ds_cfg = icfg.dataset
    dev = resolve_device(device)
    dataset = build_dataset(ds_cfg, device=dev)
    os.makedirs(icfg.save_folder, exist_ok=True)

    n_views = cfg.n_views
    eval_depth = list(icfg.get("eval_depth", []) or [])
    want_lpips = bool(icfg.get("eval_lpips", False))
    net_cfg = NetworkConfig.from_config(cfg)
    net = Network(net_cfg, device=dev, seed=int(icfg.get("seed", 0)))
    load_params(cfg, net)
    net.eval()

    lpips_vgg = lpips_alex = None
    if want_lpips:
        lpips_vgg = lpips_fn("vgg", device=dev)
        lpips_alex = lpips_fn("alex", device=dev)

    ft_cfg = icfg.get("finetuning", None)
    with_ft = bool(ft_cfg and ft_cfg.get("with_ft", False))

    per_scene = {}
    n_scenes = min(len(dataset), int(ds_cfg.get("n_scenes", len(dataset))))
    for i in range(n_scenes):
        sample_np = collate([dataset[i]])
        batch = to_device_batch(sample_np, dev)
        # no_grad, not inference_mode: share_selection=False differentiates
        # a render inside the forward
        with torch.no_grad():
            out = net(batch, with_fine=True)
        if with_ft:
            out = dict(out)
            out["image_fine"], out["render_pkg"] = finetune_scene(
                out, batch, net_cfg, ft_cfg, n_views)

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
        if lpips_vgg is not None:
            rec["lpips_vgg"] = float(lpips_vgg(f_e * 2 - 1, gt_e * 2 - 1))
            rec["lpips_alex"] = float(lpips_alex(f_e * 2 - 1, gt_e * 2 - 1))
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

        video_frames = int(icfg.get("video_frames", 0))
        save_mesh = bool(icfg.get("save_mesh", False))
        if video_frames > 0 or save_mesh:
            gaussians = _fine_gaussians(out["render_pkg"])
            tmats = sample_np.get("transform_mats")
            if tmats is not None:  # (B, 1, 4, 4) or (B, 4, 4) -> (4, 4)
                tmats = np.asarray(tmats).reshape(-1, 4, 4)[0]
            if video_frames > 0:
                _save_video(icfg.save_folder, scene, gaussians, net_cfg,
                            ds_cfg.dataset_name, (H, W), tmats, video_frames, dev)
            if save_mesh:
                _save_mesh(icfg.save_folder, scene, gaussians, net_cfg,
                           ds_cfg.dataset_name, (H, W), tmats,
                           int(icfg.get("mesh_video_frames", 0)), dev)

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


def finetune_scene(out, batch, net_cfg, ft_cfg, n_views):
    """Per-scene finetuning of the fine Gaussians against the source views
    (``infer.finetuning``; reference ``renderer.py:128-207``): ``steps`` Adam
    steps of the render MSE with the reference's per-attribute learning
    rates, then a re-render of every view.  Returns (image_fine (1, H,
    V·W, 3), render_pkg with the refined last entry)."""
    from ..core.camera import Camera
    from .finetune import finetune, params_from_gaussians

    # the wrappers of kernels #1 / #2 take f32 (the network's render_pkg is
    # f32 under the bf16 policy too, as the JAX package's is)
    centers, sh, op_raw, sc_raw, rot = (
        t.detach().to(torch.float32) for t in out["render_pkg"][-1][:5])
    ok = out["render_pkg"][-1][5]
    Nf = centers.shape[1]
    # dead slots: raw opacity far below the sigmoid knee, so they stay
    # invisible through finetuning
    op_masked = torch.where(ok[0][:, None], op_raw[0], torch.full_like(op_raw[0], -15.0))
    p = params_from_gaussians(centers[0], sh[0].reshape(Nf, -1, 3), op_masked,
                              sc_raw[0], rot[0])

    B, V_total, H, W, _ = batch["tar_rgb"].shape
    cams = Camera.from_c2w(batch["tar_c2w"][0], batch["fovx"][0], batch["fovy"][0],
                           width=W, height=H, znear=batch["near_far"][0, 0],
                           zfar=batch["near_far"][0, 1])
    raster_kw = dict(tile_size=net_cfg.tile_size, max_tiles=net_cfg.max_tiles,
                     max_per_tile=net_cfg.max_per_tile)
    p, _ = finetune(
        p, cams[:n_views], batch["tar_rgb"][0, :n_views],
        batch["bg_color"][0, :n_views],
        sh_degree=net_cfg.sh_degree,
        steps=int(ft_cfg.get("steps", 500)),
        position_lr=float(ft_cfg.get("position_lr", 1.6e-5)),
        feature_lr=float(ft_cfg.get("feature_lr", 2.5e-3)),
        opacity_lr=float(ft_cfg.get("opacity_lr", 0.05)),
        scaling_lr=float(ft_cfg.get("scaling_lr", 5e-3)),
        rotation_lr=float(ft_cfg.get("rotation_lr", 1e-3)),
        raster_kw=raster_kw,
    )

    shs = torch.cat([p["sh_dc"], p["sh_rest"]], dim=1)
    with torch.no_grad():
        imgs = torch.stack([
            rasterize(p["xyz"], shs, torch.sigmoid(p["opacity"][:, 0]),
                      torch.exp(p["scaling"]), p["rotation"], cams[j],
                      batch["bg_color"][0, j], net_cfg.sh_degree, **raster_kw).image
            for j in range(V_total)
        ])                                                   # (V, H, W, 3)
    image_fine = imgs.permute(1, 0, 2, 3).reshape(1, H, V_total * W, 3)

    refined_pkg = list(out["render_pkg"])
    refined_pkg[-1] = (p["xyz"][None], shs.reshape(1, Nf, -1), p["opacity"][None, :, 0:1],
                       p["scaling"][None], p["rotation"][None], ok)
    return image_fine, refined_pkg


def _save_comparison(folder, scene, gt, coarse, fine):
    """gt / coarse / fine stacked vertically as ``{scene}.png``."""
    img = torch.cat([gt, coarse, fine], dim=0)
    write_png(os.path.join(folder, f"{scene}.png"), to_uint8(img.cpu().numpy()))


def _fine_gaussians(render_pkg):
    """The cached fine Gaussians (reference ``return_buffer`` contract) as
    the activated attribute 5-tuple for re-rendering."""
    centers, sh, op_raw, sc_raw, rot, ok = render_pkg[-1]
    f32 = lambda t: t.detach().to(torch.float32)
    opa = torch.where(ok[0], torch.sigmoid(f32(op_raw[0]).reshape(-1)), 0.0)
    return (f32(centers[0]), f32(sh[0]).reshape(sh.shape[1], -1, 3), opa,
            torch.exp(f32(sc_raw[0])), f32(rot[0]))


def _renderer(net_cfg, device):
    from ..splat.rasterizer import Renderer

    return Renderer(sh_degree=net_cfg.sh_degree, white_background=True, device=device)


@torch.no_grad()
def _render_frames(gaussians, cams, net_cfg, device):
    """(H, W, 3) images of the Gaussians in each camera, on the CPU."""
    r = _renderer(net_cfg, device)
    return [r.render_img(cam, None, *gaussians, max_tiles=net_cfg.max_tiles,
                         max_per_tile=net_cfg.max_per_tile)["image"].cpu().numpy()
            for cam in cams]


def _save_video(folder, scene, gaussians, net_cfg, ds_name, img_size, tmats,
                n_frames, device):
    """Orbit video of the cached fine Gaussians (``evaluation.py:169-194``)
    as ``{scene}_f{j:03d}.png``: the frame files the JAX evaluation writes
    when it has no mp4 encoder."""
    from ..tools.video_path import uni_video_path

    cams = uni_video_path(n_frames, ds_name, img_size, transform_mats=tmats,
                          device=device)
    for j, fr in enumerate(_render_frames(gaussians, cams, net_cfg, device)):
        write_png(os.path.join(folder, f"{scene}_f{j:03d}.png"), to_uint8(fr))


def _save_mesh(folder, scene, gaussians, net_cfg, ds_name, img_size, tmats,
               turntable_frames, device):
    """TSDF-fuse fine-Gaussian RGB-D renders -> ``{scene}.obj``, and its
    turntable ``{scene}_mesh{j:03d}.png`` (``evaluation.py:197-208``,
    ``meshExtractor.py:31-139``)."""
    from ..tools.mesh_extractor import MeshExtractor, save_obj
    from ..tools.video_path import uni_mesh_path

    half = 0.5 * net_cfg.scene_size
    aabb = np.array([[-half] * 3, [half] * 3], np.float32)
    cams = uni_mesh_path(16, ds_name, img_size, transform_mats=tmats, device=device)
    verts, faces, colors = MeshExtractor(_renderer(net_cfg, device), aabb).extract(
        gaussians, cams, max_tiles=net_cfg.max_tiles,
        max_per_tile=net_cfg.max_per_tile)
    save_obj(os.path.join(folder, f"{scene}.obj"), verts, faces, colors)
    if turntable_frames > 0 and len(faces):
        from ..tools.mesh_render import turntable_frames as tt

        frames = tt(verts, faces, n_frames=turntable_frames, colors=colors,
                    size=img_size[0])
        for j, fr in enumerate(frames):
            write_png(os.path.join(folder, f"{scene}_mesh{j:03d}.png"), to_uint8(fr))


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
