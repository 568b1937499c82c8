#!/usr/bin/env python
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Drives ``generativedensification_torch`` only (no JAX):

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and both TF32 flags;
2. builds every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
   started together) and prints the build time and ``-Xptxas -v``
   registers / shared memory;
3. kernel #1 phase: holds the forward compositor against its plain PyTorch
   version (atol 2e-4 on color, depth and alpha) on the ``bench.py`` scene
   (512², 131,072 Gaussians, seed 0) and on the 262,144 coarse Gaussians of
   the full-width model (scene B, view 0), and times both with CUDA events
   (median of >= 20 kernel calls);
4. kernel #2 phase: on scene B with the batch's view-0 image as ground
   truth, holds the compositing backward against its plain version in all
   three modes (each per-slot gradient array scaled by its max |value|,
   atol 5e-5), checks that two launches give bitwise the same output, and
   times each mode;
5. coarse phase: the full-width network (ViT-B/16, 12-layer volume
   transformer, 64³ Gaussians) from seeded weights on
   ``make_probe_batch(B=1, V_total=8, 512², n_views=4)``,
   ``forward(with_fine=False)``: 2 warm-ups, then 5 timed forwards, each
   with the launch counts set to 0 just before and read just after
   (exactly 8 forward-compositor launches);
6. serving phase: the same network, ``forward(with_fine=True)`` (fused
   selection, densifier, fine render; 331,744 fine Gaussians): 2 warm-ups,
   5 timed forwards with exactly 16 forward and 4 backward compositor
   launches each, finite outputs of the documented shapes, peak memory,
   overflow and a device-time breakdown by stage;
7. the 2DGS serving phases (``tpu.renderer=2dgs``, the same weights):
   kernel #3 (surfel forward) against its plain version (atol 2e-4 on every
   output row) on a small surfel scene (256², 20,000 surfels, seed 0) and on
   scene B' (the model's 262,144 coarse surfels in view 0), kernel #4
   (surfel backward) in both modes on scene B' (scaled 5e-5 per row,
   bitwise repeatable), each timed with CUDA events; then the full-width
   serving forward with exactly 16 surfel-forward and 4 surfel-backward
   launches (and no 3DGS launch), finite 2DGS maps, peak memory, overflow
   and a device-time breakdown by stage;
8. evaluation phase: ``eval.evaluation.main`` on 2 ``synthetic`` scenes at
   512² with seeded weights, with each renderer;
9. the tiny configuration with the fine stage on the card and on the CPU
   from the same seeded weights, with each renderer: Gaussians, selection
   scores and selected index sets agree, images agree but for isolated
   knife-edge pixels;
10. prints the per-phase JSON, the card, the ``{"kernels": [...]}`` line,
   and as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a card or outside a checkout.
"""

from __future__ import annotations

import importlib.metadata
import json
import statistics
import subprocess
import sys
import time

import numpy as np

ATOL = 2e-4
GRAD_ATOL = 5e-5              # per array, after scaling by its max |value|
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # f32 outside the tensor cores
# operations per (slot, live pixel) evaluation of a compositor: 2 diffs,
# 7 products/sums of the power form, clamp, exp, opacity product, alpha
# clamp, the 1/255 compare
OPS_PER_EVAL = 17
# per contributing pair, forward: 1 - alpha, U, the 1e-4 compare, w, and 4
# multiply-adds into color and depth
OPS_PER_CONTRIB = 12
# per contributing pair, backward: the forward's 4, contrib (7), the prefix
# (2), suffix, max + reciprocal, g_alpha (3), g_power (2), gx and gy (8) =
# 29, then the mode's row sums: |gx|, |gy| (4); full adds the ten signed
# rows (21); noabs has only those
OPS_PER_CONTRIB_BWD = {"full": 54, "noabs": 50, "selonly": 33}
# the surfel kernels (csrc/surfel_fwd.cu, csrc/surfel_bwd.cu): the circle
# test per (slot, live pixel) is 2 differences, 3 products/sums and a
# compare; inside the circle, the three affine cr rows (12), the |cr_z|
# guard (3), the reciprocal, u, v, the object-space power (4), the filter
# power, the max (2), z, exp, the opacity product, the alpha clamp and two
# compares = 31; per contribution, forward: 1 - alpha, U, the 1e-4 compare,
# the median crossing (3), w, six color/normal and one depth multiply-add
# (14), the mapped depth (4), w·m and three moment sums (5) = 30; backward
# selonly: the chain (4), cw (5), prefix (2), the clamped reciprocal (2),
# g_alpha (4), g_power (2), the branch selects (2), rz², d cr (10), the
# filter terms (4), the guard, the two screen rows (14) and their abs sums
# (4) = 55; full: the chain (4), cw with the distortion terms (25), prefix,
# reciprocal, g_alpha, g_power, selects, rz², d cr (19), the filter terms
# (4), dL/dm, dm/dz, the crossing and gz (14), the z term of d cr_z (3),
# the guard, 13 row products and 19 row sums = 106
SURFEL_OPS_PER_EVAL = 6
SURFEL_OPS_PER_INSIDE = 31
SURFEL_OPS_PER_CONTRIB = {"fwd": 30, "selonly": 55, "full": 106}
# surfel-map pixels that may differ card vs CPU beyond ATOL: a surfel seen
# nearly edge-on has its ray-plane depth z = det / cr_z near a pole, and
# cross-device rounding of its coefficients can move z across the z > 0.2
# cull while the screen-space filter keeps its alpha; the depth normal reads
# a 3x3 stencil of depths, so each such depth pixel moves up to nine normals
# (on an NVIDIA H100 80GB HBM3 at 700 W, card vs CPU: 0.09% of depth pixels,
# 0.61% of depth-normal pixels)
SURFEL_KNIFE_EDGE_SHARE = 1e-2
V_TOTAL, N_VIEWS, HW = 8, 4, 512


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes: int, ops: int) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bytes=n_bytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def compositor_inputs(means, shs, opa, scales, quats, cam, tile_size,
                      max_tiles, max_per_tile):
    """Project + bin one view with the port's own functions; returns the
    kernels' inputs and the pairs the budgets dropped."""
    import torch

    from generativedensification_torch.core.transforms import normalize_quat
    from generativedensification_torch.splat.binning import bin_gaussians
    from generativedensification_torch.splat.composite import pack_table
    from generativedensification_torch.splat.projection import project_gaussians

    proj = project_gaussians(means, shs, opa, cam, 1, scales,
                             normalize_quat(quats))
    bins = bin_gaussians(proj, cam.height, cam.width, tile_size=tile_size,
                         max_tiles=max_tiles)
    opa_eff = torch.where(proj.valid, proj.opacity, torch.zeros_like(proj.opacity))
    table = pack_table(proj.xy, proj.conic, proj.color, opa_eff, proj.depth,
                       proj.valid)
    counts = torch.clamp(bins.tile_counts, max=min(max_per_tile,
                                                   means.shape[0] * max_tiles))
    overflow = int(bins.overflow) + int((bins.tile_counts - counts).sum())
    args = (table, bins.sorted_ids, bins.tile_starts, counts, bins.tiles_x,
            bins.tiles_y, tile_size)
    return args, overflow


def kernel_record(name: str, args, overflow: int) -> dict:
    """Kernel #1 vs plain on one scene: agreement, times and the bound."""
    import torch

    from generativedensification_torch.splat import kernels

    table, ids, starts, counts, tiles_x, tiles_y, ts = args
    out = kernels.composite_fwd(*args)
    torch.cuda.synchronize()
    stats = {}
    ref = kernels.composite_fwd_plain(*args, stats=stats)
    err = float((out - ref).abs().max())
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite compositor output")
    if err > ATOL:
        fail(f"{name}: kernel vs plain max_abs_err {err} > {ATOL}")
    ms = cuda_ms(lambda: kernels.composite_fwd(*args), reps=25)
    plain_ms = cuda_ms(lambda: kernels.composite_fwd_plain(*args), reps=3,
                       warmup=1)
    n_tiles = tiles_x * tiles_y
    npix = ts * ts
    live = int(counts.sum())
    n_bytes = table.numel() * 4 + live * 4 + 2 * n_tiles * 4 + n_tiles * 5 * npix * 4
    ops = stats["evals"] * OPS_PER_EVAL + stats["contribs"] * OPS_PER_CONTRIB
    rec = dict(scene=name, gaussians=table.shape[0], live_pairs=live,
               overflow=overflow, evals=stats["evals"],
               contribs=stats["contribs"], ms=ms, plain_ms=plain_ms,
               max_abs_err=err, alpha_mean=float(out[:, 4].mean()),
               **bound(n_bytes, ops))
    print(f"[kernel] {json.dumps(rec)}")
    return rec


def bwd_records(args, gt) -> dict:
    """Kernel #2 vs plain in every mode on one scene, against the image-MSE
    cotangent of ``gt`` (the selection pass's), plus seeded alpha and depth
    cotangents so that every row of ``full`` and ``noabs`` is exercised."""
    import torch

    from generativedensification_torch.splat import kernels
    from generativedensification_torch.splat.composite import (
        _bwd_common,
        _images,
        mse_image_cotangent,
    )

    table, ids, starts, counts, tiles_x, tiles_y, ts = args
    bg = torch.ones(3, device=table.device)
    out = kernels.composite_fwd(*args)
    image, alpha, depth = _images(out, bg, tiles_x, tiles_y, ts)
    g = torch.Generator(device=table.device).manual_seed(0)
    noise = lambda x: 1e-7 * torch.randn(x.shape, generator=g, device=x.device)
    cot = (mse_image_cotangent(image, gt), noise(alpha), noise(depth))
    gc4, g2, _ = _bwd_common(out, bg, cot, tiles_x, tiles_y, ts)
    bargs = (table, ids, starts, counts, gc4, g2, tiles_x, tiles_y, ts)
    n_tiles = tiles_x * tiles_y
    live = int(counts.sum())
    recs = {}
    for mode in kernels.BWD_ROWS:
        k1 = kernels.composite_bwd(*bargs, mode=mode)
        k2 = kernels.composite_bwd(*bargs, mode=mode)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            fail(f"composite_bwd {mode}: two launches differ")
        if not torch.isfinite(k1).all():
            fail(f"composite_bwd {mode}: non-finite output")
        stats = {}
        ref = kernels.composite_bwd_plain(*bargs, mode=mode, stats=stats)
        scale = ref.abs().amax(dim=0).clamp(min=1e-30)
        err = float(((k1 - ref) / scale).abs().max())
        if err > GRAD_ATOL:
            fail(f"composite_bwd {mode}: scaled max err {err} > {GRAD_ATOL}")
        ms = cuda_ms(lambda: kernels.composite_bwd(*bargs, mode=mode), reps=21)
        plain_ms = cuda_ms(lambda: kernels.composite_bwd_plain(*bargs, mode=mode),
                           reps=2, warmup=0)
        w = kernels.BWD_ROWS[mode]
        n_bytes = (table.numel() * 4 + live * 4 + 2 * n_tiles * 4
                   + gc4.numel() * 4 + g2.numel() * 4 + ids.shape[0] * w * 4)
        ops = (stats["evals"] * OPS_PER_EVAL
               + stats["contribs"] * OPS_PER_CONTRIB_BWD[mode])
        recs[mode] = dict(mode=mode, ms=ms, plain_ms=plain_ms, max_scaled_err=err,
                          bitwise_repeatable=True, evals=stats["evals"],
                          contribs=stats["contribs"], live_pairs=live,
                          **bound(n_bytes, ops))
        print(f"[kernel] composite_bwd {json.dumps(recs[mode])}")
    return recs


def bench_scene(dev):
    """``bench.py``'s scene (512², 131,072 Gaussians, seed 0)."""
    import torch

    from generativedensification_torch.core.camera import Camera

    rng = np.random.default_rng(0)
    n = 131072
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    means = f(rng.uniform(-0.45, 0.45, size=(n, 3)))
    shs = f(rng.normal(size=(n, 4, 3)) * 0.3 + 0.2)
    opa_raw = f(rng.normal(size=(n,)) - 1.0)
    scale_raw = f(rng.uniform(np.log(0.002), np.log(0.01), size=(n, 3)))
    quats = f(rng.normal(size=(n, 4)))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.9
    cam = Camera.from_c2w(f(c2w), 0.8, 0.8, 512, 512, znear=0.1, zfar=10.0)
    return compositor_inputs(means, shs, torch.sigmoid(opa_raw),
                             torch.exp(scale_raw), quats, cam, 32, 4, 4096)


def surfel_kernel_inputs(means, shs, opa, scales2d, quats, cam, tile_size,
                         max_tiles, max_per_tile):
    """Set up and bin one view's surfels with the port's own functions (the
    part of ``rasterize_surfels`` before compositing); returns the kernels'
    inputs and the ``SurfelInputs`` record."""
    from generativedensification_torch.splat.surfel import (
        pack_surfel_table,
        surfel_inputs,
    )

    si = surfel_inputs(means, shs, opa, scales2d, quats, cam, 1, tile_size,
                       max_tiles, max_per_tile)
    table = pack_surfel_table(*si.attrs)
    ids, _, starts, counts = si.bins
    return (table, ids, starts, counts, si.planes, *si.dims), si


def surfel_fwd_record(name: str, args, si) -> dict:
    """Kernel #3 vs plain on one scene: agreement per output row, times and
    the bound."""
    import torch

    from generativedensification_torch.splat import surfel_kernels as sk

    table, ids, starts, counts, planes, tiles_x, tiles_y, ts = args
    out = sk.surfel_fwd(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite surfel compositor output")
    stats = {}
    ref = sk.surfel_fwd_plain(*args, stats=stats)
    err_rows = (out - ref).abs().amax(dim=(0, 2)).tolist()
    err = max(err_rows)
    if err > ATOL:
        fail(f"{name}: surfel kernel vs plain max_abs_err {err} > {ATOL} "
             f"(rows {dict(zip(sk.FWD_ROWS, err_rows))})")
    ms = cuda_ms(lambda: sk.surfel_fwd(*args), reps=25)
    plain_ms = cuda_ms(lambda: sk.surfel_fwd_plain(*args), reps=3, warmup=1)
    n_tiles, npix = tiles_x * tiles_y, ts * ts
    live = int(counts.sum())
    n_bytes = (table.numel() * 4 + live * 4 + 2 * n_tiles * 4 + 8
               + n_tiles * len(sk.FWD_ROWS) * npix * 4)
    ops = (stats["evals"] * SURFEL_OPS_PER_EVAL
           + stats["inside"] * SURFEL_OPS_PER_INSIDE
           + stats["contribs"] * SURFEL_OPS_PER_CONTRIB["fwd"])
    rec = dict(scene=name, surfels=table.shape[0], live_pairs=live,
               overflow=int(si.overflow), evals=stats["evals"],
               inside=stats["inside"], contribs=stats["contribs"], ms=ms,
               plain_ms=plain_ms, max_abs_err=err,
               max_abs_err_by_row=dict(zip(sk.FWD_ROWS, err_rows)),
               alpha_mean=float(1.0 - out[:, 12].mean()), **bound(n_bytes, ops))
    print(f"[kernel] surfel_fwd {json.dumps(rec)}")
    return rec


def surfel_bwd_records(args, si, gt) -> dict:
    """Kernel #4 vs plain in both modes on one scene, against the image-MSE
    cotangent of ``gt`` (the selection pass's; ``full`` also gets seeded
    cotangents on the other five maps, so that every row is exercised)."""
    import torch

    from generativedensification_torch.splat import surfel
    from generativedensification_torch.splat import surfel_kernels as sk
    from generativedensification_torch.splat.composite import mse_image_cotangent

    table, ids, starts, counts, planes, tiles_x, tiles_y, ts = args
    bg = torch.ones(3, device=table.device)
    out = sk.surfel_fwd(*args)
    maps = surfel._maps(out, bg, *si.dims)
    g = torch.Generator(device=table.device).manual_seed(0)
    noise = lambda x: 1e-7 * torch.randn(x.shape, generator=g, device=x.device)
    cot = (mse_image_cotangent(maps[0], gt), *(noise(m) for m in maps[1:]))
    n_tiles, npix = tiles_x * tiles_y, ts * ts
    live = int(counts.sum())
    recs = {}
    for mode, n_in in (("selonly", 4), ("full", 13)):
        cot8, aux5, _ = surfel._bwd_rows(out, bg, cot, si.dims, mode)
        bargs = (*args[:5], cot8, aux5, *args[5:])
        k1 = sk.surfel_bwd(*bargs, mode=mode)
        k2 = sk.surfel_bwd(*bargs, mode=mode)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            fail(f"surfel_bwd {mode}: two launches differ")
        if not torch.isfinite(k1).all():
            fail(f"surfel_bwd {mode}: non-finite output")
        stats = {}
        ref = sk.surfel_bwd_plain(*bargs, mode=mode, stats=stats)
        scale = ref.abs().amax(dim=0).clamp(min=1e-30)
        err = float(((k1 - ref) / scale).abs().max())
        if err > GRAD_ATOL:
            fail(f"surfel_bwd {mode}: scaled max err {err} > {GRAD_ATOL}")
        ms = cuda_ms(lambda: sk.surfel_bwd(*bargs, mode=mode), reps=21)
        plain_ms = cuda_ms(lambda: sk.surfel_bwd_plain(*bargs, mode=mode),
                           reps=2, warmup=0)
        w = sk.SURFEL_BWD_ROWS[mode]
        # the cotangent and total rows the mode reads (selonly: gC and G2)
        n_bytes = (table.numel() * 4 + live * 4 + 2 * n_tiles * 4 + 8
                   + n_in * n_tiles * npix * 4 + ids.shape[0] * w * 4)
        ops = (stats["evals"] * SURFEL_OPS_PER_EVAL
               + stats["inside"] * SURFEL_OPS_PER_INSIDE
               + stats["contribs"] * SURFEL_OPS_PER_CONTRIB[mode])
        recs[mode] = dict(mode=mode, ms=ms, plain_ms=plain_ms, max_scaled_err=err,
                          bitwise_repeatable=True, evals=stats["evals"],
                          inside=stats["inside"], contribs=stats["contribs"],
                          live_pairs=live, **bound(n_bytes, ops))
        print(f"[kernel] surfel_bwd {json.dumps(recs[mode])}")
    return recs


def surfel_scene(dev):
    """A small surfel scene: 256², 20,000 surfels (the JAX surfel parity
    scene's distributions, ``tests/test_pallas_surfel.py``), seed 0."""
    import torch

    from generativedensification_torch.core.camera import Camera
    from generativedensification_torch.core.transforms import normalize_quat

    rng = np.random.default_rng(0)
    n = 20000
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    means = f(rng.uniform(-0.35, 0.35, size=(n, 3)))
    shs = f(rng.normal(size=(n, 4, 3)) * 0.3 + 0.2)
    opa = torch.sigmoid(f(rng.normal(size=(n,))))
    scales = f(np.exp(rng.uniform(np.log(0.01), np.log(0.03), size=(n, 2))))
    quats = normalize_quat(f(rng.normal(size=(n, 4))))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.6
    cam = Camera.from_c2w(f(c2w), 0.8, 0.8, 256, 256, znear=0.2, zfar=4.0)
    return surfel_kernel_inputs(means, shs, opa, scales, quats, cam, 32, 4, 4096)


def check_outputs(out, B, V_total, H, W, N, fine_n=None, surfels=False):
    import torch

    shapes = {"image": (B, H, V_total * W, 3), "depth": (B, H, V_total * W, 1),
              "acc_map": (B, H, V_total * W), "overflow": (B, V_total)}
    if surfels:
        shapes.update({"rend_dist": (B, H, V_total * W),
                       "rend_normal": (B, H, V_total * W, 3),
                       "depth_normal": (B, H, V_total * W, 3)})
    if fine_n is not None:
        shapes.update({"image_fine": (B, H, V_total * W, 3),
                       "depth_fine": (B, H, V_total * W, 1),
                       "acc_map_fine": (B, H, V_total * W)})
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            fail(f"output {k} has shape {tuple(out[k].shape)}, expected {shape}")
        if not torch.isfinite(out[k].float()).all():
            fail(f"output {k} is not finite")
    centers = out["render_pkg"][0][0]
    if tuple(centers.shape) != (B, N, 3) or not torch.isfinite(centers).all():
        fail("render_pkg centers malformed")
    for suffix in ("", "_fine") if fine_n is not None else ("",):
        img, acc = out["image" + suffix], out["acc_map" + suffix]
        if img.min() < 0 or img.max() > 1 or acc.min() < -1e-6 or acc.max() > 1 + 1e-6:
            fail(f"image{suffix} / acc_map{suffix} outside [0, 1]")
    if fine_n is not None:
        pkg = out["render_pkg"]
        if len(pkg) != 2:
            fail(f"render_pkg has {len(pkg)} entries, expected 2")
        widths = (3, 12, 1, 3, 4)
        for t, w in zip(pkg[1][:5], widths):
            if tuple(t.shape) != (B, fine_n, w) or not torch.isfinite(t).all():
                fail(f"fine render_pkg entry {tuple(t.shape)} malformed, "
                     f"expected ({B}, {fine_n}, {w})")
        if tuple(pkg[1][5].shape) != (B, fine_n) or pkg[1][5].dtype != torch.bool:
            fail("fine validity mask malformed")


def forward_breakdown(net, batch, with_fine: bool) -> dict:
    """Device time of one forward by stage, from CUDA events recorded on the
    stream around the ViT encoder, the volume transformer, each render
    (projection or surfel setup, binning, compositing), each compositor
    launch and, with the fine stage, the selection backward, the point
    features + fine head, the densifier stages and the fine renders.  The
    first V_total renders are the coarse ones; "coarse_renders" excludes the
    selection backward they contain.  "other" is the feature lift, the
    Gaussian heads, the pool and union gathers, the 2DGS maps (surface
    depth, normals) and the gaps between stages."""
    import torch

    from generativedensification_torch.models import network as network_mod
    from generativedensification_torch.splat import composite, surfel

    names = ("img_encoder", "vol_decoder", "renders", "compositor",
             "selection_backward", "point_feats_fine_head", "densifier")
    spans = {n: [] for n in names}

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def timed(name, fn):
        def run(*a, **k):
            s = event()
            r = fn(*a, **k)
            spans[name].append((s, event()))
            return r
        return run

    handles = []
    mods = [("img_encoder", net.img_encoder), ("vol_decoder", net.vol_decoder)]
    mods += [("densifier", st) for st in net.stages]
    for name, mod in mods:
        handles.append(mod.register_forward_pre_hook(
            lambda m, a, n=name: spans[n].append([event(), None])))
        handles.append(mod.register_forward_hook(
            lambda m, a, o, n=name: spans[n][-1].__setitem__(1, event())))
    if net.cfg.renderer == "2dgs":
        patched = [(network_mod, "rasterize_surfels", "renders"),
                   (surfel, "surfel_fwd", "compositor"),
                   (surfel, "composite_surfels_backward", "selection_backward")]
    else:
        patched = [(network_mod, "rasterize", "renders"),
                   (composite, "composite_fwd", "compositor"),
                   (composite, "composite_backward", "selection_backward")]
    saved = [getattr(m, a) for m, a, _ in patched]
    for (m, a, name), fn in zip(patched, saved):
        setattr(m, a, timed(name, fn))
    net._point_feats = timed("point_feats_fine_head", net._point_feats)
    net.decoder.fine = timed("point_feats_fine_head", net.decoder.fine)
    try:
        start = event()
        net(batch, with_fine=with_fine)
        end = event()
    finally:
        for (m, a, _), fn in zip(patched, saved):
            setattr(m, a, fn)
        del net._point_feats, net.decoder.fine
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    ms = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}
    renders = [s.elapsed_time(e) for s, e in spans["renders"]]
    ms["coarse_renders"] = sum(renders[:V_TOTAL]) - ms["selection_backward"]
    ms["fine_renders"] = sum(renders[V_TOTAL:])
    ms["total"] = start.elapsed_time(end)
    ms["other"] = ms["total"] - sum(
        ms[k] for k in ("img_encoder", "vol_decoder", "coarse_renders",
                        "selection_backward", "point_feats_fine_head",
                        "densifier", "fine_renders"))
    ms["render_data_plane"] = ms["renders"] - ms["compositor"] - ms["selection_backward"]
    ms["compositor_launches"] = len(spans["compositor"])
    return ms


def device_busy(net, batch, with_fine: bool) -> dict:
    """``torch.profiler`` over one forward: the summed device time of every
    CUDA kernel against the forward's wall time, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net(batch, with_fine=with_fine)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_ = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels_) / 1e3
    top = sorted(kernels_, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top]}


def timed_forwards(net, batch, with_fine: bool, expect: dict, n: int = 5):
    """2 warm-ups, then ``n`` forwards with the launch counts set to 0 just
    before each and read just after; fails unless every run launched
    exactly ``expect``."""
    import torch

    from generativedensification_torch.splat import kernels

    for _ in range(2):
        net(batch, with_fine=with_fine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net(batch, with_fine=with_fine)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(kernels.launch_counts)
        if launches != expect:
            fail(f"with_fine={with_fine}: expected launches {expect} per "
                 f"forward, got {launches}")
    return out, times, launches, torch.cuda.max_memory_allocated()


def fine_config(**over):
    """The serving configuration: the infer defaults (``mask_pool`` 262144)
    in f32, built without PyYAML."""
    from generativedensification_torch.config import default_infer_config

    cfg = default_infer_config()
    cfg.set_dotted("tpu.compute_dtype", "float32")
    for k, v in over.items():
        cfg.set_dotted(k, v)
    return cfg


def tiny_card_vs_cpu(renderer: str = "3dgs", seed: int = 35):
    """The tiny test configuration with the fine stage on the card and on
    the CPU from the same seeded weights: the coarse Gaussians agree to
    1e-4, the selection scores to 5e-5 of their max, the opacity-pool and
    selected index sets are identical (the seed is fixed so that the
    selection boundary's margin is >= 100x the score tolerance), and the
    renders agree to 2e-4 except at isolated knife-edge pixels (alpha at
    1/255 or T at 1e-4 land on the other side under cross-device
    rounding): at most 0.1% of pixels may differ by more.

    With the surfel renderer the maps are held to 2e-4 of max(1, max |map|)
    (the form of the JAX package's surfel contract) on all but ``SURFEL_KNIFE_EDGE_SHARE`` of the pixels (the z = det / cr_z
    pole of a surfel seen edge-on is one more such edge), and the fine maps
    are held on identical inputs: the card's fine surfels rendered on the
    CPU against the card's fine maps.  End to end the fine stage is chaotic
    under random weights: a pool point that samples a knife-edge pixel of
    the coarse surface depth gets another depth feature, and the densifier's
    attention windows spread it to the other points, so the end-to-end share
    of differing fine pixels is printed, not held."""
    import torch

    from generativedensification_torch.data.synthetic import make_probe_batch
    from generativedensification_torch.models import network as network_mod

    cfg = network_mod.NetworkConfig(
        n_views=2, encoder_backbone="tiny_test", n_groups=(4,),
        n_offset_groups=8, num_layers=2, num_heads=4, view_embed_dim=8,
        embedding_dim=32, vol_feat_reso=4, vol_embedding_reso=8,
        vol_embedding_out_dim=16, k_num=96, dec_depths=(1, 1),
        dec_channels=(32, 48), dec_num_head=(4, 6), non_leaf_ratio=(0.75,),
        mask_pool=192, tile_size=16, max_tiles=8, max_per_tile=256,
        renderer=renderer)
    outs, splits, nets, batches = {}, {}, {}, {}
    real = network_mod.topk_split
    for dev in ("cuda", "cpu"):
        nets[dev] = network_mod.Network(cfg, device=dev, seed=seed)
        batches[dev] = make_probe_batch(1, 4, 64, 64, 2, seed=1, device=dev)
        calls = []
        network_mod.topk_split = lambda s, m, k: calls.append(
            (s, m, k, real(s, m, k))) or calls[-1][3]
        try:
            outs[dev] = nets[dev](batches[dev], with_fine=True)
        finally:
            network_mod.topk_split = real
        splits[dev] = calls
    worst = 0.0
    for a, b in zip(outs["cuda"]["render_pkg"][0], outs["cpu"]["render_pkg"][0]):
        worst = max(worst, float((a.cpu() - b).abs().max()))
    if worst > 1e-4:
        fail(f"tiny config: coarse Gaussians differ card vs CPU by {worst}")
    (_, _, _, pool_c), (score_c, valid_c, k, sel_c) = splits["cuda"]
    (_, _, _, pool_h), (score_h, _, _, sel_h) = splits["cpu"]
    tol = GRAD_ATOL * float(score_h.max())
    score_err = float((score_c.cpu() - score_h).abs().max())
    s = np.sort(np.where(valid_c[0].cpu().numpy(), score_h[0].numpy(), -np.inf))[::-1]
    margin = float(s[k - 1] - s[k])
    print(f"[tiny {renderer}] selection scores max|card-cpu| {score_err:.3g} (tolerance "
          f"{tol:.3g}); k-th boundary margin {margin:.3g} = {margin / tol:.0f}x "
          "the tolerance")
    if score_err > tol:
        fail(f"tiny config: selection scores differ by {score_err} > {tol}")
    if margin < 100 * tol:
        fail(f"tiny config: boundary margin {margin} < 100 x {tol}")
    for name, a, b in (("pool", pool_c, pool_h), ("selection", sel_c, sel_h)):
        if not all(torch.equal(x.cpu(), y) for x, y in zip(a, b)):
            fail(f"tiny config: {name} index sets differ card vs CPU")
    fine_keys = ["image_fine", "depth_fine", "acc_map_fine"]
    keys = ["image", "depth", "acc_map"]
    share = 1e-3
    cpu = dict(outs["cpu"])
    end_to_end = {}
    if renderer == "2dgs":
        keys += ["rend_dist", "rend_normal", "depth_normal"]
        share = SURFEL_KNIFE_EDGE_SHARE
        for key in fine_keys:
            d = (outs["cuda"][key].cpu() - cpu[key]).abs()
            end_to_end[key] = float(
                (d > ATOL * max(1.0, float(cpu[key].abs().max()))).float().mean())
        print(f"[tiny {renderer}] end-to-end fine maps, share of pixels beyond "
              f"the tolerance (not held): {json.dumps(end_to_end)}")
        # the card's fine surfels rendered on the CPU
        c, sh, op, sc, rot, ok = (t.cpu() for t in outs["cuda"]["render_pkg"][1])
        net_h, batch_h = nets["cpu"], batches["cpu"]
        fine = net_h._render_all(
            batch_h, net_h._cameras_all(batch_h),
            (c, sh.reshape(*sh.shape[:2], -1, 3), op, sc, rot), ok)
        cpu.update(image_fine=network_mod._cat_views(fine["image"]),
                   depth_fine=network_mod._cat_views(fine["depth"])[..., None],
                   acc_map_fine=network_mod._cat_views(fine["alpha"]))
    shares = {}
    for key in keys + fine_keys:
        d = (outs["cuda"][key].cpu() - cpu[key]).abs()
        # surfel maps scaled as the JAX package's surfel contract scales them
        scale = max(1.0, float(cpu[key].abs().max())) if renderer == "2dgs" else 1.0
        frac = float((d > ATOL * scale).float().mean())
        shares[key] = frac
        print(f"[tiny {renderer}] {key}: max|card-cpu| {float(d.max()):.3g}, "
              f"share beyond the tolerance: {frac:.2e}")
        if frac > share:
            fail(f"tiny config ({renderer}): {key} differs card vs CPU on "
                 f"{frac:.2%} of pixels")
    return dict(score_err=score_err, score_tol=tol, margin=margin, shares=shares,
                fine_end_to_end_shares=end_to_end)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from generativedensification_torch.models.network import Network, NetworkConfig
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    from generativedensification_torch.data.synthetic import make_probe_batch
    from generativedensification_torch.eval import evaluation
    from generativedensification_torch.splat import kernels
    from generativedensification_torch.utils.device import resolve_device

    def expect(**launches):
        """Launches per forward: the given kernels, every other one 0."""
        return {**dict.fromkeys(kernels.launch_counts, 0), **launches}

    # -- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    dev = resolve_device(None)
    print(card)
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "not installed"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} triton {triton} "
          f"python {sys.version.split()[0]}; tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}")

    # -- 2. build every kernel (one nvcc per source, started together)
    t0 = time.perf_counter()
    libs = kernels.build()
    print(f"[build] {len(libs)} sources in {time.perf_counter() - t0:.1f}s")
    for lib in libs.values():
        print(f"[build] {lib.src.name} -> {lib.path.name}")
        for line in lib.build_log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    # -- 3. kernel #1, scene A: bench.py's scene
    with torch.inference_mode():
        args, overflow = bench_scene(dev)
        bench_rec = kernel_record("bench_512_131k", args, overflow)

    # the full-width serving network from the infer configuration
    cfg = NetworkConfig.from_config(fine_config())
    t0 = time.perf_counter()
    net = Network(cfg, seed=0)
    net.eval()
    batch = make_probe_batch(1, V_TOTAL, HW, HW, n_views=N_VIEWS, seed=0)
    n_coarse = (2 * cfg.vol_embedding_reso) ** 3
    n_fine = (sum(lv["leaf"] for lv in cfg.level_sizes())
              + min(cfg.mask_pool, n_coarse) - cfg.k_num)
    print(f"[slice] network built in {time.perf_counter() - t0:.1f}s, "
          f"{sum(p.numel() for p in net.parameters())} parameters; "
          f"{n_coarse} coarse -> {n_fine} fine Gaussians")

    with torch.inference_mode():
        out = net(batch, with_fine=True)                      # warm-up
        torch.cuda.synchronize()
        check_outputs(out, 1, V_TOTAL, HW, HW, n_coarse, n_fine)

        # -- 3/4. scene B: the model's 262,144 coarse Gaussians in view 0
        centers, shs_c, opacity_c, scaling_c, rotation_c = out["render_pkg"][0]
        cam = net._cameras_all(batch)[0][0]
        args, overflow = compositor_inputs(
            centers[0], shs_c[0], torch.sigmoid(opacity_c[0, :, 0]),
            torch.exp(scaling_c[0]), rotation_c[0], cam, cfg.tile_size,
            cfg.max_tiles, cfg.max_per_tile)
        model_rec = kernel_record("model_512_262k_view0", args, overflow)
        bwd_recs = bwd_records(args, batch["tar_rgb"][0, 0])

        # -- 5. the coarse path
        out_c, times_c, launches_c, peak_c = timed_forwards(
            net, batch, False, expect(composite_fwd=V_TOTAL))
        check_outputs(out_c, 1, V_TOTAL, HW, HW, n_coarse)
        split_c = forward_breakdown(net, batch, False)

        # -- 6. the serving path
        out_f, times_f, launches_f, peak_f = timed_forwards(
            net, batch, True, expect(composite_fwd=2 * V_TOTAL,
                                     composite_bwd=N_VIEWS))
        check_outputs(out_f, 1, V_TOTAL, HW, HW, n_coarse, n_fine)
        split_f = forward_breakdown(net, batch, True)
        busy = device_busy(net, batch, True)
    coarse_ms, fine_ms = statistics.median(times_c), statistics.median(times_f)
    ov_coarse = int(out_c["overflow"].sum())
    ov_serving = int(out_f["overflow"].sum())
    fine_valid = int(out_f["render_pkg"][1][5].sum())
    print(f"[coarse] forward ms median {coarse_ms:.2f} (runs "
          f"{[round(t, 2) for t in times_c]}); overflow {ov_coarse}; peak "
          f"allocated {peak_c / 2**30:.2f} GiB")
    print(f"[serving] forward ms median {fine_ms:.2f} (runs "
          f"{[round(t, 2) for t in times_f]}); launches {launches_f}; overflow "
          f"coarse {ov_coarse} + fine {ov_serving - ov_coarse}; fine Gaussians "
          f"{n_fine} ({fine_valid} valid); peak allocated {peak_f / 2**30:.2f} GiB")
    print(f"[breakdown] coarse forward, device ms by stage: {json.dumps(split_c)}")
    print(f"[breakdown] serving forward, device ms by stage: {json.dumps(split_f)}")
    print(f"[profiler] serving wall {busy['wall_ms']:.2f} ms, kernels busy "
          f"{busy['busy_ms']:.2f} ms ({busy['busy_ms'] / busy['wall_ms']:.1%}); "
          f"top: {json.dumps(busy['top'])}")
    del net, out, out_c, out_f
    torch.cuda.empty_cache()

    # -- 7. the 2DGS serving path: the same weights with tpu.renderer=2dgs
    cfg2 = NetworkConfig.from_config(fine_config(**{"tpu.renderer": "2dgs"}))
    net2 = Network(cfg2, seed=0)
    net2.eval()
    with torch.inference_mode():
        out2 = net2(batch, with_fine=True)                     # warm-up
        torch.cuda.synchronize()
        check_outputs(out2, 1, V_TOTAL, HW, HW, n_coarse, n_fine, surfels=True)
        # kernel #3 on a small scene, then #3 and #4 on scene B': the model's
        # 262,144 coarse surfels in view 0 (the shapes the main path gives)
        sargs, si = surfel_scene(dev)
        surfel_small_rec = surfel_fwd_record("surfels_256_20k", sargs, si)
        centers, shs_c, opacity_c, scaling_c, rotation_c = out2["render_pkg"][0]
        sargs, si = surfel_kernel_inputs(
            centers[0], shs_c[0], torch.sigmoid(opacity_c[0, :, 0]),
            torch.exp(scaling_c[0])[:, :2], rotation_c[0], cam, cfg2.tile_size,
            cfg2.max_tiles, cfg2.max_per_tile)
        surfel_rec = surfel_fwd_record("model_512_262k_view0_surfels", sargs, si)
        surfel_bwd_recs = surfel_bwd_records(sargs, si, batch["tar_rgb"][0, 0])
        out_s, times_s, launches_s, peak_s = timed_forwards(
            net2, batch, True, expect(surfel_fwd=2 * V_TOTAL, surfel_bwd=N_VIEWS))
        check_outputs(out_s, 1, V_TOTAL, HW, HW, n_coarse, n_fine, surfels=True)
        split_s = forward_breakdown(net2, batch, True)
        busy_s = device_busy(net2, batch, True)
    surfel_ms = statistics.median(times_s)
    ov_surfel = int(out_s["overflow"].sum())
    print(f"[serving 2dgs] forward ms median {surfel_ms:.2f} (runs "
          f"{[round(t, 2) for t in times_s]}); launches {launches_s}; overflow "
          f"{ov_surfel}; fine surfels {n_fine} "
          f"({int(out_s['render_pkg'][1][5].sum())} valid); peak allocated "
          f"{peak_s / 2**30:.2f} GiB; rend_dist max "
          f"{float(out_s['rend_dist'].abs().max()):.3g}")
    print(f"[breakdown] 2dgs serving forward, device ms by stage: {json.dumps(split_s)}")
    print(f"[profiler] 2dgs serving wall {busy_s['wall_ms']:.2f} ms, kernels busy "
          f"{busy_s['busy_ms']:.2f} ms ({busy_s['busy_ms'] / busy_s['wall_ms']:.1%}); "
          f"top: {json.dumps(busy_s['top'])}")
    del net2, out2, out_s
    torch.cuda.empty_cache()

    # -- 8. the evaluation entry point on 2 synthetic scenes, each renderer
    evals = {}
    for renderer in ("3dgs", "2dgs"):
        t0 = time.perf_counter()
        result = evaluation.main(fine_config(**{
            "infer.dataset.dataset_name": "synthetic", "infer.dataset.n_scenes": 2,
            "infer.save_images": 0, "tpu.renderer": renderer}))
        eval_s = time.perf_counter() - t0
        means = result["mean"]
        if len(result["scenes"]) != 2 or not all(np.isfinite(v) for v in means.values()):
            fail(f"evaluation result ({renderer}) malformed: {result}")
        print(f"[eval {renderer}] 2 synthetic scenes at {HW}² in {eval_s:.1f}s: "
              f"{json.dumps(means)}")
        evals[renderer] = {"seconds": eval_s, "mean": means}

    # -- 9. the tiny configuration, card vs CPU, each renderer
    with torch.inference_mode():
        # seeds whose selection margins are >= 100x the score tolerance on
        # the card (35: 148x with the 3DGS renderer; 28: 451x with 2DGS)
        tiny = {"3dgs": tiny_card_vs_cpu("3dgs", seed=35),
                "2dgs": tiny_card_vs_cpu("2dgs", seed=28)}

    try:
        import yaml  # noqa: F401
        has_yaml = True
    except ImportError:
        has_yaml = False
    recs = [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "generativedensification_torch/csrc/composite_fwd.cu",
        "replaces": "generativedensification_tpu/splat/pallas_kernels.py:412",
        "launches": launches_f["composite_fwd"],
        "max_abs_err": model_rec["max_abs_err"],
        "ms": model_rec["ms"],
        "plain_ms": model_rec["plain_ms"],
        "bound_ms": model_rec["bound_ms"],
        "bound_by": model_rec["bound_by"],
        "library_ms": None,
    }, {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "generativedensification_torch/csrc/composite_bwd.cu",
        "replaces": "generativedensification_tpu/splat/pallas_kernels.py:738",
        "launches": launches_f["composite_bwd"],
        "max_abs_err": bwd_recs["selonly"]["max_scaled_err"],
        "ms": bwd_recs["selonly"]["ms"],
        "plain_ms": bwd_recs["selonly"]["plain_ms"],
        "bound_ms": bwd_recs["selonly"]["bound_ms"],
        "bound_by": bwd_recs["selonly"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "surfel_fwd",
        "route": "cuda",
        "source": "generativedensification_torch/csrc/surfel_fwd.cu",
        "replaces": "generativedensification_tpu/splat/pallas_surfel.py:327",
        "launches": launches_s["surfel_fwd"],
        "max_abs_err": surfel_rec["max_abs_err"],
        "ms": surfel_rec["ms"],
        "plain_ms": surfel_rec["plain_ms"],
        "bound_ms": surfel_rec["bound_ms"],
        "bound_by": surfel_rec["bound_by"],
        "library_ms": None,
    }, {
        "name": "surfel_bwd",
        "route": "cuda",
        "source": "generativedensification_torch/csrc/surfel_bwd.cu",
        "replaces": "generativedensification_tpu/splat/pallas_surfel.py:605",
        "launches": launches_s["surfel_bwd"],
        "max_abs_err": surfel_bwd_recs["selonly"]["max_scaled_err"],
        "ms": surfel_bwd_recs["selonly"]["ms"],
        "plain_ms": surfel_bwd_recs["selonly"]["plain_ms"],
        "bound_ms": surfel_bwd_recs["selonly"]["bound_ms"],
        "bound_by": surfel_bwd_recs["selonly"]["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({
        "coarse": {"forward_ms": coarse_ms, "forward_runs_ms": times_c,
                   "launches": launches_c, "breakdown_ms": split_c,
                   "overflow": ov_coarse, "peak_bytes": peak_c},
        "serving": {"forward_ms": fine_ms, "forward_runs_ms": times_f,
                    "launches": launches_f, "breakdown_ms": split_f,
                    "busy_ms": busy["busy_ms"], "busy_wall_ms": busy["wall_ms"],
                    "overflow": ov_serving, "fine_gaussians": n_fine,
                    "fine_valid": fine_valid, "peak_bytes": peak_f},
        "serving_2dgs": {"forward_ms": surfel_ms, "forward_runs_ms": times_s,
                         "launches": launches_s, "breakdown_ms": split_s,
                         "busy_ms": busy_s["busy_ms"],
                         "busy_wall_ms": busy_s["wall_ms"], "overflow": ov_surfel,
                         "peak_bytes": peak_s},
        "eval": evals, "tiny": tiny, "pyyaml": has_yaml,
        "scenes": [bench_rec, model_rec], "composite_bwd": bwd_recs,
        "surfel_scenes": [surfel_small_rec, surfel_rec],
        "surfel_bwd": surfel_bwd_recs}))
    print(card)
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
