#!/usr/bin/env python
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Drives ``generativedensification_torch`` only (no JAX):

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and both TF32 flags;
2. builds every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
   started together) and prints the build time and ``-Xptxas -v``
   registers / shared memory; fails if kernel #1, #2, #3 or #4 spills;
3. kernel #1 phase: holds the forward compositor bitwise
   (``torch.equal``) against its plain PyTorch version and against the
   one-CTA-per-tile design it replaced (probe ``full``) on the ``bench.py`` scene A (512², 131,072
   Gaussians, seed 0), on the adversarial scene of the footprint skip
   (``tools/scenes.py``, 256², 32 and 16 px tiles), and on the 262,144
   coarse Gaussians of the full-width model (scene B, view 0) with the
   serving budgets and with the 3DGS warmup budgets; prints the skip's kept
   share of (slot, sub-tile) pairs and the evaluations it leaves (from the
   plain mirror ``kernels.subtile_touch``), and times the kernel, the
   one-CTA-per-tile design and the plain version with CUDA events (median of >= 20 kernel
   calls);
4. kernel #2 phase: on the same scenes (scene B with the batch's view-0
   image as ground truth, a seeded image elsewhere), holds the compositing
   backward against its plain version in all three modes (each per-slot
   gradient array scaled by its max |value|, atol 5e-5), checks that two
   launches give bitwise the same output, and times each mode;
4b. probe phase (kernels #1 and #3 by stage, TPU kernels #7-#10; #1's
   ladder is its earlier one-CTA-per-tile design, and ``sub_noexit`` /
   ``sub_noskip`` the production sub-tile kernel without its per-sub-tile
   exit or its footprint skip): the
   breakdown entry points ``tools.kernel_break`` (every variant of
   ``probe_kernels.composite_fwd_probe``) on scenes A and B and
   ``tools.surfel_break`` (every surfel variant) on A' (the surfel form of
   scene A) and B', each variant bitwise against its plain version and,
   where its output is the production output, against the production
   kernel, timed with CUDA events; the stage tables and trip counts; then
   ``kernel_break --bwd`` (the compositor's backward path by stage) on
   scene A; every variant must launch (the counts set to 0 just before
   and read just after), and every later phase launches none;
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
   kernel #3 (surfel forward) bitwise (``torch.equal``) against its plain
   version, and kernel #4 (surfel backward) in both modes against its
   plain version (scaled 5e-5 per row, bitwise repeatable), on a small
   surfel scene (256², 20,000 surfels, seed 0), on scene A' (the surfel
   form of scene A), on the adversarial scene of the screen-circle skip
   (``tools/scenes.py``, 256², 32 and 16 px tiles) and on scene B' (the
   model's 262,144 coarse surfels in view 0) at the serving and the 2DGS
   warmup budgets; #3 also bitwise against the one-CTA-per-tile design it
   replaced (probe ``full``) on A' and B'; the skip's kept shares (from
   the plain mirror ``surfel_kernels.subtile_touch``), each kernel timed
   with CUDA events beside the earlier design; then the full-width
   serving forward with exactly 16 surfel-forward and 4 surfel-backward
   launches (and no 3DGS launch), finite 2DGS maps, peak memory, overflow
   and a device-time breakdown by stage;
8. the f32 train phases, each renderer: the training configuration
   (``load_config()``: ``mask_pool`` 49,152, k 12,000, drop-path 0.3, order
   shuffling, accumulation 2) with the warmup budgets of
   ``train/train.py`` (3DGS 9 / 16 / 8192, 2DGS 16 / 25 / 16,384), seeded
   weights, 2 warm-up and 4 timed micro-steps (host clock + synchronize)
   with exactly 16 forward and 20 backward compositor launches each
   (4 ``selonly`` + 16 ``noabs`` for 3DGS, + 16 ``full`` for 2DGS; the
   2DGS state past micro-step 1000, so its regularizers are on), finite
   loss and gradient norm, overflow, peak memory, a device-time breakdown
   (forward, loss, backward by stage, optimizer) and the profiler's busy
   share; then one micro-step each under ``GD_APOS_MODE`` ``gauss_dsum``,
   ``gauss`` and ``gauss_dsum_col`` (deterministic algorithms, same weights,
   batch and generator seed): 20 launches of kernel #5, respectively #6,
   the loss and every gradient against ``gauss_dsum`` (1e-6 scaled), and
   kernels #5 / #6 bitwise against their plain versions on the inputs
   those micro-steps gave them, timed against the one PyTorch call that
   computes the same function;
9. evaluation phase: ``eval.evaluation.main`` on 2 ``synthetic`` scenes at
   512² with seeded weights, with each renderer;
10. the tiny configuration with the fine stage on the card and on the CPU
   from the same seeded weights, with each renderer: Gaussians, selection
   scores and selected index sets agree, images agree but for isolated
   knife-edge pixels;
11. prints the per-phase JSON, the card, the ``{"kernels": [...]}`` line,
   and as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a card or outside a checkout.
"""

from __future__ import annotations

import importlib.metadata
import json
import statistics
import sys
import time
import warnings

import numpy as np

ATOL = 2e-4
GRAD_ATOL = 5e-5              # per array, after scaling by its max |value|
# surfel-map pixels that may differ card vs CPU beyond ATOL: a surfel seen
# nearly edge-on has its ray-plane depth z = det / cr_z near a pole, and
# cross-device rounding of its coefficients can move z across the z > 0.2
# cull while the screen-space filter keeps its alpha; the depth normal reads
# a 3x3 stencil of depths, so each such depth pixel moves up to nine normals
# (on an NVIDIA H100 80GB HBM3 at 700 W, card vs CPU: 0.09% of depth pixels,
# 0.61% of depth-normal pixels)
SURFEL_KNIFE_EDGE_SHARE = 1e-2
V_TOTAL, N_VIEWS, HW = 8, 4, 512
# the warmup budgets (max_tiles, enum_tiles, max_per_tile) that
# generativedensification_tpu/train/train.py applies for the first
# overflow_warmup_steps micro-steps, per renderer
WARMUP_BUDGETS = {"3dgs": (9, 16, 8192), "2dgs": (16, 25, 16384)}
# gradients of the GD_APOS_MODE strategies against gauss_dsum, scaled by
# each parameter's max |value|; the analytically zero ones (the ViT key
# bias) must stay below this share of the step's largest gradient instead
APOS_GRAD_TOL = 1e-6
ZERO_GRAD = ("attn.key.bias",)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def kernel_record(name: str, args, overflow: int) -> dict:
    """Kernel #1 vs plain on one scene: bitwise agreement, the footprint
    skip's kept share (``kernels.subtile_touch``, the plain mirror of the
    kernel's predicate) and the evaluations it leaves, the kernel's time
    beside the one-CTA-per-tile design's (probe ``full``, also bitwise) and the bound
    from the evaluations the skip leaves."""
    import torch

    from generativedensification_torch.splat import kernels
    from generativedensification_torch.splat import probe_kernels as pk
    from generativedensification_torch.tools.timing import (
        OPS_PER_CONTRIB,
        OPS_PER_EVAL,
        bound,
        cuda_ms,
        once,
    )

    table, ids, starts, counts, tiles_x, tiles_y, ts = args
    out = kernels.composite_fwd(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite compositor output")
    ref = kernels.composite_fwd_plain(*args)
    if not torch.equal(out, ref):
        fail(f"{name}: kernel differs from its plain version (max |diff| "
             f"{float((out - ref).abs().max())})")
    touch = kernels.subtile_touch(*args)
    stats = {}
    mirrored, plain_ms = once(
        lambda: kernels.composite_fwd_plain(*args, stats=stats, touch=touch), True)
    if not torch.equal(mirrored, ref):
        fail(f"{name}: the plain version with the skip mirrored differs")
    per_tile = pk.composite_fwd_probe("full", *args)
    torch.cuda.synchronize()
    if not torch.equal(per_tile, out):
        fail(f"{name}: the one-CTA-per-tile design (probe full) differs "
             "from kernel #1")
    ms = cuda_ms(lambda: kernels.composite_fwd(*args), reps=25)
    per_tile_ms = cuda_ms(lambda: pk.composite_fwd_probe("full", *args), reps=25)
    n_tiles = tiles_x * tiles_y
    npix = ts * ts
    live = int(counts.sum())
    n_bytes = table.numel() * 4 + live * 4 + 2 * n_tiles * 4 + n_tiles * 5 * npix * 4
    ops = stats["evals_kept"] * OPS_PER_EVAL + stats["contribs"] * OPS_PER_CONTRIB
    ops_all = stats["evals"] * OPS_PER_EVAL + stats["contribs"] * OPS_PER_CONTRIB
    rec = dict(scene=name, gaussians=table.shape[0], tile_size=ts, live_pairs=live,
               overflow=overflow, evals=stats["evals"],
               evals_kept=stats["evals_kept"], contribs=stats["contribs"],
               kept_share=float(touch.sum()) / max(1, live * touch.shape[0]),
               evals_kept_share=stats["evals_kept"] / max(1, stats["evals"]),
               ms=ms, per_tile_ms=per_tile_ms, plain_ms=plain_ms, max_abs_err=0.0,
               bitwise=True, alpha_mean=float(out[:, 4].mean()),
               bound_unskipped_ms=bound(n_bytes, ops_all)["bound_ms"],
               **bound(n_bytes, ops))
    print(f"[kernel] {json.dumps(rec)}")
    return rec


def bwd_records(name: str, args, gt=None) -> dict:
    """Kernel #2 vs plain in every mode on one scene, against the image-MSE
    cotangent of ``gt`` (the selection pass's; a seeded image if None), plus
    seeded alpha and depth cotangents so that every row of ``full`` and
    ``noabs`` is exercised: two launches bitwise equal, scaled 5e-5 against
    the plain version, times, and the bound from the evaluations the
    footprint skip leaves."""
    import torch

    from generativedensification_torch.splat import kernels
    from generativedensification_torch.splat.composite import (
        _bwd_common,
        _images,
        mse_image_cotangent,
    )
    from generativedensification_torch.tools.timing import (
        OPS_PER_CONTRIB_BWD,
        OPS_PER_EVAL,
        bound,
        cuda_ms,
        once,
    )

    table, ids, starts, counts, tiles_x, tiles_y, ts = args
    bg = torch.ones(3, device=table.device)
    out = kernels.composite_fwd(*args)
    image, alpha, depth = _images(out, bg, tiles_x, tiles_y, ts)
    g = torch.Generator(device=table.device).manual_seed(0)
    if gt is None:
        gt = torch.rand(image.shape, generator=g, device=table.device)
    noise = lambda x: 1e-7 * torch.randn(x.shape, generator=g, device=x.device)
    cot = (mse_image_cotangent(image, gt), noise(alpha), noise(depth))
    gc4, g2, _ = _bwd_common(out, bg, cot, tiles_x, tiles_y, ts)
    bargs = (table, ids, starts, counts, gc4, g2, tiles_x, tiles_y, ts)
    touch = kernels.subtile_touch(*args)
    n_tiles = tiles_x * tiles_y
    live = int(counts.sum())
    recs = {}
    for mode in kernels.BWD_ROWS:
        k1 = kernels.composite_bwd(*bargs, mode=mode)
        k2 = kernels.composite_bwd(*bargs, mode=mode)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            fail(f"composite_bwd {mode} ({name}): two launches differ")
        if not torch.isfinite(k1).all():
            fail(f"composite_bwd {mode} ({name}): non-finite output")
        stats = {}
        ref, plain_ms = once(lambda: kernels.composite_bwd_plain(
            *bargs, mode=mode, stats=stats, touch=touch), True)
        scale = ref.abs().amax(dim=0).clamp(min=1e-30)
        err = float(((k1 - ref) / scale).abs().max())
        if err > GRAD_ATOL:
            fail(f"composite_bwd {mode} ({name}): scaled max err {err} > {GRAD_ATOL}")
        ms = cuda_ms(lambda: kernels.composite_bwd(*bargs, mode=mode), reps=21)
        w = kernels.BWD_ROWS[mode]
        n_bytes = (table.numel() * 4 + live * 4 + 2 * n_tiles * 4
                   + gc4.numel() * 4 + g2.numel() * 4 + ids.shape[0] * w * 4)
        ops = (stats["evals_kept"] * OPS_PER_EVAL
               + stats["contribs"] * OPS_PER_CONTRIB_BWD[mode])
        recs[mode] = dict(scene=name, mode=mode, ms=ms, plain_ms=plain_ms,
                          max_scaled_err=err, bitwise_repeatable=True,
                          evals=stats["evals"], evals_kept=stats["evals_kept"],
                          contribs=stats["contribs"], live_pairs=live,
                          **bound(n_bytes, ops))
        print(f"[kernel] composite_bwd {json.dumps(recs[mode])}")
    return recs


def surfel_fwd_record(name: str, args, si, per_tile: bool = False) -> dict:
    """Kernel #3 vs plain on one scene: bitwise agreement, the screen-circle
    skip's kept share of (slot, sub-tile) pairs and of circle tests
    (``surfel_kernels.subtile_touch``, the plain mirror of the kernel's
    predicate; the plain version with it mirrored also bitwise), times and
    the bound from the circle tests the skip leaves; with ``per_tile``,
    also bitwise against the one-CTA-per-tile design it replaced (probe
    ``full``) and that design's time."""
    import torch

    from generativedensification_torch.splat import probe_kernels as pk
    from generativedensification_torch.splat import surfel_kernels as sk
    from generativedensification_torch.tools.timing import (
        SURFEL_OPS_PER_CONTRIB,
        SURFEL_OPS_PER_EVAL,
        SURFEL_OPS_PER_INSIDE,
        bound,
        cuda_ms,
        once,
    )

    table, ids, starts, counts, planes, tiles_x, tiles_y, ts = args
    out = sk.surfel_fwd(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite surfel compositor output")
    ref = sk.surfel_fwd_plain(*args)
    if not torch.equal(out, ref):
        err_rows = (out - ref).abs().amax(dim=(0, 2)).tolist()
        fail(f"{name}: surfel kernel differs from its plain version (max |diff| "
             f"by row {dict(zip(sk.FWD_ROWS, err_rows))})")
    touch = sk.subtile_touch(table, ids, starts, counts, tiles_x, tiles_y, ts)
    stats = {}
    mirrored, plain_ms = once(
        lambda: sk.surfel_fwd_plain(*args, stats=stats, touch=touch), True)
    if not torch.equal(mirrored, ref):
        fail(f"{name}: the plain surfel version with the skip mirrored differs")
    ms = cuda_ms(lambda: sk.surfel_fwd(*args), reps=25)
    extra = {}
    if per_tile:
        probe = pk.surfel_fwd_probe("full", *args)
        torch.cuda.synchronize()
        if not torch.equal(probe, out):
            fail(f"{name}: the one-CTA-per-tile design (probe full) differs "
                 "from kernel #3")
        extra["per_tile_ms"] = cuda_ms(lambda: pk.surfel_fwd_probe("full", *args),
                                       reps=25)
    n_tiles, npix = tiles_x * tiles_y, ts * ts
    live = int(counts.sum())
    n_bytes = (table.numel() * 4 + live * 4 + 2 * n_tiles * 4 + 8
               + n_tiles * len(sk.FWD_ROWS) * npix * 4)
    rest = (stats["inside"] * SURFEL_OPS_PER_INSIDE
            + stats["contribs"] * SURFEL_OPS_PER_CONTRIB["fwd"])
    rec = dict(scene=name, surfels=table.shape[0], tile_size=ts, live_pairs=live,
               overflow=int(si.overflow), evals=stats["evals"],
               evals_kept=stats["evals_kept"], inside=stats["inside"],
               contribs=stats["contribs"],
               kept_share=float(touch.sum()) / max(1, live * touch.shape[0]),
               evals_kept_share=stats["evals_kept"] / max(1, stats["evals"]),
               ms=ms, plain_ms=plain_ms, max_abs_err=0.0, bitwise=True, **extra,
               alpha_mean=float(1.0 - out[:, 12].mean()),
               bound_unskipped_ms=bound(
                   n_bytes, stats["evals"] * SURFEL_OPS_PER_EVAL + rest)["bound_ms"],
               **bound(n_bytes, stats["evals_kept"] * SURFEL_OPS_PER_EVAL + rest))
    print(f"[kernel] surfel_fwd {json.dumps(rec)}")
    return rec


def surfel_bwd_records(name: str, args, si, gt=None) -> dict:
    """Kernel #4 vs plain in both modes on one scene, against the image-MSE
    cotangent of ``gt`` (the selection pass's; a seeded image if None;
    ``full`` also gets seeded cotangents on the other five maps, so that
    every row is exercised): two launches bitwise equal, scaled 5e-5
    against the plain version, times, and the bound from the circle tests
    the screen-circle skip leaves."""
    import torch

    from generativedensification_torch.splat import surfel_kernels as sk
    from generativedensification_torch.tools.surfel_break import bwd_inputs
    from generativedensification_torch.tools.timing import (
        SURFEL_OPS_PER_CONTRIB,
        SURFEL_OPS_PER_EVAL,
        SURFEL_OPS_PER_INSIDE,
        bound,
        cuda_ms,
        once,
    )

    table, ids, starts, counts, planes, tiles_x, tiles_y, ts = args
    rows = bwd_inputs(args, si, gt)
    touch = sk.subtile_touch(table, ids, starts, counts, tiles_x, tiles_y, ts)
    n_tiles, npix = tiles_x * tiles_y, ts * ts
    live = int(counts.sum())
    recs = {}
    for mode, n_in in (("selonly", 4), ("full", 13)):
        bargs = (*args[:5], *rows[mode], *args[5:])
        k1 = sk.surfel_bwd(*bargs, mode=mode)
        k2 = sk.surfel_bwd(*bargs, mode=mode)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            fail(f"surfel_bwd {mode} ({name}): two launches differ")
        if not torch.isfinite(k1).all():
            fail(f"surfel_bwd {mode} ({name}): non-finite output")
        stats = {}
        ref, plain_ms = once(lambda: sk.surfel_bwd_plain(
            *bargs, mode=mode, stats=stats, touch=touch), True)
        scale = ref.abs().amax(dim=0).clamp(min=1e-30)
        err = float(((k1 - ref) / scale).abs().max())
        if not err <= GRAD_ATOL:
            fail(f"surfel_bwd {mode} ({name}): scaled max err {err} > {GRAD_ATOL}")
        ms = cuda_ms(lambda: sk.surfel_bwd(*bargs, mode=mode), reps=21)
        w = sk.SURFEL_BWD_ROWS[mode]
        # the cotangent and total rows the mode reads (selonly: gC and G2)
        n_bytes = (table.numel() * 4 + live * 4 + 2 * n_tiles * 4 + 8
                   + n_in * n_tiles * npix * 4 + ids.shape[0] * w * 4)
        ops = (stats["evals_kept"] * SURFEL_OPS_PER_EVAL
               + stats["inside"] * SURFEL_OPS_PER_INSIDE
               + stats["contribs"] * SURFEL_OPS_PER_CONTRIB[mode])
        recs[mode] = dict(scene=name, mode=mode, ms=ms, plain_ms=plain_ms,
                          max_scaled_err=err, bitwise_repeatable=True,
                          evals=stats["evals"], evals_kept=stats["evals_kept"],
                          inside=stats["inside"], contribs=stats["contribs"],
                          live_pairs=live, **bound(n_bytes, ops))
        print(f"[kernel] surfel_bwd {json.dumps(recs[mode])}")
    return recs


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


def device_busy(fn) -> dict:
    """``torch.profiler`` over one call of ``fn`` (a forward or a train
    micro-step): the summed device time of every CUDA kernel against the
    call's wall time, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: a user annotation (the optimizer's step range)
    # also carries device time, which would count its kernels twice
    kernels_ = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
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


def train_config(renderer: str):
    """The training configuration (``load_config()``: ``mask_pool`` 49,152,
    k 12,000, drop-path 0.3, order shuffling, ``start_fine`` -1,
    ``accumulate_grad_batches`` 2) in f32, with the renderer's warmup
    budgets of ``train/train.py`` (pair budget off)."""
    from generativedensification_torch.config import load_config

    cfg = load_config()
    max_tiles, enum_tiles, max_per_tile = WARMUP_BUDGETS[renderer]
    for k, v in (("tpu.compute_dtype", "float32"), ("tpu.renderer", renderer),
                 ("tpu.max_tiles", max_tiles), ("tpu.enum_tiles", enum_tiles),
                 ("tpu.max_per_tile", max_per_tile), ("tpu.pair_budget", 0.0)):
        cfg.set_dotted(k, v)
    return cfg


def make_trainer(ncfg, tcfg, step0: int, device=None, seed: int = 0):
    """A network from seeded weights, the optimizer of the train group
    ``tcfg`` and a train state at micro-step ``step0``."""
    from generativedensification_torch.models.network import Network
    from generativedensification_torch.train.optim import make_optimizer
    from generativedensification_torch.train.state import create_train_state

    net = Network(ncfg, device=device, seed=seed)
    opt = make_optimizer(net, lr=tcfg.lr, beta1=tcfg.beta1, beta2=tcfg.beta2,
                         weight_decay=tcfg.weight_decay,
                         warmup_iters=tcfg.warmup_iters,
                         grad_clip=tcfg.gradient_clip_val,
                         accumulate=tcfg.accumulate_grad_batches)
    state = create_train_state(net, opt, seed=seed)
    state.step = step0
    return net, opt, state


def check_step_stats(stats, tag: str) -> None:
    for k, v in stats.items():
        if not np.isfinite(float(v)):
            fail(f"{tag}: {k} is not finite ({float(v)})")
    if not float(stats["grad_norm"]) > 0:
        fail(f"{tag}: grad_norm {float(stats['grad_norm'])} is not positive")


def timed_train_steps(step_fn, state, batch, expect: dict, n: int = 4):
    """2 warm-up micro-steps, then ``n`` timed ones (host clock around the
    step and a synchronize), each with the launch counts set to 0 just
    before and read just after; fails unless every micro-step launched
    exactly ``expect`` and gave a finite loss and a positive gradient
    norm."""
    import torch

    from generativedensification_torch.splat import kernels

    for _ in range(2):
        state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, stats = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(kernels.launch_counts)
        if launches != expect:
            fail(f"train micro-step: expected launches {expect}, got {launches}")
        check_step_stats(stats, "train micro-step")
    return state, stats, times, launches, torch.cuda.max_memory_allocated()


def _tensors(x):
    """The tensors in a module output (tensors, tuples, dataclasses)."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def train_breakdown(net, opt, state, batch):
    """Device time of one train micro-step by stage, from CUDA events on the
    stream: forward, loss, backward and optimizer; in the backward, the
    compositor backwards (preamble, kernel, slot reduction and unpacking),
    their kernel launches and slot reductions alone, and the spans of the
    densifier stages, the volume transformer and the ViT, each from the
    first gradient that reaches one of the module's outputs to the last
    gradient accumulated into its parameters.  "backward_other" is the rest
    of the backward: the losses' adjoints, the fine head, the pool and
    union gathers, projection, SH and the 2DGS maps.  Returns the new
    state and the times."""
    import torch

    from generativedensification_torch.splat import composite, surfel
    from generativedensification_torch.train.loss import Losses
    from generativedensification_torch.train.step import make_train_step

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    marks, in_backward = {}, [False]
    spans = {"compositor_backward": [], "compositor_backward_kernel": [],
             "slot_reduction": []}
    stages = {"densifier": list(net.stages), "vol_decoder": [net.vol_decoder],
              "img_encoder": [net.img_encoder]}
    first = {n: [] for n in stages}
    last = {n: [] for n in stages}

    class TimedLosses(Losses):
        def __call__(self, batch, output, step):
            marks["loss_start"] = event()
            res = super().__call__(batch, output, step)
            marks["loss_end"] = event()
            in_backward[0] = True
            return res

    def timed(name, fn):
        def run(*a, **k):
            if not in_backward[0]:
                return fn(*a, **k)
            s = event()
            r = fn(*a, **k)
            spans[name].append((s, event()))
            return r
        return run

    patched = [(composite, "composite_backward", "compositor_backward"),
               (surfel, "composite_surfels_backward", "compositor_backward"),
               (composite, "composite_bwd", "compositor_backward_kernel"),
               (surfel, "surfel_bwd", "compositor_backward_kernel"),
               (composite, "slots_to_gaussians", "slot_reduction"),
               (surfel, "slots_to_gaussians", "slot_reduction")]
    saved = [getattr(m, a) for m, a, _ in patched]
    handles = [
        opt.register_step_pre_hook(lambda *a: marks.__setitem__("opt_start", event())),
        opt.register_step_post_hook(lambda *a: marks.__setitem__("opt_end", event())),
    ]

    def on_output(name):
        def hook(mod, args, out):
            for t in _tensors(out):
                if t.requires_grad:
                    t.register_hook(lambda g: first[name].append(event()))
        return hook

    for name, mods in stages.items():
        for mod in mods:
            handles.append(mod.register_forward_hook(on_output(name)))
            for p in mod.parameters():
                handles.append(p.register_post_accumulate_grad_hook(
                    lambda p, n=name: last[n].append(event())))
    step_fn = make_train_step(net, opt, TimedLosses(), with_fine=True)
    for (m, a, name), fn in zip(patched, saved):
        setattr(m, a, timed(name, fn))
    try:
        start = event()
        state, _ = step_fn(state, batch)
        end = event()
    finally:
        for (m, a, _), fn in zip(patched, saved):
            setattr(m, a, fn)
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    el = lambda a, b: a.elapsed_time(b)
    ms = {"forward": el(start, marks["loss_start"]),
          "loss": el(marks["loss_start"], marks["loss_end"]),
          "backward": el(marks["loss_end"], marks["opt_start"]),
          "optimizer": el(marks["opt_start"], marks["opt_end"]),
          "total": el(start, end)}
    for name, v in spans.items():
        ms[name] = sum(el(s, e) for s, e in v)
    for name in stages:
        ms[f"{name}_backward"] = (el(first[name][0], last[name][-1])
                                  if first[name] and last[name] else 0.0)
    ms["backward_other"] = ms["backward"] - ms["compositor_backward"] - sum(
        ms[f"{n}_backward"] for n in stages)
    ms["compositor_backward_calls"] = len(spans["compositor_backward"])
    return state, ms


def apos_phase(net, batch, step0: int, expect: dict, n_bwd: int):
    """One train micro-step under each of ``gauss_dsum``, ``gauss`` and
    ``gauss_dsum_col`` (``composite.APOS_MODE``, as the tests set it), each
    with a new optimizer (accumulating 2: its first micro-step moves no
    parameter), the same weights, batch and generator seed.  ``gauss`` must
    launch ``reduce_slots`` and ``gauss_dsum_col`` ``transpose_rows`` once
    per compositing backward (``n_bwd``), the other one never; the losses
    must agree and every parameter's gradient must lie within 1e-6 of the
    ``gauss_dsum`` step's after scaling by its max |value|.  The inputs of
    the first launch of each width and point count are kept for the kernel
    phases (the shapes the train step gives the kernels).  The three micro-steps run
    under ``torch.use_deterministic_algorithms``, so that they differ only
    by the strategy: the gather backwards then add in a fixed order instead
    of with atomics; the ops that have no such algorithm are listed."""
    import torch

    from generativedensification_torch.splat import composite

    captured = {}
    real = {"reduce_slots": composite.reduce_slots,
            "transpose_rows": composite.transpose_rows}

    def capture(name):
        def run(x, *a):
            # (kernel, width, gaussians): the coarse and the fine renders
            w, n = (x.shape[1], a[0]) if name == "reduce_slots" else x.shape
            captured.setdefault((name, w, n), (x, *a))
            return real[name](x, *a)
        return run

    mode0 = composite.APOS_MODE
    runs = {}
    composite.reduce_slots = capture("reduce_slots")
    composite.transpose_rows = capture("transpose_rows")
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            _apos_steps(net, batch, step0, expect, n_bwd, runs)
        finally:
            torch.use_deterministic_algorithms(False)
            composite.APOS_MODE = mode0
            composite.reduce_slots = real["reduce_slots"]
            composite.transpose_rows = real["transpose_rows"]
            net.zero_grad(set_to_none=True)
    nondet = sorted({str(w.message).split(" does not have")[0][:80] for w in caught
                     if "deterministic" in str(w.message)})
    print(f"[apos] ops without a deterministic algorithm: {json.dumps(nondet)}")

    ref_loss, ref, _ = runs["gauss_dsum"]
    gmax = max(float(g.abs().max()) for g in ref.values())
    recs = {}
    for mode in ("gauss", "gauss_dsum_col"):
        loss, grads, launches = runs[mode]
        worst, worst_at, bitwise = 0.0, None, loss == ref_loss
        for k, a in ref.items():
            b = grads[k]
            bitwise = bitwise and torch.equal(a, b)
            if k.endswith(ZERO_GRAD):
                # analytically zero (softmax ignores a constant shift of a
                # query's logits): rounding noise, negligible in both
                for g in (a, b):
                    if float(g.abs().max()) > APOS_GRAD_TOL * gmax:
                        fail(f"GD_APOS_MODE={mode}: {k} gradient not negligible")
                continue
            scale = float(a.abs().max())
            err = (float((b - a).abs().max()) / scale if scale
                   else (np.inf if float(b.abs().max()) else 0.0))
            if err > worst:
                worst, worst_at = err, k
        recs[mode] = dict(loss=loss, loss_gauss_dsum=ref_loss,
                          max_scaled_grad_err=worst, worst_param=worst_at,
                          bitwise_equal=bitwise, launches=launches,
                          nondeterministic_ops=nondet)
        print(f"[apos] {mode}: {json.dumps(recs[mode])}")
        if abs(loss - ref_loss) > APOS_GRAD_TOL * abs(ref_loss):
            fail(f"GD_APOS_MODE={mode}: loss {loss} vs gauss_dsum {ref_loss}")
        if worst > APOS_GRAD_TOL:
            fail(f"GD_APOS_MODE={mode}: gradients differ from gauss_dsum by "
                 f"{worst} scaled at {worst_at} > {APOS_GRAD_TOL}")
    return recs, captured


def _apos_steps(net, batch, step0, expect, n_bwd, runs):
    """The micro-steps of ``apos_phase``, one per strategy."""
    import torch

    from generativedensification_torch.splat import composite, kernels
    from generativedensification_torch.train.loss import Losses
    from generativedensification_torch.train.optim import make_optimizer
    from generativedensification_torch.train.state import create_train_state
    from generativedensification_torch.train.step import make_train_step

    for mode in ("gauss_dsum", "gauss", "gauss_dsum_col"):
        composite.APOS_MODE = mode
        opt = make_optimizer(net, accumulate=2)
        st = create_train_state(net, opt, seed=1)
        st.step = step0
        step_fn = make_train_step(net, opt, Losses(), with_fine=True)
        kernels.reset_launch_counts()
        st, stats = step_fn(st, batch)
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        want = dict(expect, reduce_slots=n_bwd if mode == "gauss" else 0,
                    transpose_rows=n_bwd if mode == "gauss_dsum_col" else 0)
        if launches != want:
            fail(f"GD_APOS_MODE={mode}: expected launches {want}, got {launches}")
        check_step_stats(stats, f"GD_APOS_MODE={mode}")
        grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).clone()
                 for k, p in net.named_parameters()}
        runs[mode] = (float(stats["loss"]), grads, launches)
        del opt, st


def reduction_records(captured: dict, label: str) -> dict:
    """Kernels #5 and #6 against their plain versions (bitwise) on the
    inputs the train step gave them, with their times, the time of the one
    PyTorch call that computes the same function, and the bound.  Each
    timed call finds the 50 MB L2 cache cold (a 256 MB buffer is read
    before it), as its bound assumes, and the card busy while the host
    enqueues it (a ~0.5 ms spin ahead of the start event), so that the
    interval holds the kernel and not the wrapper's host time."""
    import torch

    from generativedensification_torch.splat import kernels
    from generativedensification_torch.tools.timing import bound, cuda_ms

    recs = {}
    dev = next(iter(captured.values()))[0].device
    scratch = torch.zeros(64 * 2**20, dtype=torch.float32, device=dev)

    def flush():
        scratch.sum()
        torch.cuda._sleep(1_000_000)

    for (name, w, n_pts), args in sorted(captured.items()):
        if name == "reduce_slots":
            rows, n, d = args
            run = lambda: kernels.reduce_slots(rows, n, d)
            plain = lambda: kernels.reduce_slots_plain(rows, n, d)
            library = lambda: rows.view(n, d, w).sum(1)
            n_bytes, ops = (n * d * w + n * w) * 4, n * (d - 1) * w
            shape = dict(n=n, d=d, w=w)
        else:
            (cols,) = args
            run = lambda: kernels.transpose_rows(cols)
            plain = lambda: kernels.transpose_rows_plain(cols)
            library = lambda: cols.t().contiguous()
            n_bytes, ops = 2 * cols.numel() * 4, 0
            shape = dict(w=w, M=cols.shape[1])
        out, ref = run(), plain()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"{name} {label} w={w}: kernel differs from its plain version "
                 f"(max |diff| {float((out - ref).abs().max())})")
        rec = dict(kernel=name, scene=label, **shape, bitwise_equal=True,
                   max_abs_err=float((out - ref).abs().max()),
                   ms=cuda_ms(run, reps=25, before=flush),
                   plain_ms=cuda_ms(plain, reps=21, before=flush),
                   library_ms=cuda_ms(library, reps=25, before=flush),
                   **bound(n_bytes, ops))
        print(f"[kernel] {json.dumps(rec)}")
        recs[f"{name}_{label}_w{w}_n{n_pts}"] = rec
    return recs


def train_phase(renderer: str, batch, expect: dict, device=None) -> dict:
    """The full-width f32 train micro-step of one renderer: the training
    configuration with its warmup budgets, seeded weights, 2 warm-up and
    4 timed micro-steps (2 optimizer updates), a stage breakdown of one
    more, the profiler's device-busy share of one more, then the
    GD_APOS_MODE micro-steps and kernels #5 / #6 on their inputs.  The
    2DGS state starts past micro-step 1000 so that its distortion and
    normal terms are active."""
    import torch

    from generativedensification_torch.models.network import NetworkConfig
    from generativedensification_torch.train.loss import Losses
    from generativedensification_torch.train.step import make_train_step

    cfg = train_config(renderer)
    ncfg = NetworkConfig.from_config(cfg)
    step0 = 1001 if renderer == "2dgs" else 0
    net, opt, state = make_trainer(ncfg, cfg.train, step0, device=device)
    step_fn = make_train_step(net, opt, Losses(), with_fine=True)
    state, stats, times, launches, peak = timed_train_steps(
        step_fn, state, batch, expect)
    state, split = train_breakdown(net, opt, state, batch)
    busy = device_busy(lambda: step_fn(state, batch))
    step_ms = statistics.median(times)
    stats = {k: float(v) for k, v in stats.items()}
    rec = dict(renderer=renderer, step_ms=step_ms, step_runs_ms=times,
               samples_per_s=batch["tar_rgb"].shape[0] / step_ms * 1e3,
               launches=launches, peak_bytes=peak, stats=stats,
               overflow=stats["overflow"], optimizer_updates=opt.count,
               micro_steps=state.step - step0, breakdown_ms=split,
               busy_ms=busy["busy_ms"], busy_wall_ms=busy["wall_ms"],
               busy_top=busy["top"], budgets=WARMUP_BUDGETS[renderer],
               mask_pool=ncfg.mask_pool, k_num=ncfg.k_num,
               drop_path=ncfg.drop_path, shuffle_orders=ncfg.shuffle_orders)
    print(f"[train {renderer}] micro-step ms median {step_ms:.2f} (runs "
          f"{[round(t, 2) for t in times]}); {rec['samples_per_s']:.3f} samples/s; "
          f"launches {launches}; overflow {stats['overflow']:.0f}; stats "
          f"{json.dumps(stats)}; peak allocated {peak / 2**30:.2f} GiB")
    print(f"[breakdown] {renderer} train micro-step, device ms by stage: "
          f"{json.dumps(split)}")
    print(f"[profiler] {renderer} train micro-step wall {busy['wall_ms']:.2f} ms, "
          f"kernels busy {busy['busy_ms']:.2f} ms "
          f"({busy['busy_ms'] / busy['wall_ms']:.1%}); top: {json.dumps(busy['top'])}")
    del opt, state, step_fn
    apos, captured = apos_phase(net, batch, step0, expect, 2 * V_TOTAL + N_VIEWS)
    reductions = reduction_records(captured, renderer)
    del net, captured
    torch.cuda.empty_cache()
    return dict(rec, apos=apos, reductions=reductions)


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


def probe_phase() -> dict:
    """The stage probes of kernels #1 and #3 (TPU kernels #7-#10) through
    their breakdown entry points, with the launch counts set to 0 just
    before and read just after: every variant of ``tools.kernel_break`` on
    scenes A and B and of ``tools.surfel_break`` on A′ and B′, each held
    bitwise against its plain version and, where its output is the
    production output, against the production kernel (the tools fail
    otherwise); then ``kernel_break --bwd`` on scene A.  Fails unless every
    variant launched."""
    from generativedensification_torch.splat import kernels
    from generativedensification_torch.splat import probe_kernels as pk
    from generativedensification_torch.tools import kernel_break, surfel_break

    kernels.reset_launch_counts()
    for k in pk.variant_launches:
        pk.variant_launches[k] = 0
    t0 = time.perf_counter()
    runs = {}
    for scene in ("A", "B"):
        print(f"[probes] kernel_break --scene {scene}")
        runs[f"3dgs_{scene}"] = kernel_break.run([*pk.COMPOSITE_VARIANTS,
                                                 "--scene", scene])
        print(f"[probes] surfel_break --scene {scene}")
        runs[f"2dgs_{scene}"] = surfel_break.run(["--scene", scene])
    print("[probes] kernel_break --bwd --scene A")
    runs["bwd_A"] = kernel_break.run(["--bwd", "--scene", "A"])
    launches = {f"{kind}:{v}": n for (kind, v), n in pk.variant_launches.items()}
    totals = {k: kernels.launch_counts[k] for k in ("composite_fwd_probe",
                                                     "surfel_fwd_probe")}
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        fail(f"probe variants never launched by the breakdowns: {idle}")
    print(f"[probes] launches {json.dumps(totals)} in "
          f"{time.perf_counter() - t0:.1f}s; per variant {json.dumps(launches)}")
    return dict(runs=runs, launches=launches, totals=totals)


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
    from generativedensification_torch.splat import probe_kernels as pk
    from generativedensification_torch.tools import scenes, timing
    from generativedensification_torch.utils.device import resolve_device

    def expect(**launches):
        """Launches per forward: the given kernels, every other one 0."""
        return {**dict.fromkeys(kernels.launch_counts, 0), **launches}

    # -- 1. the card
    card = timing.card()
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
    # the sub-tile kernels #1-#4 must not spill
    for name in ("composite_fwd", "composite_bwd", "surfel_fwd", "surfel_bwd"):
        spills = [ln.strip() for ln in libs[name].build_log.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads"
                  not in ln]
        if spills:
            fail(f"{name} spills registers: {spills}")

    # -- 3. kernels #1 and #2, scene A: bench.py's scene; the adversarial
    # scene of the footprint skip at both tile sizes
    with torch.inference_mode():
        args, overflow, _ = scenes.bench_scene(dev)
        bench_rec = kernel_record("bench_512_131k", args, overflow)
        bwd_recs_a = bwd_records("bench_512_131k", args)
        adversarial = {}
        for ts in (32, 16):
            args, overflow, _ = scenes.adversarial_scene(dev, ts)
            label = f"adversarial_256_ts{ts}"
            adversarial[label] = dict(fwd=kernel_record(label, args, overflow),
                                      bwd=bwd_records(label, args))

    # the full-width serving network from the infer configuration
    cfg = NetworkConfig.from_config(scenes.fine_config())
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
        cam = net._cameras_all(batch)[0][0]
        args, overflow, _ = scenes.model_gaussians(out["render_pkg"][0], cam, cfg)
        model_rec = kernel_record("model_512_262k_view0", args, overflow)
        bwd_recs = bwd_records("model_512_262k_view0", args, batch["tar_rgb"][0, 0])
        # scene B at the 3DGS train step's warmup budgets
        max_tiles, enum_tiles, max_per_tile = WARMUP_BUDGETS["3dgs"]
        args, overflow, _ = scenes.model_gaussians(
            out["render_pkg"][0], cam, cfg, None, max_tiles, max_per_tile, enum_tiles)
        warm_rec = kernel_record("model_512_262k_view0_warmup", args, overflow)
        bwd_recs_warm = bwd_records("model_512_262k_view0_warmup", args,
                                    batch["tar_rgb"][0, 0])
        del args

        # -- probes: the stage breakdowns of kernels #1 and #3 (#7-#10)
        probes = probe_phase()

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
        busy = device_busy(lambda: net(batch, with_fine=True))
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
    cfg2 = NetworkConfig.from_config(scenes.fine_config(**{"tpu.renderer": "2dgs"}))
    net2 = Network(cfg2, seed=0)
    net2.eval()
    with torch.inference_mode():
        out2 = net2(batch, with_fine=True)                     # warm-up
        torch.cuda.synchronize()
        check_outputs(out2, 1, V_TOTAL, HW, HW, n_coarse, n_fine, surfels=True)
        # kernels #3 and #4 on a small scene, on scene A', on the
        # screen-circle skip's adversarial scene (32 and 16 px tiles), and on
        # scene B': the model's 262,144 coarse surfels in view 0 (the shapes
        # the main path gives) at the serving and the 2DGS warmup budgets
        surfel_scenes, surfel_bwd = {}, {}
        runs = [("surfels_256_20k", *scenes.surfel_scene(dev), None, False),
                ("surfels_bench_512_131k", *scenes.surfel_bench_scene(dev), None,
                 True)]
        runs += [(f"surfel_adversarial_256_ts{ts}",
                  *scenes.surfel_adversarial_scene(dev, ts), None, False)
                 for ts in (32, 16)]
        max_tiles, enum_tiles, max_per_tile = WARMUP_BUDGETS["2dgs"]
        for label, budgets in (("", ()), ("_warmup",
                                          (None, max_tiles, max_per_tile, enum_tiles))):
            sargs, si = scenes.model_surfels(out2["render_pkg"][0], cam, cfg2, *budgets)
            runs.append((f"model_512_262k_view0_surfels{label}", sargs, si,
                         batch["tar_rgb"][0, 0], True))
        for label, sargs, si, gt, per_tile in runs:
            surfel_scenes[label] = surfel_fwd_record(label, sargs, si, per_tile)
            surfel_bwd[label] = surfel_bwd_records(label, sargs, si, gt)
        del runs, sargs
        surfel_rec = surfel_scenes["model_512_262k_view0_surfels"]
        surfel_bwd_recs = surfel_bwd["model_512_262k_view0_surfels"]
        out_s, times_s, launches_s, peak_s = timed_forwards(
            net2, batch, True, expect(surfel_fwd=2 * V_TOTAL, surfel_bwd=N_VIEWS))
        check_outputs(out_s, 1, V_TOTAL, HW, HW, n_coarse, n_fine, surfels=True)
        split_s = forward_breakdown(net2, batch, True)
        busy_s = device_busy(lambda: net2(batch, with_fine=True))
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

    # -- 8. the f32 train step at full width, each renderer: 16 forward
    # compositor launches, 4 selonly + 16 backward ones (3DGS noabs, 2DGS
    # full) per micro-step; then GD_APOS_MODE and kernels #5 / #6
    n_bwd = 2 * V_TOTAL + N_VIEWS
    train = {
        "3dgs": train_phase("3dgs", batch, expect(composite_fwd=2 * V_TOTAL,
                                                  composite_bwd=n_bwd)),
        "2dgs": train_phase("2dgs", batch, expect(surfel_fwd=2 * V_TOTAL,
                                                  surfel_bwd=n_bwd)),
    }

    # -- 9. the evaluation entry point on 2 synthetic scenes, each renderer
    evals = {}
    for renderer in ("3dgs", "2dgs"):
        t0 = time.perf_counter()
        result = evaluation.main(scenes.fine_config(**{
            "infer.dataset.dataset_name": "synthetic", "infer.dataset.n_scenes": 2,
            "infer.save_images": 0, "tpu.renderer": renderer}))
        eval_s = time.perf_counter() - t0
        means = result["mean"]
        if len(result["scenes"]) != 2 or not all(np.isfinite(v) for v in means.values()):
            fail(f"evaluation result ({renderer}) malformed: {result}")
        print(f"[eval {renderer}] 2 synthetic scenes at {HW}² in {eval_s:.1f}s: "
              f"{json.dumps(means)}")
        evals[renderer] = {"seconds": eval_s, "mean": means}

    # -- 10. the tiny configuration, card vs CPU, each renderer
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
    for name, source, replaces, mode in (
            ("reduce_slots", "reduce_slots.cu", "pallas_kernels.py:505", "gauss"),
            ("transpose_rows", "transpose_rows.cu", "pallas_kernels.py:467",
             "gauss_dsum_col")):
        # the 3DGS noabs width at the coarse Gaussians: the train step's
        # largest reduction
        r = train["3dgs"]["reductions"][f"{name}_3dgs_w10_n{n_coarse}"]
        recs.append({
            "name": name,
            "route": "cuda",
            "source": f"generativedensification_torch/csrc/{source}",
            "replaces": f"generativedensification_tpu/splat/{replaces}",
            "launches": train["3dgs"]["apos"][mode]["launches"][name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    # the probes, each with one variant at scene A / A′ (the others are in
    # the breakdowns above) and its launches in the breakdown run
    for name, kind, variant, replaces in (
            ("composite_fwd_probe:trans", "3dgs", "trans", "dev_kernel_break.py:207"),
            ("composite_fwd_probe:full_bulk", "3dgs", "full_bulk",
             "dev_kernel_break.py:308"),
            ("composite_fwd_probe:tpb2", "3dgs", "tpb2", "dev_kernel_break.py:401"),
            ("surfel_fwd_probe:acc", "2dgs", "acc", "dev_surfel_break.py:206")):
        r = next(x for x in probes["runs"][f"{kind}_A"]["stages"]
                 if x["variant"] == variant)
        if kind == "2dgs":
            n = sum(v for k, v in probes["launches"].items() if k.startswith("surfel:"))
        else:
            tpu = pk.TPU_KERNEL[variant]
            n = sum(v for k, v in probes["launches"].items() if k.startswith("composite:")
                    and pk.TPU_KERNEL[k.split(":")[1]] == tpu)
        recs.append({
            "name": name,
            "route": "cuda",
            "source": "generativedensification_torch/csrc/"
                      + ("surfel_fwd_probe.cu" if kind == "2dgs"
                         else "composite_fwd_probe.cu"),
            "replaces": f"scripts/{replaces}",
            "launches": n,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        })
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
        "train": train, "eval": evals, "tiny": tiny, "pyyaml": has_yaml,
        "scenes": [bench_rec, model_rec, warm_rec],
        "composite_bwd": {"A": bwd_recs_a, "B": bwd_recs, "B_warmup": bwd_recs_warm},
        "adversarial": adversarial,
        "surfel_scenes": surfel_scenes, "surfel_bwd": surfel_bwd, "probes": probes}))
    print(card)
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
