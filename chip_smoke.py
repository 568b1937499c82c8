#!/usr/bin/env python
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Drives ``generativedensification_torch`` only (no JAX):

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and both TF32 flags;
2. builds every CUDA kernel from ``csrc/`` (one ``nvcc`` per source, all
   started together) and prints the build time and ``-Xptxas -v``
   registers / shared memory; fails if kernel #1-#6 or a stage probe
   spills; then holds
   kernels #5 / #6 bit for bit against their plain versions at the train
   step's shapes and on edge cases (``tools/kernel_break.py``
   ``REDUCE_CASES`` / ``TRANSPOSE_CASES``: bases that are not 16 B
   aligned, ragged n and M, d = 1, widths outside the templated set and
   too wide for one tile of #6, NaN and +-inf);
3. kernel #1 phase: holds the forward compositor bitwise
   (``torch.equal``) against its plain PyTorch version on the ``bench.py``
   scene A (512², 131,072 Gaussians, seed 0), on the adversarial scene of
   the footprint skip (``tools/scenes.py``, 256², 32 and 16 px tiles), and
   on the 262,144 coarse Gaussians of the full-width model (scene B, view
   0) with the
   serving budgets and with the 3DGS warmup budgets; prints the skip's kept
   share of (slot, sub-tile) pairs and the evaluations it leaves (from the
   plain mirror ``kernels.subtile_touch``), and times the kernel and the
   plain version with CUDA events (median of >= 20 kernel calls);
4. kernel #2 phase: on the same scenes (scene B with the batch's view-0
   image as ground truth, a seeded image elsewhere), holds the compositing
   backward against its plain version in all three modes (each per-slot
   gradient array scaled by its max |value|, atol 5e-5), checks that two
   launches give bitwise the same output, and times each mode;
4a. pre-pass phase (``csrc/prepass.cu``: the projection and the tile
   binning, which replace no TPU kernel): on the model's coarse and fine
   Gaussians in view 0 and on ``tools/scenes.py``'s pre-pass scene at the
   same counts, the binning kernels bitwise against the plain chain, the
   projection kernel against the plain chain (bits and largest relative
   difference per output, ``valid`` / ``radius`` flips), one view's
   launches, and the pre-pass timed both ways in turns (device and host ms)
   with each kernel's device ms beside its bound; every later phase's
   launch totals count each render's pre-pass (``expect_launches``);
4b. probe phase (kernels #1 and #3 by stage, TPU kernels #7-#10: every
   variant an instantiation of the production sub-tile body): the
   breakdown entry points ``tools.kernel_break`` (every variant of
   ``probe_kernels.composite_fwd_probe``) on scenes A and B and
   ``tools.surfel_break`` (every surfel variant) on A' (the surfel form of
   scene A) and B', each variant bitwise against its plain version and,
   where its output is the production output, against the production
   kernel (for #3 also the rows that ``trans`` / ``acc`` reach), timed
   with CUDA events beside its bound, every variant and the production
   kernel in the same 5 rounds; the stage tables and trip counts; then
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
   warmup budgets; the skip's kept shares (from the plain mirror
   ``surfel_kernels.subtile_touch``), each kernel timed with CUDA events;
   the surfel set-up kernel (``csrc/prepass.cu`` ``gd_surfel_setup``)
   against its plain chain on scene A' and on the model's coarse and fine
   surfels in view 0 (bit for bit on the libraries its orders were
   measured on), timed against the chain in turns (``surfel_setup_phase``);
   then the full-width serving forward with exactly 16 surfel-forward, 4
   surfel-backward and 16 surfel set-up launches (and no 3DGS launch),
   finite 2DGS maps, peak memory, overflow and a device-time breakdown by
   stage;
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
   computes the same function; ``slots_to_gaussians`` timed under the three
   strategies on the ``gauss_dsum`` step's inputs (device ms per
   micro-step);
8b. the bf16 compute policy (``tpu.compute_dtype=bfloat16``, the config
   default) beside f32 on the same seeded weights and batch: the 3DGS
   serving forward and the 3DGS train micro-step (B=1, warmup budgets),
   each timed in turns (f32, bf16, bf16, f32, f32, bf16, bf16, f32) after 2
   warm-ups per dtype, every run with the launch counts set to 0 just
   before and read just after (unchanged by the dtype: 16 + 4 serving, 16
   + 20 train), a stage breakdown per dtype, the fine image's PSNR bf16
   against f32 (at least ``BF16_PSNR_FLOOR``), each dtype's peak memory
   with its own network or trainer the only one on the card; then one
   2DGS bf16 micro-step (finite, 16 surfel-forward + 20 surfel-backward
   launches);
8c. the train CLI phase: ``train.train.main`` at ``load_config()``'s
   defaults (bf16, 3DGS, B=3, accumulation 2, the warmup budgets) on
   ``synthetic`` 512² data, 21 micro-steps and one validation batch, the
   checkpoint into a temporary directory, and a second ``main`` with
   ``model.ckpt_path`` that restores micro-step 21 and the parameters,
   moments and accumulators bit for bit; exactly 48 forward and 12
   ``selonly`` + 48 ``noabs`` backward compositor launches per micro-step
   (16 + 4 + 16 per sample), no probe; the CLI's loader-attached samples/s,
   the median micro-step interval, peak memory, checkpoint size and the
   save and restore seconds (``cli_phase``);
9. evaluation phase: ``eval.evaluation.main`` on 2 ``synthetic`` scenes at
   512² with seeded weights, with each renderer (3DGS at the config's
   bf16, 2DGS in f32); then ``main`` on one scene at bf16 with every side
   output (``eval_phase``): a full-width reference ``.ckpt`` synthesized by
   ``utils/torch_convert.py`` (every key consumed, every parameter filled),
   per-scene finetuning at the config's 500 steps (exactly 4 launches of
   kernel #1 and 4 of kernel #2 ``noabs`` per step, the step's ms, the
   source-view MSE before and after), the 24-frame orbit video, the TSDF
   mesh from 48 RGB-D renders and its 4-frame turntable, LPIPS from seeded
   random weights; kernel #2 ``noabs`` against its plain version on a
   finetune step's inputs (scaled 5e-5) and #1 bitwise on a video frame's;
   the phase's seconds and peak memory;
9c. residual attribute mode (``model.enable_residual_attribute=True``,
   the reference's ``epoch=49_residual.ckpt``): the serving forward at full
   width (f32, the base mode's 331,744 fine Gaussians, exactly 16 forward
   and 4 ``selonly`` launches each of 5 timed forwards, overflow, peak
   memory, a stage breakdown) with kernel #1 bitwise and kernel #2 in
   every mode against their plain versions on its fine render of view 0;
   the f32 train micro-step (the 3DGS training configuration at its warmup
   budgets, exactly 16 + 4 ``selonly`` + 16 ``noabs`` launches, a stage
   breakdown) with #1 bitwise and #2 ``noabs`` on a fine render's inputs;
   the evaluation with a synthesized residual ``.ckpt`` (every key
   consumed), 50 finetune steps, the video and LPIPS (``eval_phase``);
9d. the quality regression (``tools/overfit.py``): the three overfit
   cases of ``tests/test_torch_overfit.py`` (3DGS, 2DGS, residual) on the
   card at the JAX package's thresholds, with their launches;
10. the tiny configuration with the fine stage on the card and on the CPU
   from the same seeded weights, with each renderer and in residual mode:
   Gaussians, selection scores and selected index sets agree, images
   agree but for isolated knife-edge pixels;
11. prints the per-phase JSON, the card, the ``{"kernels": [...]}`` line,
   and as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a card or outside a checkout.
"""

from __future__ import annotations

import dataclasses
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
# the projection kernel against the plain chain (tests/test_torch_prepass.py):
# each output's largest difference over the plain chain's largest |value|,
# and the share of Gaussians whose ``valid`` or ``radius`` may flip
PROJECT_RTOL = 1e-5
PROJECT_FLIP_SHARE = 1e-4
# the bf16 serving forward's fine image against the f32 one on the same
# weights and batch (32.25 dB on an NVIDIA H100 80GB HBM3 at 700 W); a bf16
# path that rounds where it must not, or computes garbage, falls far below
BF16_PSNR_FLOOR = 28.0
V_TOTAL, N_VIEWS, HW = 8, 4, 512
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
    and the bound from the evaluations the skip leaves."""
    import torch

    from generativedensification_torch.splat import kernels
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
    ms = cuda_ms(lambda: kernels.composite_fwd(*args), reps=25)
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
               ms=ms, plain_ms=plain_ms, max_abs_err=0.0,
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


def surfel_fwd_record(name: str, args, si) -> dict:
    """Kernel #3 vs plain on one scene: bitwise agreement, the screen-circle
    skip's kept share of (slot, sub-tile) pairs and of circle tests
    (``surfel_kernels.subtile_touch``, the plain mirror of the kernel's
    predicate; the plain version with it mirrored also bitwise), times and
    the bound from the circle tests the skip leaves."""
    import torch

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
               ms=ms, plain_ms=plain_ms, max_abs_err=0.0, bitwise=True,
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


def train_config(renderer: str, dtype: str = "float32"):
    """The training configuration (``load_config()``: ``mask_pool`` 49,152,
    k 12,000, drop-path 0.3, order shuffling, ``start_fine`` -1,
    ``accumulate_grad_batches`` 2) in ``dtype`` (f32 unless asked), with
    the renderer's warmup budgets of ``train/train.py`` (pair budget off)."""
    from generativedensification_torch.config import load_config

    from generativedensification_torch.train.train import warmup_budgets

    cfg = load_config()
    cfg.set_dotted("tpu.compute_dtype", dtype)
    cfg.set_dotted("tpu.renderer", renderer)
    for k, v in warmup_budgets(cfg).items():
        cfg.set_dotted(f"tpu.{k}", v)
    return cfg


def budgets_of(renderer: str) -> tuple:
    """(max_tiles, enum_tiles, max_per_tile) of ``renderer``'s warmup
    budgets, as the train CLI sets them (``train_config``)."""
    tpu = train_config(renderer).tpu
    return tpu.max_tiles, tpu.enum_tiles, tpu.max_per_tile


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
    phases (the shapes the train step gives the kernels), and so are those
    of ``slots_to_gaussians`` in the ``gauss_dsum`` step, with its calls per
    width and point count.  The three micro-steps run
    under ``torch.use_deterministic_algorithms``, so that they differ only
    by the strategy: the gather backwards then add in a fixed order instead
    of with atomics; the ops that have no such algorithm are listed."""
    import torch

    from generativedensification_torch.splat import composite, surfel

    captured, calls = {}, {}
    real = {"reduce_slots": composite.reduce_slots,
            "transpose_rows": composite.transpose_rows}

    def capture(name):
        def run(x, *a):
            # (kernel, width, gaussians): the coarse and the fine renders
            w, n = (x.shape[1], a[0]) if name == "reduce_slots" else x.shape
            captured.setdefault((name, w, n), (x, *a))
            return real[name](x, *a)
        return run

    def capture_slots(rows, sorted_o, depth_order, n_slots):
        # the reduction's inputs and calls per (width, gaussians), one step
        if composite.APOS_MODE == "gauss_dsum":
            key = ("slots_to_gaussians", rows.shape[1], depth_order.shape[0])
            captured.setdefault(key, (rows, sorted_o, depth_order, n_slots))
            calls[key] = calls.get(key, 0) + 1
        return stg(rows, sorted_o, depth_order, n_slots)

    stg = composite.slots_to_gaussians
    mode0 = composite.APOS_MODE
    runs = {}
    composite.reduce_slots = capture("reduce_slots")
    composite.transpose_rows = capture("transpose_rows")
    composite.slots_to_gaussians = surfel.slots_to_gaussians = capture_slots
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
            composite.slots_to_gaussians = surfel.slots_to_gaussians = stg
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
    return recs, captured, calls


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


def reduction_records(captured: dict, calls: dict, label: str) -> dict:
    """Kernels #5 and #6 against their plain versions (bit for bit,
    ``kernel_break.same_bits``) on the inputs the train step gave them, with
    their times, the time of the one PyTorch call that computes the same
    function, and the bound; then ``slots_to_gaussians`` under
    ``gauss_dsum`` (no kernel), ``gauss`` (#5) and ``gauss_dsum_col`` (#6) on
    the inputs the ``gauss_dsum`` step gave it, and its device ms per
    micro-step (weighted by the step's calls).  Each timed call finds the
    50 MB L2 cache cold and the card busy while the host enqueues it
    (``timing.cold_l2``; ~2 ms for ``slots_to_gaussians``, whose
    ``gauss_dsum_col`` enqueues 2 D + 4 launches), so that the interval
    holds the device's work and not the host's enqueueing."""
    import torch

    from generativedensification_torch.splat import composite, kernels
    from generativedensification_torch.tools.kernel_break import same_bits
    from generativedensification_torch.tools.timing import bound, cold_l2, cuda_ms

    recs = {}
    dev = next(iter(captured.values()))[0].device
    flush = cold_l2(dev)
    for (name, w, n_pts), args in sorted(captured.items()):
        if name == "slots_to_gaussians":
            continue
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
        if not same_bits(out, ref):
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
    mode0, per_step = composite.APOS_MODE, {}
    flush = cold_l2(dev, spin_cycles=4_000_000)
    try:
        for (name, w, n_pts), args in sorted(captured.items()):
            if name != "slots_to_gaussians":
                continue
            count = calls[(name, w, n_pts)]
            for mode in ("gauss_dsum", "gauss", "gauss_dsum_col"):
                composite.APOS_MODE = mode
                ms = cuda_ms(lambda: composite.slots_to_gaussians(*args), reps=21,
                             before=flush)
                per_step[mode] = per_step.get(mode, 0.0) + count * ms
                print(f"[slot reduction] {label} {mode} w={w} n={n_pts}: {ms:.4f} ms "
                      f"x {count} calls per micro-step")
    finally:
        composite.APOS_MODE = mode0
    print(f"[slot reduction] {label} device ms per micro-step by GD_APOS_MODE: "
          f"{json.dumps(per_step)}")
    return dict(recs, slot_reduction_ms_per_micro_step=per_step)


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
               busy_top=busy["top"], budgets=budgets_of(renderer),
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
    apos, captured, calls = apos_phase(net, batch, step0, expect,
                                       2 * V_TOTAL + N_VIEWS)
    reductions = reduction_records(captured, calls, renderer)
    del net, captured
    torch.cuda.empty_cache()
    return dict(rec, apos=apos, reductions=reductions)


def tiny_card_vs_cpu(renderer: str = "3dgs", seed: int = 35, residual: bool = False):
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
    of differing fine pixels is printed, not held.

    In residual attribute mode (``residual``) the fine maps are held the
    same way, on identical inputs: the densifier works on ×2 coordinates,
    which doubles the argument of the ``UpscaleModule``'s 2^14 positional
    encoding frequency, and the seeded (unscaled) offset head then turns
    cross-device rounding into fine Gaussians that move a few pixels end
    to end (0.14% of the fine image's pixels beyond 2e-4 on an NVIDIA H100
    80GB HBM3 at 700 W, against 0.1% held)."""
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
        renderer=renderer, enable_residual_attribute=residual)
    label = renderer + (" residual" if residual else "")
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
    print(f"[tiny {label}] selection scores max|card-cpu| {score_err:.3g} (tolerance "
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
    if renderer == "2dgs" or residual:
        for key in fine_keys:
            d = (outs["cuda"][key].cpu() - cpu[key]).abs()
            end_to_end[key] = float(
                (d > ATOL * max(1.0, float(cpu[key].abs().max()))).float().mean())
        print(f"[tiny {label}] end-to-end fine maps, share of pixels beyond "
              f"the tolerance (not held): {json.dumps(end_to_end)}")
        # the card's fine primitives rendered on the CPU
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
        print(f"[tiny {label}] {key}: max|card-cpu| {float(d.max()):.3g}, "
              f"share beyond the tolerance: {frac:.2e}")
        if frac > share:
            fail(f"tiny config ({label}): {key} differs card vs CPU on "
                 f"{frac:.2%} of pixels")
    return dict(score_err=score_err, score_tol=tol, margin=margin, shares=shares,
                fine_end_to_end_shares=end_to_end)


def _in_turns(runs: dict, rounds: int) -> dict:
    """Call each of ``runs`` (name -> fn returning ms) ``2 * rounds`` times
    in turns (a, b, b, a, ...); returns name -> list of ms."""
    names = list(runs)
    times = {n: [] for n in names}
    for r in range(rounds):
        order = names if r % 2 == 0 else names[::-1]
        for n in order + order[::-1]:
            times[n].append(runs[n]())
    return times


def peak_alone(build, run, runs: int = 1, warm: int = 2) -> dict:
    """Peak allocated bytes of ``runs`` calls of ``run(obj)`` with
    ``build()``'s network (or trainer) the only model on the card: built
    after every other one was freed, ``warm`` warm-up calls, then the
    counted ones; freed again after.  ``base_bytes`` is what was allocated
    before the build (the batch and whatever the caller holds)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    obj = build()
    for _ in range(warm):
        run(obj)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(runs):
        run(obj)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del obj
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    if left > 2**26:
        fail(f"peak_alone: {left} bytes of the measured model were not freed")
    return dict(peak_bytes=peak, base_bytes=base)


def bf16_phase(batch, expect_serving: dict, expect_train: dict,
               expect_train_2dgs: dict) -> dict:
    """The bf16 compute policy beside f32 on the same weights and batch:
    the 3DGS serving forward (infer configuration) and the 3DGS train
    micro-step at B=1 (training configuration, warmup budgets), each timed
    in turns (f32, bf16, bf16, f32, ...) with the launch counts held per
    run, and a stage breakdown of each dtype; the bf16 fine image must lie
    at least ``BF16_PSNR_FLOOR`` dB from the f32 one.  Then the peak memory
    of each dtype with its own network (or trainer) the only one on the
    card (``peak_alone``), and one 2DGS bf16 micro-step (finite, its launch
    counts)."""
    import torch

    from generativedensification_torch.models.network import Network, NetworkConfig
    from generativedensification_torch.splat import kernels
    from generativedensification_torch.tools import scenes
    from generativedensification_torch.train.loss import Losses
    from generativedensification_torch.train.step import make_train_step

    dtypes = ("float32", "bfloat16")
    rec = {"serving": {}, "train": {}}

    def counted(fn, expect, tag):
        def run():
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if dict(kernels.launch_counts) != expect:
                fail(f"{tag}: expected launches {expect}, got "
                     f"{dict(kernels.launch_counts)}")
            last[tag] = res
            return ms
        return run

    last = {}
    # -- serving forward
    def serving_net(dt):
        return Network(NetworkConfig.from_config(scenes.fine_config(
            **{"tpu.compute_dtype": dt})), seed=0)

    nets = {dt: serving_net(dt) for dt in dtypes}
    n_coarse = (2 * nets["float32"].cfg.vol_embedding_reso) ** 3
    n_fine = (sum(lv["leaf"] for lv in nets["float32"].cfg.level_sizes())
              + min(nets["float32"].cfg.mask_pool, n_coarse) - nets["float32"].cfg.k_num)
    with torch.inference_mode():
        runs = {dt: counted(lambda n=net: n(batch, with_fine=True), expect_serving,
                            f"serving {dt}") for dt, net in nets.items()}
        for run in runs.values():
            run(), run()                                   # warm-ups
        times = _in_turns(runs, 2)
        for dt, net in nets.items():
            out = last[f"serving {dt}"]
            check_outputs(out, 1, V_TOTAL, HW, HW, n_coarse, n_fine)
            rec["serving"][dt] = dict(
                forward_ms=statistics.median(times[dt]), runs_ms=times[dt],
                overflow=int(out["overflow"].sum()),
                breakdown_ms=forward_breakdown(net, batch, True))
        img = {dt: last[f"serving {dt}"]["image_fine"].float() for dt in dtypes}
        mse = float(((img["bfloat16"] - img["float32"]) ** 2).mean())
        psnr = -10 * np.log10(max(mse, 1e-20))
        rec["serving"]["fine_image_psnr_bf16_vs_f32"] = psnr
        if not psnr >= BF16_PSNR_FLOOR:
            fail(f"bf16 serving: the fine image lies {psnr:.2f} dB from f32's "
                 f"(floor {BF16_PSNR_FLOOR} dB)")
    del nets, runs, run, img, net, out
    last.clear()
    with torch.inference_mode():
        for dt in dtypes:
            rec["serving"][dt].update(peak_alone(
                lambda dt=dt: serving_net(dt), lambda n: n(batch, with_fine=True)))

    # -- train micro-step (3DGS, B=1)
    def trainer(dt):
        cfg = train_config("3dgs", dt)
        net, opt, state = make_trainer(NetworkConfig.from_config(cfg), cfg.train, 0)
        return [net, opt, state, make_train_step(net, opt, Losses(), with_fine=True)]

    def advance(t):
        t[2], stats = t[3](t[2], batch)
        return stats

    trainers = {dt: trainer(dt) for dt in dtypes}

    def step_of(dt):
        return lambda: advance(trainers[dt])

    runs = {dt: counted(step_of(dt), expect_train, f"train {dt}") for dt in dtypes}
    for run in runs.values():
        run(), run()                                       # warm-ups
    times = _in_turns(runs, 2)
    for dt in dtypes:
        stats = {k: float(v) for k, v in last[f"train {dt}"].items()}
        check_step_stats(last[f"train {dt}"], f"train {dt}")
        net, opt, state = trainers[dt][:3]
        state, split = train_breakdown(net, opt, state, batch)
        trainers[dt][2] = state
        rec["train"][dt] = dict(step_ms=statistics.median(times[dt]),
                                runs_ms=times[dt], stats=stats, breakdown_ms=split)
    del trainers, runs, run, last, net, opt, state
    for dt in dtypes:
        # one accumulating and one updating micro-step (accumulation 2)
        rec["train"][dt].update(peak_alone(lambda dt=dt: trainer(dt), advance,
                                           runs=2))

    # -- one 2DGS bf16 micro-step, past micro-step 1000 (its terms on)
    cfg = train_config("2dgs", "bfloat16")
    net, opt, state = make_trainer(NetworkConfig.from_config(cfg), cfg.train, 1001)
    step_fn = make_train_step(net, opt, Losses(), with_fine=True)
    kernels.reset_launch_counts()
    state, stats = step_fn(state, batch)
    torch.cuda.synchronize()
    if dict(kernels.launch_counts) != expect_train_2dgs:
        fail(f"2dgs bf16 micro-step: expected launches {expect_train_2dgs}, got "
             f"{dict(kernels.launch_counts)}")
    check_step_stats(stats, "2dgs bf16 micro-step")
    rec["train_2dgs_bf16"] = dict(stats={k: float(v) for k, v in stats.items()},
                                  launches=dict(kernels.launch_counts))
    del net, opt, state, step_fn
    torch.cuda.empty_cache()

    for part in ("serving", "train"):
        for dt in dtypes:
            r = dict(rec[part][dt])
            split = r.pop("breakdown_ms")
            print(f"[bf16] {part} {dt}: {json.dumps(r)}")
            print(f"[breakdown] {part} {dt}, device ms by stage: {json.dumps(split)}")
    print(f"[bf16] serving fine image PSNR bf16 vs f32 "
          f"{rec['serving']['fine_image_psnr_bf16_vs_f32']:.2f} dB; 2dgs bf16 "
          f"micro-step {json.dumps(rec['train_2dgs_bf16'])}")
    return rec


# the validation share of the 64 synthetic scenes that gives exactly one
# batch of 3 (int(64 * 0.05) = 3; the default 0.02 gives none)
CLI_VAL_FRACTION = 0.05


def cli_phase() -> dict:
    """The train CLI at its config defaults: ``train.train.main`` on the
    card with ``load_config()`` (bf16, 3DGS, B=3, accumulation 2, the
    warmup budgets for the first 2,000 micro-steps) on ``synthetic`` 512²
    data, one epoch of 21 micro-steps (``limit_train_batches`` 1.0), one
    validation batch and the checkpoint at its end into a temporary
    directory; then a second ``main`` with ``model.ckpt_path`` and no epoch,
    which must restore micro-step 21 and the parameters, moments and
    accumulators bit for bit.  The first ``main``'s datasets render their
    ground truth when built (set-up, not timed with the loop; kernel #1 at
    16 px tiles, counted apart), so that every launch inside the loop is
    the train step's: each micro-step must launch exactly 16 forward and 4
    ``selonly`` + 16 ``noabs`` backward compositors per sample, and the run
    as a whole (counts set to 0 just before ``main``, read just after) those
    plus the validation's and the set-up's.  Reports the
    loader-attached samples/s of the CLI's own 20-step window, the median
    interval between micro-step starts (host clock, no synchronize, so the
    CLI's own pipelining is kept), peak memory, and the save and restore
    seconds; the temporary directory is deleted."""
    import pathlib
    import shutil
    import tempfile

    import torch

    from generativedensification_torch.config import load_config
    from generativedensification_torch.splat import kernels
    from generativedensification_torch.train import train as train_mod
    from generativedensification_torch.train.state import latest_step

    tmp = tempfile.mkdtemp(prefix="gd_cli_")
    over = ["train_dataset.dataset_name=synthetic", "test_dataset.dataset_name=synthetic",
            "train.n_epoch=1", "train.limit_train_batches=1.0",
            f"train.limit_val_batches={CLI_VAL_FRACTION}", f"logger.dir={tmp}",
            "exp_name=smoke"]
    cfg = load_config(overrides=over)
    B = int(cfg.train.batch_size)
    marks = {"build_s": 0.0, "lens": [], "starts": [], "deltas": [], "save_s": [],
             "restore_s": [], "build_launches": dict.fromkeys(kernels.launch_counts, 0)}
    logs = []
    real = {k: getattr(train_mod, k) for k in ("build_dataset", "make_train_step",
                                               "save_checkpoint", "restore_checkpoint",
                                               "ScalarLog")}

    def build(ds_cfg, device=None):
        ds = real["build_dataset"](ds_cfg, device=device)
        if len(marks["lens"]) < 2:           # the first main's two datasets
            before = dict(kernels.launch_counts)
            t0 = time.perf_counter()
            for i in range(len(ds)):
                ds[i]                        # render and cache the ground truth
            torch.cuda.synchronize()
            marks["build_s"] += time.perf_counter() - t0
            marks["lens"].append(len(ds))
            for n, c in kernels.launch_counts.items():
                marks["build_launches"][n] += c - before[n]
        return ds

    def make_step(*a, **k):
        fn = real["make_train_step"](*a, **k)

        def run(state, b):
            before = dict(kernels.launch_counts)
            marks["starts"].append(time.perf_counter())
            out = fn(state, b)
            marks["deltas"].append({n: kernels.launch_counts[n] - before[n]
                                    for n in before})
            return out
        return run

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            marks[key].append(time.perf_counter() - t0)
            return out
        return run

    def capture(cfg, rank=0):
        logs.append(real["ScalarLog"](cfg, rank))
        return logs[-1]

    train_mod.build_dataset = build
    train_mod.make_train_step = make_step
    train_mod.save_checkpoint = timed("save_s", real["save_checkpoint"])
    train_mod.restore_checkpoint = timed("restore_s", real["restore_checkpoint"])
    train_mod.ScalarLog = capture
    try:
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = train_mod.main(cfg)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        ckpt = f"{tmp}/smoke/ckpts"
        step_saved = latest_step(ckpt)
        size = sum(f.stat().st_size for f in pathlib.Path(ckpt).rglob("*")
                   if f.is_file())
        resumed = train_mod.main(load_config(overrides=over + [
            f"model.ckpt_path={ckpt}", "train.n_epoch=0"]))
    finally:
        for k, v in real.items():
            setattr(train_mod, k, v)
        shutil.rmtree(tmp, ignore_errors=True)

    n_steps = len(marks["deltas"])
    n_train, n_val = marks["lens"][:2]
    per_step = expect_launches(kernels, backward=True, composite_fwd=2 * V_TOTAL * B,
                               composite_bwd=(2 * V_TOTAL + N_VIEWS) * B)
    bad = [i for i, d in enumerate(marks["deltas"]) if d != per_step]
    if n_steps != n_train // B or int(n_val * CLI_VAL_FRACTION) // B != 1 or bad:
        fail(f"train CLI: {n_steps} micro-steps (expected {n_train // B}), "
             f"{int(n_val * CLI_VAL_FRACTION) // B} validation batches (expected 1); steps with "
             f"other launches than {per_step}: {bad[:3]} "
             f"{[marks['deltas'][i] for i in bad[:3]]}")
    val = expect_launches(kernels, composite_fwd=2 * V_TOTAL * B,
                          composite_bwd=N_VIEWS * B)
    # the ground-truth renders of the datasets' set-up, then the loop's
    want = {n: marks["build_launches"][n] + n_steps * per_step[n] + val[n]
            for n in per_step}
    if launches != want:
        fail(f"train CLI: launches {launches} over the run, expected {want}")
    if state.step != n_steps or step_saved != n_steps:
        fail(f"train CLI: state at step {state.step}, checkpoint at {step_saved}, "
             f"expected {n_steps}")
    if resumed.step != n_steps:
        fail(f"train CLI resume: step {resumed.step}, expected {n_steps}")
    same = all(torch.equal(a, b) for a, b in zip(state.net.parameters(),
                                                 resumed.net.parameters()))
    opt_a, opt_b = state.optimizer.state, resumed.optimizer.state
    same_opt = all(torch.equal(opt_a[p][k], opt_b[q][k])
                   for p, q in zip(state.net.parameters(), resumed.net.parameters())
                   for k in ("mu", "nu", "acc"))
    same_opt = same_opt and (state.optimizer.count, state.optimizer.mini_step) == (
        resumed.optimizer.count, resumed.optimizer.mini_step)
    if not (same and same_opt):
        fail(f"train CLI resume: parameters bitwise {same}, optimizer bitwise {same_opt}")
    history = logs[0].history
    train_logs = [s for p, _, s in history if p == "train"]
    val_logs = [s for p, _, s in history if p == "val"]
    if len(train_logs) != 1 or len(val_logs) != 1:
        fail(f"train CLI: {len(train_logs)} train and {len(val_logs)} val logs, "
             "expected one each")
    for s in train_logs + val_logs:
        if not all(np.isfinite(v) for v in s.values()):
            fail(f"train CLI: non-finite scalars {s}")
    intervals = np.diff(marks["starts"]) * 1e3
    rec = dict(batch_size=B, micro_steps=n_steps, updates=state.optimizer.count,
               compute_dtype=cfg.tpu.compute_dtype,
               samples_per_s=train_logs[0]["samples_per_s"],
               micro_step_ms_median=float(np.median(intervals)),
               micro_step_ms=[round(float(t), 2) for t in intervals],
               loss=train_logs[0]["loss"], overflow=train_logs[0]["overflow"],
               lr=train_logs[0]["lr"], val=val_logs[0], launches_per_step=per_step,
               launches=launches, dataset_launches=marks["build_launches"],
               peak_bytes=peak, main_s=main_s,
               dataset_build_s=marks["build_s"], save_s=marks["save_s"][0],
               restore_s=marks["restore_s"][0], checkpoint_bytes=size,
               resume_bitwise=True)
    print(f"[cli] {n_steps} micro-steps at B={B} ({cfg.tpu.compute_dtype}) in "
          f"{main_s:.1f}s; loader-attached {rec['samples_per_s']:.3f} samples/s "
          f"(steps 1-20); micro-step median {rec['micro_step_ms_median']:.1f} ms; "
          f"peak allocated {peak / 2**30:.2f} GiB; checkpoint "
          f"{size / 2**30:.2f} GiB saved in {rec['save_s']:.2f}s, restored in "
          f"{rec['restore_s']:.2f}s; loss {rec['loss']:.4f} overflow "
          f"{rec['overflow']:.0f}; datasets built in {marks['build_s']:.1f}s")
    del state, resumed
    torch.cuda.empty_cache()
    return rec


# the full-width evaluation run: finetuning at the config's 500 steps, the
# orbit video, the mesh and its turntable, LPIPS, a reference checkpoint
EVAL_FT_STEPS = 500
RESIDUAL_FT_STEPS = 50       # the residual evaluation's finetuning, cut short
EVAL_VIDEO_FRAMES = 24
EVAL_MESH_FRAMES = 4
MESH_VIEWS = 3 * 16          # uni_mesh_path(16): three elevation rings


def eval_phase(residual: bool = False) -> dict:
    """``eval.evaluation.main`` on one ``synthetic`` 512² scene at the infer
    configuration's dtype (bf16) with every side output: a full-width
    reference checkpoint synthesized by ``utils/torch_convert.py`` and
    written as a ``.ckpt`` (every source key consumed, every parameter
    filled), per-scene finetuning (``EVAL_FT_STEPS`` Adam steps on the
    331,744 fine Gaussians in the 4 source views: each step exactly 4
    launches of kernel #1 and 4 of kernel #2, all ``noabs``, its ms by the
    host clock with synchronize, the source-view MSE before and after, the
    overflow), the orbit video (``EVAL_VIDEO_FRAMES`` frames, one #1 launch
    each), the TSDF mesh (``MESH_VIEWS`` RGB-D renders, one #1 launch each;
    seconds for render + fusion and for extraction, vertex and face counts)
    and its turntable, LPIPS (seeded random weights for both backbones
    through ``LPIPS_WEIGHTS_NPZ``; ms per image pair).  Then kernel #2
    ``noabs`` against its plain version on one finetune step's own inputs
    (scaled 5e-5 per row) and kernel #1 bitwise its plain version on one
    video frame's inputs.  Everything is written to a temporary directory,
    deleted at the end.

    ``residual``: the reference's residual checkpoint layout
    (``model.enable_residual_attribute=True``, ``epoch=49_residual.ckpt``),
    finetuning cut to ``RESIDUAL_FT_STEPS`` and no mesh."""
    import os
    import shutil
    import tempfile

    import torch

    from generativedensification_torch.eval import evaluation
    from generativedensification_torch.eval import finetune as ft
    from generativedensification_torch.models.network import NetworkConfig
    from generativedensification_torch.splat import composite, kernels
    from generativedensification_torch.tools import mesh_extractor, mesh_render, scenes
    from generativedensification_torch.tools.convert_lpips import random_weights
    from generativedensification_torch.tools.timing import cuda_ms
    from generativedensification_torch.utils import torch_convert
    from generativedensification_torch.utils.image_io import read_png

    ft_steps = RESIDUAL_FT_STEPS if residual else EVAL_FT_STEPS
    tag = "eval residual" if residual else "eval full"
    tmp = tempfile.mkdtemp(prefix="gd_eval_")
    t_setup = time.perf_counter()
    for net in ("vgg", "alex"):
        np.savez(f"{tmp}/lpips_{net}.npz", **random_weights(net, seed=0))
    env0 = os.environ.get("LPIPS_WEIGHTS_NPZ")
    os.environ["LPIPS_WEIGHTS_NPZ"] = tmp + "/lpips_{net}.npz"
    cfg = scenes.fine_config(**{
        "tpu.compute_dtype": "bfloat16", "infer.dataset.dataset_name": "synthetic",
        "infer.dataset.n_scenes": 1, "infer.finetuning.with_ft": True,
        "infer.finetuning.steps": ft_steps, "infer.video_frames": EVAL_VIDEO_FRAMES,
        "infer.save_mesh": not residual,
        "infer.mesh_video_frames": 0 if residual else EVAL_MESH_FRAMES,
        "infer.eval_lpips": True, "infer.ckpt_path": f"{tmp}/ref.ckpt",
        "infer.save_folder": f"{tmp}/out", "model.enable_residual_attribute": residual})
    sd = torch_convert.synthesize_reference_state_dict(NetworkConfig.from_config(cfg))
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}},
               f"{tmp}/ref.ckpt")
    ckpt_bytes = os.path.getsize(f"{tmp}/ref.ckpt")
    del sd
    setup_s = time.perf_counter() - t_setup

    rec = dict(ft_ms=[], ft_launches=[], ft_loss=[], ft_overflow=[], bwd_modes=[],
               lpips_ms=[], mse=None, report={}, captured={}, secs={}, launches={},
               mesh=None)
    real = dict(convert=torch_convert.convert_state_dict, ft_step=ft.ft_step,
                finetune_scene=evaluation.finetune_scene, lpips_fn=evaluation.lpips_fn,
                save_video=evaluation._save_video, save_mesh=evaluation._save_mesh,
                fuse=mesh_extractor.MeshExtractor.fuse,
                extract_mesh=mesh_extractor.TSDFVolume.extract_mesh,
                save_obj=mesh_extractor.save_obj, turntable=mesh_render.turntable_frames,
                fwd=composite.composite_fwd, bwd=composite.composite_bwd)
    capture = {"fwd": False, "bwd": False, "in_step": False}

    def convert(sd, net, report=None):
        return real["convert"](sd, net, rec["report"])

    def fwd(*a):
        if capture["fwd"]:
            rec["captured"]["fwd"] = a
            capture["fwd"] = False
        return real["fwd"](*a)

    def bwd(table, ids, starts, counts, gc4, g2, tiles_x, tiles_y, ts, mode="full"):
        a = (table, ids, starts, counts, gc4, g2, tiles_x, tiles_y, ts)
        if capture["in_step"]:
            rec["bwd_modes"].append(mode)
        if capture["bwd"]:
            rec["captured"]["bwd"] = (a, mode)
            capture["bwd"] = False
        return real["bwd"](*a, mode=mode)

    def ft_step(*a, **k):
        capture["bwd"] = len(rec["ft_ms"]) == 1            # the second step's
        capture["in_step"] = True
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        loss, overflow = real["ft_step"](*a, **k)
        torch.cuda.synchronize()
        capture["in_step"] = False
        rec["ft_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["ft_launches"].append(dict(kernels.launch_counts))
        rec["ft_loss"].append(float(loss))
        rec["ft_overflow"].append(int(overflow))
        return loss, overflow

    def finetune_scene(out, batch, net_cfg, ft_cfg, n_views):
        t0 = time.perf_counter()
        image_fine, pkg = real["finetune_scene"](out, batch, net_cfg, ft_cfg, n_views)
        torch.cuda.synchronize()
        rec["secs"]["finetune"] = time.perf_counter() - t0
        B, V, H, W, _ = batch["tar_rgb"].shape
        gt = batch["tar_rgb"].permute(0, 2, 1, 3, 4).reshape(1, H, V * W, 3)
        src = slice(0, W * n_views)
        mse = lambda img: float(torch.mean((img[:, :, src] - gt[:, :, src]) ** 2))
        rec["mse"] = (mse(out["image_fine"]), mse(image_fine))
        return image_fine, pkg

    def lpips_fn(*a, **k):
        fn = real["lpips_fn"](*a, **k)

        def timed(x, y):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = fn(x, y)
            torch.cuda.synchronize()
            rec["lpips_ms"].append((time.perf_counter() - t0) * 1e3)
            return d
        return timed

    def counted(key, fn, first_fwd=False):
        def run(*a, **k):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            capture["fwd"] = first_fwd
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec["secs"][key] = time.perf_counter() - t0
            rec["launches"][key] = dict(kernels.launch_counts)
            return out
        return run

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            rec["secs"][key] = rec["secs"].get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    def save_obj(path, verts, faces, colors=None):
        rec["mesh"] = dict(vertices=len(verts), faces=len(faces),
                           finite=bool(np.isfinite(verts).all()))
        return timed("mesh_obj_write", real["save_obj"])(path, verts, faces, colors)

    torch_convert.convert_state_dict = convert
    ft.ft_step = ft_step
    evaluation.finetune_scene = finetune_scene
    evaluation.lpips_fn = lpips_fn
    evaluation._save_video = counted("video", real["save_video"], first_fwd=True)
    evaluation._save_mesh = counted("mesh", real["save_mesh"])
    mesh_extractor.MeshExtractor.fuse = timed("mesh_render_fuse", real["fuse"])
    mesh_extractor.TSDFVolume.extract_mesh = timed("mesh_extract", real["extract_mesh"])
    mesh_extractor.save_obj = save_obj
    mesh_render.turntable_frames = timed("mesh_turntable", real["turntable"])
    composite.composite_fwd = fwd
    composite.composite_bwd = bwd
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = evaluation.main(cfg)
        torch.cuda.synchronize()
        phase_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        torch_convert.convert_state_dict = real["convert"]
        ft.ft_step = real["ft_step"]
        evaluation.finetune_scene = real["finetune_scene"]
        evaluation.lpips_fn = real["lpips_fn"]
        evaluation._save_video = real["save_video"]
        evaluation._save_mesh = real["save_mesh"]
        mesh_extractor.MeshExtractor.fuse = real["fuse"]
        mesh_extractor.TSDFVolume.extract_mesh = real["extract_mesh"]
        mesh_extractor.save_obj = real["save_obj"]
        mesh_render.turntable_frames = real["turntable"]
        composite.composite_fwd = real["fwd"]
        composite.composite_bwd = real["bwd"]
        if env0 is None:
            os.environ.pop("LPIPS_WEIGHTS_NPZ", None)
        else:
            os.environ["LPIPS_WEIGHTS_NPZ"] = env0

    # -- what the run must have done
    report = rec["report"]
    if not report or report["unconsumed"] or report["unfilled"]:
        fail(f"{tag}: the synthesized reference checkpoint did not load fully: "
             f"unconsumed {report.get('unconsumed')}, unfilled {report.get('unfilled')}")
    expect_step = expect_launches(kernels, backward=True, composite_fwd=N_VIEWS,
                                  composite_bwd=N_VIEWS)
    if len(rec["ft_ms"]) != ft_steps:
        fail(f"{tag}: {len(rec['ft_ms'])} finetune steps, expected {ft_steps}")
    bad = [i for i, l in enumerate(rec["ft_launches"]) if l != expect_step]
    if bad:
        fail(f"{tag}: finetune steps {bad[:5]} launched {rec['ft_launches'][bad[0]]}, "
             f"expected {expect_step}")
    modes = set(rec["bwd_modes"])
    if modes != {"noabs"} or len(rec["bwd_modes"]) != N_VIEWS * ft_steps:
        fail(f"{tag}: the finetune backward ran kernel #2 in modes {modes}, "
             f"{len(rec['bwd_modes'])} times")
    mse0, mse1 = rec["mse"]
    if not mse1 < mse0:
        fail(f"{tag}: finetuning did not lower the source-view MSE ({mse0} -> {mse1})")
    outputs = [("video", EVAL_VIDEO_FRAMES)] + ([] if residual else [("mesh", MESH_VIEWS)])
    for key, n in outputs:
        if rec["launches"][key] != expect_launches(kernels, composite_fwd=n):
            fail(f"{tag}: the {key} launched {rec['launches'][key]}, expected {n} #1")
    scene = next(iter(result["scenes"]))
    keys = {"psnr", "psnr_coarse", "psnr_fine", "ssim", "lpips_vgg", "lpips_alex"}
    if set(result["mean"]) != keys or not all(np.isfinite(v) for v in result["mean"].values()):
        fail(f"{tag}: metrics malformed: {result}")
    files = sorted(os.listdir(f"{tmp}/out"))
    expect_files = [f"{scene}.png"] + [f"{scene}_f{j:03d}.png"
                                       for j in range(EVAL_VIDEO_FRAMES)]
    if not residual:
        expect_files += [f"{scene}.obj"] + [f"{scene}_mesh{j:03d}.png"
                                            for j in range(EVAL_MESH_FRAMES)]
    expect_files.sort()
    if files != expect_files:
        fail(f"{tag}: wrote {files}, expected {expect_files}")
    frame = read_png(f"{tmp}/out/{scene}_f000.png")
    if frame.shape != (HW, HW, 3) or not residual and (
            not rec["mesh"]["faces"] or not rec["mesh"]["finite"]):
        fail(f"{tag}: video frame {frame.shape} or mesh {rec['mesh']} malformed")

    # -- kernel #2 noabs on a finetune step's inputs; #1 on a video frame's
    (bargs, mode) = rec["captured"]["bwd"]
    k1 = kernels.composite_bwd(*bargs, mode=mode)
    k2 = kernels.composite_bwd(*bargs, mode=mode)
    ref = kernels.composite_bwd_plain(*bargs, mode=mode)
    torch.cuda.synchronize()
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    bwd_err = float(((k1 - ref) / scale).abs().max())
    if mode != "noabs" or bwd_err > GRAD_ATOL or not torch.equal(k1, k2):
        fail(f"{tag}: kernel #2 {mode} on finetune inputs: scaled err {bwd_err} "
             f"(tolerance {GRAD_ATOL}), repeatable {torch.equal(k1, k2)}")
    bwd_ms = cuda_ms(lambda: kernels.composite_bwd(*bargs, mode=mode), reps=21)
    fargs = rec["captured"]["fwd"]
    out = kernels.composite_fwd(*fargs)
    plain = kernels.composite_fwd_plain(*fargs)
    if not torch.equal(out, plain):
        fail(f"{tag}: kernel #1 differs from its plain version on a video frame "
             f"(max |diff| {float((out - plain).abs().max())})")
    fwd_ms = cuda_ms(lambda: kernels.composite_fwd(*fargs), reps=21)
    shutil.rmtree(tmp)

    summary = dict(
        scene=scene, residual=residual, metrics=result["mean"], phase_s=phase_s,
        setup_s=setup_s, ckpt_bytes=ckpt_bytes, checkpoint_filled=len(report["filled"]),
        peak_bytes=peak, ft_steps=ft_steps,
        ft_ms_median=statistics.median(rec["ft_ms"]),
        ft_ms_first=rec["ft_ms"][:3], ft_s=rec["secs"]["finetune"],
        ft_launches_per_step=rec["ft_launches"][0], ft_bwd_modes=sorted(modes),
        mse_before=mse0, mse_after=mse1, ft_loss_first=rec["ft_loss"][0],
        ft_loss_last=rec["ft_loss"][-1], ft_overflow_max=max(rec["ft_overflow"]),
        video_s=rec["secs"]["video"], video_frames=EVAL_VIDEO_FRAMES,
        video_launches=rec["launches"]["video"]["composite_fwd"],
        lpips_ms=rec["lpips_ms"],
        bwd_noabs_on_ft=dict(max_scaled_err=bwd_err, ms=bwd_ms, bitwise_repeatable=True),
        fwd_on_video=dict(bitwise=True, ms=fwd_ms))
    if not residual:
        summary.update(
            mesh_s=rec["secs"]["mesh"], mesh_render_fuse_s=rec["secs"]["mesh_render_fuse"],
            mesh_extract_s=rec["secs"]["mesh_extract"],
            mesh_obj_write_s=rec["secs"]["mesh_obj_write"],
            mesh_turntable_s=rec["secs"].get("mesh_turntable"),
            mesh_launches=rec["launches"]["mesh"]["composite_fwd"], **rec["mesh"])
    side = ("" if residual
            else f", mesh + {EVAL_MESH_FRAMES} turntable frames")
    print(f"[{tag}] one synthetic scene at {HW}², bf16, reference .ckpt "
          f"({ckpt_bytes / 2**20:.0f} MiB, {len(report['filled'])} parameters filled, "
          f"every key consumed), {ft_steps} finetune steps, "
          f"{EVAL_VIDEO_FRAMES} video frames{side}, LPIPS: {phase_s:.1f}s, peak "
          f"{peak / 2**30:.2f} GiB; {json.dumps(summary)}")
    return summary


RESIDUAL = {"model.enable_residual_attribute": True}


def fine_stats(out) -> dict:
    """The valid fine Gaussians of batch element 0: their count, mean
    opacity and median largest scale (activated), the attributes residual
    mode accumulates parent plus child."""
    import torch

    _, _, op, sc, _, ok = out["render_pkg"][1]
    ok = ok[0]
    return dict(valid=int(ok.sum()),
                opacity_mean=float(torch.sigmoid(op[0, ok, 0]).mean()),
                scale_max_median=float(torch.exp(sc[0, ok]).amax(-1).median()))


def capture_composite(composite, calls: list, modes: list | None = None):
    """Wrap ``composite.composite_fwd`` (and, with ``modes``,
    ``composite.composite_bwd``) to append each call's arguments, the
    backward's as (arguments, mode); returns a function that restores
    them."""
    real_fwd, real_bwd = composite.composite_fwd, composite.composite_bwd

    def fwd(*a):
        calls.append(a)
        return real_fwd(*a)

    def bwd(table, ids, starts, counts, gc4, g2, tiles_x, tiles_y, ts, mode="full"):
        a = (table, ids, starts, counts, gc4, g2, tiles_x, tiles_y, ts)
        modes.append((a, mode))
        return real_bwd(*a, mode=mode)

    composite.composite_fwd = fwd
    if modes is not None:
        composite.composite_bwd = bwd

    def restore():
        composite.composite_fwd, composite.composite_bwd = real_fwd, real_bwd
    return restore


def residual_serving_phase(batch, expect: dict, n_fine: int) -> dict:
    """Residual attribute mode served at full width
    (``model.enable_residual_attribute=True`` on the serving configuration,
    f32, seeded weights): the fine count from ``cfg.level_sizes()`` (the
    base mode's ``n_fine``); kernel #1 bitwise and kernel #2 in every mode
    (scaled 5e-5, bitwise repeatable) against their plain versions on the
    residual fine render of view 0 (its accumulated attributes binned at
    the serving budgets, the batch's view-0 image as ground truth), with
    that render's overflow; then 2 warm-ups and 5 timed forwards with
    exactly ``expect`` launches each, finite outputs, overflow, peak memory
    and a device-time breakdown by stage."""
    import torch

    from generativedensification_torch.models.network import Network, NetworkConfig
    from generativedensification_torch.splat import composite
    from generativedensification_torch.tools import scenes

    t_phase = time.perf_counter()
    cfg = NetworkConfig.from_config(scenes.fine_config(**RESIDUAL))
    n_coarse = (2 * cfg.vol_embedding_reso) ** 3
    n_res = (sum(lv["leaf"] for lv in cfg.level_sizes())
             + min(cfg.mask_pool, n_coarse) - cfg.k_num)
    if not cfg.enable_residual_attribute or n_res != n_fine:
        fail(f"residual serving: {n_res} fine Gaussians, base mode {n_fine}")
    net = Network(cfg, seed=0)
    net.eval()
    calls = []
    with torch.inference_mode():
        restore = capture_composite(composite, calls)
        try:
            out = net(batch, with_fine=True)                  # warm-up
        finally:
            restore()
        out_c = net(batch, with_fine=False)
        torch.cuda.synchronize()
        check_outputs(out, 1, V_TOTAL, HW, HW, n_coarse, n_fine)
        if len(calls) != 2 * V_TOTAL or calls[V_TOTAL][0].shape[0] != n_fine:
            fail(f"residual serving: {len(calls)} compositor calls, the fine "
                 f"one over {calls[V_TOTAL][0].shape[0]} Gaussians")
        fine0 = calls[V_TOTAL]
        ov_view0 = int(out["overflow"][0, 0] - out_c["overflow"][0, 0])
        del calls
        label = "residual_fine_512_view0"
        fwd_rec = kernel_record(label, fine0, ov_view0)
        bwd_recs = bwd_records(label, fine0, batch["tar_rgb"][0, 0])
        del fine0
        stats = fine_stats(out)
        out_r, times, launches, peak = timed_forwards(net, batch, True, expect)
        check_outputs(out_r, 1, V_TOTAL, HW, HW, n_coarse, n_fine)
        split = forward_breakdown(net, batch, True)
    ov_coarse = int(out_c["overflow"].sum())
    ov = int(out_r["overflow"].sum())
    ms = statistics.median(times)
    rec = dict(forward_ms=ms, forward_runs_ms=times, launches=launches,
               breakdown_ms=split, overflow=ov, overflow_coarse=ov_coarse,
               overflow_fine=ov - ov_coarse, fine_gaussians=n_fine, fine=stats,
               peak_bytes=peak, kernel_fwd=fwd_rec, kernel_bwd=bwd_recs,
               phase_s=time.perf_counter() - t_phase)
    print(f"[serving residual] forward ms median {ms:.2f} (runs "
          f"{[round(t, 2) for t in times]}); launches {launches}; overflow coarse "
          f"{ov_coarse} + fine {ov - ov_coarse} (view 0 fine {ov_view0}); fine "
          f"Gaussians {n_fine}: {json.dumps(stats)}; peak allocated "
          f"{peak / 2**30:.2f} GiB; phase {rec['phase_s']:.1f}s")
    print(f"[breakdown] residual serving forward, device ms by stage: {json.dumps(split)}")
    del net, out, out_c, out_r
    torch.cuda.empty_cache()
    return rec


def residual_train_phase(batch, expect: dict) -> dict:
    """The full-width f32 train micro-step in residual attribute mode (the
    3DGS training configuration at its warmup budgets, B=1, seeded
    weights): 2 warm-up and 4 timed micro-steps with exactly ``expect``
    launches each, finite loss and gradient norm, overflow and peak memory;
    a stage breakdown of one more; then one more micro-step with the
    compositor's calls recorded (again ``expect`` launches, kernel #2 4
    ``selonly`` + 16 ``noabs``), and kernel #1 bitwise and kernel #2
    ``noabs`` (scaled 5e-5, bitwise repeatable) against their plain
    versions on the inputs its fine renders gave them."""
    import torch

    from generativedensification_torch.models.network import NetworkConfig
    from generativedensification_torch.splat import composite, kernels
    from generativedensification_torch.tools.timing import cuda_ms
    from generativedensification_torch.train.loss import Losses
    from generativedensification_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    cfg = train_config("3dgs")
    for k, v in RESIDUAL.items():
        cfg.set_dotted(k, v)
    ncfg = NetworkConfig.from_config(cfg)
    n_fine = (sum(lv["leaf"] for lv in ncfg.level_sizes()) + ncfg.mask_pool
              - ncfg.k_num)
    net, opt, state = make_trainer(ncfg, cfg.train, 0)
    step_fn = make_train_step(net, opt, Losses(), with_fine=True)
    state, stats, times, launches, peak = timed_train_steps(
        step_fn, state, batch, expect)
    # the breakdown at the base train phase's micro-step (7th: accumulation
    # only, no optimizer update), so that the two compare stage by stage
    state, split = train_breakdown(net, opt, state, batch)
    fwd_calls, bwd_calls = [], []
    restore = capture_composite(composite, fwd_calls, bwd_calls)
    try:
        kernels.reset_launch_counts()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    finally:
        restore()
    modes = {m: sum(1 for _, mode in bwd_calls if mode == m)
             for m in ("selonly", "noabs", "full")}
    if (dict(kernels.launch_counts) != expect
            or modes != dict(selonly=N_VIEWS, noabs=2 * V_TOTAL, full=0)):
        fail(f"residual train: launches {dict(kernels.launch_counts)}, kernel #2 "
             f"modes {modes}")
    fargs = next(a for a in reversed(fwd_calls) if a[0].shape[0] == n_fine)
    bargs = next(a for a, m in reversed(bwd_calls)
                 if m == "noabs" and a[0].shape[0] == n_fine)
    del fwd_calls, bwd_calls
    out = kernels.composite_fwd(*fargs)
    if not torch.equal(out, kernels.composite_fwd_plain(*fargs)):
        fail("residual train: kernel #1 differs from its plain version on a "
             "fine render's inputs")
    fwd_ms = cuda_ms(lambda: kernels.composite_fwd(*fargs), reps=21)
    k1 = kernels.composite_bwd(*bargs, mode="noabs")
    k2 = kernels.composite_bwd(*bargs, mode="noabs")
    ref = kernels.composite_bwd_plain(*bargs, mode="noabs")
    torch.cuda.synchronize()
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    bwd_err = float(((k1 - ref) / scale).abs().max())
    if bwd_err > GRAD_ATOL or not torch.equal(k1, k2):
        fail(f"residual train: kernel #2 noabs on a fine render's inputs: scaled "
             f"err {bwd_err}, repeatable {torch.equal(k1, k2)}")
    bwd_ms = cuda_ms(lambda: kernels.composite_bwd(*bargs, mode="noabs"), reps=21)
    del fargs, bargs, out, k1, k2, ref
    step_ms = statistics.median(times)
    stats = {k: float(v) for k, v in stats.items()}
    rec = dict(step_ms=step_ms, step_runs_ms=times, launches=launches,
               bwd_modes_per_step=dict(selonly=N_VIEWS, noabs=2 * V_TOTAL),
               peak_bytes=peak, stats=stats, overflow=stats["overflow"],
               fine_gaussians=n_fine, breakdown_ms=split, budgets=budgets_of("3dgs"),
               fwd_on_fine=dict(bitwise=True, ms=fwd_ms),
               bwd_noabs_on_fine=dict(max_scaled_err=bwd_err, ms=bwd_ms,
                                      bitwise_repeatable=True),
               phase_s=time.perf_counter() - t_phase)
    print(f"[train residual] micro-step ms median {step_ms:.2f} (runs "
          f"{[round(t, 2) for t in times]}); launches {launches}; overflow "
          f"{stats['overflow']:.0f}; stats {json.dumps(stats)}; peak allocated "
          f"{peak / 2**30:.2f} GiB; #1 on a fine render bitwise, {fwd_ms:.3f} ms; "
          f"#2 noabs scaled err {bwd_err:.2e}, {bwd_ms:.3f} ms; phase "
          f"{rec['phase_s']:.1f}s")
    print(f"[breakdown] residual train micro-step, device ms by stage: "
          f"{json.dumps(split)}")
    del net, opt, state, step_fn
    torch.cuda.empty_cache()
    return rec


# The residual overfit case's PSNR rise (more than 0.5 dB from step 2 to
# step 29) is decided by chance in the JAX package itself: JAX passes it at
# PRNGKey 0 and 1 and fails it at 2 (21.27 -> 20.90 dB); from the same
# weights both packages plateau once the warmup ends; and on the card the
# same seed passes or fails from run to run (the gather backwards' atomics
# reorder sums, and the trajectory is chaotic).  ROADMAP queue 3 has the
# measurements.  Its verdict is printed and kept, not held; every other
# check of the case is.
OVERFIT_REPORTED = {("residual", "rise")}


def overfit_phase() -> dict:
    """The quality regression on the card (``tools/overfit.py``, the three
    cases of ``tests/test_torch_overfit.py`` at the JAX package's
    thresholds but ``OVERFIT_REPORTED``), each with the launch counts set
    to 0 just before and read just after: per micro-step 2 V_total forward
    and n_views + 2 V_total backward launches of the case's renderer."""
    from generativedensification_torch.splat import kernels
    from generativedensification_torch.tools import overfit

    batch = overfit.scene_batch(None)
    V = batch["tar_rgb"].shape[1]
    recs = {}
    for case, (changes, steps, *_) in overfit.CASES.items():
        fwd, bwd = (("surfel_fwd", "surfel_bwd") if changes.get("renderer") == "2dgs"
                    else ("composite_fwd", "composite_bwd"))
        n_views = overfit.TINY["n_views"]
        expect = expect_launches(kernels, backward=True, surfel_setup=0,
                                 **{fwd: steps * 2 * V, bwd: steps * (n_views + 2 * V)})
        kernels.reset_launch_counts()
        r = overfit.run_case(case, batch=batch)
        launches = dict(kernels.launch_counts)
        reported = [k for k in r["failed"] if (case, k) in OVERFIT_REPORTED]
        print(f"[overfit {case}] {r['key']} {r['first']:.2f} -> {r['final']:.2f} in "
              f"{steps} steps (needs {json.dumps(r['needs'])}), {r['seconds']:.1f}s; "
              f"overflow {r['stats']['overflow']:.0f}; failed {r['failed']}"
              f"{' (reported, not held)' if reported else ''}; launches {launches}; "
              f"trace {[round(x, 2) for x in r['trace']]}")
        held = [k for k in r["failed"] if k not in reported]
        if held:
            fail(f"overfit {case}: {held}")
        if launches != expect:
            fail(f"overfit {case}: launches {launches}, expected {expect}")
        recs[case] = dict(r, launches=launches)
    return recs


def expect_launches(kernels, backward: bool = False, **launches):
    """Launches per call: the given kernels, every other one 0, and each
    render's pre-pass: a 3DGS render (one ``composite_fwd``) launches each
    of ``project``, ``depth_rank``, ``tile_keys`` and ``tile_ranges`` once,
    a 2DGS render (one ``surfel_fwd``) ``surfel_setup`` and the three
    binning kernels.  A 2DGS render that autograd records sets its surfels
    up by the plain chain: pass ``surfel_setup=0`` for training.  With
    ``backward`` every 3DGS render is recorded and differentiated: each
    launches one ``project_bwd`` (train, finetune and overfit steps)."""
    n3, n2 = launches.get("composite_fwd", 0), launches.get("surfel_fwd", 0)
    prepass = dict(project=n3, surfel_setup=n2, depth_rank=n3 + n2,
                   tile_keys=n3 + n2, tile_ranges=n3 + n2,
                   project_bwd=n3 if backward else 0)
    return {**dict.fromkeys(kernels.launch_counts, 0), **prepass, **launches}


def render_inputs(pkg, cam) -> tuple:
    """``rasterize``'s inputs for batch element 0 of a ``render_pkg`` entry
    (coarse, or fine with its validity), activated as ``_render_views``
    does, with the camera ``cam``."""
    import torch

    centers, shs, opacity, scaling, rotation = pkg[:5]
    n = centers.shape[1]
    opa = torch.sigmoid(opacity[0].reshape(-1))
    if len(pkg) > 5:
        opa = torch.where(pkg[5][0], opa, torch.zeros_like(opa))
    return (centers[0], shs[0].reshape(n, -1, 3), opa, torch.exp(scaling[0]),
            rotation[0], cam)


PREPASS_KERNELS = ("project", "depth_rank", "tile_keys", "tile_ranges")


def orders_measured() -> bool:
    """Whether the libraries are those on which the projection kernel's
    summation orders were measured (torch 2.11 with CUDA 12.8: cuBLAS's GEMM
    for the plain chain's two 4-term products, ``linalg.norm``'s lane
    tree): only there is it held bit for bit to the plain chain."""
    import torch

    return torch.__version__.startswith("2.11.") and torch.version.cuda == "12.8"


def prepass_bytes(n: int, sh_coeffs: int, max_tiles: int) -> dict:
    """Bytes each pre-pass kernel must move for one view of ``n`` Gaussians
    (each input read once, each output written once): its roofline bound
    at 3.35 TB/s; the work is a few dozen operations a byte short of the
    f32 peak."""
    return {"project": n * (12 + 12 * sh_coeffs + 4 + 12 + 16 + 45),
            # the inputs but the opacity, an offset, five cotangents and
            # six gradients
            "project_bwd": n * (140 + 24 * sh_coeffs),
            "depth_rank": n * 16,
            "tile_keys": n * (33 + 4 * max_tiles),
            "tile_ranges": n * max_tiles * 25}


def timed_views(fn, reps: int = 20) -> tuple:
    """One warm-up call of ``fn``, then the median device ms (CUDA events
    around each call) and host ms (its enqueue) of ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        dev_ms.append(e0.elapsed_time(e1))
    return statistics.median(dev_ms), statistics.median(host_ms)


def project_bwd_timing(view, deg: int, bytes_bound: float) -> dict:
    """The projection's backward of one view, ``view`` ``rasterize``'s
    inputs with a zero screen offset as the train step passes none: the
    ``project_bwd`` kernel against the recompute it replaced
    (``project_vjp_recompute``) on the same inputs and seeded cotangents,
    every gradient asked; the largest difference of each gradient over its
    largest value where the kernel's forward and the chain agree on
    validity, failing above ``PROJECT_RTOL``; both timed in turns (kernel,
    recompute, recompute, kernel; median device ms of 20 calls by CUDA
    events, host ms of their enqueue) and the kernel's mean device ms (the
    profiler, 10 calls) beside its byte bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from generativedensification_torch.splat import projection

    with torch.inference_mode(False):
        # the recompute records autograd: copies of the view's tensors, which
        # the serving phases made under inference mode
        means, shs, opa, scales, quats = (t.clone() for t in view[:5])
        cam = dataclasses.replace(view[5], **{
            f.name: getattr(view[5], f.name).clone() for f in dataclasses.fields(view[5])
            if isinstance(getattr(view[5], f.name), torch.Tensor)})
        n = means.shape[0]
        inputs = (means, shs, opa, scales, quats, torch.zeros((n, 2), device=means.device))
        g = torch.Generator(device=means.device).manual_seed(0)
        cots = [torch.randn((n, *shape), generator=g, device=means.device)
                for shape in ((2,), (), (3,), (3,), ())]
        need = (True,) * 6
        kern = lambda: projection._project_vjp_kernel(cam, deg, inputs, cots, need)
        recompute = lambda: projection.project_vjp_recompute(cam, deg, inputs, cots, need)
        with torch.no_grad():
            valid = projection._project_kernel(cam, deg, *inputs)[6]
            ref_valid = projection._project_plain(cam, deg, *inputs)[0].valid
        same = valid == ref_valid
        rel = {}
        for name, a, b in zip(("means3d", "shs", "opacity", "scales", "rotations",
                               "screen_offset"), kern(), recompute()):
            rel[name] = float((a - b)[same].abs().max()) / max(float(b.abs().max()), 1e-30)
            if not rel[name] <= PROJECT_RTOL:
                fail(f"project_bwd: the {name} gradient differs from the recompute's by "
                     f"{rel[name]:.3g} of its largest value (limit {PROJECT_RTOL})")
        runs = {"kernel": [], "recompute": []}
        for which in ("kernel", "recompute", "recompute", "kernel"):
            runs[which].append(timed_views(kern if which == "kernel" else recompute))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                kern()
            torch.cuda.synchronize()
    kernel_ms = None
    for ev in prof.key_averages():
        if "project_bwd_kernel" in ev.key and ev.device_time_total > 0:
            kernel_ms = ev.device_time_total / ev.count / 1e3
    return dict(rel=rel, flips=int((~same).sum()), kernel_ms=kernel_ms,
                bound_ms=bytes_bound / 3.35e12 * 1e3,
                device_ms=statistics.median(r[0] for r in runs["kernel"]),
                host_ms=statistics.median(r[1] for r in runs["kernel"]),
                recompute_device_ms=statistics.median(r[0] for r in runs["recompute"]),
                recompute_host_ms=statistics.median(r[1] for r in runs["recompute"]))


def prepass_phase(views: dict, tile_size: int, max_tiles: int,
                  max_per_tile: int) -> dict:
    """The renders' pre-pass (``csrc/prepass.cu``) at the serving shapes,
    ``views`` {label: ``rasterize``'s inputs of one view}: the binning kernels
    bitwise against ``bin_gaussians_plain`` (every ``TileBins`` field, the
    capped counts, the total overflow) from the plain projection and from the
    projection kernel's; the projection kernel against ``project_gaussians``
    (outputs that differ in any bit, the largest difference over the largest
    value, ``valid`` / ``radius`` flips), failing above ``PROJECT_RTOL`` /
    ``PROJECT_FLIP_SHARE`` and, at the model's views on the libraries the
    kernel's summation orders were measured on (``orders_measured``), on any
    differing bit; one view's pre-pass timed both ways in turns (kernels,
    plain, plain, kernels; median device ms of 20 views by CUDA events, host
    ms of their enqueue) and each kernel's device ms (the profiler); the
    launches of one view; at the model's views the projection's backward
    (``project_bwd_timing``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from generativedensification_torch.splat import binning, kernels, projection

    def binned_as_plain(proj, cap):
        bins, counts, total = binning.bin_and_cap(proj, H, W, tile_size, max_tiles, cap)
        plain = binning.bin_gaussians_plain(proj, H, W, tile_size, max_tiles)
        counts_ref = torch.clamp(plain.tile_counts, max=cap)
        same = all(torch.equal(getattr(bins, f), getattr(plain, f)) for f in (
            "sorted_ids", "sorted_o", "sorted_valid", "sorted_rank", "depth_order",
            "tile_starts", "tile_counts", "overflow"))
        return same and torch.equal(counts, counts_ref) and int(total) == int(
            plain.overflow) + int((plain.tile_counts - counts_ref).sum())

    recs = {}
    for label, (means, shs, opa, scales, quats, cam) in views.items():
        H, W = cam.height, cam.width
        n = means.shape[0]
        deg = int(round(shs.shape[1] ** 0.5)) - 1
        cap = min(max_per_tile, n * max_tiles)
        ref, ref_eff = projection._project_plain(cam, deg, means, shs, opa, scales,
                                                 quats, None)
        if not binned_as_plain(ref, cap):
            fail(f"prepass ({label}): the binning kernels differ from the plain chain "
                 "on the plain projection")
        kernels.reset_launch_counts()
        proj, eff = projection.project(means, shs, opa, cam, deg, scales, quats)
        bins, counts, total = binning.bin_and_cap(proj, H, W, tile_size, max_tiles, cap)
        torch.cuda.synchronize()
        launches = {k: kernels.launch_counts[k] for k in PREPASS_KERNELS}
        if launches != dict.fromkeys(PREPASS_KERNELS, 1):
            fail(f"prepass ({label}): one view launched {launches}")
        if not binned_as_plain(proj, cap):
            fail(f"prepass ({label}): the binning kernels differ from the plain chain "
                 "on the projection kernel's output")
        both = proj.valid & ref.valid
        diff = {}
        for name, a, b, rows in (("xy", proj.xy, ref.xy, None),
                                 ("depth", proj.depth, ref.depth, None),
                                 ("conic", proj.conic, ref.conic, both),
                                 ("color", proj.color, ref.color, None),
                                 ("opacity_eff", eff, ref_eff, both)):
            bits = int((a != b).any(-1).sum() if a.dim() > 1 else (a != b).sum())
            if rows is not None:
                a, b = a[rows], b[rows]
            rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            diff[name] = dict(bits=bits, rel=rel)
            if not rel <= PROJECT_RTOL:
                fail(f"prepass ({label}): the projection kernel's {name} differs by "
                     f"{rel:.3g} of its largest value (limit {PROJECT_RTOL})")
        flips = dict(valid=int((proj.valid != ref.valid).sum()),
                     radius=int((proj.radius[both] != ref.radius[both]).sum()))
        if sum(flips.values()) > PROJECT_FLIP_SHARE * n:
            fail(f"prepass ({label}): the projection kernel flips {flips} of {n} "
                 f"Gaussians (limit {PROJECT_FLIP_SHARE} of them)")
        bitwise = not any(d["bits"] for d in diff.values()) and not any(flips.values())
        if label.startswith("model_") and orders_measured() and not bitwise:
            fail(f"prepass ({label}): the projection kernel is not bit for bit the "
                 f"plain chain's on the libraries its orders were measured on: "
                 f"{json.dumps(diff)}, flips {flips}")

        def kern():
            p, _ = projection.project(means, shs, opa, cam, deg, scales, quats)
            binning.bin_and_cap(p, H, W, tile_size, max_tiles, cap)

        def chain():
            p, _ = projection._project_plain(cam, deg, means, shs, opa, scales, quats,
                                             None)
            b = binning.bin_gaussians_plain(p, H, W, tile_size, max_tiles)
            c = torch.clamp(b.tile_counts, max=cap)
            return b.overflow + (b.tile_counts - c).sum().to(torch.int32)

        runs = {"kernels": [], "plain": []}
        for which in ("kernels", "plain", "plain", "kernels"):
            runs[which].append(timed_views(kern if which == "kernels" else chain))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                kern()
            torch.cuda.synchronize()
        per_kernel = {}
        for ev in prof.key_averages():
            for k in PREPASS_KERNELS:
                if f"{k}_kernel" in ev.key and ev.device_time_total > 0:
                    per_kernel[k] = ev.device_time_total / ev.count / 1e3
        sorts = sum(ev.device_time_total for ev in prof.key_averages()
                    if "RadixSort" in ev.key) / 10 / 1e3
        bound = {k: b / 3.35e12 * 1e3 for k, b in prepass_bytes(
            n, shs.shape[1], max_tiles).items()}
        rec = dict(n=n, same_bits_binning=True, projection=diff, flips=flips,
                   projection_bitwise=bitwise, orders_measured=orders_measured(),
                   launches=launches,
                   device_ms=statistics.median(r[0] for r in runs["kernels"]),
                   host_ms=statistics.median(r[1] for r in runs["kernels"]),
                   plain_device_ms=statistics.median(r[0] for r in runs["plain"]),
                   plain_host_ms=statistics.median(r[1] for r in runs["plain"]),
                   kernel_ms=per_kernel, sorts_ms=sorts, bound_ms=bound,
                   pairs=int(counts.sum()), overflow=int(total))
        if label.startswith("model_"):
            rec["backward"] = project_bwd_timing(
                (means, shs, opa, scales, quats, cam), deg,
                prepass_bytes(n, shs.shape[1], max_tiles)["project_bwd"])
        print(f"[prepass {label}] {json.dumps(rec)}")
        recs[label] = rec
    return recs


SETUP_OUTPUTS = ("acr", "bcr", "ccr", "det", "xy", "depth", "conic", "color",
                 "opacity_eff", "radius", "valid", "normal")


def surfel_setup_phase(views: dict) -> dict:
    """The 2DGS surfel set-up kernel (``csrc/prepass.cu`` ``gd_surfel_setup``)
    against its plain chain, ``views`` {label: ``surfel_setup``'s inputs of
    one view}: one launch, the outputs that differ in any bit, the largest
    difference over the largest value, ``valid`` / ``radius`` flips, failing
    above ``PROJECT_RTOL`` / ``PROJECT_FLIP_SHARE`` and, on the libraries
    whose orders the kernel repeats (``orders_measured``), on any differing
    bit; the kernel's mean device ms (the profiler, 10 views; None where it
    records none of them), and the kernel
    against the plain chain in turns (kernel, plain, plain, kernel; median
    device ms of 20 views by CUDA events, host ms of their enqueue)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from generativedensification_torch.splat import kernels, surfel

    recs = {}
    for label, (means, scales, quats, opa, shs, cam) in views.items():
        n = means.shape[0]
        kernels.reset_launch_counts()
        got = surfel.surfel_setup(means, scales, quats, opa, shs, cam, 1)
        torch.cuda.synchronize()
        if kernels.launch_counts["surfel_setup"] != 1 or sum(
                kernels.launch_counts.values()) != 1:
            fail(f"surfel setup ({label}): one call launched {dict(kernels.launch_counts)}")
        ref = surfel._surfel_plain(cam, 1, means, scales, quats, opa, shs)
        out = dict(zip(SETUP_OUTPUTS, got))
        plain = dict(zip(SETUP_OUTPUTS, ref))
        both = out["valid"] & plain["valid"]
        flips = dict(valid=int((out["valid"] != plain["valid"]).sum()),
                     radius=int((out["radius"][both] != plain["radius"][both]).sum()))
        diff = {}
        for name in SETUP_OUTPUTS:
            a, b = out[name], plain[name]
            bits = int((a != b).reshape(n, -1).any(-1).sum())
            if name in ("valid", "radius"):
                diff[name] = dict(bits=bits)
                continue
            if name in ("conic", "opacity_eff"):
                a, b = a[both], b[both]
            rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            diff[name] = dict(bits=bits, rel=rel)
            if not rel <= PROJECT_RTOL:
                fail(f"surfel setup ({label}): the kernel's {name} differs by {rel:.3g} "
                     f"of its largest value (limit {PROJECT_RTOL})")
        if sum(flips.values()) > PROJECT_FLIP_SHARE * n:
            fail(f"surfel setup ({label}): the kernel flips {flips} of {n} surfels")
        bitwise = not any(d["bits"] for d in diff.values())
        if orders_measured() and not bitwise:
            fail(f"surfel setup ({label}): the kernel is not bit for bit the plain "
                 f"chain's on the libraries its orders were measured on: "
                 f"{json.dumps(diff)}")

        args = (means, scales, quats, opa, shs)
        runs = {"kernel": [], "plain": []}
        for which in ("kernel", "plain", "plain", "kernel"):
            runs[which].append(timed_views(
                (lambda: surfel._surfel_setup_kernel(cam, 1, *args)) if which == "kernel"
                else (lambda: surfel._surfel_plain(cam, 1, *args))))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                surfel._surfel_setup_kernel(cam, 1, *args)
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if "surfel_setup_kernel" in ev.key and ev.device_time_total > 0]
        kernel_ms = (sum(ev.device_time_total for ev in evs)
                     / sum(ev.count for ev in evs) / 1e3 if evs else None)
        rec = dict(n=n, bitwise=bitwise, orders_measured=orders_measured(), diff=diff,
                   flips=flips, valid=int(out["valid"].sum()), kernel_ms=kernel_ms,
                   bound_ms=n * (88 + 97) / 3.35e12 * 1e3,
                   device_ms=statistics.median(r[0] for r in runs["kernel"]),
                   host_ms=statistics.median(r[1] for r in runs["kernel"]),
                   plain_device_ms=statistics.median(r[0] for r in runs["plain"]),
                   plain_host_ms=statistics.median(r[1] for r in runs["plain"]))
        print(f"[surfel setup {label}] {json.dumps(rec)}")
        recs[label] = rec
    return recs


def probe_phase() -> dict:
    """The stage probes of kernels #1 and #3 (TPU kernels #7-#10, each an
    instantiation of the production sub-tile body) through their breakdown
    entry points, with the launch counts set to 0 just before and read just
    after: every variant of ``tools.kernel_break`` on scenes A and B and of
    ``tools.surfel_break`` on A′ and B′, each held bitwise against its plain
    version and, where its output is the production output, against the
    production kernel (the tools fail otherwise), timed in rounds with the
    production kernel; then ``kernel_break --bwd`` on scene A.
    Fails unless every variant launched."""
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
        runs[f"2dgs_{scene}"] = surfel_break.run([*pk.SURFEL_VARIANTS,
                                                 "--scene", scene])
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
    from generativedensification_torch.tools import kernel_break, scenes, timing
    from generativedensification_torch.utils.device import resolve_device

    def expect(backward=False, **launches):
        """Launches per forward (with ``backward``, per micro-step): the
        given kernels, every other one 0."""
        return expect_launches(kernels, backward, **launches)

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
          f"{torch.backends.cudnn.allow_tf32}; bf16 reduced-precision reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    # -- 2. build every kernel (one nvcc per source, started together)
    t0 = time.perf_counter()
    libs = kernels.build()
    print(f"[build] {len(libs)} sources in {time.perf_counter() - t0:.1f}s")
    for lib in libs.values():
        print(f"[build] {lib.src.name} -> {lib.path.name}")
        for line in lib.build_log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"[build] {line.strip()}")
    # no kernel may spill: #1-#6, nor a stage probe (it would time the
    # spill, not its stage)
    for name in libs:
        spills = [ln.strip() for ln in libs[name].build_log.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads"
                  not in ln]
        if spills:
            fail(f"{name} spills registers: {spills}")

    # -- 2b. kernels #5 and #6 bit for bit against their plain versions at
    # the train step's shapes and on the edge cases (unaligned bases, ragged
    # n and M, d = 1, widths outside the templated set and too wide for one
    # tile of #6, NaN and +-inf)
    with torch.inference_mode():
        slot_cases = kernel_break.slot_edge_cases(dev)
    bad = [k for k, r in slot_cases.items()
           if not r["same_bits"] or ("offset" in k) == r["aligned"]]
    print(f"[slot kernels] {len(slot_cases)} cases: {json.dumps(slot_cases)}")
    if bad:
        fail(f"kernels #5 / #6 differ from their plain versions (or a base is "
             f"aligned where it must not be) on {bad}")
    torch.cuda.empty_cache()

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
        max_tiles, enum_tiles, max_per_tile = budgets_of("3dgs")
        args, overflow, _ = scenes.model_gaussians(
            out["render_pkg"][0], cam, cfg, None, max_tiles, max_per_tile, enum_tiles)
        warm_rec = kernel_record("model_512_262k_view0_warmup", args, overflow)
        bwd_recs_warm = bwd_records("model_512_262k_view0_warmup", args,
                                    batch["tar_rgb"][0, 0])
        del args

        # -- the renders' pre-pass kernels at the serving shapes: the
        # model's coarse and fine Gaussians in view 0, and the pre-pass
        # scene at the coarse and fine counts
        views = {"model_coarse_view0": render_inputs(out["render_pkg"][0], cam),
                 "model_fine_view0": render_inputs(out["render_pkg"][1], cam)}
        for n in (n_coarse, n_fine):
            views[f"scene_{n}"] = scenes.prepass_scene(dev, n, HW)
        prepass = prepass_phase(views, cfg.tile_size, cfg.max_tiles, cfg.max_per_tile)
        del views

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
    base_fine = fine_stats(out_f)
    ov_coarse = int(out_c["overflow"].sum())
    ov_serving = int(out_f["overflow"].sum())
    fine_valid = int(out_f["render_pkg"][1][5].sum())
    print(f"[coarse] forward ms median {coarse_ms:.2f} (runs "
          f"{[round(t, 2) for t in times_c]}); overflow {ov_coarse}; peak "
          f"allocated {peak_c / 2**30:.2f} GiB")
    print(f"[serving] forward ms median {fine_ms:.2f} (runs "
          f"{[round(t, 2) for t in times_f]}); launches {launches_f}; overflow "
          f"coarse {ov_coarse} + fine {ov_serving - ov_coarse}; fine Gaussians "
          f"{n_fine}: {json.dumps(base_fine)}; peak allocated {peak_f / 2**30:.2f} GiB")
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
        runs = [("surfels_256_20k", *scenes.surfel_scene(dev), None),
                ("surfels_bench_512_131k", *scenes.surfel_bench_scene(dev), None)]
        runs += [(f"surfel_adversarial_256_ts{ts}",
                  *scenes.surfel_adversarial_scene(dev, ts), None)
                 for ts in (32, 16)]
        max_tiles, enum_tiles, max_per_tile = budgets_of("2dgs")
        for label, budgets in (("", ()), ("_warmup",
                                          (None, max_tiles, max_per_tile, enum_tiles))):
            sargs, si = scenes.model_surfels(out2["render_pkg"][0], cam, cfg2, *budgets)
            runs.append((f"model_512_262k_view0_surfels{label}", sargs, si,
                         batch["tar_rgb"][0, 0]))
        for label, sargs, si, gt in runs:
            surfel_scenes[label] = surfel_fwd_record(label, sargs, si)
            surfel_bwd[label] = surfel_bwd_records(label, sargs, si, gt)
        del runs, sargs
        surfel_rec = surfel_scenes["model_512_262k_view0_surfels"]
        surfel_bwd_recs = surfel_bwd["model_512_262k_view0_surfels"]
        # the surfel set-up kernel against its plain chain: scene A' and the
        # model's coarse and fine surfels in view 0
        surfel_views = {"surfels_bench_512_131k": scenes.surfel_bench_inputs(dev)}
        for label, pkg in (("model_coarse_view0", out2["render_pkg"][0]),
                           ("model_fine_view0", out2["render_pkg"][1])):
            means, shs, opa, scales, quats, _ = render_inputs(pkg, cam)
            surfel_views[label] = (means, scales[:, :2], quats, opa, shs, cam)
        setup = surfel_setup_phase(surfel_views)
        del surfel_views
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
        "3dgs": train_phase("3dgs", batch, expect(True, composite_fwd=2 * V_TOTAL,
                                                  composite_bwd=n_bwd)),
        "2dgs": train_phase("2dgs", batch, expect(surfel_fwd=2 * V_TOTAL,
                                                  surfel_bwd=n_bwd, surfel_setup=0)),
    }

    # -- 8b. the bf16 compute policy beside f32 (same weights and batch, in
    # turns), and one 2DGS bf16 micro-step
    bf16 = bf16_phase(batch, expect(composite_fwd=2 * V_TOTAL, composite_bwd=N_VIEWS),
                      expect(True, composite_fwd=2 * V_TOTAL, composite_bwd=n_bwd),
                      expect(surfel_fwd=2 * V_TOTAL, surfel_bwd=n_bwd, surfel_setup=0))

    # -- 8c. the train CLI at its config defaults (bf16, B=3), checkpoint
    # and resume
    cli = cli_phase()

    # -- 9. the evaluation entry point on 2 synthetic scenes, each renderer:
    # 3DGS at the config's dtype (bf16), 2DGS in f32 as before
    evals = {}
    for renderer, dtype in (("3dgs", "bfloat16"), ("2dgs", "float32")):
        t0 = time.perf_counter()
        result = evaluation.main(scenes.fine_config(**{
            "infer.dataset.dataset_name": "synthetic", "infer.dataset.n_scenes": 2,
            "infer.save_images": 0, "tpu.renderer": renderer,
            "tpu.compute_dtype": dtype}))
        eval_s = time.perf_counter() - t0
        means = result["mean"]
        if len(result["scenes"]) != 2 or not all(np.isfinite(v) for v in means.values()):
            fail(f"evaluation result ({renderer}) malformed: {result}")
        print(f"[eval {renderer} {dtype}] 2 synthetic scenes at {HW}² in "
              f"{eval_s:.1f}s: {json.dumps(means)}")
        evals[renderer] = {"seconds": eval_s, "mean": means, "dtype": dtype}

    # -- 9b. the full-width evaluation with every side output: a reference
    # checkpoint, finetuning on kernels #1 / #2, the video, the mesh, LPIPS
    eval_full = eval_phase()

    # -- 9c. residual attribute mode (the reference's second checkpoint):
    # served, trained and evaluated at full width through kernels #1 / #2
    t0 = time.perf_counter()
    residual = {
        "serving": residual_serving_phase(
            batch, expect(composite_fwd=2 * V_TOTAL, composite_bwd=N_VIEWS), n_fine),
        "train": residual_train_phase(
            batch, expect(True, composite_fwd=2 * V_TOTAL, composite_bwd=n_bwd)),
        "eval": eval_phase(residual=True),
    }
    print(f"[residual] serving + train + eval phases in "
          f"{time.perf_counter() - t0:.1f}s")

    # -- 9d. the quality regression: the three overfit cases on the card
    t0 = time.perf_counter()
    overfit = overfit_phase()
    print(f"[overfit] three cases in {time.perf_counter() - t0:.1f}s")

    # -- 10. the tiny configuration, card vs CPU, each renderer
    with torch.inference_mode():
        # seeds whose selection margins are >= 100x the score tolerance on
        # the card (35: 148x with the 3DGS renderer; 28: 451x with 2DGS)
        tiny = {"3dgs": tiny_card_vs_cpu("3dgs", seed=35),
                "2dgs": tiny_card_vs_cpu("2dgs", seed=28),
                "residual": tiny_card_vs_cpu("3dgs", seed=35, residual=True)}

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
    # the probes, each with one variant at scene B / B′ (the others are in
    # the breakdowns above) and its launches in the breakdown runs
    for name, kind, variant, replaces in (
            ("composite_fwd_probe:trans", "3dgs", "trans", "dev_kernel_break.py:207"),
            ("composite_fwd_probe:full_bulk", "3dgs", "full_bulk",
             "dev_kernel_break.py:308"),
            ("composite_fwd_probe:tpb2", "3dgs", "tpb2", "dev_kernel_break.py:401"),
            ("surfel_fwd_probe:acc", "2dgs", "acc", "dev_surfel_break.py:206")):
        r = next(x for x in probes["runs"][f"{kind}_B"]["stages"]
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
    # the pre-pass kernels replace no TPU kernel (XLA fuses the projection
    # and the binning there); at the fine Gaussians of view 0, the plain
    # time that of the whole chain the four replace
    fine_pre = prepass["model_fine_view0"]
    for name in PREPASS_KERNELS:
        recs.append({
            "name": name,
            "route": "cuda",
            "source": "generativedensification_torch/csrc/prepass.cu",
            "replaces": "none: XLA fused jnp code on the TPU",
            "launches": launches_f[name],
            "max_abs_err": 0.0 if name != "project" else max(
                d["rel"] for d in fine_pre["projection"].values()),
            "ms": fine_pre["kernel_ms"].get(name),
            "plain_ms": fine_pre["plain_device_ms"],
            "bound_ms": fine_pre["bound_ms"][name],
            "bound_by": "bytes",
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
                    "fine_valid": fine_valid, "fine": base_fine, "peak_bytes": peak_f},
        "serving_2dgs": {"forward_ms": surfel_ms, "forward_runs_ms": times_s,
                         "launches": launches_s, "breakdown_ms": split_s,
                         "busy_ms": busy_s["busy_ms"],
                         "busy_wall_ms": busy_s["wall_ms"], "overflow": ov_surfel,
                         "peak_bytes": peak_s},
        "train": train, "bf16": bf16, "cli": cli, "eval": evals,
        "eval_full": eval_full, "residual": residual, "overfit": overfit, "tiny": tiny,
        "pyyaml": has_yaml,
        "scenes": [bench_rec, model_rec, warm_rec], "prepass": prepass,
        "surfel_setup": setup,
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
