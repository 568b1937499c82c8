#!/usr/bin/env python
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Drives ``generativedensification_torch`` only (no JAX):

1. prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions and both TF32 flags;
2. builds every CUDA kernel of the coarse path from ``csrc/`` (one ``nvcc``
   per source, all started together) and prints the build time and
   ``-Xptxas -v`` registers / shared memory;
3. kernel phase: holds the forward compositor against its plain PyTorch
   version (atol 2e-4 on color, depth and alpha) on the ``bench.py`` scene
   (512², 131,072 Gaussians, seed 0) and on the 262,144 Gaussians of the
   full coarse model, and times both with CUDA events (median of >= 20
   kernel calls);
4. slice phase: the full-width coarse ``Network`` (ViT-B/16, 12-layer
   volume transformer, 64³ Gaussians) from seeded weights on
   ``make_probe_batch(B=1, V_total=8, 512², n_views=4)``: 2 warm-up
   forwards, then 5 timed ones, each with the launch counts set to 0 just
   before and read just after (exactly 8 compositor launches per forward);
   outputs must be finite and of the documented shapes, and the tiny test
   configuration must agree between the card and the CPU;
5. prints one JSON line per kernel record, and as the last line
   ``{"ok": true, "device": {...}}``.

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
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # f32 outside the tensor cores
# operations per (slot, live pixel) evaluation of the compositor: 2 diffs,
# 7 products/sums of the power form, clamp, exp, opacity product, alpha
# clamp, the 1/255 compare; and per contributing pair: 1 - alpha, U, the
# 1e-4 compare, w, and 4 multiply-adds into color and depth
OPS_PER_EVAL = 17
OPS_PER_CONTRIB = 12


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


def compositor_inputs(means, shs, opa, scales, quats, cam, tile_size,
                      max_tiles, max_per_tile):
    """Project + bin one view with the port's own functions; returns the
    kernel's inputs and the binning counters."""
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
    """Kernel vs plain on one scene: agreement, times and the bound."""
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
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    rec = dict(scene=name, gaussians=table.shape[0], live_pairs=live,
               overflow=overflow, evals=stats["evals"],
               contribs=stats["contribs"], bytes=n_bytes, ops=ops, ms=ms,
               plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes > t_ops else "operations",
               max_abs_err=err,
               alpha_mean=float(out[:, 4].mean()))
    print(f"[kernel] {json.dumps(rec)}")
    return rec


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


def check_outputs(out, B, V_total, H, W, N):
    import torch

    shapes = {"image": (B, H, V_total * W, 3), "depth": (B, H, V_total * W, 1),
              "acc_map": (B, H, V_total * W), "overflow": (B, V_total)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            fail(f"output {k} has shape {tuple(out[k].shape)}, expected {shape}")
        if not torch.isfinite(out[k].float()).all():
            fail(f"output {k} is not finite")
    centers = out["render_pkg"][0][0]
    if tuple(centers.shape) != (B, N, 3) or not torch.isfinite(centers).all():
        fail("render_pkg centers malformed")
    img, acc = out["image"], out["acc_map"]
    if img.min() < 0 or img.max() > 1 or acc.min() < -1e-6 or acc.max() > 1 + 1e-6:
        fail("image / acc_map outside [0, 1]")


def forward_breakdown(net, batch) -> dict:
    """Device time of one forward by stage, from CUDA events recorded on the
    stream around the ViT encoder, the volume transformer, each render
    (projection, binning, compositing) and each compositor launch; "other"
    is the feature lift, the Gaussian head and the gaps between stages."""
    import torch

    from generativedensification_torch.models import network as network_mod
    from generativedensification_torch.splat import composite

    spans = {"img_encoder": [], "vol_decoder": [], "renders": [], "compositor": []}

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
    for name in ("img_encoder", "vol_decoder"):
        mod = getattr(net, name)
        handles.append(mod.register_forward_pre_hook(
            lambda m, a, n=name: spans[n].append([event(), None])))
        handles.append(mod.register_forward_hook(
            lambda m, a, o, n=name: spans[n][-1].__setitem__(1, event())))
    patched = [(network_mod, "rasterize"), (composite, "composite_fwd")]
    saved = [getattr(m, a) for m, a in patched]
    for (m, a), fn, name in zip(patched, saved, ("renders", "compositor")):
        setattr(m, a, timed(name, fn))
    try:
        start = event()
        net(batch)
        end = event()
    finally:
        for (m, a), fn in zip(patched, saved):
            setattr(m, a, fn)
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    ms = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}
    ms["total"] = start.elapsed_time(end)
    ms["other"] = ms["total"] - ms["img_encoder"] - ms["vol_decoder"] - ms["renders"]
    ms["render_data_plane"] = ms["renders"] - ms["compositor"]
    ms["compositor_launches"] = len(spans["compositor"])
    return ms


def device_busy(net, batch) -> dict:
    """``torch.profiler`` over one forward: the summed device time of every
    CUDA kernel against the forward's wall time, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels_ = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels_) / 1e3
    top = sorted(kernels_, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top]}


def tiny_card_vs_cpu():
    """The tiny test configuration on the card and on the CPU from the same
    seeded weights: the Gaussians agree to 1e-4, and the renders agree to
    2e-4 except at isolated knife-edge pixels (alpha at 1/255 or T at 1e-4
    land on the other side under cross-device rounding): at most 0.1% of
    pixels may differ by more."""
    import torch

    from generativedensification_torch.data.synthetic import make_probe_batch
    from generativedensification_torch.models.network import Network, NetworkConfig

    cfg = NetworkConfig(
        n_views=2, encoder_backbone="tiny_test", n_groups=(4,),
        n_offset_groups=8, num_layers=2, num_heads=4, view_embed_dim=8,
        embedding_dim=32, vol_feat_reso=4, vol_embedding_reso=8,
        vol_embedding_out_dim=16, tile_size=16, max_tiles=4, max_per_tile=256)
    outs = {}
    for dev in ("cuda", "cpu"):
        net = Network(cfg, device=dev, seed=1)
        with torch.inference_mode():
            outs[dev] = net(make_probe_batch(1, 4, 64, 64, 2, seed=1, device=dev))
    worst = 0.0
    for a, b in zip(outs["cuda"]["render_pkg"][0], outs["cpu"]["render_pkg"][0]):
        worst = max(worst, float((a.cpu() - b).abs().max()))
    if worst > 1e-4:
        fail(f"tiny config: Gaussians differ card vs CPU by {worst}")
    for k in ("image", "depth", "acc_map"):
        d = (outs["cuda"][k].cpu() - outs["cpu"][k]).abs()
        frac = float((d > ATOL).float().mean())
        print(f"[tiny] {k}: max|card-cpu| {float(d.max()):.3g}, "
              f"share > {ATOL}: {frac:.2e}")
        if frac > 1e-3:
            fail(f"tiny config: {k} differs card vs CPU on {frac:.2%} of pixels")


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
    from generativedensification_torch.splat import kernels
    from generativedensification_torch.utils.device import resolve_device

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

    # -- 2. build every kernel of the path (one source today)
    t0 = time.perf_counter()
    lib = kernels.build()
    print(f"[build] composite_fwd.cu in {time.perf_counter() - t0:.1f}s -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # -- 3. kernel phase, scene 1: bench.py's scene
    with torch.inference_mode():
        args, overflow = bench_scene(dev)
        bench_rec = kernel_record("bench_512_131k", args, overflow)

    # -- 4. slice phase: the full-width coarse network
    cfg = NetworkConfig()
    t0 = time.perf_counter()
    net = Network(cfg, seed=0)
    batch = make_probe_batch(1, 8, 512, 512, n_views=cfg.n_views, seed=0)
    print(f"[slice] network built in {time.perf_counter() - t0:.1f}s, "
          f"{sum(p.numel() for p in net.parameters())} parameters")
    H = W = 512
    with torch.inference_mode():
        out = net(batch)                                       # warm-up 1
        torch.cuda.synchronize()
        check_outputs(out, 1, 8, H, W, (2 * cfg.vol_embedding_reso) ** 3)

        # kernel phase, scene 2: the model's 262,144 Gaussians in view 0
        centers, shs_c, opacity_c, scaling_c, rotation_c = out["render_pkg"][0]
        cam = net._cameras_all(batch)[0][0]
        args, overflow = compositor_inputs(
            centers[0], shs_c[0], torch.sigmoid(opacity_c[0, :, 0]),
            torch.exp(scaling_c[0]), rotation_c[0], cam, cfg.tile_size,
            cfg.max_tiles, cfg.max_per_tile)
        model_rec = kernel_record("model_512_262k_view0", args, overflow)

        net(batch)                                             # warm-up 2
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, launches = [], None
        for _ in range(5):
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = net(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches = dict(kernels.launch_counts)
            if launches["composite_fwd"] != 8:
                fail(f"expected 8 compositor launches per forward, got {launches}")
        check_outputs(out, 1, 8, H, W, (2 * cfg.vol_embedding_reso) ** 3)
        peak = torch.cuda.max_memory_allocated()
        fwd_ms = statistics.median(times)

        # where the forward's time goes (one more forward each)
        split = forward_breakdown(net, batch)
        busy = device_busy(net, batch)
    kernel_total = split["compositor"]
    overflow_total = int(out["overflow"].sum())
    print(f"[slice] forward ms median {fwd_ms:.2f} (runs {[round(t, 2) for t in times]}); "
          f"compositor {kernel_total:.3f} ms over {split['compositor_launches']} "
          f"launches = {kernel_total / fwd_ms:.1%} of the forward; overflow "
          f"{overflow_total}; peak allocated {peak / 2**30:.2f} GiB")
    print(f"[breakdown] device ms by stage: {json.dumps(split)}")
    print(f"[profiler] wall {busy['wall_ms']:.2f} ms, kernels busy "
          f"{busy['busy_ms']:.2f} ms ({busy['busy_ms'] / busy['wall_ms']:.1%}); "
          f"top: {json.dumps(busy['top'])}")

    with torch.inference_mode():
        tiny_card_vs_cpu()

    rec = {
        "name": "composite_fwd",
        "route": "cuda",
        "source": "generativedensification_torch/csrc/composite_fwd.cu",
        "replaces": "generativedensification_tpu/splat/pallas_kernels.py:412",
        "launches": launches["composite_fwd"],
        "max_abs_err": model_rec["max_abs_err"],
        "ms": model_rec["ms"],
        "plain_ms": model_rec["plain_ms"],
        "bound_ms": model_rec["bound_ms"],
        "bound_by": model_rec["bound_by"],
        "library_ms": None,
    }
    print(json.dumps({"slice": {"forward_ms": fwd_ms, "forward_runs_ms": times,
                                "compositor_ms_per_forward": kernel_total,
                                "breakdown_ms": split, "busy_ms": busy["busy_ms"],
                                "busy_wall_ms": busy["wall_ms"],
                                "overflow": overflow_total, "peak_bytes": peak},
                      "scenes": [bench_rec, model_rec]}))
    print(card)
    print(json.dumps({"kernels": [rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
