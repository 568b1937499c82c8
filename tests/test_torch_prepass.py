"""The renders' pre-pass (``csrc/prepass.cu``): the projection and the tile
binning as kernels.

On the CPU: ``ProjectFunction``'s backward, which recomputes the plain
projection for CPU tensors, against autograd of the plain chain (bitwise),
and the CPU entries ``project`` / ``bin_gaussians`` / ``bin_and_cap``
against the plain chains they take.  On the card (``gpu`` marker; skips
without one): the binning kernels bitwise against ``bin_gaussians_plain``
on every budget path, the projection kernel against ``project_gaussians``,
the gradients through ``ProjectFunction`` (the ``project_bwd`` kernel)
against plain autograd and the recompute bitwise, a render with no host
synchronisation, and one view's launches.  ``tests/test_torch_project_bwd.py``
holds the backward kernel in full.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_prepass.py
"""

import dataclasses

import pytest
import torch

from generativedensification_torch.core.transforms import normalize_quat
from generativedensification_torch.splat import kernels
from generativedensification_torch.splat.binning import (
    bin_and_cap,
    bin_gaussians,
    bin_gaussians_plain,
)
from generativedensification_torch.splat.projection import (
    ProjectFunction,
    _project_plain,
    project,
    project_gaussians,
    project_vjp_recompute,
)
from generativedensification_torch.splat.rasterizer import rasterize
from generativedensification_torch.tools.scenes import prepass_scene
from generativedensification_torch.utils import tracing

torch.set_num_threads(1)

OUTPUTS = ("xy", "depth", "conic", "color", "opacity_eff")
BINS = ("sorted_ids", "sorted_o", "sorted_valid", "sorted_rank", "depth_order",
        "tile_starts", "tile_counts", "overflow")


def _leaves(scene, offset: bool):
    means, shs, opa, scales, quats, cam = scene
    leaves = [t.clone().requires_grad_(True) for t in (means, shs, opa, scales, quats)]
    off = torch.zeros((means.shape[0], 2), device=means.device, requires_grad=True)
    return cam, leaves + [off if offset else None]


def _loss(outs, weights):
    return sum((o * w).sum() for o, w in zip(outs, weights) if w is not None)


def _weights(scene, used, seed=0):
    """Seeded weights of each differentiable output (``None`` where
    unused)."""
    g = torch.Generator().manual_seed(seed)
    n = scene[0].shape[0]
    shapes = {"xy": (n, 2), "depth": (n,), "conic": (n, 3), "color": (n, 3),
              "opacity_eff": (n,)}
    return [torch.randn(shapes[k], generator=g).to(scene[0].device) if k in used
            else None for k in OUTPUTS]


def _plain_grads(cam, deg, leaves, weights):
    proj, opa_eff = _project_plain(cam, deg, *leaves)
    outs = (proj.xy, proj.depth, proj.conic, proj.color, opa_eff)
    wrt = [t for t in leaves if t is not None and t.requires_grad]
    return torch.autograd.grad(_loss(outs, weights), wrt, allow_unused=True)


def _function_grads(cam, deg, leaves, weights):
    outs = ProjectFunction.apply(cam, deg, *leaves)
    wrt = [t for t in leaves if t is not None and t.requires_grad]
    return torch.autograd.grad(_loss(outs[:5], weights), wrt, allow_unused=True)


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("deg,offset,used", [
    (0, False, OUTPUTS),
    (1, True, OUTPUTS),
    (2, False, ("xy", "conic")),
    (3, True, ("color", "opacity_eff", "depth")),
])
def test_project_function_recompute_matches_autograd(deg, offset, used):
    """On the CPU the plain chain stands in for the kernel: the backward
    launches nothing and is ``project_vjp_recompute``, which gives
    autograd's gradients bit for bit, with unused outputs and inputs that
    take no gradient."""
    scene = prepass_scene("cpu", 300, height=48, width=64, seed=deg, sh_degree=deg)
    cam, leaves = _leaves(scene, offset)
    leaves[1].requires_grad_(deg != 2)          # shs: no gradient asked
    weights = _weights(scene, used, seed=deg)
    ref = _plain_grads(cam, deg, leaves, weights)
    kernels.reset_launch_counts()
    got = _function_grads(cam, deg, leaves, weights)
    assert not any(kernels.launch_counts.values())
    need = [t is not None and t.requires_grad for t in leaves]
    recomputed = [g for g, n in zip(project_vjp_recompute(cam, deg, leaves, weights, need),
                                    need) if n]
    assert len(got) == len(ref) == len(recomputed)
    for g, r, c in zip(got, ref, recomputed):
        assert (g is None) == (r is None) == (c is None)
        if r is not None:
            assert torch.equal(g, r) and torch.equal(g, c)


def test_cpu_entries_take_the_plain_chains():
    """``project``, ``bin_gaussians`` and ``bin_and_cap`` on CPU tensors are
    the plain chains, operation for operation, and launch nothing."""
    means, shs, opa, scales, quats, cam = prepass_scene("cpu", 2000, height=80,
                                                         width=96, smax=0.08)
    kernels.reset_launch_counts()
    proj, opa_eff = project(means, shs, opa, cam, 1, scales, quats)
    ref = project_gaussians(means, shs, opa, cam, 1, scales, normalize_quat(quats))
    for f in dataclasses.fields(ref):
        a, b = getattr(proj, f.name), getattr(ref, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
    assert torch.equal(opa_eff, torch.where(ref.valid, ref.opacity, 0.0))
    for kw in ({}, {"enum_tiles": 9}, {"max_pairs": 2500}):
        plain = bin_gaussians_plain(ref, 80, 96, 16, 4, **kw)
        bins = bin_gaussians(ref, 80, 96, 16, 4, **kw)
        capped_bins, counts, overflow = bin_and_cap(ref, 80, 96, 16, 4, 8, **kw)
        for name in BINS:
            assert torch.equal(getattr(bins, name), getattr(plain, name)), name
            assert torch.equal(getattr(capped_bins, name), getattr(plain, name)), name
        assert torch.equal(counts, torch.clamp(plain.tile_counts, max=8))
        assert int(overflow) == int(plain.overflow) + int((plain.tile_counts - counts).sum())
        assert int(overflow) > int(plain.overflow) > 0
    assert not any(kernels.launch_counts.values())


def test_count_takes_numbers():
    """``tracing.count`` of a Python number: in a request it adds to the
    request's counter beside tensors; outside one, to ``outside``."""
    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("gd.forward"):
            tracing.count("views", 1)
            tracing.count("views", torch.tensor([2, 3]))
            tracing.count("views", 1)
        tracing.count("views", 5)
    finally:
        tracing.disable()
    s = tracing.summary()
    tracing.reset()
    assert s["counters"] == {"views": 7} and s["outside"] == {"views": 5}


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the pre-pass kernels have no CPU mode")
    return torch.device("cuda")


def _perturbed(proj, kind, seed=0):
    """The projection with depth ties, or with culled, off-screen and
    zero-radius Gaussians marked valid or not (``kind`` "kernel": the
    projection is the kernel's, left as it is)."""
    g = torch.Generator(device=proj.xy.device).manual_seed(seed)
    n = proj.xy.shape[0]
    if kind == "ties":
        # a coarse depth grid: thousands of equal keys for the stable sort
        return dataclasses.replace(proj, depth=torch.round(proj.depth * 8.0) / 8.0)
    if kind == "culled":
        pick = lambda share: torch.rand(n, generator=g, device=proj.xy.device) < share
        valid = proj.valid & ~pick(0.1)
        radius = torch.where(pick(0.05), 0.0, proj.radius)
        xy = torch.where(pick(0.05)[:, None], proj.xy * 3.0 - 600.0, proj.xy)
        return dataclasses.replace(proj, valid=valid | pick(0.02), radius=radius, xy=xy)
    return proj


# name: (n, height, width, tile, max_tiles, enum_tiles, max_pairs, max_per_tile,
# smax, perturbation)
BIN_CASES = {
    "ts16_d4": (20000, 256, 256, 16, 4, None, None, 64, 0.03, None),
    "ts16_d16": (20000, 256, 256, 16, 16, None, None, 64, 0.03, None),
    "ts32_d4": (20000, 256, 256, 32, 4, None, None, 64, 0.03, None),
    "ts32_d16": (20000, 256, 256, 32, 16, None, None, 64, 0.03, None),
    "enum_gt_max": (20000, 256, 256, 16, 4, 16, None, 64, 0.06, None),
    "max_pairs": (20000, 256, 256, 32, 9, None, 30000, 64, 0.03, None),
    "max_pairs_enum": (20000, 256, 256, 16, 4, 9, 40000, 64, 0.06, None),
    "ragged_image": (20000, 250, 300, 32, 4, None, None, 64, 0.03, None),
    "depth_ties": (20000, 256, 256, 16, 4, None, None, 64, 0.03, "ties"),
    "culled": (20000, 256, 256, 32, 4, 9, None, 64, 0.03, "culled"),
    "rect_over_e": (20000, 256, 256, 16, 4, 9, None, 64, 0.3, None),
    "serve_262k": (262144, 512, 512, 32, 4, None, None, 4096, 0.03, None),
    "serve_332k": (331744, 512, 512, 32, 4, None, None, 4096, 0.03, None),
    "serve_332k_kernel_proj": (331744, 512, 512, 32, 4, None, None, 4096, 0.03,
                               "kernel"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BIN_CASES))
def test_binning_kernels_match_plain_bitwise(cuda_device, case):
    """``bin_and_cap`` / ``bin_gaussians`` on the card against the plain
    chain on the card, from the same projection (the plain chain's, or the
    projection kernel's): every ``TileBins`` field, the clamped counts and
    the total overflow, bit for bit."""
    n, h, w, ts, d, enum, max_pairs, cap, smax, kind = BIN_CASES[case]
    means, shs, opa, scales, quats, cam = prepass_scene(cuda_device, n, h, w, seed=1,
                                                        smax=smax)
    with torch.no_grad():
        if kind == "kernel":
            proj, _ = project(means, shs, opa, cam, 1, scales, quats)
        else:
            proj = _perturbed(project_gaussians(means, shs, opa, cam, 1, scales,
                                                normalize_quat(quats)), kind)
        plain = bin_gaussians_plain(proj, h, w, ts, d, max_pairs, enum)
        counts_ref = torch.clamp(plain.tile_counts, max=cap)
        total_ref = plain.overflow + (plain.tile_counts - counts_ref).sum().to(torch.int32)
        bins, counts, total = bin_and_cap(proj, h, w, ts, d, cap, max_pairs, enum)
        alone = bin_gaussians(proj, h, w, ts, d, max_pairs, enum)
    for name in BINS:
        ref = getattr(plain, name)
        for got in (getattr(bins, name), getattr(alone, name)):
            assert got.dtype == ref.dtype and got.shape == ref.shape, name
            assert torch.equal(got, ref), name
    assert (bins.tiles_x, bins.tiles_y, bins.tile_size) == (
        plain.tiles_x, plain.tiles_y, plain.tile_size)
    assert torch.equal(counts, counts_ref) and torch.equal(total, total_ref)
    assert int(plain.sorted_valid.sum()) > 0
    if case in ("enum_gt_max", "rect_over_e", "serve_332k", "max_pairs"):
        assert int(plain.overflow) > 0


# the projection kernel against the plain chain: the largest difference of
# each output over the largest |value| of the plain chain's.  The chain's
# two 4-term GEMMs and two norms are library calls whose summation order the
# kernel repeats as measured; elsewhere it rounds as the chain does.  Where
# the library picks another order, the two differ by rounding:
PROJECT_RTOL = 1e-5
# and ``valid`` / ``radius`` only where a comparison or a ceil sits within
# that rounding of its edge: at most this share of the Gaussians
FLIP_SHARE = 1e-4


def _orders_measured() -> bool:
    """Whether the libraries are those on which the kernel's summation
    orders were measured (torch 2.11 with CUDA 12.8: cuBLAS's GEMM for the
    chain's two 4-term products at the serving N, ``linalg.norm``'s lane
    tree).  Only there is the projection held bit for bit: another cuBLAS
    may pick another GEMM kernel, and so another order, with nothing wrong
    in the kernel; ``PROJECT_RTOL`` and ``FLIP_SHARE`` hold everywhere."""
    return torch.__version__.startswith("2.11.") and torch.version.cuda == "12.8"


@pytest.mark.gpu
@pytest.mark.parametrize("n,deg,bitwise", [(20000, 0, False), (20000, 3, False),
                                           (331744, 1, True)])
def test_project_kernel_matches_plain(cuda_device, n, deg, bitwise):
    """Within rounding everywhere; at the serving shape, on the libraries
    the orders were measured on, bit for bit, so that a render of the
    kernel's projection bins as the plain chain's would."""
    means, shs, opa, scales, quats, cam = prepass_scene(cuda_device, n, 512, seed=2,
                                                        sh_degree=deg)
    with torch.no_grad():
        before = kernels.launch_counts["project"]
        proj, opa_eff = project(means, shs, opa, cam, deg, scales, quats)
        torch.cuda.synchronize()
        assert kernels.launch_counts["project"] == before + 1
        ref, ref_eff = _project_plain(cam, deg, means, shs, opa, scales, quats, None)
    both = proj.valid & ref.valid
    flips = int((proj.valid != ref.valid).sum()) + int(
        (proj.radius[both] != ref.radius[both]).sum())
    assert flips <= FLIP_SHARE * n
    for name, a, b in (("xy", proj.xy, ref.xy), ("depth", proj.depth, ref.depth),
                       ("conic", proj.conic[both], ref.conic[both]),
                       ("color", proj.color, ref.color),
                       ("opacity_eff", opa_eff[both], ref_eff[both])):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        assert err <= PROJECT_RTOL, (name, err)
    if bitwise and _orders_measured():
        assert flips == 0
        for name in ("xy", "depth", "conic", "color", "radius", "valid"):
            assert torch.equal(getattr(proj, name), getattr(ref, name)), name
        assert torch.equal(opa_eff, ref_eff)


@pytest.mark.gpu
def test_project_function_gradients_on_card(cuda_device):
    """The kernel's forward and the ``project_bwd`` kernel's backward against
    autograd of the plain chain on the card: a loss linear in the outputs
    gives the same cotangents, so the gradients agree within
    ``PROJECT_RTOL`` of each one's largest value (the backward kernel sums
    in its own order, so not bit for bit) where the forward kernel and the
    chain agree on validity; the recompute, called explicitly, is still
    bit for bit autograd's."""
    scene = prepass_scene(cuda_device, 20000, 256, seed=3)
    cam, leaves = _leaves(scene, offset=True)
    weights = _weights(scene, OUTPUTS, seed=3)
    ref = _plain_grads(cam, 1, leaves, weights)
    before = kernels.launch_counts["project_bwd"]
    got = _function_grads(cam, 1, leaves, weights)
    assert kernels.launch_counts["project_bwd"] == before + 1
    with torch.no_grad():
        flips = ProjectFunction.apply(cam, 1, *leaves)[6] != _project_plain(
            cam, 1, *leaves)[0].valid
    assert int(flips.sum()) <= FLIP_SHARE * 20000
    for g, r in zip(got, ref):
        err = float((g - r)[~flips].abs().max()) / float(r.abs().max())
        assert err <= PROJECT_RTOL, err
    recomputed = project_vjp_recompute(cam, 1, leaves, weights, (True,) * 6)
    for g, r in zip(recomputed, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    means, shs, opa, scales, quats, cam = scene
    proj, _ = project(means, shs, opa, cam, 1, scales, quats)   # no leaf asks
    assert proj.xy.grad_fn is None


@pytest.mark.gpu
def test_render_adds_no_host_sync(cuda_device):
    """A render of one view (projection, binning, compositor) under
    ``set_sync_debug_mode("error")``, after a warm-up that builds the
    kernels."""
    means, shs, opa, scales, quats, cam = prepass_scene(cuda_device, 50000, 512, seed=4)
    bg = torch.ones(3, device=cuda_device)
    kw = dict(tile_size=32, max_tiles=4, max_per_tile=4096)
    with torch.no_grad():
        rasterize(means, shs, opa, scales, quats, cam, bg, 1, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = rasterize(means, shs, opa, scales, quats, cam, bg, 1, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert float(out.alpha.max()) > 0.5


@pytest.mark.gpu
def test_one_view_launches(cuda_device):
    """One 3DGS view: one launch of each pre-pass kernel and of the
    compositor; the 2DGS renderer's view the surfel set-up and the three
    binning kernels."""
    from generativedensification_torch.splat.surfel import rasterize_surfels

    means, shs, opa, scales, quats, cam = prepass_scene(cuda_device, 20000, 256, seed=5)
    bg = torch.ones(3, device=cuda_device)
    with torch.no_grad():
        kernels.reset_launch_counts()
        rasterize(means, shs, opa, scales, quats, cam, bg, 1, max_tiles=4)
        assert kernels.launch_counts == {
            **dict.fromkeys(kernels.launch_counts, 0), "project": 1, "depth_rank": 1,
            "tile_keys": 1, "tile_ranges": 1, "composite_fwd": 1}
        kernels.reset_launch_counts()
        rasterize_surfels(means, shs, opa, scales[:, :2], quats, cam, bg, 1, max_tiles=4)
        assert kernels.launch_counts == {
            **dict.fromkeys(kernels.launch_counts, 0), "surfel_setup": 1, "depth_rank": 1,
            "tile_keys": 1, "tile_ranges": 1, "surfel_fwd": 1}
