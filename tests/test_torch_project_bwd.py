"""The projection's backward (``csrc/prepass.cu`` ``gd_project_bwd``).

On the CPU: ``project_vjp_plain``, the kernel's arithmetic as explicit
PyTorch, against ``torch.autograd.grad`` of the plain chain
(``_project_plain``) in float64, on an adversarial scene (Gaussians behind
the near plane, with det <= 0, FOV-clamped, with a colour clamped at 0, at
|w| < 1e-7, with a zero-length quaternion, at the camera centre), for SH
degrees 0-3 with and without a screen offset, every subset of the asked
gradients and of the given cotangents; the kernel wrapper's errors; and
the dispatch: CPU tensors take the recompute.  On the card (``gpu`` marker;
skips without one): the kernel against autograd of the plain chain at
20,000, 262,144 and 331,744 Gaussians, SH degrees 0-3, float32 and bfloat16
inputs; the recompute still bit for bit autograd; the screen-only and
cotangent-free backwards; a micro-step's backward with no host
synchronisation; one training view's launches.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_project_bwd.py
"""

import dataclasses
import itertools
import math

import pytest
import torch

from generativedensification_torch.core.transforms import normalize_quat
from generativedensification_torch.splat import kernels
from generativedensification_torch.splat.projection import (
    ProjectFunction,
    _project_plain,
    _project_vjp_kernel,
    _symm6_from_scales_rots,
    compute_cov2d_abc,
    project_vjp_plain,
    project_vjp_recompute,
)
from generativedensification_torch.tools.scenes import prepass_scene

torch.set_num_threads(1)

INPUTS = ("means3d", "shs", "opacity", "scales", "rotations", "screen_offset")
OUTPUTS = (("xy", (2,)), ("depth", ()), ("conic", (3,)), ("color", (3,)),
           ("opacity_eff", ()))
# float64: the plain VJP against autograd, each element within this share of
# the largest |reference| of its Gaussian's row in that gradient
PLAIN_RTOL = 1e-9
# float32 on the card: the kernel against autograd, within this share of the
# largest |reference| of the whole gradient tensor
KERNEL_RTOL = 1e-5


def _f64(cam):
    """The camera with every floating tensor in float64."""
    return dataclasses.replace(cam, **{
        f.name: getattr(cam, f.name).double() for f in dataclasses.fields(cam)
        if torch.is_tensor(getattr(cam, f.name))
        and getattr(cam, f.name).is_floating_point()})


def adversarial_scene(sh_degree, n=640, seed=0):
    """``prepass_scene``'s 64 x 48 view in float64 with eight rows of edge
    cases: behind the near plane (z in [-1, 0.19]), a rank-1 covariance so
    large that det = ac - b² rounds to <= 0 for some, FOV-clamped (|x / z|
    up to 3x the limit), colours below 0 before the clamp, the camera plane
    (0 < |w| < 1e-7), zero-length quaternions, a mean at the camera centre (a
    zero view direction), and the rest as drawn."""
    means, shs, opa, scales, quats, cam = prepass_scene(
        "cpu", n, 48, 64, seed=seed, sh_degree=sh_degree, smax=0.3)
    cam = _f64(cam)
    means, shs, opa, scales, quats = (t.double() for t in (means, shs, opa, scales, quats))
    g = torch.Generator().manual_seed(seed + 100)
    u = lambda *shape: torch.rand(shape, generator=g, dtype=torch.float64)
    wvt = cam.world_view_transform
    to_world = lambda pv: (pv - wvt[3, :3]) @ torch.linalg.inv(wvt[:3, :3])
    k = n // 10
    rows = lambda j: slice(j * k, (j + 1) * k)
    z = u(k) * 1.19 - 1.0                                        # behind
    means[rows(0)] = to_world(torch.stack([u(k) - 0.5, u(k) - 0.5, z], -1))
    drawn = scales.clone()
    scales[rows(1)] = torch.tensor([1e9, 1e-3, 1e-3], dtype=torch.float64)  # det
    z = 0.5 + 1.5 * u(k)                                         # FOV-clamped
    side = torch.where(u(k) < 0.5, -1.0, 1.0)
    means[rows(2)] = to_world(torch.stack([side * 3.0 * z * u(k) + side * 0.6 * z,
                                           (u(k) - 0.5) * 3.0 * z, z], -1))
    shs[rows(3), 0] = -3.0 - u(k, 3)                             # colour < 0
    z = torch.where(u(k) < 0.5, -1.0, 1.0) * (1e-9 + 1e-8 * u(k))   # |w| < 1e-7
    means[rows(4)] = to_world(torch.stack([u(k) - 0.5, u(k) - 0.5, z], -1))
    quats[rows(5)] = 0.0                                         # |q| = 0
    means[6 * k] = cam.camera_center                             # at the centre
    # of the rank-1 rows, those whose det rounds to a positive value hold
    # only rounding in it (1 / det² then amplifies any order's rounding past
    # f64): they keep their drawn scales
    scales[rows(1)] = torch.where((_det(means, scales, quats, cam) > 0)[rows(1), None],
                                  drawn[rows(1)], scales[rows(1)])
    return means, shs, opa, scales, quats, cam


def _det(means, scales, quats, cam):
    """The plain chain's det = ac - b² of each Gaussian."""
    hom = torch.cat([means, torch.ones_like(means[:, :1])], -1)
    a, b, c = compute_cov2d_abc(hom @ cam.world_view_transform[:, :3],
                                _symm6_from_scales_rots(scales, normalize_quat(quats)),
                                cam.world_view_transform[:3, :3].T, cam.focal_x,
                                cam.focal_y, cam.tan_half_fovx, cam.tan_half_fovy)
    return a * c - b * b


def _cotangents(n, seed, dtype=torch.float64, device="cpu", present=(True,) * 5):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((n, *shape), generator=g, dtype=dtype).to(device) if p else None
            for (_, shape), p in zip(OUTPUTS, present)]


def _inputs(scene, offset: bool):
    means, shs, opa, scales, quats, _ = scene
    off = torch.zeros((means.shape[0], 2), dtype=means.dtype, device=means.device)
    return [means, shs, opa, scales, quats, off if offset else None]


def _assert_rows_close(got, ref, rtol=PLAIN_RTOL):
    """Every gradient: ``None`` on both sides where not asked (a gradient
    autograd finds unreached is zero), else each element within ``rtol`` of
    the largest |reference| in its Gaussian's row."""
    for name, g, r in zip(INPUTS, got, ref):
        if g is None or r is None:
            for t in (g, r):
                assert t is None or not t.any(), name
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.isfinite(r).all(), name
        scale = r.abs().reshape(r.shape[0], -1).amax(-1)
        err = (g - r).abs().reshape(r.shape[0], -1).amax(-1)
        bad = err > rtol * scale
        assert not bad.any(), (name, int(bad.sum()), float((err / scale)[bad].max()))


# ------------------------------------------------------------------ CPU


def test_adversarial_scene_has_its_edge_cases():
    """Each edge case the plain VJP is held on is present in the scene."""
    means, shs, opa, scales, quats, cam = adversarial_scene(1)
    with torch.no_grad():
        proj, _ = _project_plain(cam, 1, means, shs, opa, scales, quats, None)
        hom = torch.cat([means, torch.ones_like(means[:, :1])], -1)
        pv = hom @ cam.world_view_transform[:, :3]
        w = (hom @ cam.full_proj_transform)[:, 3]
    lim = 1.3 * cam.tan_half_fovx
    ratio = pv[:, 0] / pv[:, 2]
    assert int((pv[:, 2] < 0.2).sum()) >= 64
    assert int((_det(means, scales, quats, cam) <= 0).sum()) >= 16
    assert int(((pv[:, 2] > 0.2) & (ratio.abs() > lim)).sum()) >= 32
    assert int((w.abs() < 1e-7).sum()) >= 32
    assert int((quats.abs().sum(-1) == 0).sum()) >= 32
    assert int((proj.color == 0).all(-1).sum()) >= 32
    assert int(proj.valid.sum()) >= 100


@pytest.mark.parametrize("deg,offset", list(itertools.product(range(4), (False, True))))
def test_plain_vjp_matches_autograd(deg, offset):
    """float64, every gradient and cotangent: ``project_vjp_plain`` is
    autograd's gradient of the plain chain on the adversarial scene."""
    scene = adversarial_scene(deg, seed=deg)
    inputs = _inputs(scene, offset)
    cots = _cotangents(scene[0].shape[0], seed=deg)
    need = tuple(t is not None for t in inputs)
    ref = project_vjp_recompute(scene[5], deg, inputs, cots, need)
    got = project_vjp_plain(scene[5], deg, inputs, cots, need)
    _assert_rows_close(got, ref)


@pytest.mark.parametrize("mask", range(64), ids=lambda m: f"need{m:06b}")
def test_plain_vjp_every_asked_subset(mask):
    """Each subset of the six gradients asked (screen-only among them):
    those asked are autograd's, the others ``None``."""
    scene = adversarial_scene(1, seed=7)
    inputs = _inputs(scene, True)
    cots = _cotangents(scene[0].shape[0], seed=mask)
    need = tuple(bool(mask >> k & 1) for k in range(6))
    ref = project_vjp_recompute(scene[5], 1, inputs, cots, need)
    got = project_vjp_plain(scene[5], 1, inputs, cots, need)
    assert all((g is None) == (not n) for g, n in zip(got, need))
    _assert_rows_close(got, ref)


@pytest.mark.parametrize("mask", range(32), ids=lambda m: f"cot{m:05b}")
def test_plain_vjp_absent_cotangents(mask):
    """Each subset of the five cotangents given (``None`` for the others,
    as autograd hands over an unused output's): the gradients are
    autograd's, zero where no cotangent reaches."""
    scene = adversarial_scene(2, seed=11)
    inputs = _inputs(scene, True)
    present = tuple(bool(mask >> k & 1) for k in range(5))
    cots = _cotangents(scene[0].shape[0], seed=mask, present=present)
    need = (True,) * 6
    ref = project_vjp_recompute(scene[5], 2, inputs, cots, need)
    got = project_vjp_plain(scene[5], 2, inputs, cots, need)
    _assert_rows_close(got, ref)


def test_plain_vjp_widens_bf16_as_the_kernel_reads_it():
    """bfloat16 inputs: the gradients of the float32 widening, rounded once
    into each input's dtype."""
    means, shs, opa, scales, quats, cam = prepass_scene("cpu", 400, 48, 64, seed=3)
    inputs = [t.to(torch.bfloat16) for t in (means, shs, opa, scales, quats)] + [None]
    cots = _cotangents(400, seed=3, dtype=torch.float32)
    need = (True,) * 5 + (False,)
    wide = [None if t is None else t.float() for t in inputs]
    ref = project_vjp_plain(cam, 1, wide, cots, need)
    got = project_vjp_plain(cam, 1, inputs, cots, need)
    for g, r, t in zip(got, ref, inputs):
        if t is not None:
            assert g.dtype == torch.bfloat16 and torch.equal(g, r.to(torch.bfloat16))


def _wrapper_case(case):
    means, shs, opa, scales, quats, cam = prepass_scene("cpu", 50, 48, 64, seed=1)
    inputs = [means, shs, opa, scales, quats, None]
    cots = _cotangents(50, seed=1, dtype=torch.float32)
    deg = 1
    if case == "degree":
        deg = 4
    elif case == "float64":
        inputs[0] = means.double()
    elif case == "float16":
        inputs[3] = scales.half()
    elif case == "means_shape":
        inputs[0] = means[:, :2]
    elif case == "shs_short":
        inputs[1] = shs[:, :1]
    elif case == "cotangent_dtype":
        cots[2] = cots[2].double()
    elif case == "cotangent_shape":
        cots[0] = cots[0][:, :1]
    elif case == "camera_dtype":
        cam = _f64(cam)
    return cam, deg, inputs, cots


@pytest.mark.parametrize("case", ["degree", "float64", "float16", "means_shape",
                                  "shs_short", "cotangent_dtype", "cotangent_shape",
                                  "camera_dtype"])
def test_kernel_wrapper_raises_before_building(case, monkeypatch):
    """The wrapper checks the SH degree, the dtypes and the shapes before it
    builds or launches anything, and raises: there is no fallback."""
    cam, deg, inputs, cots = _wrapper_case(case)
    monkeypatch.setattr(kernels, "build", lambda *a, **k: pytest.fail("built"))
    with pytest.raises(ValueError):
        _project_vjp_kernel(cam, deg, inputs, cots, (True,) * 5 + (False,))


def test_cpu_backward_takes_the_recompute():
    """Through ``ProjectFunction`` CPU tensors take the recompute: the
    backward launches nothing, is ``project_vjp_recompute`` bit for bit and
    gives autograd's gradients bit for bit."""
    means, shs, opa, scales, quats, cam = prepass_scene("cpu", 300, 48, 64, seed=4)
    leaves = [t.clone().requires_grad_(True) for t in (means, shs, opa, scales, quats)]
    cots = _cotangents(300, seed=4, dtype=torch.float32)
    proj, opa_eff = _project_plain(cam, 1, *leaves, None)
    ref = torch.autograd.grad([proj.xy, proj.depth, proj.conic, proj.color, opa_eff],
                              leaves, cots)
    kernels.reset_launch_counts()
    outs = ProjectFunction.apply(cam, 1, *leaves, None)
    got = torch.autograd.grad(list(outs[:5]), leaves, cots)
    assert not any(kernels.launch_counts.values())
    recomputed = project_vjp_recompute(cam, 1, leaves + [None], cots, (True,) * 5 + (False,))
    for g, r, c in zip(got, ref, recomputed):
        assert torch.equal(g, r) and torch.equal(g, c)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the projection backward kernel has no CPU mode")
    return torch.device("cuda")


def _flips(cam, deg, inputs):
    """Gaussians whose validity the kernel's forward and the plain chain
    decide differently (within rounding of an edge where the library's
    summation order is not the kernel's)."""
    with torch.no_grad():
        outs = ProjectFunction.apply(cam, deg, *inputs)
        ref, _ = _project_plain(cam, deg, *[None if t is None else t.float()
                                            for t in inputs])
    return outs[6] != ref.valid


def _card_grads(cam, deg, inputs, cots, need):
    """(kernel, reference): the kernel's gradients through
    ``ProjectFunction`` and autograd's of the plain chain on the inputs
    widened to float32 (the gradients rounded once into their dtype)."""
    leaves = [None if t is None else t.detach().clone().requires_grad_(n)
              for t, n in zip(inputs, need)]
    wrt = [t for t in leaves if t is not None and t.requires_grad]
    outs = ProjectFunction.apply(cam, deg, *leaves)
    pairs = [(o, g) for o, g in zip(outs[:5], cots) if g is not None]
    got = torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                              allow_unused=True)
    proj, opa_eff = _project_plain(cam, deg, *[None if t is None else t.float()
                                               for t in leaves])
    pairs = [(o, g) for o, g in zip((proj.xy, proj.depth, proj.conic, proj.color,
                                     opa_eff), cots) if g is not None]
    ref = torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                              allow_unused=True)
    return got, ref


def _assert_kernel_close(got, ref, keep, dtype):
    """Each gradient within ``KERNEL_RTOL`` of its largest |reference|, and
    for bfloat16 one rounding of that largest value besides, over the
    Gaussians ``keep`` holds."""
    for g, r in zip(got, ref):
        if r is None:
            assert g is None or not g.any()
            continue
        assert g.dtype == r.dtype == dtype and g.shape == r.shape
        big = float(r.abs().max())
        tol = KERNEL_RTOL * big
        if dtype == torch.bfloat16:
            tol += math.ldexp(torch.finfo(torch.bfloat16).eps, math.floor(math.log2(big)))
        err = float((g.float() - r.float())[keep].abs().max())
        assert err <= tol, (err, tol, big)


@pytest.mark.gpu
@pytest.mark.parametrize("n,deg,dtype", list(itertools.product(
    (20000, 262144, 331744), range(4), (torch.float32, torch.bfloat16))),
    ids=lambda v: str(v).replace("torch.", ""))
def test_kernel_matches_autograd(cuda_device, n, deg, dtype):
    """The ``project_bwd`` kernel against autograd of the plain chain:
    every gradient within ``KERNEL_RTOL`` of its largest value (bfloat16:
    plus one rounding of it), where the kernel's forward and the chain
    agree on the Gaussian's validity (the forward's own test bounds the
    flips); one launch."""
    scene = prepass_scene(cuda_device, n, 512, seed=20 + deg, sh_degree=deg)
    inputs = [t.to(dtype) for t in scene[:5]] + [
        torch.zeros((n, 2), dtype=dtype, device=cuda_device)]
    cots = _cotangents(n, seed=deg, dtype=torch.float32, device=cuda_device)
    keep = ~_flips(scene[5], deg, inputs)
    assert int((~keep).sum()) <= 1e-4 * n
    before = kernels.launch_counts["project_bwd"]
    got, ref = _card_grads(scene[5], deg, inputs, cots, (True,) * 6)
    assert kernels.launch_counts["project_bwd"] == before + 1
    _assert_kernel_close(got, ref, keep, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("need,present", [
    ((False,) * 5 + (True,), (True,) * 5),                        # screen only
    ((True,) * 6, (False, True, False, True, False)),             # depth, color
    ((True, False, True, False, True, False), (True,) * 5),
    ((True,) * 6, (False,) * 5),                                  # no cotangent
], ids=["screen_only", "two_cotangents", "three_asked", "no_cotangent"])
def test_kernel_subsets(cuda_device, need, present):
    """Gradients asked and cotangents given in part, as
    ``Network._isolated_selection`` (screen offset only) and unused outputs
    leave them."""
    scene = prepass_scene(cuda_device, 20000, 256, seed=9)
    inputs = list(scene[:5]) + [torch.zeros((20000, 2), device=cuda_device)]
    cots = _cotangents(20000, seed=9, dtype=torch.float32, device=cuda_device,
                       present=present)
    got = _project_vjp_kernel(scene[5], 1, inputs, cots, need)
    ref = project_vjp_recompute(scene[5], 1, inputs, cots, need)
    keep = ~_flips(scene[5], 1, inputs)
    assert all((g is None) == (not k) for g, k in zip(got, need))
    _assert_kernel_close(got, ref, keep, torch.float32)


@pytest.mark.gpu
def test_recompute_on_card_is_autograd_bitwise(cuda_device):
    """The recompute, called explicitly on card tensors, is still autograd's
    gradient of the plain chain bit for bit: the semantics the kernel is
    held to."""
    scene = prepass_scene(cuda_device, 20000, 256, seed=3)
    inputs = list(scene[:5]) + [torch.zeros((20000, 2), device=cuda_device)]
    cots = _cotangents(20000, seed=3, dtype=torch.float32, device=cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    proj, opa_eff = _project_plain(scene[5], 1, *leaves)
    ref = torch.autograd.grad([proj.xy, proj.depth, proj.conic, proj.color, opa_eff],
                              leaves, cots)
    got = project_vjp_recompute(scene[5], 1, inputs, cots, (True,) * 6)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.gpu
def test_micro_step_backward_adds_no_host_sync(cuda_device):
    """A training micro-step of the tiny network (3DGS, every render
    recorded): after a warm-up step, the backward of its images' MSE under
    ``set_sync_debug_mode("error")``, with one ``project_bwd`` per
    recorded render.  (The train loss's MS-SSIM is left
    out: ``torch.prod``'s backward synchronises, outside the renders.)"""
    from generativedensification_torch.models.network import (
        Network,
        NetworkConfig,
        _cat_views,
    )
    from generativedensification_torch.tools import overfit

    batch = overfit.scene_batch(cuda_device)
    net = Network(NetworkConfig(**overfit.TINY), device=cuda_device, seed=0)
    net.train()
    tar = _cat_views(batch["tar_rgb"])
    renders = 2 * batch["tar_rgb"].shape[1]
    for sync_mode in ("default", "error"):
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        out = net(batch, with_fine=True, generator=gen)
        loss = sum(((out[k] - tar) ** 2).mean() for k in ("image", "image_fine"))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.set_sync_debug_mode(sync_mode)
        try:
            loss.backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert kernels.launch_counts["project_bwd"] == renders
        net.zero_grad(set_to_none=True)


@pytest.mark.gpu
def test_one_training_view_launches(cuda_device):
    """One 3DGS view that autograd records: its forward and backward launch
    the pre-pass kernels, the compositor's forward and backward and one
    ``project_bwd``, nothing else."""
    from generativedensification_torch.splat.rasterizer import rasterize

    means, shs, opa, scales, quats, cam = prepass_scene(cuda_device, 20000, 256, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (means, shs, opa, scales, quats)]
    bg = torch.ones(3, device=cuda_device)
    kernels.reset_launch_counts()
    out = rasterize(*leaves, cam, bg, 1, max_tiles=4)
    out.image.sum().backward()
    torch.cuda.synchronize()
    assert kernels.launch_counts == {
        **dict.fromkeys(kernels.launch_counts, 0), "project": 1, "depth_rank": 1,
        "tile_keys": 1, "tile_ranges": 1, "composite_fwd": 1, "composite_bwd": 1,
        "project_bwd": 1}
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
