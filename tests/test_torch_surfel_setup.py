"""The 2DGS surfel set-up as a kernel (``csrc/prepass.cu``
``gd_surfel_setup``, entry ``splat/surfel.py::surfel_setup``).

On the CPU: the filter margin as a Python float, the wrapper's shape and SH
degree errors, and the dispatch: CPU tensors and every call that autograd
records take the plain chain, and only card tensors with nothing recorded
launch the kernel.  On the card (``gpu`` marker; skips without one): every
kernel output against the plain chain at the serving shapes and on the
adversarial set-up scene, bit for bit on the libraries the kernel's orders
were measured on, and a surfel render and one network view of 2DGS maps with
no host synchronisation.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_surfel_setup.py
"""

import types

import numpy as np
import pytest
import torch

from generativedensification_torch.core.camera import Camera
from generativedensification_torch.splat import kernels, surfel
from generativedensification_torch.tools.scenes import prepass_scene, surfel_setup_scene

torch.set_num_threads(1)

OUTPUTS = ("acr", "bcr", "ccr", "det", "xy", "depth", "conic", "color", "opacity_eff",
           "radius", "valid", "normal")


def _scene(dev, n, hw=512, seed=0, sh_degree=1):
    """``prepass_scene`` in surfel form: ``surfel_setup``'s inputs."""
    means, shs, opa, scales, quats, cam = prepass_scene(dev, n, hw, seed=seed,
                                                        sh_degree=sh_degree)
    return means, scales[:, :2], quats, opa, shs, cam


# ------------------------------------------------------------------ CPU


def test_margin_is_the_f32_product():
    """The Python-float margin is 3·sqrt(2) as float32 arithmetic gives it,
    and adding it to a float32 tensor adds that float32 value."""
    ref = np.float32(3.0) * np.sqrt(np.float32(surfel.FILTER_2D_VAR))
    assert ref.dtype == np.float32 and float(ref) == surfel.MARGIN
    r = torch.tensor([0.0, 1.5, 1e6], dtype=torch.float32)
    assert torch.equal(r + surfel.MARGIN, r + torch.tensor(ref))


@pytest.mark.parametrize("bad,match", [
    ("degree", "SH degree 0-3"),
    ("means", "means3d must be"),
    ("scales", "scales2d must be"),
    ("rotations", "rotations must be"),
    ("opacity", "opacities must be"),
    ("shs", "shs must be"),
    ("camera", "one camera"),
])
def test_kernel_wrapper_rejects(bad, match):
    """The wrapper checks its inputs before it builds or launches anything."""
    means, scales, quats, opa, shs, cam = _scene("cpu", 64, hw=64)
    deg = 1
    if bad == "degree":
        deg = 4
    elif bad == "means":
        means = means[:, :2]
    elif bad == "scales":
        scales = torch.cat([scales, scales[:, :1]], dim=1)
    elif bad == "rotations":
        quats = quats[:, :3]
    elif bad == "opacity":
        opa = opa[:-1]
    elif bad == "shs":
        shs = shs[:, :1]
    else:
        cam = Camera(**{k: (v[None] if isinstance(v, torch.Tensor) else v)
                        for k, v in vars(cam).items()})
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        surfel._surfel_setup_kernel(cam, deg, means, scales, quats, opa, shs)
    assert not any(kernels.launch_counts.values())


def test_cpu_dispatch_takes_the_plain_chain(monkeypatch):
    """On CPU tensors ``surfel_setup`` and ``surfel_inputs`` are the plain
    chain (``_surfel_setup``, ``_surfel_coeffs``, the circular conic), with
    and without autograd, and launch nothing."""
    means, scales, quats, opa, shs, cam = _scene("cpu", 3000, hw=128)
    monkeypatch.setattr(surfel, "_surfel_setup_kernel", None)   # never called
    kernels.reset_launch_counts()
    got = surfel.surfel_setup(means, scales, quats, opa, shs, cam, 1)
    M, n_view, xy, depth, color, radius, valid = surfel._surfel_setup(
        means, scales, quats, opa, shs, cam, 1)
    acr, bcr, ccr, det = surfel._surfel_coeffs(M)
    tau = torch.log(torch.clamp(opa, min=1e-12) * 255.0)
    lam = 2.0 * torch.clamp(tau, min=1e-6) / torch.clamp(radius, min=1.0) ** 2
    ref = (acr, bcr, ccr, det, xy, depth, torch.stack([lam, 0 * lam, lam], -1), color,
           torch.where(valid, opa, 0.0), radius, valid, n_view)
    for name, g, r in zip(OUTPUTS, got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), name
    si = surfel.surfel_inputs(means, shs, opa, scales, quats, cam, 1, 32, 4)
    for g, r in zip(si.attrs, (acr, bcr, ccr, det, xy, radius, color, ref[8], n_view)):
        assert torch.equal(g, r)
    assert torch.equal(si.planes, torch.stack([cam.znear, cam.zfar]))
    leaves = [t.clone().requires_grad_(True) for t in (means, scales, quats, opa)]
    out = surfel.surfel_setup(*leaves, shs, cam, 1)
    assert out[0].grad_fn is not None
    assert not any(kernels.launch_counts.values())


def _meta(t):
    return t.to("meta") if isinstance(t, torch.Tensor) else t


def test_dispatch_records_grad_through_the_plain_chain(monkeypatch):
    """Off the CPU (here meta tensors, which compute shapes only) a call that
    autograd records takes the plain chain and builds its graph, and a call
    with no gradient asked launches the kernel: leaves that need no
    gradient, ``torch.no_grad()``, and a camera that asks for none."""
    means, scales, quats, opa, shs, cam = (_meta(t) for t in _scene("cpu", 200, hw=64))
    cam = Camera(**{k: _meta(v) for k, v in vars(cam).items()})
    calls = []

    def spy(*args):
        calls.append(args)
        return "kernel"

    monkeypatch.setattr(surfel, "_surfel_setup_kernel", spy)
    assert surfel.surfel_setup(means, scales, quats, opa, shs, cam, 1) == "kernel"
    leaves = [t.clone().requires_grad_(True) for t in (means, scales, quats, opa, shs)]
    with torch.no_grad():
        assert surfel.surfel_setup(*leaves, cam, 1) == "kernel"
    assert len(calls) == 2
    out = surfel.surfel_setup(*leaves, cam, 1)
    assert len(calls) == 2 and len(out) == len(OUTPUTS)
    assert all(o.grad_fn is not None for o in out[:4])
    assert out[0].shape == (200, 3) and out[3].shape == (200,)
    wvt = cam.world_view_transform.clone().requires_grad_(True)
    cam_grad = Camera(**{**vars(cam), "world_view_transform": wvt})
    out = surfel.surfel_setup(means, scales, quats, opa, shs, cam_grad, 1)
    assert len(calls) == 2 and out[0].grad_fn is not None


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the surfel set-up kernel has no CPU mode")
    return torch.device("cuda")


# where the libraries pick another summation order than the measured one,
# the kernel and the chain differ by rounding: each output's largest
# difference over the chain's largest |value| (the coefficients cancel at
# the depth pole, so they are held relative to the tensor, not the element)
SETUP_RTOL = 1e-5
# and ``valid`` / ``radius`` only where a comparison or a ceil sits within
# that rounding of its edge: at most this share of the surfels
FLIP_SHARE = 1e-4


def _orders_measured() -> bool:
    """Whether the libraries are those on which the kernel's orders were
    measured (torch 2.11 with CUDA 12.8: cuBLAS's GEMM for the (N, 3) @
    (3, 3) products, the reductions' lane tree, the contraction in
    ``linalg.cross``): only there is the set-up held bit for bit."""
    return torch.__version__.startswith("2.11.") and torch.version.cuda == "12.8"


def _same(a, b) -> bool:
    """Equal values (``torch.equal``), NaN at the same places."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return torch.equal(nan_a, nan_b) and torch.equal(a.masked_fill(nan_a, 0),
                                                     b.masked_fill(nan_b, 0))


def _check_setup(means, scales, quats, opa, shs, cam, deg, bitwise):
    with torch.no_grad():
        before = kernels.launch_counts["surfel_setup"]
        got = surfel.surfel_setup(means, scales, quats, opa, shs, cam, deg)
        torch.cuda.synchronize()
        assert kernels.launch_counts["surfel_setup"] == before + 1
        ref = surfel._surfel_plain(cam, deg, means, scales, quats, opa, shs)
    n = means.shape[0]
    diff = {name: int((g != r).reshape(n, -1).any(-1).sum())
            for name, g, r in zip(OUTPUTS, got, ref)}
    for name, g, r in zip(OUTPUTS, got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype, name
    vi, ri = OUTPUTS.index("valid"), OUTPUTS.index("radius")
    both = got[vi] & ref[vi]
    flips = int((got[vi] != ref[vi]).sum()) + int((got[ri][both] != ref[ri][both]).sum())
    assert flips <= FLIP_SHARE * n, (flips, diff)
    for name, g, r in zip(OUTPUTS, got, ref):
        if name in ("valid", "radius"):
            continue
        rows = both if name in ("conic", "opacity_eff") else slice(None)
        err = float((g[rows] - r[rows]).abs().max()) / max(float(r[rows].abs().max()),
                                                            1e-30)
        assert err <= SETUP_RTOL, (name, err, diff)
    if bitwise and _orders_measured():
        for name, g, r in zip(OUTPUTS, got, ref):
            assert _same(g, r), (name, diff)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n,deg,bitwise", [(262144, 1, True), (331744, 1, True),
                                           (20000, 0, False), (20000, 3, False)])
def test_setup_kernel_matches_plain(cuda_device, n, deg, bitwise):
    """Every output of one launch against the plain chain in view 0 of a
    512² rig (``prepass_scene``): within rounding everywhere, and at the
    model's 262,144 coarse and 331,744 fine surfels, on the libraries the
    orders were measured on, ``torch.equal``."""
    _check_setup(*_scene(cuda_device, n, sh_degree=deg), deg, bitwise)


@pytest.mark.gpu
def test_setup_kernel_adversarial(cuda_device):
    """The same on ``surfel_setup_scene`` at 262,144 surfels: edge-on surfels
    at the depth pole, centres around the near cull, endpoints behind 0.05,
    centres just off the screen, zero and near-zero opacities, zero scales
    and quaternions."""
    means, shs, opa, scales, quats, cam = surfel_setup_scene(cuda_device)
    got = _check_setup(means, scales, quats, opa, shs, cam, 1, True)
    valid = got[OUTPUTS.index("valid")]
    assert 0 < int(valid.sum()) < means.shape[0]


def _no_sync(fn):
    """``fn()`` once to build and warm up, then again under
    ``set_sync_debug_mode("error")``."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.gpu
def test_surfel_render_adds_no_host_sync(cuda_device):
    """``rasterize_surfels`` of one view, with and without the fused
    selection, enqueues with no host synchronisation."""
    means, scales, quats, opa, shs, cam = _scene(cuda_device, 50000, seed=4)
    bg = torch.ones(3, device=cuda_device)
    gt = torch.rand((512, 512, 3), device=cuda_device)
    kw = dict(tile_size=32, max_tiles=4, max_per_tile=4096)
    with torch.no_grad():
        out = _no_sync(lambda: surfel.rasterize_surfels(
            means, shs, opa, scales, quats, cam, bg, 1, **kw))
        sel = _no_sync(lambda: surfel.rasterize_surfels(
            means, shs, opa, scales, quats, cam, bg, 1, sel_gt=gt, **kw))
    assert float(out.alpha.max()) > 0.5 and float(sel.sel_abs.abs().max()) > 0


@pytest.mark.gpu
def test_network_2dgs_view_adds_no_host_sync(cuda_device):
    """``Network._render_views_2dgs`` over two views (the first with the
    fused selection): the renders and every per-view 2DGS map (the surface
    depth, the normal rotation, the rays, the depth normal) with no host
    synchronisation."""
    from generativedensification_torch.models.network import Network

    means, scales, quats, opa, shs, _ = _scene(cuda_device, 50000, seed=6)
    views = [prepass_scene("cpu", 1, 512, seed=s)[-1] for s in (6, 7)]
    c2w = torch.stack([torch.linalg.inv(v.world_view_transform.T) for v in views])
    cams = Camera.from_c2w(c2w.to(cuda_device), 0.8, 0.8, 512, 512, znear=0.1, zfar=10.0)
    cfg = types.SimpleNamespace(sh_degree=1, tile_size=32, max_tiles=4,
                                max_per_tile=4096, enum_tiles=0, depth_ratio=0.0)
    net = types.SimpleNamespace(cfg=cfg)
    bgs = torch.ones((2, 3), device=cuda_device)
    gt = torch.rand((1, 512, 512, 3), device=cuda_device)
    scales3 = torch.cat([scales, scales[:, :1]], dim=1)
    with torch.no_grad():
        res = _no_sync(lambda: Network._render_views_2dgs(
            net, cams, bgs, means, shs, opa, scales3, quats, gt))
    assert res["image"].shape == (2, 512, 512, 3) and res["sel_abs"].shape[0] == 1
    assert float(res["alpha"].max()) > 0.5
    assert bool(torch.isfinite(res["depth_normal"]).all())
