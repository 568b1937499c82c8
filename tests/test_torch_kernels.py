"""The port's kernels: the compositing forward's plain version against a
per-pixel serial reference and the backward's modes against each other on
the CPU, the same for the 2DGS surfel kernels, the slot-reduction kernels'
plain versions against the PyTorch calls they equal, and all six CUDA
kernels against their plain versions on the card (``gpu`` marker; skips
without one).

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""

import math

import numpy as np
import pytest
import torch

from generativedensification_torch.core.camera import Camera
from generativedensification_torch.core.transforms import normalize_quat
from generativedensification_torch.splat import kernels
from generativedensification_torch.splat.binning import bin_gaussians
from generativedensification_torch.splat.composite import (
    _bwd_common,
    _images,
    mse_image_cotangent,
    pack_table,
)
from generativedensification_torch.splat.projection import project_gaussians
from generativedensification_torch.splat import surfel, surfel_kernels
from generativedensification_torch.tools import scenes

torch.set_num_threads(1)


def _scene(n, seed, dev, hw=64, scale=4.0):
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    means = f(rng.uniform(-0.45, 0.45, size=(n, 3)))
    shs = f(rng.normal(size=(n, 4, 3)) * 0.3 + 0.2)
    opa = torch.sigmoid(f(rng.normal(size=(n,)) - 1.0))
    scales = f(scale * np.exp(rng.uniform(np.log(0.002), np.log(0.01), size=(n, 3))))
    quats = normalize_quat(f(rng.normal(size=(n, 4))))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.9
    cam = Camera.from_c2w(f(c2w), 0.8, 0.8, hw, hw, znear=0.1, zfar=10.0)
    return project_gaussians(means, shs, opa, cam, 1, scales, quats)


def _inputs(proj, hw, ts, max_tiles=9):
    bins = bin_gaussians(proj, hw, hw, tile_size=ts, max_tiles=max_tiles)
    table = pack_table(proj.xy, proj.conic, proj.color, proj.opacity,
                       proj.depth, proj.valid)
    return (table, bins.sorted_ids, bins.tile_starts, bins.tile_counts,
            bins.tiles_x, bins.tiles_y, ts)


def _serial_reference(table, ids, starts, counts, tiles_x, tiles_y, ts):
    """One pixel at a time, one slot at a time, in float32 scalars."""
    f = np.float32
    tab = table.numpy()
    out = np.zeros((tiles_x * tiles_y, 5, ts * ts), np.float32)
    for t in range(tiles_x * tiles_y):
        ox, oy = f((t % tiles_x) * ts), f((t // tiles_x) * ts)
        seg = ids.numpy()[starts[t]: starts[t] + counts[t]]
        for p in range(ts * ts):
            px, py = f(p % ts), f(p // ts)
            T, acc = f(1.0), np.zeros(4, np.float32)
            for g in seg:
                x, y, a, b, c, opa, r, gg, bl, z, valid, _ = tab[g]
                dx, dy = px - (x - ox), py - (y - oy)
                power = min(f(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy, f(0))
                alpha = min(f(0.99), (opa if valid > 0 else f(0)) * f(math.exp(power)))
                if alpha < f(1.0 / 255.0):
                    continue
                U = T * (f(1) - alpha)
                if U < f(1e-4):
                    break
                acc += alpha * T * np.asarray([r, gg, bl, z], np.float32)
                T = U
            out[t, :4, p] = acc
            out[t, 4, p] = f(1) - T
    return out


@pytest.mark.parametrize("ts", [16, 32])
def test_plain_version_matches_serial_reference(ts):
    proj = _scene(600, seed=0, dev="cpu", hw=32)
    args = _inputs(proj, 32, ts)
    with torch.inference_mode():
        out = kernels.composite_fwd(*args)          # CPU tensor -> plain
    ref = _serial_reference(*args)
    assert ref[:, 4].max() > 0.5
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)


def test_wrapper_checks_inputs():
    proj = _scene(50, seed=1, dev="cpu")
    table, ids, starts, counts, tx, ty, ts = _inputs(proj, 64, 16)
    with pytest.raises(ValueError, match="table"):
        kernels.composite_fwd(table.double(), ids, starts, counts, tx, ty, ts)
    with pytest.raises(ValueError, match="int32"):
        kernels.composite_fwd(table, ids.long(), starts, counts, tx, ty, ts)
    with pytest.raises(ValueError, match="one entry per tile"):
        kernels.composite_fwd(table, ids, starts[:-1], counts, tx, ty, ts)


def _bwd_inputs(args, seed):
    """The backward's gc4 / G2 from a forward and a seeded ground truth
    (the selection pass's image-MSE cotangent plus seeded alpha and depth
    cotangents, so that every row of the full mode is exercised)."""
    table, ids, starts, counts, tx, ty, ts = args
    out = kernels.composite_fwd(*args)
    bg = torch.ones(3, device=table.device)
    image, alpha, depth = _images(out, bg, tx, ty, ts)
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=table.device)
    gt = f(rng.uniform(size=tuple(image.shape)))
    cot = (mse_image_cotangent(image, gt), f(rng.normal(size=tuple(alpha.shape)) * 1e-4),
           f(rng.normal(size=tuple(depth.shape)) * 1e-4))
    gc4, g2, _ = _bwd_common(out, bg, cot, tx, ty, ts)
    return gc4, g2


def test_bwd_plain_modes_agree():
    """noabs is full's first ten rows and selonly its last two."""
    proj = _scene(600, seed=5, dev="cpu", hw=32)
    args = _inputs(proj, 32, 16)
    gc4, g2 = _bwd_inputs(args, seed=0)
    rows = {m: kernels.composite_bwd(*args[:4], gc4, g2, *args[4:], mode=m)
            for m in kernels.BWD_ROWS}
    assert float(rows["selonly"].abs().max()) > 0
    torch.testing.assert_close(rows["noabs"], rows["full"][:, :10], rtol=0, atol=0)
    torch.testing.assert_close(rows["selonly"], rows["full"][:, 10:], rtol=0, atol=0)
    assert kernels.launch_counts["composite_bwd"] == 0  # CPU: no launch


def test_bwd_wrapper_checks_inputs():
    proj = _scene(50, seed=1, dev="cpu")
    args = _inputs(proj, 64, 16)
    gc4, g2 = _bwd_inputs(args, seed=1)
    with pytest.raises(ValueError, match="mode"):
        kernels.composite_bwd(*args[:4], gc4, g2, *args[4:], mode="abs")
    with pytest.raises(ValueError, match="gc4"):
        kernels.composite_bwd(*args[:4], gc4[:, :3], g2, *args[4:])
    with pytest.raises(ValueError, match="g2"):
        kernels.composite_bwd(*args[:4], gc4, g2.double(), *args[4:])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA compositor has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
def test_cuda_kernel_matches_plain(cuda_device, ts):
    """The CUDA compositor against its plain version on the card, 256²."""
    with torch.inference_mode():
        proj = _scene(20000, seed=3, dev=cuda_device, hw=256, scale=2.0)
        args = _inputs(proj, 256, ts)
        before = kernels.launch_counts["composite_fwd"]
        out = kernels.composite_fwd(*args)
        torch.cuda.synchronize()
        assert kernels.launch_counts["composite_fwd"] == before + 1
        ref = kernels.composite_fwd_plain(*args)
    assert float(out[:, 4].max()) > 0.5
    torch.testing.assert_close(out, ref, atol=2e-4, rtol=0)


@pytest.mark.gpu
def test_cuda_wrapper_refuses_other_tiles(cuda_device):
    proj = _scene(100, seed=4, dev=cuda_device)
    args = _inputs(proj, 64, 8)
    with pytest.raises(ValueError, match="16 or 32"):
        kernels.composite_fwd(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["full", "noabs", "selonly"])
@pytest.mark.parametrize("ts", [16, 32])
def test_cuda_bwd_matches_plain_and_repeats(cuda_device, ts, mode):
    """The CUDA backward against its plain version on the card, 256²: each
    row scaled by its max |value| agrees to 5e-5 (the JAX gradient
    contract), and two launches give bitwise the same output."""
    with torch.inference_mode():
        proj = _scene(20000, seed=6, dev=cuda_device, hw=256, scale=2.0)
        args = _inputs(proj, 256, ts)
        gc4, g2 = _bwd_inputs(args, seed=2)
        before = kernels.launch_counts["composite_bwd"]
        out = kernels.composite_bwd(*args[:4], gc4, g2, *args[4:], mode=mode)
        again = kernels.composite_bwd(*args[:4], gc4, g2, *args[4:], mode=mode)
        torch.cuda.synchronize()
        assert kernels.launch_counts["composite_bwd"] == before + 2
        ref = kernels.composite_bwd_plain(*args[:4], gc4, g2, *args[4:], mode=mode)
    assert torch.equal(out, again)
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    assert float(scale.min()) > 0
    torch.testing.assert_close(out / scale, ref / scale, atol=5e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
def test_cuda_kernels_on_adversarial_scene(cuda_device, ts):
    """Kernels #1 and #2 on the footprint skip's adversarial scene
    (``tools/scenes.py``: saturating tiles, Gaussians just outside sub-tile
    edges with alpha within 0.1% of 1/255 there, opacities at 1/255,
    near-singular conics, invalid rows): the forward bitwise equal to its
    plain version, every backward mode within 5e-5 scaled and bitwise
    repeatable."""
    with torch.inference_mode():
        args, _, _ = scenes.adversarial_scene(cuda_device, ts)
        out = kernels.composite_fwd(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, kernels.composite_fwd_plain(*args))
        gc4, g2 = _bwd_inputs(args, seed=4)
        for mode in kernels.BWD_ROWS:
            bargs = (*args[:4], gc4, g2, *args[4:])
            a = kernels.composite_bwd(*bargs, mode=mode)
            b = kernels.composite_bwd(*bargs, mode=mode)
            torch.cuda.synchronize()
            ref = kernels.composite_bwd_plain(*bargs, mode=mode)
            assert torch.equal(a, b), mode
            scale = ref.abs().amax(dim=0).clamp(min=1e-30)
            torch.testing.assert_close(a / scale, ref / scale, atol=5e-5, rtol=0)


# --------------------------------------------------------------------------
# the 2DGS surfel kernels
# --------------------------------------------------------------------------


def _surfel_inputs(n, seed, dev, hw=32, ts=16, max_tiles=16):
    """A seeded surfel scene (the JAX backend-parity scene's distributions),
    set up and binned by the port: the kernels' inputs."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    means = f(rng.uniform(-0.35, 0.35, (n, 3)))
    shs = f(rng.normal(size=(n, 4, 3)) * 0.3 + 0.2)
    opa = torch.sigmoid(f(rng.normal(size=(n,))))
    scales = f(np.exp(rng.uniform(np.log(0.05), np.log(0.15), (n, 2))) * 64 / hw)
    quats = normalize_quat(f(rng.normal(size=(n, 4))))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.6
    cam = Camera.from_c2w(f(c2w), 0.8, 0.8, hw, hw, znear=0.2, zfar=4.0)
    si = surfel.surfel_inputs(means, shs, opa, scales, quats, cam, 1, ts,
                              max_tiles, 256, enum_tiles=max_tiles)
    table = surfel.pack_surfel_table(*si.attrs)
    ids, _, _, starts, counts = si.bins
    return (table, ids, starts, counts, si.planes, *si.dims), si


def _surfel_serial_reference(table, ids, starts, counts, planes, tiles_x,
                             tiles_y, ts):
    """The surfel forward one pixel at a time, one slot at a time, in
    float32 scalars: the chain of ``surfel_kernels`` written out."""
    f = np.float32
    tab = table.numpy()
    znear, zfar = planes.numpy()
    F = zfar / (zfar - znear)
    out = np.zeros((tiles_x * tiles_y, 13, ts * ts), np.float32)
    for t in range(tiles_x * tiles_y):
        seg = ids.numpy()[starts[t]: starts[t] + counts[t]]
        for p in range(ts * ts):
            X, Y = f((t % tiles_x) * ts + p % ts), f((t // tiles_x) * ts + p // ts)
            T, acc = f(1.0), np.zeros(12, np.float32)
            for g in seg:
                a, b, c = tab[g, 0:3], tab[g, 3:6], tab[g, 6:9]
                det, px, py, opa = tab[g, 9:13]
                dx, dy = X - px, Y - py
                d2 = dx * dx + dy * dy
                if not d2 <= tab[g, 19] * tab[g, 19]:
                    continue
                cr = (a + X * b) + Y * c
                rz = f(1) / (f(1e-8) if abs(cr[2]) < f(1e-8) else cr[2])
                u, v = cr[0] * rz, cr[1] * rz
                power = max(f(-0.5) * (u * u + v * v), f(-0.25) * d2)
                z = det * rz
                alpha = min(f(0.99), opa * f(math.exp(power)))
                if alpha < f(1 / 255) or not z > f(0.2):
                    continue
                U = T * (f(1) - alpha)
                if U < f(1e-4):
                    break
                if T > 0.5 and U < 0.5:
                    acc[7] = z
                w = alpha * T
                m = F * (f(1) - znear / max(z, f(1e-6)))
                acc[0:6] += w * tab[g, 13:19]
                acc[6] += w * z
                acc[9:12] += w * np.asarray([1, m, m * m], np.float32)
                T = U
            acc[8] = acc[9] * acc[11] - acc[10] * acc[10]
            out[t, :12, p] = acc
            out[t, 12, p] = T
    return out


@pytest.mark.parametrize("ts", [16, 32])
def test_surfel_plain_matches_serial_reference(ts):
    args, si = _surfel_inputs(24, seed=0, dev="cpu", ts=ts)
    with torch.inference_mode():
        out = surfel_kernels.surfel_fwd(*args)      # CPU tensor -> plain
    ref = _surfel_serial_reference(*args)
    assert ref[:, 12].min() < 0.5 and (ref[:, 7] > 0).any()
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_surfel_wrappers_check_inputs():
    args, si = _surfel_inputs(20, seed=1, dev="cpu")
    table, ids, starts, counts, planes, tx, ty, ts = args
    with pytest.raises(ValueError, match="table"):
        surfel_kernels.surfel_fwd(table[:, :20].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="planes"):
        surfel_kernels.surfel_fwd(table, ids, starts, counts, planes[:1], tx, ty, ts)
    with pytest.raises(ValueError, match="int32"):
        surfel_kernels.surfel_fwd(table, ids.long(), starts, counts, planes, tx, ty, ts)
    cot8 = torch.zeros((tx * ty, 8, ts * ts))
    aux5 = torch.zeros((tx * ty, 5, ts * ts))
    with pytest.raises(ValueError, match="mode"):
        surfel_kernels.surfel_bwd(*args[:5], cot8, aux5, tx, ty, ts, mode="noabs")
    with pytest.raises(ValueError, match="aux5"):
        surfel_kernels.surfel_bwd(*args[:5], cot8, aux5[:, :4], tx, ty, ts)


def _surfel_bwd_inputs(args, si, seed):
    """cot8 / aux5 from a forward, the image-MSE cotangent of a seeded
    ground truth and seeded cotangents on the other five maps."""
    table = args[0]
    out = surfel_kernels.surfel_fwd(*args)
    bg = torch.ones(3, device=table.device)
    maps = surfel._maps(out, bg, *si.dims)
    rng = np.random.default_rng(seed)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=table.device)
    gt = f(rng.uniform(size=tuple(maps[0].shape)))
    cot = (mse_image_cotangent(maps[0], gt),
           *(f(rng.normal(size=tuple(m.shape)) * 1e-4) for m in maps[1:]))
    return {mode: surfel._bwd_rows(out, bg, cot, si.dims, mode)[:2]
            for mode in surfel_kernels.SURFEL_BWD_ROWS}


def test_surfel_bwd_selonly_is_the_screen_gradient():
    """``selonly``'s Σ_pixels |d/dscreen x| against the signed rows of
    ``full`` under the same image-only cotangent: a screen move shifts acr by
    -bcr·ox and the center by ox, so |-(d_acr · bcr) + d_px| = |Σ gx| can
    not exceed it, slot by slot."""
    args, si = _surfel_inputs(24, seed=2, dev="cpu")
    rows = _surfel_bwd_inputs(args, si, seed=0)
    sel = surfel_kernels.surfel_bwd(*args[:5], *rows["selonly"], *args[5:],
                                    mode="selonly")
    cot8, aux5 = rows["selonly"]
    full = surfel_kernels.surfel_bwd(*args[:5], cot8, aux5, *args[5:], mode="full")
    table = args[0]
    gx = -(full[:, 0:3] * table[args[1].long(), 3:6]).sum(-1) + full[:, 10]
    assert float(sel[:, 0].max()) > 0
    assert bool((sel[:, 0] >= gx.abs() - 1e-6 * float(sel[:, 0].max())).all())
    assert not any(kernels.launch_counts[k] for k in ("surfel_fwd", "surfel_bwd"))


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
def test_cuda_surfel_fwd_matches_plain(cuda_device, ts):
    """The CUDA surfel compositor against its plain version on the card,
    256², bitwise (the screen-circle skip drops only pairs that fail the
    circle test at every pixel of a sub-tile)."""
    with torch.inference_mode():
        args, _ = _surfel_inputs(3000, seed=3, dev=cuda_device, hw=256, ts=ts)
        before = kernels.launch_counts["surfel_fwd"]
        out = surfel_kernels.surfel_fwd(*args)
        torch.cuda.synchronize()
        assert kernels.launch_counts["surfel_fwd"] == before + 1
        ref = surfel_kernels.surfel_fwd_plain(*args)
    assert float(out[:, 12].min()) < 0.5
    assert torch.equal(out, ref), float((out - ref).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["full", "selonly"])
@pytest.mark.parametrize("ts", [16, 32])
def test_cuda_surfel_bwd_matches_plain_and_repeats(cuda_device, ts, mode):
    """The CUDA surfel backward against its plain version on the card, 256²:
    each row scaled by its max |value| within 5e-5, and two launches
    bitwise equal."""
    with torch.inference_mode():
        args, si = _surfel_inputs(3000, seed=6, dev=cuda_device, hw=256, ts=ts)
        cot8, aux5 = _surfel_bwd_inputs(args, si, seed=2)[mode]
        bargs = (*args[:5], cot8, aux5, *args[5:])
        before = kernels.launch_counts["surfel_bwd"]
        out = surfel_kernels.surfel_bwd(*bargs, mode=mode)
        again = surfel_kernels.surfel_bwd(*bargs, mode=mode)
        torch.cuda.synchronize()
        assert kernels.launch_counts["surfel_bwd"] == before + 2
        ref = surfel_kernels.surfel_bwd_plain(*bargs, mode=mode)
    assert torch.equal(out, again)
    scale = ref.abs().amax(dim=0).clamp(min=1e-30)
    assert float(scale.min()) > 0
    torch.testing.assert_close(out / scale, ref / scale, atol=5e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
def test_cuda_surfel_kernels_on_adversarial_scene(cuda_device, ts):
    """Kernels #3 and #4 on the screen-circle skip's adversarial scene
    (``tools/scenes.py``: saturating tiles, circles grazing sub-tile edges
    and corners by a few ulps, radius 0 and 1 on pixel centres, edge-on
    surfels, non-finite rows): the forward bitwise equal to its plain
    version, both backward modes within 5e-5 scaled and bitwise
    repeatable."""
    with torch.inference_mode():
        args, si = scenes.surfel_adversarial_scene(cuda_device, ts)
        out = surfel_kernels.surfel_fwd(*args)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all())
        assert torch.equal(out, surfel_kernels.surfel_fwd_plain(*args))
        rows = _surfel_bwd_inputs(args, si, seed=4)
        for mode in surfel_kernels.SURFEL_BWD_ROWS:
            bargs = (*args[:5], *rows[mode], *args[5:])
            a = surfel_kernels.surfel_bwd(*bargs, mode=mode)
            b = surfel_kernels.surfel_bwd(*bargs, mode=mode)
            torch.cuda.synchronize()
            ref = surfel_kernels.surfel_bwd_plain(*bargs, mode=mode)
            assert torch.equal(a, b), mode
            scale = ref.abs().amax(dim=0).clamp(min=1e-30)
            torch.testing.assert_close(a / scale, ref / scale, atol=5e-5, rtol=0)


# --------------------------------------------------------------------------
# the slot reductions: reduce_slots (TPU pallas_reduce_slots) and
# transpose_rows (TPU pallas_transpose16)
# --------------------------------------------------------------------------


def _slot_rows(n, d, w, seed, dev="cpu"):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(n * d, w)).astype(np.float32)
    rows[rng.uniform(size=n * d) < 0.3] = 0.0      # dead slots are zero rows
    return torch.as_tensor(rows, device=dev)


def test_reduce_and_transpose_plain_versions():
    """``reduce_slots_plain`` adds each group's rows in order (bitwise a
    left-to-right loop; equal to ``sum(1)`` to rounding);
    ``transpose_rows_plain`` is ``.t()`` exactly; the wrappers take the
    plain versions on the CPU and check their inputs."""
    rows = _slot_rows(37, 9, 10, seed=1)
    red = kernels.reduce_slots(rows, 37, 9)
    loop = rows.view(37, 9, 10)[:, 0]
    for k in range(1, 9):
        loop = loop + rows.view(37, 9, 10)[:, k]
    assert torch.equal(red, loop)
    torch.testing.assert_close(red, rows.view(37, 9, 10).sum(1), atol=1e-5, rtol=0)
    assert torch.equal(kernels.reduce_slots(rows[:37], 37, 1), rows[:37])
    cols = _slot_rows(1, 19, 50, seed=2)
    assert torch.equal(kernels.transpose_rows(cols), cols.t())
    assert kernels.launch_counts["reduce_slots"] == 0     # CPU: no launch
    assert kernels.launch_counts["transpose_rows"] == 0
    with pytest.raises(ValueError, match="n·d"):
        kernels.reduce_slots(rows, 36, 9)
    with pytest.raises(ValueError, match="float32"):
        kernels.reduce_slots(rows.double(), 37, 9)
    with pytest.raises(ValueError, match="float32"):
        kernels.transpose_rows(cols[0])


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 10, 12, 19])
def test_cuda_reduce_slots_matches_plain(cuda_device, w):
    """The CUDA segmented sum bitwise equal to its plain version at the
    widths the backwards write (3DGS 12 / 10 / 2, surfels 19 / 2), at a
    scene-B size and at a ragged small one."""
    for n, d in ((262_144, 9), (1000, 4)):
        rows = _slot_rows(n, d, w, seed=w, dev=cuda_device)
        before = kernels.launch_counts["reduce_slots"]
        out = kernels.reduce_slots(rows, n, d)
        torch.cuda.synchronize()
        assert kernels.launch_counts["reduce_slots"] == before + 1
        assert torch.equal(out, kernels.reduce_slots_plain(rows, n, d))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 10, 12, 19, 40])
def test_cuda_transpose_rows_matches_plain(cuda_device, w):
    """The CUDA transpose bitwise equal to its plain version, (w, M) with M
    a multiple of the tile and not, and w above one tile's 32 rows."""
    for M in (262_144, 1001):
        cols = _slot_rows(1, w, M, seed=w, dev=cuda_device)
        before = kernels.launch_counts["transpose_rows"]
        out = kernels.transpose_rows(cols)
        torch.cuda.synchronize()
        assert kernels.launch_counts["transpose_rows"] == before + 1
        assert torch.equal(out, kernels.transpose_rows_plain(cols))
