"""PyTorch port vs the JAX package: the evaluation tools.

``rotmat_to_quat``, ``slerp`` / ``interpolate_poses``, each orbit path of
``tools/video_path.py`` (the cameras' ``world_view_transform`` and
``full_proj_transform`` at 1e-6), TSDF fusion and marching tetrahedra on
the same RGB-D inputs (the volume's arrays bitwise, vertex and face arrays
equal), the mesh turntable, the PNG writer, the LPIPS weight tool, the
copied data tools byte for byte, and the counterparts of
``tests/test_tools.py::TestDownloadTools`` / ``TestCo3DPrep``."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativedensification_tpu.core import transforms as jtf
from generativedensification_tpu.tools import mesh_extractor as jme
from generativedensification_tpu.tools import mesh_render as jmr
from generativedensification_tpu.tools import pose_interp as jpi
from generativedensification_tpu.tools import video_path as jvp
from generativedensification_torch.core import transforms as ttf
from generativedensification_torch.core.camera import Camera as TCamera
from generativedensification_torch.tools import mesh_extractor as tme
from generativedensification_torch.tools import mesh_render as tmr
from generativedensification_torch.tools import pose_interp as tpi
from generativedensification_torch.tools import video_path as tvp

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPIED = ("hdf5_tools", "prepare_dataset", "pose_groups", "prepare_co3d", "download",
          "convert_lpips")


def _random_rotations(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(jtf.quat_to_rotmat(jnp.asarray(q)))


def test_rotmat_to_quat_matches_jax():
    """Random rotations plus the four branch cases (identity and the
    half-turns about x, y, z): 1e-6, and the round trip."""
    R = np.concatenate([_random_rotations(200, 0),
                        np.stack([np.eye(3), np.diag([1, -1, -1]), np.diag([-1, 1, -1]),
                                  np.diag([-1, -1, 1])]).astype(np.float32)])
    j = np.asarray(jtf.rotmat_to_quat(jnp.asarray(R)))
    t = ttf.rotmat_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    back = ttf.quat_to_rotmat(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(back, R, atol=1e-5)


def test_slerp_and_interpolate_poses_match_jax():
    q0 = np.array([1.0, 0, 0, 0], np.float32)
    q1 = np.array([np.cos(0.6), 0.3, np.sin(0.6), 0.1], np.float32)
    q1 /= np.linalg.norm(q1)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(tpi.slerp(q0, q1, t), jpi.slerp(q0, q1, t))
    rng = np.random.default_rng(1)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    c2ws[:, :3, :3] = _random_rotations(5, 2)
    c2ws[:, :3, 3] = rng.uniform(-1, 1, (5, 3))
    for order in (True, False):
        j = jpi.interpolate_poses(c2ws, 4, order_poses=order)
        t = tpi.interpolate_poses(c2ws, 4, order_poses=order)
        assert t.shape == j.shape == (17, 4, 4)
        np.testing.assert_allclose(t, j, atol=1e-6, rtol=0)
    # 3x4 keyframes are padded
    np.testing.assert_allclose(tpi.interpolate_poses(c2ws[:, :3], 2),
                               jpi.interpolate_poses(c2ws[:, :3], 2), atol=1e-6)


def _same_cameras(jcams, tcams):
    assert len(jcams) == len(tcams) and len(tcams) > 0
    for jc, tc in zip(jcams, tcams):
        assert (tc.height, tc.width) == (jc.height, jc.width)
        assert tc.world_view_transform.device.type == "cpu"
        for f in ("world_view_transform", "full_proj_transform"):
            np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                       atol=1e-6, rtol=1e-6, err_msg=f)


def test_video_paths_match_jax():
    """Every path of ``tools/video_path.py``: the gobjverse and instant3d
    orbits (default and given transforms, elevations), the interpolated
    path, and the two dispatchers."""
    rng = np.random.default_rng(3)
    tmat = np.eye(4, dtype=np.float32)
    tmat[:3, :3] = _random_rotations(1, 4)[0]
    tmat[:3, 3] = rng.uniform(-0.2, 0.2, 3)
    for fn in ("gobjverse_frames", "instant3d_frames"):
        for t, elev in ((None, 0.0), (tmat, 30.0), (tmat, -30.0)):
            _same_cameras(getattr(jvp, fn)(6, (48, 40), t, elev),
                          getattr(tvp, fn)(6, (48, 40), t, elev, device="cpu"))
    c2ws = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    c2ws[:, :3, :3] = _random_rotations(3, 5)
    c2ws[:, :3, 3] = rng.uniform(-2, 2, (3, 3))
    _same_cameras(jvp.interpolated_frames(9, (32, 32), c2ws),
                  tvp.interpolated_frames(9, (32, 32), c2ws, device="cpu"))
    for ds in ("GSO", "synthetic", "instant3d", "mvgen"):
        _same_cameras(jvp.uni_video_path(5, ds, (32, 32), tmat),
                      tvp.uni_video_path(5, ds, (32, 32), tmat, device="cpu"))
    sample = {"tar_c2w": c2ws[None]}
    _same_cameras(jvp.uni_video_path(6, "unposed", (32, 32), sample=sample),
                  tvp.uni_video_path(6, "unposed", (32, 32), sample=sample, device="cpu"))
    for ds in ("gobjeverse", "instant3d"):
        _same_cameras(jvp.uni_mesh_path(4, ds, (32, 32), tmat),
                      tvp.uni_mesh_path(4, ds, (32, 32), tmat, device="cpu"))
    with pytest.raises(NotImplementedError):
        tvp.uni_video_path(8, "nope", (32, 32), device="cpu")


def _sphere_rgbd(jcam, radius=0.2):
    """Depth, alpha and color of a sphere at the origin seen by ``jcam``,
    ray-cast with the fusion's pinhole model."""
    H, W = jcam.height, jcam.width
    c2w = np.linalg.inv(np.asarray(jcam.world_view_transform, np.float64).T)
    fx, fy = float(jcam.focal_x), float(jcam.focal_y)
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    d_cam = np.stack([(u - (W - 1) / 2) / fx, (v - (H - 1) / 2) / fy, np.ones_like(u)], -1)
    d = d_cam @ c2w[:3, :3].T
    o = c2w[:3, 3]
    a = (d * d).sum(-1)
    b = 2 * (d @ o)
    c = o @ o - radius ** 2
    disc = b * b - 4 * a * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a), 0.0)
    p = o + t[..., None] * d
    rgb = np.clip(0.5 + p, 0, 1)
    return (rgb.astype(np.float32), t.astype(np.float32), hit.astype(np.float32))


def test_tsdf_and_marching_tetrahedra_match_jax():
    """Eight orbit views of a ray-cast sphere fused into both volumes: the
    TSDF, weight and color arrays bitwise, then the extracted vertices,
    faces and vertex colors equal."""
    aabb = np.array([[-0.3] * 3, [0.3] * 3], np.float32)
    jv = jme.TSDFVolume(aabb, voxel_size=0.02, sdf_trunc=0.04)
    tv = tme.TSDFVolume(aabb, voxel_size=0.02, sdf_trunc=0.04, device="cpu")
    assert tuple(tv.tsdf.shape) == tuple(jv.dims) == (32, 32, 32)
    for elev in (0.0, 30.0):
        for jc in jvp.gobjverse_frames(4, (48, 48), elevation=elev):
            rgb, depth, alpha = _sphere_rgbd(jc)
            jv.integrate(rgb, depth, alpha, jc)
            tc = TCamera(**{k: torch.from_numpy(np.array(getattr(jc, k))) for k in (
                "world_view_transform", "full_proj_transform", "camera_center",
                "tan_half_fovx", "tan_half_fovy", "znear", "zfar")},
                height=jc.height, width=jc.width)
            tv.integrate(*map(torch.from_numpy, (rgb, depth, alpha)), tc)
    assert float(jv.weight.max()) > 1
    np.testing.assert_array_equal(tv.tsdf.numpy(), jv.tsdf)
    np.testing.assert_array_equal(tv.weight.numpy(), jv.weight)
    np.testing.assert_array_equal(tv.color.numpy(), jv.color)
    jverts, jfaces, jcols = jv.extract_mesh()
    tverts, tfaces, tcols = tv.extract_mesh()
    assert len(jfaces) > 100
    np.testing.assert_array_equal(tverts, jverts)
    np.testing.assert_array_equal(tfaces, jfaces)
    np.testing.assert_array_equal(tcols, jcols)
    # the surface is the sphere
    r = np.linalg.norm(tverts[np.unique(tfaces)], axis=-1)
    assert abs(float(np.median(r)) - 0.2) < 0.02


def test_save_obj_and_turntable_match_jax(tmp_path):
    """``save_obj`` text and ``render_mesh`` / ``turntable_frames`` images
    equal JAX's on a unit cube."""
    v = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                  for z in (-0.5, 0.5)], np.float64)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
             (1, 5, 7, 3)]
    f = np.array([t for (a, b, c, d) in quads for t in ((a, b, c), (a, c, d))])
    cols = np.random.default_rng(0).uniform(size=(8, 3))
    c2w = jmr._look_at([0.0, 0.8, -2.5], [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(tmr._look_at([0.0, 0.8, -2.5], [0.0, 0.0, 0.0]), c2w)
    img = tmr.render_mesh(v, f, c2w, fov=0.7, size=64, colors=cols)
    np.testing.assert_array_equal(img, jmr.render_mesh(v, f, c2w, fov=0.7, size=64,
                                                       colors=cols))
    frames = tmr.turntable_frames(v, f, n_frames=2, size=48)
    np.testing.assert_array_equal(frames, jmr.turntable_frames(v, f, n_frames=2, size=48))
    assert frames.shape == (2, 48, 48, 3) and all(float(fr.min()) < 0.9 for fr in frames)
    tme.save_obj(tmp_path / "t.obj", v, f, cols)
    jme.save_obj(tmp_path / "j.obj", v, f, cols)
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()


def test_png_roundtrip(tmp_path):
    """The port's PNG writer: the decoded pixels are the uint8 array the
    JAX evaluation encodes (clip, scale by 255, truncate), RGB and gray."""
    from generativedensification_torch.utils.image_io import read_png, to_uint8, write_png

    img = np.random.default_rng(0).uniform(-0.1, 1.1, (37, 53, 3)).astype(np.float32)
    expect = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(to_uint8(img), expect)
    write_png(tmp_path / "a.png", to_uint8(img))
    assert (tmp_path / "a.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(read_png(tmp_path / "a.png"), expect)
    write_png(tmp_path / "g.png", expect[..., 0])
    np.testing.assert_array_equal(read_png(tmp_path / "g.png"), expect[..., 0])
    with pytest.raises(ValueError):
        write_png(tmp_path / "f.png", img)


@pytest.mark.parametrize("name", COPIED)
def test_copied_tools_are_the_jax_files(name):
    """The JAX-free tools are the JAX package's files, byte for byte but for
    the package name in their usage strings."""
    port = (ROOT / "generativedensification_torch/tools" / f"{name}.py").read_bytes()
    ref = (ROOT / "generativedensification_tpu/tools" / f"{name}.py").read_bytes()
    assert port == ref.replace(b"generativedensification_tpu",
                               b"generativedensification_torch")
    assert (ROOT / "generativedensification_torch/tools/metric_co3d.py").read_bytes() \
        == (ROOT / "metric_co3d.py").read_bytes()


def test_lpips_random_weights_and_convert():
    """``random_weights`` equals JAX's for both backbones; ``convert``
    without a backbone file needs torchvision, as JAX's does."""
    from generativedensification_tpu.tools import convert_lpips as jcl
    from generativedensification_torch.tools import convert_lpips as tcl

    for net in ("vgg", "alex"):
        a, b = tcl.random_weights(net, seed=4), jcl.random_weights(net, seed=4)
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    try:
        import torchvision  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            tcl.convert("vgg", None, None)


def test_metric_co3d_pools_scene_weighted(tmp_path):
    import json

    from generativedensification_torch.tools.metric_co3d import pool

    for i, scenes in enumerate(({"a": {"psnr": 20.0, "ssim": 0.8}},
                                {"b": {"psnr": 30.0, "ssim": 0.9},
                                 "c": {"psnr": 25.0, "ssim": 0.7, "x": 1.0}})):
        (tmp_path / f"{i}.json").write_text(json.dumps({"scenes": scenes}))
    out = pool([tmp_path / "0.json", tmp_path / "1.json"])
    assert out == {"psnr": 25.0, "ssim": pytest.approx(0.8)}


# -- the counterparts of tests/test_tools.py's data-tool tests, on the port's
# copies


class TestDownloadTools:
    def test_url_list_local_files(self, tmp_path):
        from generativedensification_torch.tools.download import download_url_list

        src = tmp_path / "src"
        src.mkdir()
        (src / "a.bin").write_bytes(b"hello")
        (src / "b.bin").write_bytes(b"world")
        urls = [f"file://{src}/a.bin", f"file://{src}/b.bin"]
        out = tmp_path / "out"
        got = download_url_list(urls, str(out), workers=2)
        assert sorted(p.split("/")[-1] for p in got) == ["a.bin", "b.bin"]
        assert (out / "a.bin").read_bytes() == b"hello"
        got2 = download_url_list(urls, str(out), workers=2)
        assert sorted(got2) == sorted(got)

    def test_hf_gated_error(self, monkeypatch):
        from generativedensification_torch.tools import download as dl

        monkeypatch.setitem(__import__("sys").modules, "huggingface_hub", None)
        with pytest.raises((RuntimeError, ImportError)):
            dl.download_hf_folder("some/repo", "/tmp/x")


class TestCo3DPrep:
    def _rig(self, n=12, seed=0):
        rng = np.random.default_rng(seed)
        R, T = [], []
        pts = rng.normal(scale=[0.3, 0.2, 0.5], size=(500, 3)) + [1.0, -2.0, 0.5]
        for i in range(n):
            ang = 2 * np.pi * i / n
            eye = np.array([3 * np.cos(ang) + 1.0, 3 * np.sin(ang) - 2.0, 0.8])
            fwd = pts.mean(0) - eye
            fwd /= np.linalg.norm(fwd)
            right = np.cross(fwd, [0, 0, 1.0])
            right /= np.linalg.norm(right)
            up = np.cross(right, fwd)
            Rw2c = np.stack([right, up, fwd])
            R.append(Rw2c.T)
            T.append(-eye @ Rw2c.T)
        return np.stack(R), np.stack(T), pts

    def test_normalize_sequence_matches_jax(self):
        from generativedensification_tpu.tools.prepare_co3d import normalize_sequence_np as j
        from generativedensification_torch.tools.prepare_co3d import normalize_sequence_np

        R, T, pts = self._rig()
        out = normalize_sequence_np(R, T, pts, 1.0)
        assert np.abs(out[2]).max() == pytest.approx(0.475, rel=1e-5)
        for a, b in zip(out, j(R, T, pts, 1.0)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_crop_non_integer(self):
        from generativedensification_torch.tools.prepare_co3d import (
            crop_image_at_non_integer_locations,
        )

        img = np.full((3, 40, 50), 0.7, np.float32)
        out = crop_image_at_non_integer_locations(img, 10.3, 25.1, 19.7)
        assert out.shape == (3, 20, 20)
        np.testing.assert_allclose(out, 0.7, atol=1e-6)
        ramp = np.tile(np.arange(50, dtype=np.float32)[None, None], (1, 40, 1))
        out = crop_image_at_non_integer_locations(ramp, 8.0, 30.0, 20.0)
        assert out.shape == (1, 16, 16)
        np.testing.assert_allclose(out.mean(), 29.5, atol=0.6)

    def test_write_scene_h5(self, tmp_path):
        import h5py

        from generativedensification_torch.tools.prepare_co3d import write_scene_h5

        rng = np.random.default_rng(0)
        imgs = [rng.integers(0, 255, (8, 8, 4), dtype=np.uint8) for _ in range(6)]
        c2ws = []
        for i in range(6):
            m = np.eye(4, dtype=np.float32)
            m[:3, 3] = [np.cos(i), np.sin(i), 2.0]
            c2ws.append(m)
        fovs = [np.array([0.7, 0.7], np.float32)] * 6
        path = tmp_path / "co3d.h5"
        write_scene_h5(path, "seq0", imgs, c2ws, fovs, split="test")
        with h5py.File(path) as f:
            assert f["seq0/n_frames"][()] == 6
            assert f["seq0/image_0"].shape == (8, 8, 4)
            assert "groups_4_0" in f["seq0/groups"]
            assert f["splits/test"][()][0] == b"seq0"
