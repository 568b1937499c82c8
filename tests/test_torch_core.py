"""PyTorch port vs the JAX package: core math, projection, binning, and the
port's import / device contracts.  Inputs are numpy arrays made from a seed
and handed to both packages."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativedensification_tpu.core import camera as jcam
from generativedensification_tpu.core import rays as jrays
from generativedensification_tpu.core import sh as jsh
from generativedensification_tpu.core import transforms as jtf
from generativedensification_tpu.core import activations as jact
from generativedensification_tpu.splat import binning as jbin
from generativedensification_tpu.splat import projection as jproj
from generativedensification_torch.core import activations as tact
from generativedensification_torch.core import camera as tcam
from generativedensification_torch.core import rays as trays
from generativedensification_torch.core import sh as tsh
from generativedensification_torch.core import transforms as ttf
from generativedensification_torch.splat import binning as tbin
from generativedensification_torch.splat import projection as tproj

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), **(tol or CORE_TOL))


def _t(x):
    return torch.from_numpy(np.array(x))


def _camera(W=64, H=48, dist=1.9, fov=0.8):
    c2w = np.eye(4, dtype=np.float32)
    rot = np.linalg.qr(np.random.default_rng(5).normal(size=(3, 3)))[0]
    c2w[:3, :3] = rot if np.linalg.det(rot) > 0 else -rot
    c2w[:3, 3] = -dist * c2w[:3, 2]
    jc = jcam.Camera.from_c2w(jnp.asarray(c2w), fov, fov, W, H, znear=0.1, zfar=10.0)
    tc = tcam.Camera.from_c2w(_t(c2w), fov, fov, W, H, znear=0.1, zfar=10.0)
    return jc, tc


class TestCore:
    def test_transforms(self):
        rng = np.random.default_rng(0)
        q = rng.normal(size=(64, 4)).astype(np.float32)
        s = rng.uniform(0.2, 1.5, size=(64, 3)).astype(np.float32)
        _close(jtf.normalize_quat(q), ttf.normalize_quat(_t(q)))
        qn = np.asarray(jtf.normalize_quat(q))
        _close(jtf.quat_to_rotmat(qn), ttf.quat_to_rotmat(_t(qn)))
        _close(jtf.build_covariance(s, q), ttf.build_covariance(_t(s), _t(q)))
        cov = np.asarray(jtf.build_covariance(s, q))
        _close(jtf.covariance_to_symm6(cov), ttf.covariance_to_symm6(_t(cov)))

    @pytest.mark.parametrize("degree", [0, 1, 3, 8])
    def test_rsh_cart(self, degree):
        d = np.random.default_rng(1).normal(size=(200, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        _close(jsh.rsh_cart(d, degree), tsh.rsh_cart(_t(d), degree))

    @pytest.mark.parametrize("degree", [0, 1, 2, 3])
    def test_eval_sh_color(self, degree):
        rng = np.random.default_rng(2)
        shs = rng.normal(size=(100, (degree + 1) ** 2, 3)).astype(np.float32)
        dirs = rng.normal(size=(100, 3)).astype(np.float32)
        _close(jsh.eval_sh_color(shs, dirs, degree),
               tsh.eval_sh_color(_t(shs), _t(dirs), degree))

    def test_camera_and_rays(self):
        jc, tc = _camera()
        for f in ("world_view_transform", "full_proj_transform", "camera_center",
                  "tan_half_fovx", "tan_half_fovy", "znear", "zfar"):
            _close(getattr(jc, f), getattr(tc, f))
        _close(jc.focal_x, tc.focal_x)
        _close(jcam.get_projection_matrix(0.1, 10.0, 0.8, 0.6),
               tcam.get_projection_matrix(torch.tensor(0.1), torch.tensor(10.0),
                                          torch.tensor(0.8), torch.tensor(0.6)))
        _close(jrays.camera_rays(jc), trays.camera_rays(tc))
        rays = np.random.default_rng(3).normal(size=(5, 7, 6)).astype(np.float32)
        _close(jrays.rays_to_plucker(rays), trays.rays_to_plucker(_t(rays)))

    def test_activations(self):
        x = np.linspace(-20, 20, 101).astype(np.float32)
        _close(jact.trunc_exp(x), tact.trunc_exp(_t(x)))
        xt = _t(x).requires_grad_(True)
        tact.trunc_exp(xt).sum().backward()
        _close(jax.grad(lambda v: jact.trunc_exp(v).sum())(jnp.asarray(x)), xt.grad)
        y = np.linspace(0, 1, 33).astype(np.float32)
        _close(jact.inverse_sigmoid(y), tact.inverse_sigmoid(_t(y)), rtol=1e-5, atol=1e-5)
        assert tact.coarse_scale_shift(1 / 32) == jact.coarse_scale_shift(1 / 32)
        assert tact.fine_scale_shift(1 / 32) == jact.fine_scale_shift(1 / 32)
        assert tact.opacity_shift() == jact.opacity_shift()


def _scene(n=400, seed=0, spread=0.45, smin=0.005, smax=0.04):
    rng = np.random.default_rng(seed)
    f = lambda x: np.asarray(x, np.float32)
    return dict(
        means=f(rng.uniform(-spread, spread, (n, 3))),
        shs=f(rng.normal(size=(n, 4, 3)) * 0.3 + 0.2),
        opa=f(1 / (1 + np.exp(-(rng.normal(size=n) - 1.0)))),
        scales=f(np.exp(rng.uniform(np.log(smin), np.log(smax), (n, 3)))),
        quats=f(rng.normal(size=(n, 4))),
    )


def _project_both(sc, W=64, H=48):
    jc, tc = _camera(W, H)
    qn = np.asarray(jtf.normalize_quat(sc["quats"]))
    jp = jproj.project_gaussians(
        jnp.asarray(sc["means"]), None, jnp.asarray(sc["shs"]),
        jnp.asarray(sc["opa"]), jc, 1, scales=jnp.asarray(sc["scales"]),
        rotations=jnp.asarray(qn))
    tp = tproj.project_gaussians(
        _t(sc["means"]), _t(sc["shs"]), _t(sc["opa"]), tc, 1,
        _t(sc["scales"]), _t(qn))
    return jp, tp


class TestProjection:
    def test_matches_jax(self):
        jp, tp = _project_both(_scene())
        np.testing.assert_array_equal(np.asarray(jp.valid), tp.valid.numpy())
        v = np.asarray(jp.valid)
        assert v.sum() > 100
        for f in ("xy", "depth", "conic", "color", "opacity"):
            np.testing.assert_allclose(
                np.asarray(getattr(jp, f))[v], getattr(tp, f).numpy()[v],
                atol=1e-5, err_msg=f)
        # radius = ceil(3 sqrt(lambda1)) may flip by one between two
        # implementations' rounding; the cull is safe, so only <=0.1% of
        # radii may differ, and by exactly one pixel
        dr = np.abs(np.asarray(jp.radius) - tp.radius.numpy())
        assert dr.max() <= 1.0
        assert (dr > 0).mean() <= 1e-3

    def test_constants(self):
        for k in ("NEAR_CULL", "LOWPASS", "RADIUS_SIGMA", "FOV_CLAMP"):
            assert getattr(tproj, k) == getattr(jproj, k)


class TestBinning:
    @pytest.mark.parametrize("ts,max_tiles,enum_tiles,max_pairs", [
        (16, 4, None, None),
        (32, 4, None, None),
        (16, 2, 9, None),       # enumerate + compact, overflowing budget
        (16, 4, None, 300),     # live-pair budget drops the farthest pairs
    ])
    def test_same_integer_arrays(self, ts, max_tiles, enum_tiles, max_pairs):
        jp, _ = _project_both(_scene(seed=4, smax=0.08))
        # identical projected inputs for both binnings
        tp = tproj.ProjectedGaussians(
            **{f: _t(getattr(jp, f)) for f in
               ("xy", "depth", "conic", "color", "opacity", "radius", "valid")})
        kw = dict(tile_size=ts, max_tiles=max_tiles, enum_tiles=enum_tiles,
                  max_pairs=max_pairs)
        jb = jax.jit(lambda p: jbin.bin_gaussians(p, 48, 64, **kw))(jp)
        tb = tbin.bin_gaussians(tp, 48, 64, **kw)
        eq = lambda a, b: np.testing.assert_array_equal(np.asarray(a), b.numpy())
        for f in ("sorted_valid", "depth_order", "tile_starts", "tile_counts",
                  "overflow"):
            eq(getattr(jb, f), getattr(tb, f))
        live = np.asarray(jb.sorted_valid)
        for f in ("sorted_ids", "sorted_o", "sorted_rank"):
            np.testing.assert_array_equal(np.asarray(getattr(jb, f))[live],
                                          getattr(tb, f).numpy()[live])
        assert (jb.tiles_x, jb.tiles_y) == (tb.tiles_x, tb.tiles_y)
        if enum_tiles or max_pairs:
            assert int(tb.overflow) > 0


def test_port_imports_no_jax():
    """Importing every port module pulls in neither JAX nor the JAX
    package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import generativedensification_torch as g\n"
        "for m in pkgutil.walk_packages(g.__path__, g.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k.startswith('generativedensification_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means CUDA: without a card the entry points raise
    instead of moving to the CPU."""
    from generativedensification_torch.data.synthetic import make_probe_batch
    from generativedensification_torch.models.network import Network, NetworkConfig
    from generativedensification_torch.splat.rasterizer import Renderer
    from generativedensification_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = NetworkConfig(encoder_backbone="tiny_test", num_layers=1,
                        embedding_dim=8, num_heads=2, view_embed_dim=4,
                        n_groups=(2,), vol_feat_reso=2, vol_embedding_reso=2,
                        vol_embedding_out_dim=4)
    for make in (lambda: resolve_device(None), lambda: Network(cfg),
                 lambda: make_probe_batch(1, 2, 32, 32, 2), lambda: Renderer()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert resolve_device("cpu").type == "cpu"


def test_config_copy_matches():
    from generativedensification_tpu.config import defaults as jdef
    from generativedensification_torch.config import defaults as tdef
    from generativedensification_torch.config import from_dotlist, merge, to_dict

    assert tdef.BASE == jdef.BASE and tdef.INFER == jdef.INFER
    # the port's NetworkConfig reads the same values from one config tree
    import dataclasses

    from generativedensification_tpu.models.network import NetworkConfig as JNC
    from generativedensification_torch.models.network import NetworkConfig as TNC

    over = ["model.num_layers=3", "tpu.tile_size=16", "tpu.enum_tiles=9"]
    from generativedensification_tpu.config import confignode as jcn

    jn = JNC.from_config(jcn.merge(jdef.default_config(), jcn.from_dotlist(over)))
    tn = TNC.from_config(merge(tdef.default_config(), from_dotlist(over)))
    for f in dataclasses.fields(tn):
        assert getattr(tn, f.name) == getattr(jn, f.name), f.name
    assert (tn.num_layers, tn.tile_size, tn.enum_tiles) == (3, 16, 9)
    cfg = merge(tdef.default_config(), from_dotlist(["model.k_num=8000", "train.lr=1e-5"]))
    assert cfg.model.k_num == 8000 and cfg.train.lr == 1e-5
    assert to_dict(cfg)["train_dataset"]["n_group"] == "${n_views}"
    assert cfg.train_dataset.n_group == 4
