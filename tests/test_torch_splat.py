"""PyTorch port vs the JAX package: the forward compositor and the
rasterizer.  On the CPU the port composites through the kernel's plain
version (``tests/test_torch_kernels.py`` holds the CUDA kernel against it
on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativedensification_tpu.core.camera import Camera as JCamera
from generativedensification_tpu.splat.composite import composite_tiles as j_composite
from generativedensification_tpu.splat.rasterizer import rasterize as j_rasterize
from generativedensification_torch.core.camera import Camera as TCamera
from generativedensification_torch.splat import kernels
from generativedensification_torch.splat.composite import composite_tiles, pack_table
from generativedensification_torch.splat.rasterizer import Renderer, rasterize

torch.set_num_threads(1)

TILES = 2   # 2x2 tiles, as tests/test_pallas.py
N = 96
P = 192


def _pallas_scene(seed=0, ts=32):
    """The scene of tests/test_pallas.py::_data (same generator calls)."""
    rng = np.random.default_rng(seed)
    counts = np.asarray([70, 50, 0, 60], np.int32)
    starts = np.asarray([0, 70, 120, 120], np.int32)
    sorted_o = rng.permutation(P).astype(np.int32)
    ids = sorted_o % N
    valid = np.zeros(P, bool)
    for s, c in zip(starts, counts):
        valid[s:s + c] = True
    xy = rng.uniform(0, 2 * ts, (N, 2)).astype(np.float32)
    conic = np.tile(np.asarray([[0.08, 0.01, 0.06]], np.float32), (N, 1))
    color = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    opa = rng.uniform(0.2, 0.95, N).astype(np.float32)
    depth = rng.uniform(1, 3, N).astype(np.float32)
    bg = np.asarray([0.3, 0.6, 0.9], np.float32)
    return dict(xy=xy, conic=conic, color=color, opa=opa, depth=depth, bg=bg,
                ids=ids.astype(np.int32), sorted_o=sorted_o, valid=valid,
                starts=starts, counts=counts)


def _jax_composite(d, ts, backend):
    bins = (jnp.asarray(d["ids"]), jnp.asarray(d["sorted_o"]),
            jnp.asarray(d["valid"]), jnp.asarray(d["ids"]),
            jnp.arange(N, dtype=jnp.int32), jnp.asarray(d["starts"]),
            jnp.asarray(d["counts"]))
    fn = jax.jit(lambda xy, conic, color, opa, depth, bg, bins: j_composite(
        xy, jnp.zeros_like(xy), conic, color, opa, depth, bg, bins,
        TILES, TILES, ts, 128, 32, backend))
    return fn(*(jnp.asarray(d[k]) for k in ("xy", "conic", "color", "opa",
                                            "depth", "bg")), bins)


def _port_composite(d, ts, device="cpu"):
    t = lambda k: torch.from_numpy(d[k]).to(device)
    with torch.inference_mode():
        return composite_tiles(t("xy"), t("conic"), t("color"), t("opa"),
                               t("depth"), t("bg"), t("ids"), t("starts"),
                               t("counts"), TILES, TILES, ts)


class TestCompositeVsJax:
    @pytest.mark.parametrize("backend", ["xla", "pallas"])
    @pytest.mark.parametrize("ts", [16, 32])
    def test_forward_matches(self, ts, backend):
        d = _pallas_scene(ts=ts)
        jo = _jax_composite(d, ts, backend)
        to = _port_composite(d, ts)
        for a, b, name in zip(jo, to, ["image", "alpha", "depth"]):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=2e-4,
                                       err_msg=name)

    def test_backward_not_ported(self):
        d = _pallas_scene()
        xy = torch.from_numpy(d["xy"]).requires_grad_(True)
        t = lambda k: torch.from_numpy(d[k])
        img, _, _ = composite_tiles(xy, t("conic"), t("color"), t("opa"),
                                    t("depth"), t("bg"), t("ids"), t("starts"),
                                    t("counts"), TILES, TILES, 32)
        with pytest.raises(NotImplementedError, match="slice 4"):
            img.sum().backward()

    def test_plain_version_counts_work(self):
        d = _pallas_scene()
        t = lambda k: torch.from_numpy(d[k])
        table = pack_table(t("xy"), t("conic"), t("color"), t("opa"), t("depth"))
        stats = {}
        out = kernels.composite_fwd_plain(table, t("ids"), t("starts"),
                                          t("counts"), TILES, TILES, 32,
                                          stats=stats)
        assert out.shape == (4, 5, 1024)
        # every live slot is evaluated on every pixel until that pixel stops
        assert 0 < stats["contribs"] <= stats["evals"] <= 180 * 1024
        assert kernels.launch_counts["composite_fwd"] == 0  # CPU: no launch


def _bench_like_scene(n, seed=0):
    """``bench.py``'s scene generator (seed 0 through numpy)."""
    rng = np.random.default_rng(seed)
    f = lambda x: np.asarray(x, np.float32)
    means = f(rng.uniform(-0.45, 0.45, size=(n, 3)))
    shs = f(rng.normal(size=(n, 4, 3)) * 0.3 + 0.2)
    opa_raw = f(rng.normal(size=(n,)) - 1.0)
    scale_raw = f(rng.uniform(np.log(0.002), np.log(0.01), size=(n, 3)))
    quats = f(rng.normal(size=(n, 4)))
    return means, shs, 1 / (1 + np.exp(-opa_raw)), np.exp(scale_raw), quats


def _j_rasterize_jit(cam, gaussians, bg, kw):
    """The JAX rasterizer (``backend="xla"``) under one jit."""
    fn = jax.jit(lambda g, b: j_rasterize(*g, cam, b, 1, backend="xla",
                                          chunk=32, **kw))
    return fn(tuple(map(jnp.asarray, gaussians)), jnp.asarray(bg))


@pytest.mark.parametrize("ts,max_tiles", [(16, 9), (32, 4)])
def test_rasterize_matches_jax(ts, max_tiles):
    H = W = 64
    means, shs, opa, scales, quats = _bench_like_scene(3000, seed=1)
    scales = scales * 4.0    # splats of a few pixels at 64²
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.9
    bg = np.asarray([1.0, 0.5, 0.0], np.float32)
    kw = dict(tile_size=ts, max_tiles=max_tiles, max_per_tile=512)
    jc = JCamera.from_c2w(jnp.asarray(c2w), 0.8, 0.8, W, H, znear=0.1, zfar=10.0)
    jo = _j_rasterize_jit(jc, (means, shs, opa, scales, quats), bg, kw)
    tc = TCamera.from_c2w(torch.from_numpy(c2w), 0.8, 0.8, W, H, znear=0.1,
                          zfar=10.0)
    with torch.inference_mode():
        to = rasterize(*map(torch.from_numpy, (means, shs, opa, scales, quats)),
                       tc, torch.from_numpy(bg), 1, **kw)
    assert float(np.asarray(jo.alpha).max()) > 0.5
    for f in ("image", "alpha", "depth"):
        np.testing.assert_allclose(np.asarray(getattr(jo, f)),
                                   getattr(to, f).numpy(), atol=2e-4, err_msg=f)
    np.testing.assert_array_equal(np.asarray(jo.radii), to.radii.numpy())
    assert int(jo.overflow) == int(to.overflow)


def test_render_view_raw_parameters():
    """``render_view``: exp / sigmoid activations with the head shifts."""
    from generativedensification_tpu.splat.rasterizer import render_view as j_rv
    from generativedensification_torch.splat.rasterizer import render_view as t_rv

    rng = np.random.default_rng(4)
    n = 500
    f = lambda x: np.asarray(x, np.float32)
    means, shs = f(rng.uniform(-0.4, 0.4, (n, 3))), f(rng.normal(size=(n, 4, 3)) * 0.3)
    opa_raw, scale_raw = f(rng.normal(size=n)), f(rng.normal(size=(n, 3)) * 0.3)
    rot_raw = f(rng.normal(size=(n, 4)))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.9
    kw = dict(sh_degree=1, scale_shift=-4.0, opacity_shift=-1.0, tile_size=16,
              max_tiles=9, max_per_tile=512)
    jc = JCamera.from_c2w(jnp.asarray(c2w), 0.8, 0.8, 32, 32, znear=0.1, zfar=10.0)
    jo = jax.jit(lambda *g: j_rv(*g, jc, jnp.ones(3), backend="xla", chunk=32, **kw))(
        *map(jnp.asarray, (means, shs, opa_raw, scale_raw, rot_raw)))
    tc = TCamera.from_c2w(torch.from_numpy(c2w), 0.8, 0.8, 32, 32, znear=0.1, zfar=10.0)
    with torch.inference_mode():
        to = t_rv(*map(torch.from_numpy, (means, shs, opa_raw, scale_raw, rot_raw)),
                  tc, torch.ones(3), **kw)
    assert float(np.asarray(jo.alpha).max()) > 0.3
    for k in ("image", "alpha", "depth"):
        np.testing.assert_allclose(np.asarray(getattr(jo, k)), getattr(to, k).numpy(),
                                   atol=2e-4, err_msg=k)


def test_renderer_dict_and_cap_overflow():
    """``Renderer.render_img`` keys, and the per-tile cap counted in
    overflow exactly as the JAX rasterizer counts it."""
    means, shs, opa, scales, quats = _bench_like_scene(2000, seed=2)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.9
    jc = JCamera.from_c2w(jnp.asarray(c2w), 0.8, 0.8, 32, 32, znear=0.1, zfar=10.0)
    tc = TCamera.from_c2w(torch.from_numpy(c2w), 0.8, 0.8, 32, 32, znear=0.1,
                          zfar=10.0)
    kw = dict(tile_size=16, max_tiles=4, max_per_tile=64)
    jo = _j_rasterize_jit(jc, (means, shs, opa, scales * 3, quats),
                          np.ones(3, np.float32), kw)
    with torch.inference_mode():
        out = Renderer(1, device="cpu").render_img(
            tc, None, *map(torch.from_numpy, (means, shs, opa, scales * 3, quats)),
            prex="_fine", **kw)
        to = rasterize(*map(torch.from_numpy, (means, shs, opa, scales * 3, quats)),
                       tc, torch.ones(3), 1, **kw)
    assert set(out) == {"image_fine", "depth_fine", "acc_map_fine", "radii_fine"}
    assert out["depth_fine"].shape == (32, 32, 1)
    assert int(to.overflow) == int(jo.overflow) > 0
    np.testing.assert_allclose(np.asarray(jo.image), out["image_fine"].numpy(),
                               atol=2e-4)
