"""The stage probes of the two forward compositors on the card: every
variant's CUDA kernel bitwise against its plain version, and the variants
whose output is the production output (3DGS: ``full``, ``noexit``,
``noskip``, ``b128``, ``full_bulk`` and the ``tpb*``; 2DGS: ``full``,
``noskip`` and the rows that ``trans`` / ``acc`` reach) bitwise against the
production kernel, at both tile sizes (``gpu`` marker; skips without a
card).

This file imports neither JAX nor the JAX package, so it also runs on a
machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_probe_kernels.py
"""

import numpy as np
import pytest
import torch

from generativedensification_torch.core.camera import Camera
from generativedensification_torch.splat import kernels
from generativedensification_torch.splat import probe_kernels as pk
from generativedensification_torch.splat import surfel_kernels
from generativedensification_torch.tools import scenes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA probes have no CPU mode")
    return torch.device("cuda")


def _scene(dev, ts, n=20000, hw=256):
    """A dense 3DGS scene (the kernel tests' distributions, scales x2), so
    that tiles run several staging batches and some leave early."""
    rng = np.random.default_rng(3)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    means = f(rng.uniform(-0.45, 0.45, size=(n, 3)))
    shs = f(rng.normal(size=(n, 4, 3)) * 0.3 + 0.2)
    opa = torch.sigmoid(f(rng.normal(size=(n,)) + 1.0))
    scales = f(2.0 * np.exp(rng.uniform(np.log(0.002), np.log(0.01), size=(n, 3))))
    quats = f(rng.normal(size=(n, 4)))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -1.9
    cam = Camera.from_c2w(f(c2w), 0.8, 0.8, hw, hw, znear=0.1, zfar=10.0)
    return scenes.compositor_inputs(means, shs, opa, scales, quats, cam, ts, 9,
                                    4096)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
def test_composite_probes_match_plain(cuda_device, ts):
    with torch.inference_mode():
        args = _scene(cuda_device, ts)
        prod = kernels.composite_fwd(*args)
        for v in pk.COMPOSITE_VARIANTS:
            before = kernels.launch_counts["composite_fwd_probe"]
            out = pk.composite_fwd_probe(v, *args)
            torch.cuda.synchronize()
            assert kernels.launch_counts["composite_fwd_probe"] == before + 1
            ref = pk.composite_fwd_probe_plain(v, *args)
            assert torch.equal(out, ref), v
            if v in pk.PRODUCTION_OUTPUT:
                assert torch.equal(out, prod), v
        trips = pk.composite_fwd_probe("trips", *args)
    pix = pk.lane_pixels(ts, False, cuda_device)[:, 0]   # each sub-tile's CTA
    executed, assigned = trips[:, 0][:, pix], trips[:, 1][:, pix]
    assert bool((assigned > 1).any())                # several batches somewhere
    assert bool((executed < assigned).any())         # and CTAs that leave early


@pytest.mark.gpu
@pytest.mark.parametrize("ts", [16, 32])
def test_surfel_probes_match_plain(cuda_device, ts):
    with torch.inference_mode():
        args, _ = scenes.surfel_bench_scene(cuda_device, "free", ts, 9, n=20000,
                                            hw=256)
        prod = surfel_kernels.surfel_fwd(*args)
        for v in pk.SURFEL_VARIANTS:
            before = kernels.launch_counts["surfel_fwd_probe"]
            out = pk.surfel_fwd_probe(v, *args)
            torch.cuda.synchronize()
            assert kernels.launch_counts["surfel_fwd_probe"] == before + 1
            ref = pk.surfel_fwd_probe_plain(v, *args)
            assert torch.equal(out, ref), v
            if v in pk.SURFEL_PRODUCTION_OUTPUT:
                assert torch.equal(out, prod), v
            rows = list(pk.SURFEL_STAGE_ROWS.get(v, ()))
            assert torch.equal(out[:, rows], prod[:, rows]), v


@pytest.mark.gpu
def test_probe_wrappers_refuse(cuda_device):
    args = _scene(cuda_device, 16, n=500, hw=48)          # 9 sub-tiles
    with pytest.raises(ValueError, match="multiple of 2"):
        pk.composite_fwd_probe("tpb2", *args)
    with pytest.raises(ValueError, match="unknown probe variant"):
        pk.composite_fwd_probe("pvpu", *args)
