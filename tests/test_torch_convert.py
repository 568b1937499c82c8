"""The reference checkpoint loader of the port (``utils/torch_convert.py``,
``tools/convert_torch_ckpt.py``) against the JAX package's converter.

A seeded state dict with the reference's exact key names and shapes
(``synthesize_reference_state_dict``, the tiny configuration of
``tests/test_eval.py``), loaded directly by the port, must equal the JAX
``convert_state_dict`` followed by the port's Flax bridge
(``utils/convert.py``) bit for bit in every tensor but the ConvTranspose3d
kernels, which differ by exactly the three-axis flip: the JAX converter
keeps the reference's ConvTranspose3d kernel unflipped (ROADMAP queue 3)
while the bridge flips it.  The JAX side needs only the parameter tree's
shapes (``jax.eval_shape``: nothing compiles)."""

import jax
import numpy as np
import pytest
import torch

from generativedensification_tpu.data.synthetic import make_probe_batch as j_probe
from generativedensification_tpu.models import network as jnet
from generativedensification_tpu.utils import torch_convert as jtc
from generativedensification_torch.models import network as tnet
from generativedensification_torch.utils import torch_convert as ttc
from generativedensification_torch.utils.convert import state_dict_from_flax
from test_eval import TINY
from test_torch_fine import FINE

torch.set_num_threads(1)


def _jax_zero_params(residual):
    jn = jnet.Network(jnet.NetworkConfig(**FINE, enable_residual_attribute=residual,
                                         drop_path=0.0, raster_chunk=16))
    shapes = jax.eval_shape(lambda: jn.init(
        {"params": jax.random.PRNGKey(0)}, j_probe(1, 4, 64, 64, 2, seed=0),
        with_fine=True))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _port_net(residual):
    return tnet.Network(tnet.NetworkConfig(**FINE, enable_residual_attribute=residual),
                        device="cpu")


@pytest.mark.parametrize("residual,seed", [(False, 3), (True, 5)])
def test_reference_load_matches_jax_converter(residual, seed, capsys):
    """Every source key consumed, every port parameter filled, and each
    tensor bitwise JAX's (the ConvTranspose3d kernel after the flip)."""
    net = _port_net(residual)
    sd = ttc.synthesize_reference_state_dict(net.cfg, seed=seed)
    jsd = jtc.synthesize_reference_state_dict(net.cfg, seed=seed)
    assert sd.keys() == jsd.keys()
    assert all(np.array_equal(sd[k], jsd[k]) for k in sd)

    report = {}
    port = ttc.convert_state_dict(sd, net, report)
    assert report["unconsumed"] == [] and report["unfilled"] == []
    assert sorted(report["filled"]) == sorted(net.state_dict())
    out = capsys.readouterr().out
    assert "not consumed" not in out and "not filled" not in out, out

    jparams = jtc.convert_state_dict(sd, _jax_zero_params(residual))
    bridged = state_dict_from_flax(jparams["params"])
    assert set(bridged) == set(port)
    flipped = []
    for k, t in port.items():
        b = bridged[k]
        if k.endswith("deconv.weight"):
            assert not torch.equal(t, b)
            b = torch.flip(b, dims=(2, 3, 4))
            flipped.append(k)
        assert torch.equal(t, b), k
    assert flipped == ["vol_decoder.deconv.weight"]
    # the ConvTranspose3d kernel is the reference's own tensor, unflipped
    np.testing.assert_array_equal(port["vol_decoder.deconv.weight"].numpy(),
                                  sd["net.vol_decoder.deconv.weight"])
    net.load_state_dict(port)


def test_layout_mismatches_and_vit_only(tmp_path):
    """A shape that does not fit raises with the parameter's name; a bare
    timm ViT state dict (``--vit-only``) fills the image encoder alone and
    reports the rest unfilled."""
    net = _port_net(False)
    sd = ttc.synthesize_reference_state_dict(net.cfg, seed=1)
    bad = dict(sd, **{"net.decoder.mlp_coarse.0.weight": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="decoder.coarse_fc0.weight"):
        ttc.convert_state_dict(bad, net)

    from generativedensification_torch.tools import convert_torch_ckpt

    vp = "net.img_encoder.model."
    torch.save({k[len(vp):]: torch.from_numpy(v) for k, v in sd.items()
                if k.startswith(vp)}, tmp_path / "dino.pth")
    report = convert_torch_ckpt.main(["--ckpt", str(tmp_path / "dino.pth"), "--out",
                                      str(tmp_path / "vit"), "--vit-only", *TINY],
                                     device="cpu")
    assert report["unconsumed"] == []
    assert all(k.startswith("img_encoder.") for k in report["filled"])
    assert report["unfilled"] and not any(k.startswith("img_encoder.")
                                         for k in report["unfilled"])


def test_ckpt_through_convert_tool_equals_direct_load(tmp_path, monkeypatch):
    """``.ckpt`` -> ``tools.convert_torch_ckpt`` -> checkpoint directory ->
    ``eval.main`` serves the same parameters as ``eval.main`` on the
    ``.ckpt`` itself, which equal the direct load."""
    from generativedensification_torch.eval import evaluation as teval
    from generativedensification_torch.tools import convert_torch_ckpt

    cfg = teval.config_from_args(TINY)
    net = tnet.Network(tnet.NetworkConfig.from_config(cfg), device="cpu")
    sd = ttc.synthesize_reference_state_dict(net.cfg, seed=7)
    ckpt = tmp_path / "epoch=49.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "epoch": 49}, ckpt)
    direct = ttc.load_torch_network_params(str(ckpt), net)

    report = convert_torch_ckpt.main(["--ckpt", str(ckpt), "--out",
                                      str(tmp_path / "conv"), *TINY],
                                     device="cpu")
    assert report["unconsumed"] == [] and report["unfilled"] == []

    served = []
    real = teval.load_params

    def spy(cfg, n):
        real(cfg, n)
        served.append({k: v.clone() for k, v in n.state_dict().items()})

    monkeypatch.setattr(teval, "load_params", spy)
    for path in (ckpt, tmp_path / "conv"):
        res = teval.main(teval.config_from_args(TINY + [
            "infer.dataset.dataset_name=synthetic", "infer.dataset.n_scenes=1",
            "infer.dataset.img_size=[64,64]", "infer.dataset.n_group=2",
            "infer.save_images=0", f"infer.save_folder={tmp_path / 'eval'}",
            f"infer.ckpt_path={path}"]), device="cpu")
        assert np.isfinite(res["mean"]["psnr"])
    monkeypatch.undo()
    for params in served:
        assert params.keys() == direct.keys()
        for k in direct:
            assert torch.equal(params[k], direct[k]), k
    with pytest.raises(FileNotFoundError):
        teval.load_params(teval.config_from_args(
            TINY + [f"infer.ckpt_path={tmp_path / 'missing.bin'}"]), net)
