"""PyTorch port vs the JAX package: LPIPS, MS-SSIM, per-scene finetuning in
the evaluation, and the evaluation CLI with every side output.

LPIPS (``eval/lpips.py``) for both backbones with ``random_weights`` against
JAX ``load_lpips`` on 64² images (1e-5 relative); ``finetune_scene`` on the
tiny network lowers the source-view MSE in 40 steps (the counterpart of
``tests/test_eval.py::test_eval_finetuning_improves_source_mse``); the
evaluation ``main`` at the tiny configuration with finetuning, the orbit
video, the mesh and its turntable, LPIPS and a synthesized reference
``.ckpt``, on the CPU: the metric schema, the files, and the comparison
image's pixels."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativedensification_tpu.eval import lpips as jlp
from generativedensification_tpu.eval import metrics as jm
from generativedensification_torch.eval import evaluation as teval
from generativedensification_torch.eval import lpips as tlp
from generativedensification_torch.eval import metrics as tm
from generativedensification_torch.tools.convert_lpips import random_weights
from generativedensification_torch.utils.image_io import read_png, to_uint8
from test_eval import TINY

torch.set_num_threads(1)

SYNTH = ["infer.dataset.dataset_name=synthetic", "infer.dataset.n_scenes=1",
         "infer.dataset.img_size=[64,64]", "infer.dataset.n_group=2"]


def _images(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.normal(size=a.shape), -1, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_matches_jax(net, tmp_path):
    """Seeded random weights through the .npz: batched and single images,
    1e-5 relative; d(a, a) = 0."""
    path = tmp_path / f"lpips_{net}.npz"
    np.savez(path, **random_weights(net, seed=3))
    jf = jlp.load_lpips(str(path), net)
    tf = tlp.load_lpips(str(path), net, device="cpu")
    a, b = _images(1)
    for x, y in ((a, b), (a[0], b[0])):
        j = float(jf(jnp.asarray(x), jnp.asarray(y)))
        t = float(tf(torch.from_numpy(x), torch.from_numpy(y)))
        assert j > 0
        np.testing.assert_allclose(t, j, rtol=1e-5)
    assert float(tf(torch.from_numpy(a), torch.from_numpy(a))) == 0.0


def test_lpips_fn_reads_the_env_file_per_backbone(tmp_path, monkeypatch):
    """``LPIPS_WEIGHTS_NPZ`` with ``{net}`` names one file per backbone;
    without weights ``lpips_fn`` raises as the JAX one does; MS-SSIM
    against JAX."""
    monkeypatch.delenv("LPIPS_WEIGHTS_NPZ", raising=False)
    with pytest.raises(NotImplementedError, match="LPIPS_WEIGHTS_NPZ"):
        tm.lpips_fn("alex")
    for net in ("vgg", "alex"):
        np.savez(tmp_path / f"w_{net}.npz", **random_weights(net, seed=6))
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(tmp_path / "w_{net}.npz"))
    a, b = _images(2)
    for net in ("vgg", "alex"):
        fn = tm.lpips_fn(net, device="cpu")
        assert fn is tm.lpips_fn(net, device="cpu")          # cached
        ref = tlp.load_lpips(str(tmp_path / f"w_{net}.npz"), net, device="cpu")
        x, y = torch.from_numpy(a), torch.from_numpy(b)
        assert float(fn(x, y)) == float(ref(x, y))

    rng = np.random.default_rng(7)
    p = rng.uniform(size=(2, 176, 176, 3)).astype(np.float32)
    g = np.clip(p + 0.05 * rng.normal(size=p.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(tm.ms_ssim_img(torch.from_numpy(p), torch.from_numpy(g))),
                               float(jm.ms_ssim_img(jnp.asarray(p), jnp.asarray(g))),
                               rtol=1e-5)


def test_finetune_scene_lowers_source_mse():
    """The tiny network's fine Gaussians finetuned 40 steps against the 2
    source views (64², seeded weights): the source-view MSE of the re-render
    falls below the feed-forward one; the refined render_pkg keeps the
    validity mask and the shapes."""
    from generativedensification_torch.data.pipeline import collate, to_device_batch
    from generativedensification_torch.data.synthetic import SyntheticDataset
    from generativedensification_torch.models.network import Network, NetworkConfig

    cfg = teval.config_from_args(TINY + SYNTH + ["infer.finetuning.with_ft=True",
                                                 "infer.finetuning.steps=40"])
    net_cfg = NetworkConfig.from_config(cfg)
    net = Network(net_cfg, device="cpu", seed=0).eval()
    batch = to_device_batch(collate([SyntheticDataset(cfg.infer.dataset, device="cpu")[0]]),
                            "cpu")
    with torch.no_grad():
        out = net(batch, with_fine=True)
    B, V, H, W, _ = batch["tar_rgb"].shape
    gt = batch["tar_rgb"].permute(0, 2, 1, 3, 4).reshape(1, H, V * W, 3)
    src = slice(0, W * cfg.n_views)
    mse = lambda img: float(torch.mean((img[:, :, src] - gt[:, :, src]) ** 2))
    image_fine, pkg = teval.finetune_scene(out, batch, net_cfg, cfg.infer.finetuning,
                                           cfg.n_views)
    assert image_fine.shape == out["image_fine"].shape
    assert np.isfinite(mse(image_fine)) and mse(image_fine) < mse(out["image_fine"])
    assert torch.equal(pkg[-1][5], out["render_pkg"][-1][5])
    for a, b in zip(pkg[-1][:5], out["render_pkg"][-1][:5]):
        assert a.shape == b.shape and a.dtype == torch.float32


@pytest.mark.parametrize("mode", [[], ["model.enable_residual_attribute=True"]],
                         ids=["base", "residual"])
def test_evaluation_cli_with_every_side_output(mode, tmp_path, monkeypatch):
    """``main`` with a synthesized reference ``.ckpt``, finetuning (5
    steps), a 2-frame video, the mesh with a 1-frame turntable and LPIPS
    from seeded random weights: JAX's metric keys plus ``lpips_vgg`` /
    ``lpips_alex``, all finite; the comparison image, the video frames, the
    .obj and the turntable frame written; the comparison PNG's pixels are
    the uint8 array of ground truth, coarse and fine stacked.  In base and
    in residual attribute mode (the reference's ``epoch=49_residual.ckpt``
    layout: every key consumed, every parameter filled)."""
    from generativedensification_torch.models.network import NetworkConfig
    from generativedensification_torch.utils.torch_convert import (
        synthesize_reference_state_dict,
    )

    for net in ("vgg", "alex"):
        np.savez(tmp_path / f"lpips_{net}.npz", **random_weights(net, seed=1))
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", str(tmp_path / "lpips_{net}.npz"))
    sd = synthesize_reference_state_dict(
        NetworkConfig.from_config(teval.config_from_args(TINY + mode)), seed=3)
    ckpt = tmp_path / "ref.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    saved = {}
    real = teval._save_comparison
    monkeypatch.setattr(teval, "_save_comparison",
                        lambda *a: saved.update(args=a) or real(*a))
    ft_steps = []
    from generativedensification_torch.eval import finetune as tft
    real_step = tft.ft_step
    monkeypatch.setattr(tft, "ft_step", lambda *a, **k: ft_steps.append(1) or
                        real_step(*a, **k))

    out_dir = tmp_path / "out"
    reports = []
    from generativedensification_torch.utils import torch_convert
    real_convert = torch_convert.convert_state_dict
    monkeypatch.setattr(torch_convert, "convert_state_dict", lambda sd, net, report=None:
                        real_convert(sd, net, reports.append({}) or reports[-1]))
    cfg = teval.config_from_args(TINY + mode + SYNTH + [
        "infer.finetuning.with_ft=True", "infer.finetuning.steps=5",
        "infer.video_frames=2", "infer.save_mesh=True", "infer.mesh_video_frames=1",
        "infer.eval_lpips=True", f"infer.ckpt_path={ckpt}", f"infer.save_folder={out_dir}",
        f"infer.metric_path={out_dir}/metrics.json", "infer.save_images=1"])
    result = teval.main(cfg, device="cpu")
    assert cfg.model.enable_residual_attribute == bool(mode)
    (report,) = reports
    assert report["filled"] and not report["unconsumed"] and not report["unfilled"]
    keys = {"psnr", "psnr_coarse", "psnr_fine", "ssim", "lpips_vgg", "lpips_alex"}
    assert set(result) == {"mean", "scenes"} and set(result["mean"]) == keys
    rec = result["scenes"]["synthetic_0"]
    assert set(rec) == keys and all(np.isfinite(v) for v in rec.values())
    assert rec["psnr"] == max(rec["psnr_coarse"], rec["psnr_fine"])
    assert rec["lpips_vgg"] > 0 and rec["lpips_alex"] > 0
    assert len(ft_steps) == 5
    with open(out_dir / "metrics.json") as f:
        assert json.load(f) == result

    files = sorted(os.listdir(out_dir))
    assert files == ["metrics.json", "synthetic_0.obj", "synthetic_0.png",
                     "synthetic_0_f000.png", "synthetic_0_f001.png",
                     "synthetic_0_mesh000.png"], files
    _, _, gt, coarse, fine = saved["args"]
    expect = to_uint8(torch.cat([gt, coarse, fine], dim=0).numpy())
    np.testing.assert_array_equal(read_png(out_dir / "synthetic_0.png"), expect)
    assert expect.shape == (3 * 64, 4 * 64, 3)
    for name in ("synthetic_0_f000.png", "synthetic_0_mesh000.png"):
        assert read_png(out_dir / name).shape == (64, 64, 3)
    obj = (out_dir / "synthetic_0.obj").read_text().splitlines()
    assert any(ln.startswith("v ") for ln in obj) and any(ln.startswith("f ") for ln in obj)


def test_eval_all_skips_missing_data(tmp_path, monkeypatch):
    """``tools.eval_all`` runs every (checkpoint, run) pair and skips the
    ones whose data is missing; a synthetic run goes through."""
    from generativedensification_torch.tools import eval_all

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(eval_all, "RUNS", [
        ("gso", "GSO", "dataset/missing", []),
        ("synth", "synthetic", "unused", ["infer.dataset.n_scenes=1",
                                         "infer.dataset.img_size=[64,64]",
                                         "infer.dataset.n_group=2", "n_views=2"])])
    monkeypatch.setattr(eval_all, "CKPTS", [("seeded", "None", [])])
    results = eval_all.main(TINY + ["infer.save_images=0"], device="cpu")
    assert list(results) == ["synth_seeded"]
    assert (tmp_path / "outputs/metrics/synth_seeded.json").exists()
