"""Produce the LPIPS weight .npz consumed by ``eval/lpips.py``.

The reference evaluates LPIPS-vgg and LPIPS-alex via the ``lpips`` package
(``evaluation.py:63-64,139-140``).  This tool converts those torch weights
into the flat npz schema of :mod:`generativedensification_torch.eval.lpips`:

  * ``conv{i}/kernel`` (kh, kw, I, O), ``conv{i}/bias`` (O,) — backbone
    features (torchvision VGG16 / AlexNet ``.features`` convs, in order);
  * ``lin{i}/kernel`` (C,) — the lpips 1x1 non-negative calibration heads
    (``lpips/weights/v0.1/{net}.pth``);
  * ``shift`` / ``scale`` (3,) — the lpips ScalingLayer constants.

Usage:
  python -m generativedensification_torch.tools.convert_lpips \
      --net vgg --out lpips_vgg.npz \
      [--backbone path/to/vgg16_features_state_dict.pth] \
      [--lin path/to/lpips_vgg.pth] [--random]

Without ``--backbone`` it tries torchvision's pretrained download (needs
network); ``--random`` emits a correctly-shaped random-weight npz for
pipeline tests in offline environments.
"""

from __future__ import annotations

import argparse

import numpy as np

# lpips ScalingLayer constants (lpips/lpips.py ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_VGG_CONVS = [
    (3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
    (256, 256), (256, 512), (512, 512), (512, 512), (512, 512), (512, 512),
    (512, 512),
]
_VGG_K = [3] * 13
_VGG_LIN_CH = (64, 128, 256, 512, 512)

_ALEX_CONVS = [(3, 64), (64, 192), (192, 384), (384, 256), (256, 256)]
_ALEX_K = [11, 5, 3, 3, 3]
_ALEX_LIN_CH = (64, 192, 384, 256, 256)


def _t2f_conv(w: np.ndarray) -> np.ndarray:
    """(O, I, kh, kw) -> (kh, kw, I, O)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def random_weights(net: str, seed: int = 0) -> dict:
    """Correctly-shaped random npz payload (offline pipeline testing)."""
    rng = np.random.default_rng(seed)
    convs, ks, lin_ch = (
        (_VGG_CONVS, _VGG_K, _VGG_LIN_CH) if net == "vgg"
        else (_ALEX_CONVS, _ALEX_K, _ALEX_LIN_CH)
    )
    out = {"shift": _SHIFT, "scale": _SCALE}
    for i, ((ci, co), k) in enumerate(zip(convs, ks)):
        out[f"conv{i}/kernel"] = rng.normal(
            scale=(2.0 / (k * k * ci)) ** 0.5, size=(k, k, ci, co)
        ).astype(np.float32)
        out[f"conv{i}/bias"] = np.zeros(co, np.float32)
    for i, c in enumerate(lin_ch):
        out[f"lin{i}/kernel"] = np.abs(
            rng.normal(scale=0.1, size=(c,))
        ).astype(np.float32)
    return out


def convert(net: str, backbone_path: str | None, lin_path: str | None) -> dict:
    import torch

    out = {"shift": _SHIFT, "scale": _SCALE}

    # backbone conv weights
    if backbone_path:
        sd = torch.load(backbone_path, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
    else:
        import torchvision

        model = (
            torchvision.models.vgg16(weights="IMAGENET1K_V1") if net == "vgg"
            else torchvision.models.alexnet(weights="IMAGENET1K_V1")
        )
        sd = model.features.state_dict()
    conv_ws = sorted(
        (k for k in sd if k.endswith(".weight") and sd[k].ndim == 4),
        key=lambda k: int(k.split(".")[-2]),
    )
    for i, k in enumerate(conv_ws):
        out[f"conv{i}/kernel"] = _t2f_conv(np.asarray(sd[k]))
        out[f"conv{i}/bias"] = np.asarray(sd[k.replace(".weight", ".bias")])

    # lpips lin calibration heads: lin{i}.model.1.weight (1, C, 1, 1)
    if lin_path:
        lsd = torch.load(lin_path, map_location="cpu", weights_only=False)
        for i in range(5):
            key = next(k for k in lsd if k.startswith(f"lin{i}."))
            out[f"lin{i}/kernel"] = np.asarray(lsd[key]).reshape(-1)
    else:
        print("[convert_lpips] WARNING: no --lin weights; using uniform "
              "calibration (NOT the published LPIPS metric)")
        ch = _VGG_LIN_CH if net == "vgg" else _ALEX_LIN_CH
        for i, c in enumerate(ch):
            out[f"lin{i}/kernel"] = np.full(c, 1.0 / c, np.float32)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", choices=["vgg", "alex"], default="vgg")
    ap.add_argument("--out", required=True)
    ap.add_argument("--backbone", default=None,
                    help="torch state_dict of the backbone .features")
    ap.add_argument("--lin", default=None,
                    help="lpips lin weights .pth (lpips/weights/v0.1/)")
    ap.add_argument("--random", action="store_true",
                    help="emit random weights (offline pipeline test)")
    args = ap.parse_args()

    data = (
        random_weights(args.net) if args.random
        else convert(args.net, args.backbone, args.lin)
    )
    np.savez(args.out, **data)
    print(f"[convert_lpips] wrote {args.out} ({len(data)} arrays, net={args.net})")


if __name__ == "__main__":
    main()
