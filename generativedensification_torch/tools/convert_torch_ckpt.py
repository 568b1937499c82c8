"""CLI: convert a reference torch checkpoint into a directory of the port's
checkpoints.

Maps the reference's released Lightning checkpoints (``epoch=49.ckpt``,
``epoch=49_residual.ckpt``) or a bare timm DINO ViT state_dict onto the
port's ``Network`` through :mod:`generativedensification_torch.utils.
torch_convert`, and writes ``{out}/0/state.pt`` (parameters only), which
``train/state.py::restore_params`` reads and ``infer.ckpt_path={out}``
serves:

  python -m generativedensification_torch.tools.convert_torch_ckpt \\
      --ckpt epoch=49.ckpt --out converted_params \\
      [--config configs/base.yaml k=v ...] [--vit-only]

``--vit-only`` maps a bare timm ``vit_base_patch16_224.dino`` state_dict
(keys without the ``net.img_encoder.model.`` prefix) onto the image
encoder alone; every other parameter keeps its seeded value.  The network
is built on the card unless ``main`` is given ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None, device=None) -> dict:
    """Convert; returns the converter's report (``filled``, ``unconsumed``,
    ``unfilled``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", nargs="*", default=[])
    ap.add_argument("--vit-only", action="store_true")
    args, overrides = ap.parse_known_args(argv)

    from ..config import load_config
    from ..models.network import Network, NetworkConfig
    from ..train.state import save_params
    from ..utils import torch_convert as tc
    from ..utils.device import resolve_device

    cfg = load_config(
        [c for c in args.config if c.endswith((".yaml", ".yml"))],
        [o for o in (args.config + overrides) if "=" in o],
    )
    net = Network(NetworkConfig.from_config(cfg), device=resolve_device(device))
    sd = tc.load_torch_state_dict(args.ckpt)
    if args.vit_only:
        # a bare timm state_dict -> prefixed as the network checkpoint is
        sd = {f"net.img_encoder.model.{k}": v for k, v in sd.items()}
    report = {}
    params = tc.convert_state_dict(sd, net, report)
    path = save_params(args.out, params)
    print(f"[convert_torch_ckpt] wrote {path}")
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
