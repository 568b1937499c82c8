"""Benchmark runner, PyTorch: the reference ``eval_all.py``.

Port of the top-level ``eval_all.py``: loops the released checkpoints over
GSO (with depth eval), Gobjaverse and the two Co3D categories (3DGS, and
Co3D with the 2DGS surfel renderer) at n_views=4, writing per-run metric
JSONs that ``tools.metric_co3d`` pools.  Runs in-process on the card:

    python -m generativedensification_torch.tools.eval_all [key=value ...]

A run whose dataset or checkpoint is missing is skipped with a note.
"""

from __future__ import annotations

import sys

from ..config import load_config
from ..eval.evaluation import main as eval_main

RUNS = [
    # (tag, dataset_name, data_root, extra overrides)
    ("gso", "GSO", "dataset/google_scanned_objects",
     ["infer.eval_depth=[0.005,0.01,0.02]"]),
    ("gobjaverse", "gobjeverse", "dataset/gobjaverse/gobjaverse.h5", []),
    ("co3d_teddybear", "gobjeverse", "dataset/Co3D/co3d_teddybear.hdf5", []),
    ("co3d_hydrant", "gobjeverse", "dataset/Co3D/co3d_hydrant.hdf5", []),
    # Co3D with the 2DGS surfel renderer (depth / normal side outputs)
    ("co3d_teddybear_2dgs", "gobjeverse", "dataset/Co3D/co3d_teddybear.hdf5",
     ["tpu.renderer=2dgs"]),
    ("co3d_hydrant_2dgs", "gobjeverse", "dataset/Co3D/co3d_hydrant.hdf5",
     ["tpu.renderer=2dgs"]),
]

CKPTS = [
    ("base", "ckpts/epoch=49", []),
    ("residual", "ckpts/epoch=49_residual", ["model.enable_residual_attribute=True"]),
]


def main(argv, device=None) -> dict:
    """Every (checkpoint, run) pair; returns {f"{tag}_{ckpt_tag}": result}
    of the runs that were not skipped."""
    extra = [a for a in argv if "=" in a]
    results = {}
    for ckpt_tag, ckpt_path, ckpt_over in CKPTS:
        for tag, ds, root, over in RUNS:
            overrides = [
                f"infer.dataset.dataset_name={ds}",
                f"infer.dataset.data_root={root}",
                f"infer.ckpt_path={ckpt_path}",
                "n_views=4",
                f"infer.metric_path=outputs/metrics/{tag}_{ckpt_tag}.json",
                f"infer.save_folder=outputs/eval/{tag}_{ckpt_tag}",
            ] + over + ckpt_over + extra
            cfg = load_config(None, overrides, infer=True)
            print(f"===== eval {tag} / {ckpt_tag} =====")
            try:
                results[f"{tag}_{ckpt_tag}"] = eval_main(cfg, device)
            except FileNotFoundError as e:
                print(f"[eval_all] skipped {tag}/{ckpt_tag}: {e}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
