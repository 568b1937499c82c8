#!/usr/bin/env python
"""Pool the two Co3D per-scene metric JSONs into scene-count-weighted mean
PSNR/SSIM/LPIPS — reference ``metric_co3d.py:20-49``."""

from __future__ import annotations

import json
import sys


def pool(paths):
    scenes = {}
    for p in paths:
        with open(p) as f:
            scenes.update(json.load(f)["scenes"])
    if not scenes:
        return {}
    keys = set.intersection(*(set(v) for v in scenes.values()))
    return {k: sum(v[k] for v in scenes.values()) / len(scenes) for k in sorted(keys)}


if __name__ == "__main__":
    paths = sys.argv[1:] or [
        "outputs/metrics/co3d_teddybear_base.json",
        "outputs/metrics/co3d_hydrant_base.json",
    ]
    print(json.dumps(pool(paths), indent=2))
