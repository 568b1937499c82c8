"""Visualization: depth colorization and training image panels
(reference ``tools/img_utils.py:159-176`` + ``lightning/vis.py``)."""

from __future__ import annotations

import numpy as np


def visualize_depth(depth: np.ndarray, minmax=None, cmap: str = "jet"):
    """Depth map -> uint8 color image (+ the (min, max) used)."""
    import matplotlib.cm as cm

    d = np.asarray(depth, np.float32).copy()
    finite = np.isfinite(d) & (d > 0)
    if minmax is None:
        lo = np.percentile(d[finite], 1) if finite.any() else 0.0
        hi = np.percentile(d[finite], 99) if finite.any() else 1.0
    else:
        lo, hi = minmax
    x = np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    rgba = cm.get_cmap(cmap)(x)
    out = (rgba[..., :3] * 255).astype(np.uint8)
    out[~finite] = 0
    return out, (lo, hi)


def make_panel(gt, pred_coarse, pred_fine=None, depth=None, normal=None):
    """Stack gt/prediction/depth rows into one uint8 panel (vis.py:7-85)."""
    rows = [gt, pred_coarse]
    if pred_fine is not None:
        rows.append(pred_fine)
    rows = [np.clip(np.asarray(r), 0, 1) for r in rows]
    if depth is not None:
        rows.append(visualize_depth(np.asarray(depth))[0].astype(np.float32) / 255.0)
    if normal is not None:
        rows.append(np.asarray(normal) * 0.5 + 0.5)
    h = min(r.shape[0] for r in rows)
    rows = [r[:h] for r in rows]
    panel = np.concatenate(rows, axis=0)
    return (panel * 255).astype(np.uint8)
