"""Host-side data (numpy samples) and the device feed.

``dataset_dict[name](cfg, device=None)`` builds a dataset, as the JAX
package's registry does.  The port holds ``synthetic`` so far; the datasets
that read files (GSO, Gobjaverse, Instant3D, ShapeNet, MipNeRF) arrive with
ROADMAP queue 1 (data and the train CLI).
"""

from __future__ import annotations

from .synthetic import SyntheticDataset

_NOT_PORTED = ("gobjeverse", "GSO", "instant3d", "shapenet", "mipnerf360")


class _Registry(dict):
    def __missing__(self, name):
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"dataset {name!r} is not ported yet: it arrives with ROADMAP "
                "queue 1 (data and the train CLI)")
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(self)}")


dataset_dict = _Registry(synthetic=SyntheticDataset)

__all__ = ["dataset_dict", "SyntheticDataset"]
