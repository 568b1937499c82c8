"""Host-side data (numpy samples) and the device feed.

The JAX package's registry: ``dataset_dict[name](cfg)`` builds a dataset
whose samples are numpy dicts (``base.BATCH_ARRAY_KEYS``).  The file-backed
datasets (``gobjverse``, ``gso``, ``instant3d``, ``shapenet``,
``mipnerf``) are copies of the JAX package's, and import their optional
packages (h5py, imageio, cv2, sklearn) when they are built or read: a
missing package raises its ``ImportError`` there.  ``synthetic`` renders its
ground truth with the port's rasterizer on a device; ``build_dataset``
passes it one.  Batching, sharding and prefetching live in
:mod:`.pipeline`.
"""

from __future__ import annotations

from .base import dataset_dict, register_dataset
from .pipeline import BatchLoader, collate

# register the datasets
from . import gobjverse  # noqa: F401
from . import gso  # noqa: F401
from . import instant3d  # noqa: F401
from . import shapenet  # noqa: F401
from . import mipnerf  # noqa: F401
from .synthetic import SyntheticDataset


def build_dataset(cfg, device=None):
    """``dataset_dict[cfg.dataset_name](cfg)``; the synthetic dataset
    renders on ``device`` (``None``: the card)."""
    cls = dataset_dict[cfg.dataset_name]
    return cls(cfg, device=device) if cls is SyntheticDataset else cls(cfg)


__all__ = ["dataset_dict", "register_dataset", "build_dataset", "BatchLoader",
           "collate", "SyntheticDataset"]
