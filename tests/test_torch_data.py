"""PyTorch port vs the JAX package: the file-backed datasets and the
``BatchLoader``.

The datasets are copies of the JAX package's (numpy, json, glob, os; h5py,
imageio, cv2 and sklearn imported when a dataset is built or read), so
their sources must stay byte for byte the JAX files; on the miniature
Gobjaverse HDF5 fixture of ``tests/test_data.py`` every sample and every
collated batch of the port equals the JAX loader's bit for bit when both
datasets' view-sampling generators (``ds.rng``, unseeded in both packages)
are seeded alike.  The loader's sharding, epoch fraction, shuffle order and
worker-error propagation are held against JAX's ``BatchLoader``."""

import pathlib
import sys

import numpy as np
import pytest

from generativedensification_tpu.data import dataset_dict as j_datasets
from generativedensification_tpu.data.pipeline import BatchLoader as JLoader
from generativedensification_torch.data import build_dataset
from generativedensification_torch.data import dataset_dict as t_datasets
from generativedensification_torch.data.pipeline import BatchLoader
from test_data import _cfg, mini_h5  # noqa: F401  (the fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPIES = ("base", "gobjverse", "gso", "instant3d", "mipnerf", "shapenet", "mvgen",
          "utils")


@pytest.mark.parametrize("name", COPIES)
def test_dataset_sources_are_copies(name):
    port = ROOT / "generativedensification_torch" / "data" / f"{name}.py"
    ref = ROOT / "generativedensification_tpu" / "data" / f"{name}.py"
    assert port.read_bytes() == ref.read_bytes()


def test_registry_matches_jax():
    """Every dataset the JAX registry names is registered in the port (the
    port's ``synthetic`` renders with its own rasterizer); ``mvgen`` stays
    unregistered, as in JAX."""
    assert set(t_datasets) == set(j_datasets)
    assert "mvgen" not in t_datasets
    with pytest.raises(KeyError):
        t_datasets["nope"]


def test_missing_package_raises_when_built(mini_h5, monkeypatch):
    """A dataset whose package is missing raises that ``ImportError`` when it
    is built; importing the registry needs none of them."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        build_dataset(_cfg(mini_h5, "train"))


def _pair(root, split, seed=7):
    jd = j_datasets["gobjeverse"](_cfg(root, split))
    td = build_dataset(_cfg(root, split))
    jd.rng, td.rng = np.random.default_rng(seed), np.random.default_rng(seed)
    return jd, td


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if k == "meta":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("split", ["train", "test"])
def test_gobjverse_samples_bitwise(mini_h5, split):
    jd, td = _pair(mini_h5, split)
    assert len(jd) == len(td) > 0
    assert list(map(str, jd.scenes_name)) == list(map(str, td.scenes_name))
    for i in range(len(td)):
        _same(jd[i], td[i])


def test_gobjverse_batches_bitwise(mini_h5):
    """Collated batches of both loaders (shuffled by the same seed, B=2,
    two epochs) agree key by key, bit for bit."""
    jd, td = _pair(mini_h5, "train")
    jl = JLoader(jd, 2, shuffle=True, seed=3, process_index=0, process_count=1)
    tl = BatchLoader(td, 2, shuffle=True, seed=3)
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl) > 0
        for a, b in zip(jb, tb):
            _same(a, b)


def test_batchloader_propagates_worker_errors():
    """A dataset exception inside the prefetch thread surfaces in the
    consumer, chained to its cause."""

    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            raise ValueError("boom")

    bl = BatchLoader(Broken(), 2, shuffle=False, process_index=0, process_count=1)
    with pytest.raises(RuntimeError, match="worker failed") as err:
        next(iter(bl))
    assert isinstance(err.value.__cause__, ValueError)


class _Fake:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2, 2), i, np.float32), "meta": {"scene": str(i)}}


def _ids(loader):
    return [b["x"][:, 0, 0].astype(int).tolist() for b in loader]


@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_and_sharding(shuffle):
    """Round-robin shards per process: disjoint, of ``len`` batches, and the
    JAX loader's batches in the JAX order."""
    ds = _Fake(20)
    shards = []
    for rank in (0, 1):
        tl = BatchLoader(ds, 2, shuffle=shuffle, process_index=rank, process_count=2)
        jl = JLoader(ds, 2, shuffle=shuffle, process_index=rank, process_count=2)
        ids = _ids(tl)
        assert ids == _ids(jl) and len(ids) == len(tl) == 5
        shards.append({v for b in ids for v in b})
    assert shards[0].isdisjoint(shards[1])


def test_epoch_fraction_and_drop_last():
    ds = _Fake(20)
    tl = BatchLoader(ds, 2, shuffle=True, epoch_fraction=0.5, process_index=0,
                     process_count=1)
    jl = JLoader(ds, 2, shuffle=True, epoch_fraction=0.5, process_index=0,
                 process_count=1)
    assert _ids(tl) == _ids(jl) and len(tl) == 5
    # a new epoch reshuffles (seed + epoch), as JAX's does
    assert _ids(tl) == _ids(jl) and tl.epoch == jl.epoch == 2
    keep = BatchLoader(_Fake(7), 2, shuffle=False, drop_last=False,
                       process_index=0, process_count=1)
    assert _ids(keep) == [[0, 1], [2, 3], [4, 5], [6]] and len(keep) == 4


def test_loader_defaults_to_a_single_process():
    """Without ``torch.distributed`` a loader is rank 0 of 1 (the
    two-process case runs in ``tests/test_torch_ckpt.py``)."""
    tl = BatchLoader(_Fake(6), 2)
    assert (tl.process_index, tl.process_count) == (0, 1)
