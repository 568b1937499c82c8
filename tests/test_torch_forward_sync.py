"""The forward with no host wait.

From the moment a batch's tensors are on the card until
``Network.forward`` returns, the host never waits for the device: no value
of the forward is made on the card from host data (a tensor from a Python
list, a list index, a scalar stored by ``__setitem__``), which PyTorch
copies from pageable memory and then synchronises.

On the CPU: the constructions that replaced such tensors (the rigid
inverse's bottom row, the ``-trans`` orders' column swap, the lift's and the
point features' normalised sample coordinates) bitwise against the
expressions they replaced, and a tiny-configuration forward, serving in
either renderer and training, that hands no tensor made from host data to
any operation.  On the card (``gpu`` marker; skips without one): the same
bitwise comparisons, and the serving forward of both renderers at the
serving configuration and the training forward under
``torch.cuda.set_sync_debug_mode("error")``.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_forward_sync.py
"""

import traceback
import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from generativedensification_torch.core.camera import rigid_inverse
from generativedensification_torch.data.synthetic import make_probe_batch
from generativedensification_torch.models.network import (
    Network,
    NetworkConfig,
    pixel_to_unit,
)
from generativedensification_torch.serialization.encode import ORDERS, encode
from generativedensification_torch.serialization.hilbert import hilbert_encode
from generativedensification_torch.serialization.zorder import z_encode
from generativedensification_torch.tools import overfit, scenes
from generativedensification_torch.tools.kernel_break import same_bits

torch.set_num_threads(1)

# the expressions the forward used to build from host data


def rigid_inverse_host(mat):
    R = mat[..., :3, :3]
    t = mat[..., :3, 3]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t[..., None])], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=mat.dtype, device=mat.device)
    return torch.cat([top, bottom.expand(*mat.shape[:-2], 1, 4)], dim=-2)


def encode_host(gc, depth, order):
    if order.endswith("-trans"):
        gc = gc[..., [1, 0, 2]]
    if order.startswith("z"):
        return z_encode(gc, depth=depth)
    return hilbert_encode(gc, num_bits=depth)


def pixel_to_unit_host(xy, W, H):
    img_wh = torch.tensor([W, H], dtype=torch.float32, device=xy.device)
    return (xy + 0.5) / img_wh * 2.0 - 1.0


def rigid_poses(batch, dtype, device, seed=0):
    """Random rotations (QR of a normal matrix, det +1) and translations."""
    g = torch.Generator().manual_seed(seed)
    q, r = torch.linalg.qr(torch.randn(*batch, 3, 3, generator=g, dtype=torch.float64))
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]
    q = torch.where(torch.linalg.det(q)[..., None, None] < 0, -q, q)
    mat = torch.zeros(*batch, 4, 4, dtype=torch.float64)
    mat[..., :3, :3] = q
    mat[..., :3, 3] = torch.randn(*batch, 3, generator=g, dtype=torch.float64) * 2.0
    mat[..., 3, 3] = 1.0
    return mat.to(dtype=dtype, device=device)


def grid_coords(depth, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    gc = torch.randint(0, 2 ** depth, (2, 300, 3), generator=g, dtype=torch.int32)
    return gc.to(device)


def pixel_coords(W, H, device, seed=0):
    """Sample points over the image and a margin around it (the lift's grid
    projects partly off-image)."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(4, 1000, 2, generator=g) * 1.4 - 0.2
    xy = u * torch.tensor([W, H], dtype=torch.float32)
    return xy.to(device)


BATCHES = [(), (8,), (3, 8)]
SIZES = [(512, 512), (64, 48), (37, 113)]


def check_rigid_inverse(dtype, batch, device):
    mat = rigid_poses(batch, dtype, device)
    assert same_bits(rigid_inverse(mat), rigid_inverse_host(mat))


def check_encode(order, depth, device):
    gc = grid_coords(depth, device, seed=depth)
    assert same_bits(encode(gc, depth=depth, order=order), encode_host(gc, depth, order))


def check_pixel_to_unit(W, H, device):
    xy = pixel_coords(W, H, device, seed=W)
    assert same_bits(pixel_to_unit(xy, W, H), pixel_to_unit_host(xy, W, H))


@pytest.mark.parametrize("batch", BATCHES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_rigid_inverse_bitwise(dtype, batch):
    check_rigid_inverse(dtype, batch, "cpu")


@pytest.mark.parametrize("depth", [1, 10, 16])
@pytest.mark.parametrize("order", ORDERS)
def test_encode_bitwise(order, depth):
    check_encode(order, depth, "cpu")


@pytest.mark.parametrize("W,H", SIZES)
def test_pixel_to_unit_bitwise(W, H):
    check_pixel_to_unit(W, H, "cpu")


# ------------------------------------------------------------------ host data


class HostData(TorchDispatchMode):
    """Records each operation that takes a tensor made from host data
    (``aten::lift_fresh`` / ``lift_fresh_copy``: ``torch.tensor``, a list
    index, a scalar stored by ``__setitem__``), with the port's frame that
    called it.  Reading such a tensor back as a Python number
    (``_local_scalar_dense``) stays on the host and is not recorded."""

    LIFT = {"lift_fresh", "lift_fresh_copy"}

    def __init__(self):
        super().__init__()
        self.lifted = {}             # id -> weak reference
        self.uses = []

    def is_lifted(self, a) -> bool:
        ref = self.lifted.get(id(a))
        return ref is not None and ref() is a

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        if name != "_local_scalar_dense" and any(
                isinstance(a, torch.Tensor) and self.is_lifted(a)
                for a in tree_leaves((args, kwargs or {}))):
            frames = [f for f in traceback.extract_stack()
                      if "generativedensification_torch" in f.filename]
            where = (f"{frames[-1].filename.rsplit('/', 2)[-2]}/"
                     f"{frames[-1].filename.rsplit('/', 1)[-1]}:{frames[-1].lineno}"
                     if frames else "?")
            self.uses.append(f"{func} at {where}")
        out = func(*args, **(kwargs or {}))
        if name in self.LIFT:
            self.lifted[id(out)] = weakref.ref(out)
        return out


def test_host_data_mode_sees_the_old_constructions():
    """The guard's own check: each construction the forward used to make
    from host data is recorded; the replacements are not."""
    mat = rigid_poses((2,), torch.float32, "cpu")
    gc = grid_coords(10, "cpu")
    xy = pixel_coords(64, 48, "cpu")
    with HostData() as old:
        rigid_inverse_host(mat)
        encode_host(gc, 10, "z-trans")
        pixel_to_unit_host(xy, 64, 48)
    with HostData() as new:
        rigid_inverse(mat)
        encode(gc, 10, "z-trans")
        pixel_to_unit(xy, 64, 48)
    assert len(old.uses) == 3 and new.uses == []


FORWARDS = {
    "serve.3dgs": (dict(renderer="3dgs"), False, 1),
    "serve.2dgs": (dict(renderer="2dgs"), False, 1),
    "train.3dgs": (dict(compute_dtype="bfloat16"), True, 2),
}


@pytest.mark.parametrize("case", list(FORWARDS))
def test_forward_makes_no_tensor_from_host_data(case):
    """A tiny-configuration ``Network.forward(with_fine=True)`` on the CPU
    (serving: ``mask_pool`` the whole coarse set and f32, as the serving
    overrides; training: bf16, ``mask_pool`` below it, B=2, autograd
    recording) hands no tensor made from host data to any operation."""
    changes, train, B = FORWARDS[case]
    n_coarse = overfit.TINY["n_offset_groups"] ** 3
    pool = overfit.TINY["mask_pool"] if train else n_coarse
    net = Network(NetworkConfig(**{**overfit.TINY, "mask_pool": pool, **changes}),
                  device="cpu", seed=0)
    net.train(train)
    batch = make_probe_batch(B, 4, 64, 64, 2, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0) if train else None
    with torch.set_grad_enabled(train), HostData() as mode:
        out = net(batch, with_fine=True, generator=gen)
    assert mode.uses == []
    assert out["image_fine"].shape == (B, 64, 4 * 64, 3)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the forward's renders are CUDA kernels")
    return torch.device("cuda")


@pytest.mark.gpu
def test_constructions_bitwise_on_card(cuda_device):
    for dtype in (torch.float32, torch.float64):
        for batch in BATCHES:
            check_rigid_inverse(dtype, batch, cuda_device)
    for order in ORDERS:
        for depth in (1, 10, 16):
            check_encode(order, depth, cuda_device)
    for W, H in SIZES:
        check_pixel_to_unit(W, H, cuda_device)


def no_sync_forward(net, batch, gen_seed=None):
    """One warm-up forward, then one under ``set_sync_debug_mode("error")``
    (each with a fresh generator from ``gen_seed`` when given)."""
    dev = batch["tar_rgb"].device
    gen = lambda: (None if gen_seed is None
                   else torch.Generator(device=dev).manual_seed(gen_seed))
    net(batch, with_fine=True, generator=gen())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = net(batch, with_fine=True, generator=gen())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("renderer", ["3dgs", "2dgs"])
def test_serving_forward_adds_no_host_sync(cuda_device, renderer):
    """The serving forward (the infer configuration in f32, as the serve
    cells run it: 4 + 4 views at 512², the whole fine stage) synchronises
    nowhere."""
    cfg = NetworkConfig.from_config(scenes.fine_config(**{"tpu.renderer": renderer}))
    net = Network(cfg, device=cuda_device, seed=0)
    net.eval()
    batch = make_probe_batch(1, 8, 512, 512, n_views=4, seed=0, device=cuda_device)
    with torch.no_grad():
        out = no_sync_forward(net, batch)
    assert bool(torch.isfinite(out["image_fine"]).all())


@pytest.mark.gpu
def test_training_forward_adds_no_host_sync(cuda_device):
    """The training forward (bf16, ``mask_pool`` 49,152, B=2, autograd
    recording, the densifier's draws from a card generator), forward only."""
    cfg = NetworkConfig.from_config(scenes.fine_config(
        **{"tpu.compute_dtype": "bfloat16", "model.mask_pool": 49152}))
    net = Network(cfg, device=cuda_device, seed=0)
    net.train()
    batch = make_probe_batch(2, 8, 512, 512, n_views=4, seed=0, device=cuda_device)
    out = no_sync_forward(net, batch, gen_seed=0)
    assert out["image_fine"].requires_grad
