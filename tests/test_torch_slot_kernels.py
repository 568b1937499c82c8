"""The plain versions of kernels #5 (``kernels.reduce_slots``) and #6
(``kernels.transpose_rows``) against the JAX package's ``pallas_reduce_slots``
and ``pallas_transpose16``, run in interpret mode on the CPU as
``tests/test_pallas.py`` runs the Pallas kernels, on the same seeded numpy
inputs: n a multiple of ``RED_BN`` (128) and M of ``TBLK`` (512), d 4 / 9 /
16 (the slots per Gaussian of the budgets), w 2 / 10 / 12 / 19 (the widths
the backwards write).

The transpose holds bit for bit on finite inputs: the identity matmul at
HIGHEST precision adds only exact zero products to each value.  The
reduction holds within 1e-6 of the sum of the |terms| of each output: the
selector matmul adds the d rows in an order of its own, where the port adds
them in increasing slot order (measured on the CPU: at most 2.8e-7 of that
sum, at d 16; 57% of the outputs equal bit for bit).
Also the helpers that the card's checks of #5 / #6 use
(``tools/kernel_break.py``): their edge-case inputs and ``same_bits``."""

import numpy as np
import pytest
import torch

from generativedensification_tpu.splat.pallas_kernels import (
    RED_BN,
    TBLK,
    pallas_reduce_slots,
    pallas_transpose16,
)
from generativedensification_torch.splat import kernels
from generativedensification_torch.tools import kernel_break

REDUCE_RTOL = 1e-6       # of the sum of |terms| per output element


def _rows(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.uniform(size=shape[0]) < 0.3] = 0.0          # dead slots are zero
    return x


@pytest.mark.parametrize("w", [2, 10, 12, 19])
@pytest.mark.parametrize("d", [4, 9, 16])
def test_reduce_slots_plain_matches_jax(d, w):
    n = 2 * RED_BN
    rows = _rows((n * d, w), seed=100 * d + w)
    ref = np.asarray(pallas_reduce_slots(rows, n, d, width=w))
    out = kernels.reduce_slots(torch.from_numpy(rows), n, d).numpy()
    terms = np.abs(rows).reshape(n, d, w).sum(1)
    gap = np.abs(out - ref)
    assert out.shape == ref.shape == (n, w)
    assert np.all(gap <= REDUCE_RTOL * terms), float((gap / np.maximum(terms, 1e-30)).max())


@pytest.mark.parametrize("w", [2, 10, 12, 19])
def test_transpose_rows_plain_matches_jax(w):
    M = 2 * TBLK
    cols = _rows((w, M), seed=w)
    ref = np.asarray(pallas_transpose16(cols))
    out = kernels.transpose_rows(torch.from_numpy(cols)).numpy()
    assert out.shape == ref.shape == (M, w)
    assert np.array_equal(out.view(np.int32), ref.view(np.int32))


def test_slot_case_inputs_and_same_bits():
    """The edge cases' offsets give bases that are not 16 B aligned, their
    special values are there, and ``same_bits`` tells NaN places, signed
    zeros and payload-free NaNs apart as a bitwise comparison must; the
    wrappers take the plain versions on the CPU for such inputs."""
    for label, (_, _, w, offset, _) in kernel_break.REDUCE_CASES.items():
        assert ("offset" in label) == (offset * 4 % 16 != 0), label
    for label, (w, M, offset, _) in kernel_break.TRANSPOSE_CASES.items():
        assert ("offset" in label) == (offset * 4 % 16 != 0), label
    x = kernel_break._slot_tensor((9 * 50, 10), 10, True, 0, "cpu")
    assert x.is_contiguous() and x.data_ptr() % 16
    assert torch.isnan(x).any() and torch.isposinf(x).any() and torch.isneginf(x).any()
    out = kernels.reduce_slots(x, 50, 9)
    assert kernel_break.same_bits(out, kernels.reduce_slots_plain(x, 50, 9))
    assert kernel_break.same_bits(kernels.transpose_rows(x.t().contiguous()), x)
    a = torch.tensor([0.0, 1.0, float("nan")])
    assert kernel_break.same_bits(a, a.clone())
    assert not kernel_break.same_bits(a, torch.tensor([-0.0, 1.0, float("nan")]))
    assert not kernel_break.same_bits(a, torch.tensor([0.0, float("nan"), 1.0]))
    assert not kernel_break.same_bits(a, a[:2])
