"""The compositors' footprint skip on the CPU: ``kernels.subtile_touch`` (the
PyTorch mirror of the CUDA kernels' per-sub-tile predicate) is conservative,
the plain versions with the skip are bitwise the plain versions without it
(forward and every backward mode, 16 and 32 px tiles, with pixels and tiles
that stop early), and the skip-mirrored plain forward agrees with the JAX
package's XLA compositor.  Seeded numpy / port scenes at 128²-256²."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generativedensification_tpu.splat.composite import composite_tiles as j_composite
from generativedensification_torch.splat import kernels
from generativedensification_torch.splat import probe_kernels as pk
from generativedensification_torch.splat.composite import (
    _bwd_common,
    _images,
    mse_image_cotangent,
)
from generativedensification_torch.tools import scenes

torch.set_num_threads(1)

ATOL_3DGS = 2e-4     # the JAX package's forward contract (tests/test_pallas.py)


def _scene(name, ts, hw=256):
    if name == "adversarial":
        args, _, _ = scenes.adversarial_scene("cpu", ts, hw=hw)
    else:    # bench.py's distributions, 3,000 Gaussians
        args, _, _ = scenes.bench_scene("cpu", ts, 9, n=3000, hw=hw)
    return args


def _segments(args):
    """Every in-segment slot, its tile and its row's tile-local centre,
    conic and folded opacity."""
    table, ids, starts, counts, tx, ty, ts = args
    counts = counts.long()
    tile = torch.repeat_interleave(torch.arange(tx * ty), counts)
    rank = torch.arange(tile.shape[0]) - (torch.cumsum(counts, 0) - counts)[tile]
    slot = starts.long()[tile] + rank
    rows = table[ids[slot].long()]
    gx = rows[:, 0] - ((tile % tx) * ts).float()
    gy = rows[:, 1] - (torch.div(tile, tx, rounding_mode="floor") * ts).float()
    opa = torch.where(rows[:, 10] > 0, rows[:, 5], torch.zeros_like(rows[:, 5]))
    return slot, gx, gy, rows[:, 2], rows[:, 3], rows[:, 4], opa


def _max_alpha(args):
    """(sub-tiles, P) the largest alpha of each in-segment slot over each
    sub-tile's pixels, in the plain forward's operations (-1 elsewhere)."""
    ts = args[6]
    side = ts // kernels.SUBTILE
    slot, gx, gy, a, b, c, opa = _segments(args)
    out = torch.full((side * side, args[1].shape[0]), -1.0)
    lin = torch.arange(kernels.SUBTILE, dtype=torch.float32)
    for q in range(side * side):
        px = ((q % side) * kernels.SUBTILE + lin).repeat(kernels.SUBTILE)
        py = ((q // side) * kernels.SUBTILE + lin).repeat_interleave(kernels.SUBTILE)
        for s0 in range(0, slot.shape[0], 2048):
            sl = slice(s0, s0 + 2048)
            dx = px - gx[sl, None]
            dy = py - gy[sl, None]
            power = torch.clamp(-0.5 * (a[sl, None] * dx * dx + c[sl, None] * dy * dy)
                                - b[sl, None] * dx * dy, max=0.0)
            alpha = torch.clamp(opa[sl, None] * torch.exp(power), max=kernels.ALPHA_MAX)
            out[q, slot[sl]] = alpha.max(dim=1).values
    return out


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("name", ["bench", "adversarial"])
def test_touch_is_conservative(name, ts):
    """Every (slot, sub-tile) pair the skip drops has plain alpha < 1/255 at
    every pixel of the sub-tile; the skip drops a real share of the pairs
    (at 32 px tiles, where the sub-tile is a quarter of the binned tile),
    and on the adversarial scene some dropped pairs there come within a
    factor 2 of the threshold."""
    args = _scene(name, ts)
    touch = kernels.subtile_touch(*args)
    best = _max_alpha(args)
    in_seg = best >= 0
    assert torch.equal(touch & ~in_seg, torch.zeros_like(touch))
    dropped = in_seg & ~touch
    assert bool((best[dropped] < kernels.ALPHA_MIN).all()), float(best[dropped].max())
    kept_share = float(touch.sum()) / float(in_seg.sum())
    if ts == 32:
        assert kept_share < 0.75, kept_share
        if name == "adversarial":
            assert float(best[dropped].max()) > 0.5 * kernels.ALPHA_MIN


def test_keep_rules():
    """The predicate's rules on hand-made slots: a slot far from the
    rectangle is dropped, one centred in it kept; a non-finite entry or a
    conic that is not positive definite keeps the slot; opacity <= 0 drops
    it; opacity at 1/255 keeps only a slot whose peak lies in the
    rectangle."""
    f = lambda *v: torch.tensor(v, dtype=torch.float32)
    inf, nan = float("inf"), float("nan")
    #          gx     gy    a     b     c    opa
    rows = f([40.0, 7.5, 1.0, 0.0, 1.0, 0.9],       # 32 px away: drop
             [7.5, 7.5, 1.0, 0.0, 1.0, 0.9],        # centred: keep
             [40.0, 7.5, nan, 0.0, 1.0, 0.9],       # non-finite: keep
             [inf, 7.5, 1.0, 0.0, 1.0, 0.9],
             [40.0, 7.5, 1.0, 2.0, 1.0, 0.9],       # b² > ac: keep
             [40.0, 7.5, -1.0, 0.0, 1.0, 0.9],      # a < 0: keep
             [7.5, 7.5, 1.0, 0.0, 1.0, 0.0],        # folded opacity 0: drop
             [7.5, 7.5, 1.0, 0.0, 1.0, -0.5],
             [3.0, 3.0, 1.0, 0.0, 1.0, 1.0 / 255],  # peak inside, at 1/255: keep
             [-1.0, 3.0, 1.0, 0.0, 1.0, 1.0 / 255],  # 1 px outside: drop
             [-1.0, 3.0, 1.0, 0.0, 1.0, 0.5],       # 1 px outside, opaque: keep
             [40.0, 7.5, 1e-6, 0.0, 1e-6, 0.9])     # 30 px wide: keep
    keep = kernels.subtile_keep(*rows.unbind(1), 7.5, 7.5)
    assert keep.tolist() == [False, True, True, True, True, True, False, False,
                             True, False, True, True]


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("name", ["bench", "adversarial"])
def test_forward_with_touch_is_bitwise(name, ts):
    """``composite_fwd_plain(touch=...)`` equals ``composite_fwd_plain``
    bit for bit and counts the evaluations the skip leaves; on the
    adversarial scene pixels saturate and whole tiles stop before their
    last staging batch."""
    args = _scene(name, ts)
    touch = kernels.subtile_touch(*args)
    st_all, st_kept = {}, {}
    ref = kernels.composite_fwd_plain(*args, stats=st_all)
    out = kernels.composite_fwd_plain(*args, stats=st_kept, touch=touch)
    assert torch.equal(out, ref)
    assert st_kept["evals"] == st_all["evals"]
    assert st_kept["contribs"] == st_all["contribs"]
    assert 0 < st_kept["evals_kept"] <= st_kept["evals"]
    if name == "adversarial":
        trips = pk.composite_fwd_probe_plain("trips", *args)
        assert bool((trips[:, 0, 0] < trips[:, 1, 0]).any())   # tiles stop early
        assert float(ref[:, 4].max()) > 0.999


@pytest.mark.parametrize("ts", [16, 32])
@pytest.mark.parametrize("name", ["bench", "adversarial"])
def test_backward_with_touch_is_bitwise(name, ts):
    """``composite_bwd_plain(touch=...)`` equals ``composite_bwd_plain`` bit
    for bit in all three modes (128², seeded image-MSE, alpha and depth
    cotangents)."""
    args = _scene(name, ts, hw=128)
    table, ids, starts, counts, tx, ty, _ = args
    out = kernels.composite_fwd_plain(*args)
    bg = torch.ones(3)
    image, alpha, depth = _images(out, bg, tx, ty, ts)
    rng = np.random.default_rng(3)
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    cot = (mse_image_cotangent(image, f(rng.uniform(size=tuple(image.shape)))),
           f(rng.normal(size=tuple(alpha.shape)) * 1e-4),
           f(rng.normal(size=tuple(depth.shape)) * 1e-4))
    gc4, g2, _ = _bwd_common(out, bg, cot, tx, ty, ts)
    touch = kernels.subtile_touch(*args)
    for mode in kernels.BWD_ROWS:
        bargs = (table, ids, starts, counts, gc4, g2, tx, ty, ts)
        ref = kernels.composite_bwd_plain(*bargs, mode=mode)
        got = kernels.composite_bwd_plain(*bargs, mode=mode, touch=touch)
        assert float(ref.abs().max()) > 0, mode
        assert torch.equal(got, ref), mode


@pytest.mark.parametrize("ts", [16, 32])
def test_skip_mirrored_forward_matches_jax(ts):
    """The plain forward with the skip against the JAX package's XLA
    compositor on the same arrays (bench.py's distributions, 3,000
    Gaussians at 128²): image, alpha and depth within 2e-4.  (The
    adversarial scene sets alphas within 0.1% of the 1/255 cut on purpose,
    where two correct compositors may round to either side.)"""
    args = _scene("bench", ts, hw=128)
    table, ids, starts, counts, tx, ty, _ = args
    touch = kernels.subtile_touch(*args)
    assert not bool(touch.all())
    bg = np.asarray([0.3, 0.6, 0.9], np.float32)
    out = kernels.composite_fwd_plain(*args, touch=touch)
    port = _images(out, torch.from_numpy(bg), tx, ty, ts)
    tab = table.numpy()
    opa = np.where(tab[:, 10] > 0, tab[:, 5], 0).astype(np.float32)
    ids_j = jnp.asarray(ids.numpy())
    bins = (ids_j, ids_j, ids_j, ids_j, ids_j, jnp.asarray(starts.numpy()),
            jnp.asarray(counts.numpy()))
    chunk = 32
    max_per_tile = -(-int(counts.max()) // chunk) * chunk
    xy = jnp.asarray(tab[:, 0:2])
    jo = jax.jit(lambda xy, conic, color, opa, depth, bg, bins: j_composite(
        xy, jnp.zeros_like(xy), conic, color, opa, depth, bg, bins, tx, ty, ts,
        max_per_tile, chunk, "xla"))(
        xy, jnp.asarray(tab[:, 2:5]), jnp.asarray(tab[:, 6:9]), jnp.asarray(opa),
        jnp.asarray(tab[:, 9]), jnp.asarray(bg), bins)
    assert float(port[1].max()) > 0.5
    for a, b, name in zip(jo, port, ("image", "alpha", "depth")):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL_3DGS, rtol=0,
                                   err_msg=name)
