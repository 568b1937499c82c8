"""The yardstick's arithmetic: published peaks, the roofline bound of a
compositor launch from its inputs, and the model FLOPs of a forward.

Peaks and per-pair operation counts are those of the port's
``tools/timing.py``, copied so that a change to the program cannot move
them.  A launch's operations are the (primitive, pixel) pairs its inputs
need (those that pass the alpha cut before the pixel's stop, counted by the
benchmark's own compositor, ``reference/splat/*kernels.py::pair_counts``)
times the operations of one such pair; its bytes are every input read once
and every output written once.  Neither depends on what an implementation
skips.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # bf16 on the tensor cores, dense
# the peak each product's operand type runs at
PEAK_BY_DTYPE = {"torch.bfloat16": BF16_OPS_PER_S, "torch.float32": F32_OPS_PER_S}

# per contributing (slot, pixel) pair: the evaluation (2 diffs, the power
# form's 7, clamp, exp, opacity product, alpha clamp, the 1/255 compare:
# 17), then the forward's chain and sums (12) or the backward's per mode
OPS_PER_EVAL = 17
OPS_PER_CONTRIB = 12
OPS_PER_CONTRIB_BWD = {"full": 54, "noabs": 50, "selonly": 33}
# surfels: the circle test (6), the evaluation inside it (31), then per
# contribution the forward (30) or the backward per mode
SURFEL_OPS_PER_EVAL = 6
SURFEL_OPS_PER_INSIDE = 31
SURFEL_OPS_PER_CONTRIB = {"fwd": 30, "selonly": 55, "full": 106}

# the tile-grid arguments of each compositor wrapper, after its tensors
_N_TENSORS = {"composite_fwd": 4, "composite_bwd": 6, "surfel_fwd": 5,
              "surfel_bwd": 7}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def launch_cost(name: str, args: tuple, kwargs: dict | None = None) -> tuple:
    """(bytes, operations) of one launch of a compositor wrapper, from the
    arguments it was called with."""
    from ..reference.splat import kernels as rk
    from ..reference.splat import surfel_kernels as rs

    kwargs = kwargs or {}
    n = _N_TENSORS[name]
    tensors, rest = args[:n], list(args[n:])
    tiles_x, tiles_y, ts = rest[:3]
    mode = rest[3] if len(rest) > 3 else kwargs.get("mode", "full")
    num_tiles, npix = tiles_x * tiles_y, ts * ts
    P = tensors[1].shape[0]
    if name.startswith("composite"):
        pairs = rk.pair_counts(*tensors[:4], tiles_x, tiles_y, ts)
        if name == "composite_fwd":
            return (_nbytes(*tensors) + num_tiles * rk.OUT_ROWS * npix * 4,
                    pairs * (OPS_PER_EVAL + OPS_PER_CONTRIB))
        return (_nbytes(*tensors) + P * rk.BWD_ROWS[mode] * 4,
                pairs * (OPS_PER_EVAL + OPS_PER_CONTRIB_BWD[mode]))
    pairs = rs.pair_counts(*tensors[:5], tiles_x, tiles_y, ts)
    per = SURFEL_OPS_PER_EVAL + SURFEL_OPS_PER_INSIDE
    if name == "surfel_fwd":
        return (_nbytes(*tensors) + num_tiles * len(rs.FWD_ROWS) * npix * 4,
                pairs * (per + SURFEL_OPS_PER_CONTRIB["fwd"]))
    return (_nbytes(*tensors) + P * rs.SURFEL_BWD_ROWS[mode] * 4,
            pairs * (per + SURFEL_OPS_PER_CONTRIB[mode]))


def bound_s(n_bytes: int, ops: int) -> float:
    """The least time of a launch: bytes over the memory rate or f32
    operations over the f32 rate, whichever is larger."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def model_flops(run_forward) -> int:
    """FLOPs of the matrix products, convolutions and attention that
    ``run_forward()`` runs inside the network's sub-modules (the encoder,
    the feature modulation, the volume transformer, the heads and the
    densifier), as ``torch.utils.flop_counter`` counts them from shapes;
    the renders, which run outside every sub-module, are left out."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        run_forward()
    counts = counter.get_flop_counts()
    # keys are the paths of the modules that ran: the outermost below the
    # top module (a ModuleList's members stand for it)
    inner = [k for k in counts if "." in k]
    outer = [k for k in inner if not any(k.startswith(o + ".") for o in inner)]
    return int(sum(sum(counts[k].values()) for k in outer))


def flops_by_dtype(run) -> dict:
    """{operand dtype: FLOPs} of the matrix products, convolutions and
    attention that ``run()`` dispatches, forward and backward, as
    ``torch.utils.flop_counter`` counts each from its shapes, keyed by the
    dtype of its first tensor operand.  f64 products (the reference
    compositors' chains: the renders) are left out."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    counts: dict = {}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                dt = next(t.dtype for t in tree_leaves(args) if torch.is_tensor(t))
                if dt != torch.float64:
                    counts[str(dt)] = counts.get(str(dt), 0) + int(
                        count(*args, **kwargs, out_val=out))
            return out

    with Count():
        run()
    return counts


def seconds_at_peak(flops: dict) -> float:
    """The least time of the products counted by ``flops_by_dtype``, each
    at the peak of its operand type."""
    return sum(f / PEAK_BY_DTYPE[dt] for dt, f in flops.items())
