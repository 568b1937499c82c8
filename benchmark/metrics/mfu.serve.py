"""The whole reconstruction's share of the card's f32 peak: the model
FLOPs of one request (the matrix products, convolutions and attention of
the encoder, the modulation, the volume transformer, the heads and the
densifier, counted from shapes on the plain reference), times the requests
completed, over the window and 67 TFLOP/s (f32 without TF32), %."""

from benchmark.harness.counting import F32_OPS_PER_S


def read(r):
    f = r.get("flops_per_request")
    if not f:
        return None
    done = r["attempted"] - r["failed"]
    return 100.0 * f * done / r["window_s"] / F32_OPS_PER_S
