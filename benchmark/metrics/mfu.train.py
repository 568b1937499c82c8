"""The whole micro-step's share of the card's peak: the model FLOPs of one
micro-step, forward and backward (the matrix products, convolutions and
attention, counted from shapes by ``torch.utils.flop_counter`` on the plain
reference's first checked micro-step at the cell's batch; the renders,
whose chains run in f64 there, left out), each product held to the peak of
the precision the policy runs it in: bf16 operands at 989 TFLOP/s (dense
tensor cores), f32 operands (the attention logits, the f32 layers) at 67
TFLOP/s.  That least time, times the micro-steps completed, over the
window, %."""

from benchmark.harness.counting import seconds_at_peak


def read(r):
    f = r.get("flops_by_dtype")
    if not f:
        return None
    return 100.0 * seconds_at_peak(f) * (r["attempted"] - r["failed"]) / r["window_s"]
