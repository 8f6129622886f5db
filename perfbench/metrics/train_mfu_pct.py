"""Model FLOPs of the forward and backward passes (three times the forward,
no recomputation) that the traced window's trained lines need at their own
chunks and label lengths, not their buckets', over the window's length and
the card's float32 peak, in %."""

from perfbench.harness import yardstick


def read(run):
    if run.trace is None or not run.train_shapes:
        return None
    flops = sum(yardstick.line_train_flops(run.model, c, t) for c, t in run.train_shapes)
    return 100.0 * flops / run.trace.window_s / yardstick.F32_OPS_PER_S
