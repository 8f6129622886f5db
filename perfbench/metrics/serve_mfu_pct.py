"""The FLOPs the window's lines need (convolutions, patch projection,
encoder, BiLSTM, the memory's cross K/V, and the decoder and vocabulary
projection over each line's served steps on every lane) over the traced
window's length and the card's peak for the storage type, in %."""

from perfbench.harness import yardstick


def read(run):
    if run.trace is None or not run.served:
        return None
    itemsize = 2 if run.cell["serve"]["compute_dtype"] == "bfloat16" else 4
    return 100.0 * yardstick.serve_flops(run) / run.trace.window_s / yardstick.peak_ops(itemsize)
