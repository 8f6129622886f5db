"""The encode's share of its roofline: the least time of the served lines'
encode over the device time that the Predictor's dispatch thread launched
(its union of intervals: preparation, transfer and encode), in %.

The least time is ``yardstick.line_encode_flops`` of each line at its own
real chunks (never a padding chunk or a padding row: every chunk through the
backbone, the patch projection and the encoder layers, the BiLSTM where the
model has one, and the decoder's cross K and V of the memory) over the
card's peak for the storage type (float32: 67 TFLOP/s). Bytes do not bind:
read and written once a convolution in float32, a chunk's activations are
10.5 MB against 5.04 GFLOP for the ResNet backbone and 4.6 MB against 2.13
GFLOP for SE-VGG, about 480 and 460 FLOP a byte, where the card's float32
ridge lies at 20 (67 TFLOP/s over 3.35 TB/s); the weights, read once a
batch, add under 1 MB a chunk at 64 chunks a batch.

The count is a direct convolution's multiply-adds. Where cuDNN picks a
Winograd or FFT algorithm, which does fewer, the reading can overstate the
share of the work the card did: on an H100 it runs some of the ResNet's
float32 convolutions by FFT (complex GEMMs and pointwise complex products
in the trace).
"""

from perfbench.harness import yardstick


def read(run):
    if run.trace is None or not run.served:
        return None
    spent = run.trace.busy_s(launcher="other")
    if spent <= 0:
        return None
    itemsize = 2 if run.cell["serve"]["compute_dtype"] == "bfloat16" else 4
    flops = sum(yardstick.line_encode_flops(run.model, c) for req in run.served for c in req.chunks)
    return 100.0 * flops / yardstick.peak_ops(itemsize) / spent
