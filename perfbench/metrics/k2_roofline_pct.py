"""K2 (csrc/decoder_layer_step.cu): the least time of the launches the
served lines need (yardstick.k2_least_s) over the traced device time of the
kernels named decoder_layer_step_kernel, in %."""

from perfbench.harness import yardstick

KERNEL = "decoder_layer_step_kernel"


def read(run):
    if run.trace is None or not run.served:
        return None
    spent = run.trace.time_s(KERNEL)
    return 100.0 * yardstick.k2_least_s(run) / spent if spent > 0 else None
