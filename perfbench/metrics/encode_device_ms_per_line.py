"""Device time (the union of their intervals) of the kernels and copies that
the Predictor's dispatch thread launched (preparation, transfer, encode),
per line served, in ms. Launches are told apart by the host thread of their
runtime call: every thread but the one that called predict_batch."""


def read(run):
    if run.trace is None or not run.served:
        return None
    busy = run.trace.busy_s(launcher="other")
    return busy * 1e3 / run.lines if busy > 0 else None
