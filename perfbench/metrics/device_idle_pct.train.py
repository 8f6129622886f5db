"""Share of a training window in which no kernel, copy or set ran on the card, in %."""


def read(run):
    if run.trace is None or not run.samples:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
