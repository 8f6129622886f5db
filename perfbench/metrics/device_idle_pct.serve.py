"""Share of a serving window in which no kernel, copy or set ran on the card, in %."""


def read(run):
    if run.trace is None or not run.served:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
