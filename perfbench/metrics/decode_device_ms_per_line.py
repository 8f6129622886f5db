"""Device time (the union of their intervals) of the kernels and copies
launched from the thread that called predict_batch (the decode, its graph
replays and the tokens' copy back), per line served, in ms."""


def read(run):
    if run.trace is None or not run.served:
        return None
    busy = run.trace.busy_s(launcher="main")
    return busy * 1e3 / run.lines if busy > 0 else None
