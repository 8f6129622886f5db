"""The 95th percentile of every request's time from submission to its strings, in ms."""

import numpy as np


def read(run):
    if not run.served:
        return None
    return float(np.percentile([s.latency_s for s in run.served], 95)) * 1e3
