"""Samples whose train steps completed in the window, over the window's wall time."""


def read(run):
    return run.samples / run.window_s if run.samples else None
