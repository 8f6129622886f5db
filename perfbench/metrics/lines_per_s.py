"""Lines of the requests that came back in the window, over the window's wall time."""


def read(run):
    return run.lines / run.window_s if run.served else None
