"""Process start to the first timed request or step, in s."""


def read(run):
    return run.setup_s
