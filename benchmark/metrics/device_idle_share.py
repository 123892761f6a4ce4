"""The share of the traced window in which no operation ran on the
device, in percent."""


def read(run):
    if run.trace is None or run.trace["window_ns"] <= 0:
        return None
    return 100.0 * (1 - run.trace["busy_ns"] / run.trace["window_ns"])
