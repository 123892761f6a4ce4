"""All engine tick time over all engine ticks that ended in the window
(the harness's span around ``ContinuousBatcher.step``)."""


def read(run):
    if run.serve is None:
        return None
    ticks = [(a, b) for a, b, _ in run.serve.ticks
             if run.t0 <= b <= run.t_end]
    if not ticks:
        return None
    return sum(b - a for a, b in ticks) / len(ticks) / 1e6
