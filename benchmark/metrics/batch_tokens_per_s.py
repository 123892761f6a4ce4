"""The batch tenant's tokens in steps completed inside the window, over
the window: trained tokens (each micro-step's predicted tokens) or
scored tokens."""
from benchmark.readers import window_steps


def read(run):
    return sum(s[2] for s in window_steps(run)) / run.seconds
