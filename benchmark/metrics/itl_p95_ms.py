"""95th percentile of every gap between consecutive output tokens of the
window's requests, pooled; a token's time is the end of the harness's
span around the engine tick (or prefill) that produced it."""
from benchmark.readers import nearest_rank


def read(run):
    if run.serve is None:
        return None
    p = nearest_rank(run.serve.gaps_ns, 0.95)
    return None if p is None else p / 1e6
