"""95th percentile over the window's requests of the time from a
request's due time to the serving job's next SCHED_PICK on the
partition's trace ring."""
from benchmark.readers import due_requests, nearest_rank, next_after, picks


def read(run):
    if run.serve is None:
        return None
    ts = picks(run)
    waits = []
    for r in due_requests(run):
        t = next_after(ts, r["due_ns"])
        waits.append((t if t is not None else run.t_drained) - r["due_ns"])
    p = nearest_rank(waits, 0.95)
    return None if p is None else p / 1e6
