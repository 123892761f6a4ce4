"""The scoring tenant's DEVICE_TIME_NS over its STEPS_RETIRED in the
window (the ledger)."""
from benchmark.readers import ledger_delta


def read(run):
    if run.batch.job.name != "score":
        return None
    steps = ledger_delta(run, "score", "STEPS_RETIRED")
    if steps <= 0:
        return None
    return ledger_delta(run, "score", "DEVICE_TIME_NS") / steps / 1e6
