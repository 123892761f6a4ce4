"""The training tenant's DEVICE_TIME_NS over its STEPS_RETIRED in the
window (the ledger): one optimizer step of all its micro-steps."""
from benchmark.readers import ledger_delta


def read(run):
    if run.batch.job.name != "train":
        return None
    steps = ledger_delta(run, "train", "STEPS_RETIRED")
    if steps <= 0:
        return None
    return ledger_delta(run, "train", "DEVICE_TIME_NS") / steps / 1e6
