"""The batch tenant's share of all jobs' DEVICE_TIME_NS in the window
(the ledger), over its share of the weights."""
from benchmark.readers import ledger_delta


def read(run):
    if run.serve is None:
        return None
    jobs = [run.batch.job, run.serve.job]
    dev = {j.name: ledger_delta(run, j.name, "DEVICE_TIME_NS") for j in jobs}
    total = sum(dev.values())
    if total <= 0:
        return None
    weight = run.batch.job.params.weight / sum(j.params.weight for j in jobs)
    return dev[run.batch.job.name] / total / weight
