"""Every tenant's model FLOPs in the window (``benchmark/flops.py``,
from the shapes run: the batch tenant's completed steps, the serving
tenant's prefills and decoded tokens, padding and empty lanes not
counted) over the window times the card's bf16 peak, in percent."""
from benchmark import flops as F
from benchmark.readers import window_steps


def read(run):
    if run.device.type != "cuda":
        return None
    work = len(window_steps(run)) * run.batch.step_flops()
    if run.serve is not None:
        work += sum(f for t, f in run.serve.work if run.t0 <= t <= run.t_end)
    return 100.0 * work / (run.seconds * F.PEAK["flops"])
