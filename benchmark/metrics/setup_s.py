"""Process start to the first timed instant: imports, the kernels' load
(or build), weights, tenants, the training tenant's first steps and
every warm-up."""


def read(run):
    return run.setup_s
