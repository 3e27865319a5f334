"""`setup_s`: from the start of the process to the first timed request
(imports, the kernels' build check, the weights, the warm-up)."""


def read(run):
    return run.setup_s
