"""Seconds from the start of the process to the first timed batch: start-up,
the kernels' build where it has not run before, the inputs and the
warm-up."""


def read(run):
    return run.setup_s
