"""Set-up: from the start of the process to the first timed batch.  It
holds the imports, the kernel libraries' load (and, the first time in a
checkout, their nvcc build), the weight draw and one warm batch of the
cell's shape with its graph capture."""
UNIT, RUN, SOURCE = "s", "plain", "host_clock"


def read(run):
    return run.setup_s
