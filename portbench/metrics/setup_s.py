"""From the start of the process to the end of the warm-up: imports, the
kernels' build (or its cache), the weights, the engine and its warm-up
batch. An open loop's lead-in, which serves traffic, is not in it."""


def read(run):
    return run.setup_s
