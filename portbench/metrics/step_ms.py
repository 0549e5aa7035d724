"""The window's batches' summed host time over their summed lockstep
steps (prompt steps and output steps), in milliseconds."""


def read(run):
    b = run.batches
    steps = sum(x.steps for x in b)
    return sum(x.t_end - x.t_call for x in b) / steps * 1e3 if steps else None
