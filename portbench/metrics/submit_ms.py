"""Mean host time of one ``engine.submit`` (the §X queues re-prioritise
every waiting request on each): the benchmark's span around each
``submit_group`` call, over its requests, in the window."""


def read(run):
    n = sum(k for _, k in run.record.submits)
    return sum(s for s, _ in run.record.submits) / n * 1e3 if n else None
