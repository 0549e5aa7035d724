"""The 95th percentile, over every request due in the window, of the time
from when it was due to its first token on the host (the program's
``first_token`` mark), open ones at their age at the close, as the
turnarounds take them. Nothing without the program's marks."""
import numpy as np


def read(run):
    spans = getattr(run, "spans", None)
    if spans is None or not run.due:
        return None
    first = {rid: run.window_time(ns) for rid, name, ns in spans.marks if name == "first_token"}
    return float(np.percentile([min(first.get(r.rid, run.close_t), run.close_t) - r.due for r in run.due], 95))
