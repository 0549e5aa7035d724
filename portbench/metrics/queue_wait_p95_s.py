"""The 95th percentile, over every request due in the window, of the time
from when it was due to the ``step`` call that served it (to the close
for a request no call served)."""
import numpy as np


def read(run):
    w = [run.queue_wait(r) for r in run.due]
    return float(np.percentile(w, 95)) if w else None
