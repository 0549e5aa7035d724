"""The 95th percentile turnaround of every request due in the window (open ones at their age at the close)."""
import numpy as np


def read(run):
    t = [run.turnaround(r) for r in run.due]
    return float(np.percentile(t, 95)) if t else None
