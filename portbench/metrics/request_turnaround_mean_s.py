"""The mean turnaround of every request due in the window (open ones at their age at the close)."""
import numpy as np


def read(run):
    t = [run.turnaround(r) for r in run.due]
    return float(np.mean(t)) if t else None
