"""What a metric's reader is handed: one run's records, read-only.

A reader is ``metrics/<name>.py`` with ``read(run) -> float | None``;
None (nothing to read in this cell) leaves the metric out of the line.
"""
from __future__ import annotations

from dataclasses import dataclass

from . import counts

__all__ = ["View"]


@dataclass
class View:
    record: object          # window.Record
    cfg: dict               # the configuration file
    mix: dict               # the traffic mix
    setup_s: float
    trace: object = None    # devtrace.Trace of the traced batch, or None

    @property
    def window_s(self) -> float:
        return self.record.window_s

    @property
    def close_t(self) -> float:
        return self.record.open_t + self.record.window_s

    @property
    def batches(self) -> list:
        """The batches that ran inside the window."""
        return self.record.batches[self.record.first:self.record.n_window]

    def served_in_window(self, r) -> bool:
        return r.batch is not None and self.record.first <= r.batch < self.record.n_window

    @property
    def due(self) -> list:
        """Every request due inside the window."""
        return [r for r in self.record.requests.values() if self.record.open_t <= r.due <= self.close_t]

    def turnaround(self, r) -> float:
        """From when the request was due to the end of its batch, or to
        the window's close where it was still open."""
        end = self.record.batches[r.batch].t_end if self.served_in_window(r) else self.close_t
        return end - r.due

    def queue_wait(self, r) -> float:
        """From when it was due to the ``step`` call that served it (to the close, if none did)."""
        start = self.record.batches[r.batch].t_call if self.served_in_window(r) else self.close_t
        return start - r.due

    def lane_flops(self, steps: int) -> int:
        """Model FLOPs of one lane through positions 0…steps−1."""
        return steps * 2 * counts.matmul_params_per_token(self.cfg) + sum(
            counts.attention_flops(self.cfg, p) for p in range(steps))
