"""Spans, counters and request marks inside the served path, on the device
trace's clock; off unless turned on from code.

``enable()`` starts a recording, ``collect()`` returns what it holds so
far, ``disable()`` stops it. No environment variable, flag or exporter
turns it on or writes it out: a caller reads ``collect()`` in process.

- ``span(name, **attrs)``: a context manager that records (name, start
  ns, end ns, the enclosing span, attrs); ``.set(**attrs)`` adds attrs
  known only inside it.
- ``count(name, n)``: adds ``n`` to a named counter. ``n`` may be a
  device tensor: the sum then stays on the device, and ``collect()``
  reads it once. The step itself never reads one back.
- ``mark(rid, name)``: stamps one request's event.

**Cost when off.** Every call site tests one module-level flag: ``span``
returns one shared no-op context, ``count`` and ``mark`` return. Nothing
is recorded and no device work is queued; a call site whose count needs
a device operation first tests ``is_on()``. The recorder is one per
process, not an object handed down the call chain, so that a call site
deep in a model costs only that test.

**One clock with the device trace.** Times are ``time.time_ns()``, the
Unix epoch in ns: ``torch.profiler`` (Kineto) gives its events, the
device's activity and the host's CUDA runtime calls alike, in ns of the
Unix epoch. On an H100 with torch 2.11 each of 400 ``cudaLaunchKernelExC``
calls of one-kernel launches fell between the ``time.time_ns()`` reads
around it, none between ``time.perf_counter_ns()`` or
``time.monotonic_ns()`` reads (another epoch), and torch 2.11 exposes no
profiler clock of its own to Python. So a profiled step's launches fall
inside the program's spans, and its device gaps can be laid against them.

The served path records (``serving/engine.py``, ``models/decode.py``,
``models/moe.py``):

  engine.submit     ``submit_group`` (attr requests)
  engine.step       one cycle (attrs batch, lanes, plen), holding
                    engine.form_batch, engine.prefill (the prompt's
                    lockstep steps) and engine.generate (the output steps)
  step.launch       ``_step``: the tokens to the device and the
                    ``decode_step`` call, which returns once enqueued
  step.readback     ``_greedy``: the argmax and its copy to the host
  step.bookkeep     the per-lane loop that appends and retires
  decode.embed, decode.block (attrs layer, kind) holding decode.attn or
  decode.mla and decode.mlp or decode.moe, decode.head
  moe.route, moe.dispatch, moe.experts, moe.combine (``_moe_gather``)

counters ``moe.routed`` and ``moe.dropped`` (the (token, choice) pairs of
the single-device dispatch, and those at or past the capacity), and the
mark ``first_token`` of each request, once its first token is on the host.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["Span", "Recording", "enable", "disable", "collect", "is_on", "span", "count", "mark"]

_on = False                      # the flag every call site tests
_rec: "Recording | None" = None  # the recording written while on

clock_ns = time.time_ns


class Span:
    """One recorded span; its own context manager while it is open.
    ``parent`` is the index in ``Recording.spans`` of the span that
    encloses it (−1: none)."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "_open")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.end_ns = name, attrs, None

    def __enter__(self) -> "Span":
        rec = _rec
        self._open = rec._open
        self.parent = rec._open[-1] if rec._open else -1
        rec._open.append(len(rec.spans))
        rec.spans.append(self)
        self.start_ns = clock_ns()
        return self

    def __exit__(self, typ, val, tb) -> None:
        self.end_ns = clock_ns()
        self._open.pop()

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, parent={self.parent}, {self.attrs})"


class _Off:
    """The shared context every ``span`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, typ, val, tb) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


_OFF = _Off()


@dataclass
class Recording:
    spans: list = field(default_factory=list)     # Span, in the order they opened
    counts: dict = field(default_factory=dict)    # name → int (a device tensor while recording)
    marks: list = field(default_factory=list)     # (rid, name, ns)
    _open: list = field(default_factory=list, repr=False)   # indices of the open spans, innermost last

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]


def enable() -> None:
    """Start a new recording."""
    global _on, _rec
    _rec, _on = Recording(), True


def disable() -> None:
    """Stop recording and let the recording go."""
    global _on, _rec
    _on, _rec = False, None


def is_on() -> bool:
    return _on


def collect() -> Recording:
    """What the recording holds so far, each counter read to an int (one
    read of a device counter); empty while tracing is off."""
    if _rec is None:
        return Recording()
    return Recording(spans=list(_rec.spans), counts={k: int(v) for k, v in _rec.counts.items()},
                     marks=list(_rec.marks))


def span(name: str, **attrs):
    if not _on:
        return _OFF
    return Span(name, attrs)


def count(name: str, n) -> None:
    if not _on:
        return
    c = _rec.counts
    c[name] = c.get(name, 0) + n


def mark(rid: int, name: str) -> None:
    if not _on:
        return
    _rec.marks.append((rid, name, clock_ns()))
