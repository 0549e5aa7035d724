"""CPU tests of the span readers (``spans.py``, ``spanrun.py`` and the
metrics that read the program's tracing), at sizes a test run holds.

A run on the host has no device trace: the host-clock and counter
readers return numbers, the device-trace readers nothing. The arithmetic
of the device-trace readers is held on a hand-made trace.
"""
import time

import pytest
import torch

from portbench.cells import reader
from portbench.harness import ROOT
from portbench.spanrun import SPAN_METRICS, run_spans
from portbench.spans import OUTSIDE, Trace, idle_by_span, launch_coverage
from portbench.test_portbench_harness import CLOSED, OPEN, TINY_DENSE, TINY_MOE, tiny_cell
from repro_torch import tracing

HOST = {"host_launch_ms", "readback_wait_ms", "ttft_p95_s"}
DEVICE = {"host_syncs_per_step", "idle_in_launch_share", "device_idle_share", "decode_attention_roofline"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cfg, mix, spans):
    return run_spans(tiny_cell(cfg, mix), 11, 0.3, spans, "cpu", time.perf_counter())


@pytest.mark.parametrize("cfg,mix", [(TINY_MOE, CLOSED), (TINY_DENSE, OPEN)], ids=["moe-closed", "dense-open"])
def test_a_host_run_reads_the_spans_and_counters_and_no_device_trace(cfg, mix):
    on, off = _run(cfg, mix, True), _run(cfg, mix, False)
    got = set(on["metrics"])
    assert HOST <= got and not DEVICE & got
    assert ("moe_drop_share" in got) == (cfg is TINY_MOE)
    assert 0.0 <= on["metrics"].get("moe_drop_share", 0.0) < 100.0
    assert on["metrics"]["host_launch_ms"] > 0 and on["metrics"]["readback_wait_ms"] > 0
    # every metric the harness had reads the same records either way; the span readers need the spans
    assert set(off["metrics"]) == got - set(SPAN_METRICS)
    assert not tracing.is_on()


def test_the_span_readers_read_nothing_from_the_harness_view():
    from portbench.view import View
    from portbench.window import Record

    view = View(record=Record(slots=4), cfg=TINY_MOE, mix=CLOSED, setup_s=1.0, trace=None)
    assert all(reader(ROOT, name)(view) is None for name in SPAN_METRICS)


def _span(name, start, end, parent=-1):
    s = tracing.Span(name, {})
    s.start_ns, s.end_ns, s.parent = start, end, parent
    return s


def _trace():
    """A batch from 0 to 100 ns: two steps, each a launch (a sync in the
    first) and a readback; device busy 5–20, 30–45 and 60–70."""
    spans = [_span("engine.step", 0, 95),
             _span("step.launch", 0, 25, 0), _span("decode.moe", 5, 20, 1), _span("step.readback", 25, 40, 0),
             _span("step.launch", 40, 65, 0), _span("step.readback", 65, 80, 0)]
    kernels = [("k", 5, 15), ("k", 30, 15), ("k", 60, 10)]
    runtime = [("cudaLaunchKernel", 6, 1), ("cudaStreamSynchronize", 10, 2), ("cudaMemcpyAsync", 26, 1),
               ("cudaStreamSynchronize", 27, 5), ("cudaLaunchKernel", 41, 1), ("cuLaunchKernel", 66, 1),
               ("cudaLaunchKernel", 97, 1), ("cudaDeviceSynchronize", 98, 1)]
    return Trace(window_s=1e-7, busy_s=4e-8, kernels=kernels, gaps=[], runtime=runtime, t0_ns=0, t1_ns=100,
                 spans=tracing.Recording(spans=spans))


def test_the_device_trace_readers_lay_the_runtime_calls_and_gaps_against_the_spans():
    from portbench.view import View
    from portbench.window import Record

    t = _trace()
    view = View(record=Record(slots=4), cfg=TINY_MOE, mix=CLOSED, setup_s=1.0, trace=t)
    # idle: 0–5, 20–25 and 45–60 in launches, 25–30 and 70–80 in readbacks, 80–95 in engine.step,
    # 95–100 outside: 60 ns; the first launch's sync lies in its decode.moe
    assert reader(ROOT, "idle_in_launch_share")(view) == pytest.approx(100 * 25 / 60)
    assert reader(ROOT, "host_syncs_per_step")(view) == 0.5          # one sync in two launches
    br = idle_by_span(t)
    assert br["idle_s"] == pytest.approx(60e-9) and br["in_spans_share"] == pytest.approx(55 / 60)
    assert {k: (pytest.approx(s * 1e9), n) for k, s, n in br["by_span"]} == {
        "step.launch": (25, 0), "step.readback": (15, 1), "engine.step": (15, 0), "decode.moe": (0, 1),
        OUTSIDE: (5, 1)}
    assert launch_coverage(t) == {"launches": 4, "inside_share": 0.75}
