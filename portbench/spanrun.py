"""One traced run of a cell with the program's own tracing on: the spans'
readings beside the harness's.

    python3 portbench/spanrun.py --workload <cell> --seed <n> --seconds <s> [--spans 0|1]

from the root of a checkout, on a machine with the card. It sets up as
``run.py`` does (``harness.setup``), runs the window with
``repro_torch.tracing`` on (``--spans 1``, the default) or off, profiles
one more batch (``spans.profile_call``: the device activity and the
host's CUDA runtime calls), and prints one JSON line: every per-layer
metric of the cell, the span readers (``metrics/host_launch_ms.py``,
``readback_wait_ms``, ``host_syncs_per_step``, ``idle_in_launch_share``,
``moe_drop_share``, ``ttft_p95_s``), and under ``breakdown`` the
profiled batch's ``idle_by_span`` and ``launch_coverage``. It judges
nothing: ``run.py`` holds the outputs to the reference. A run with
``--spans 0`` and one with ``--spans 1`` of the same seed give what the
spans cost.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPAN_METRICS = ("host_launch_ms", "readback_wait_ms", "host_syncs_per_step", "idle_in_launch_share",
                "moe_drop_share", "ttft_p95_s")


def run_spans(cell, seed: int, seconds: float, spans: bool, device, t_start: float) -> dict:
    """One run; returns its line."""
    import torch

    from repro_torch import tracing

    from .cells import reader
    from .harness import ROOT, setup
    from .spans import SpanView, idle_by_span, launch_coverage, profile_call
    from .window import Driver

    on_card = torch.device(device).type == "cuda"
    lm, engine, traffic, tap = setup(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    try:
        driver = Driver(engine, traffic, tap)
        if spans:
            tracing.enable()
        anchor = (tracing.clock_ns(), time.perf_counter())
        rec = driver.run(seconds)
        window = tracing.collect() if spans else None
        holder = {}
        b = driver.one_more(rec, lambda fn: holder.setdefault("t", profile_call(torch, fn, tracing.clock_ns))
                            if on_card else fn())
        trace = holder.get("t")
        if trace is not None:
            trace.steps, trace.lanes = [pos for pos, _ in b.calls], engine.num_slots
            trace.spans = tracing.collect() if spans else None
    finally:
        tracing.disable()
        tap.close()
    view = SpanView(record=rec, cfg=cell.config, mix=cell.mix, setup_s=setup_s, trace=trace, spans=window,
                    anchor=anchor)
    names = [m["name"] for m in cell.per_layer]
    metrics = {}
    for name in names + [n for n in SPAN_METRICS if n not in names]:
        v = reader(ROOT, name)(view)
        if v is not None:
            metrics[name] = float(v)
    line = {"workload": cell.name, "seed": seed, "spans": spans, "metrics": metrics,
            "device": {"kind": torch.cuda.get_device_name(0) if on_card else "cpu"},
            "window": {"seconds": rec.window_s, "batches": rec.n_window - rec.first,
                       "step_ms": [(x.t_end - x.t_call) / x.steps * 1e3 for x in view.batches if x.steps]}}
    if on_card:
        from .harness import _power_limit

        line["device"]["power_limit"] = _power_limit()
    if trace is not None:
        line["device"] |= {"busy_s": trace.busy_s, "window_s": trace.window_s}
        line["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": [list(g) for g in trace.gaps],
                             "runtime_calls": len(trace.runtime)}
        if spans:
            line["breakdown"] |= {"idle_by_span": idle_by_span(trace), "launch_coverage": launch_coverage(trace)}
    return line


def main(argv: list[str], t_start: float) -> int:
    p = argparse.ArgumentParser(prog="portbench/spanrun.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    from .cells import resolve
    from .harness import ROOT, _env

    _env()
    cell = resolve(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    line = run_spans(cell, args.seed, args.seconds, bool(args.spans), "cuda", t_start)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    from portbench.spanrun import main as _main

    sys.exit(_main(sys.argv[1:], T_START))
