"""One run of one cell: set-up, the window, the readings, the judgement.

``main`` is the command line (``run.py``); ``run_cell`` is the run, which
the CPU tests drive at small sizes with ``device="cpu"``.

Set-up: the port's LM allocated on the card and filled from the seed
(``model``), the engine with the mix's slots and cache length, and a
warm-up batch through the engine (full lanes, prompts of two tokens, two
tokens out: every device shape a lockstep step has, since a step's
shapes do not depend on the prompt length or the position). ``setup_s``
runs from the start of the process to the end of that warm-up; an open
loop's lead-in (``window.Driver.run``), which serves traffic, follows it
and is neither set-up nor window.

With ``--trace 1`` one more batch of the same traffic runs after the
window closes, under the profiler (``devtrace``); the per-layer metrics
read the window's records and that batch's trace.

After the window (and that batch) the peak of device memory is read, the
engine and its cache are let go, and ``judge`` compares the queues'
batches and the model's served tokens with the plain re-derivations.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["main", "setup", "run_cell", "ROOT"]


def _env() -> None:
    """Every cache the run could write, at fixed paths inside the checkout."""
    cache = ROOT / "build" / "portbench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def _warm_up(engine, traffic, seed: int) -> None:
    from repro_torch.serving import InferenceRequest

    from .traffic import seed_rng

    rng = seed_rng(seed, 3)
    user = traffic.users[0]
    reqs = [InferenceRequest(user=user, prompt=rng.integers(0, traffic.vocab, 2).astype("int32"), max_new_tokens=2)
            for _ in range(engine.num_slots)]
    engine.submit_group(reqs, now=0.0)
    engine.step(now=0.0)
    if not all(r.done for r in reqs):
        raise RuntimeError("the warm-up batch did not finish")


def _log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _power_limit() -> str | None:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def setup(cell, seed: int, device, lm=None, mix: dict | None = None):
    """(lm, engine, traffic, tap) for one run, warmed up: ``lm`` is built
    unless given, and filled from ``seed`` either way."""
    import torch

    from repro_torch.serving import ServingEngine

    from . import model
    from .traffic import Traffic
    from .window import StepTap

    cfg, mix = cell.config, mix or cell.mix
    t0 = time.perf_counter()
    if lm is None:
        lm = model.build(cfg, device)
    model.fill_weights(lm, seed)
    traffic = Traffic(mix, seed, cfg["vocab_size"])
    engine = ServingEngine(lm, num_slots=mix["slots"], max_len=mix["max_len"], quotas=traffic.quotas())
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    tap = StepTap()
    try:
        _warm_up(engine, traffic, seed)
    except BaseException:
        tap.close()
        raise
    tap.take()
    if on_card:
        torch.cuda.synchronize()
    _log(f"weights and engine {t1 - t0:.3f} s, warm-up {time.perf_counter() - t1:.3f} s")
    return lm, engine, traffic, tap


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run; returns the result line (without the check for JAX)."""
    import torch

    from . import judge, model
    from .cells import reader
    from .devtrace import profile_call
    from .reference import Reference
    from .view import View
    from .window import Driver

    cfg, mix = cell.config, cell.mix
    on_card = torch.device(device).type == "cuda"
    lm, engine, traffic, tap = setup(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.3f} s")
    try:
        driver = Driver(engine, traffic, tap)
        rec = driver.run(seconds)
        _log(f"lead-in {rec.open_wall - t_start - setup_s:.3f} s, window {rec.window_s:.3f} s, "
             f"{rec.n_window - rec.first} batches")
        trace_rec = None
        if trace:
            holder = {}
            b = driver.one_more(rec, lambda fn: holder.setdefault("t", profile_call(torch, fn)) if on_card else fn())
            trace_rec = holder.get("t")
            if trace_rec is not None:
                trace_rec.steps = [pos for pos, _ in b.calls]
                trace_rec.lanes = engine.num_slots
            _log("traced batch done")
    finally:
        tap.close()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    view = View(record=rec, cfg=cfg, mix=mix, setup_s=setup_s, trace=trace_rec)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(ROOT, m["name"])(view)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted = len(view.due)

    # the judgement, with the engine's state let go
    engine.cache = None
    del engine
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers, predicted = judge.check_queue(torch, rec, cfg["vocab_size"])
    _log(f"queue check {time.perf_counter() - t0:.3f} s")
    ref = Reference(model.named_weights(lm), cfg, "fp32")
    numbers |= judge.check_model(torch, ref, rec, predicted, cell.limits["sample"],
                                 bool(cfg.get("n_routed_experts")), seed, device)
    del numbers["gaps"], numbers["lanes"]
    _log(f"model check {time.perf_counter() - t0:.3f} s; token_gap {numbers['token_gap']!r}, "
         f"token_miss {numbers['token_miss']!r}, lane_gap_mean_max {numbers['lane_gap_mean_max']!r} "
         f"over {numbers['tokens_compared']} tokens")
    limits = {"batches_wrong": 0, "fed_wrong": 0, **cell.limits["limits"]}
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    failed = sum(1 for r in view.due if view.served_in_window(r)
                 and len(r.obj.generated) != r.output_len)
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": {"platform": "gpu" if on_card else "cpu",
                       "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                       "count": cell.chips if on_card else 0, "memory_peak_bytes": int(peak)}}
    if on_card:
        line["device"]["power_limit"] = _power_limit()
    if trace_rec is not None:
        line["device"] |= {"busy_s": trace_rec.busy_s, "window_s": trace_rec.window_s}
        line["breakdown"] = {"device_ops": trace_rec.device_ops(), "idle_gaps": [list(g) for g in trace_rec.gaps]}
    line["window"] = {"seconds": rec.window_s, "batches": rec.n_window - rec.first, "late_s": rec.late_s,
                      "batch_s": [b.t_end - b.t_call for b in view.batches], "judge_s": time.perf_counter() - t0}
    line["checks"] = checks
    return line


def main(argv: list[str], t_start: float) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _env()
    from .cells import resolve

    cell = resolve(ROOT, args.workload)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"portbench: no system under test at {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 4
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"portbench: modules {found} were loaded in the run's process", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
