"""CLI for the scenario pack.

    python -m repro_torch.scenarios list
    python -m repro_torch.scenarios smoke [--seed N] [--device cpu]
    python -m repro_torch.scenarios run <name> [--scale smoke|bench] [--seed N] [--device cpu]
    python -m repro_torch.scenarios record --out DIR [--scale smoke|bench|both] [--seed N] [--device cpu]

The simulators run on the CUDA card unless ``--device cpu``. ``record``
writes ``DIR/<name>/baseline.json`` and nothing else.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import (
    DEFAULT_REL_TOL,
    SCENARIOS,
    ScenarioViolation,
    record_baseline,
    run_scenario,
)


def _run_one(name: str, scale: str, seed: int, device, check_baseline: bool = True) -> dict:
    t0 = time.perf_counter()
    _, _, _, metrics = run_scenario(
        name, scale=scale, seed=seed, use_recorded_baseline=check_baseline, device=device
    )
    metrics["wall_s"] = round(time.perf_counter() - t0, 3)
    return metrics


def cmd_list(_args) -> int:
    for name in SCENARIOS:
        print(name)
    return 0


def cmd_smoke(args) -> int:
    failed = []
    for name in SCENARIOS:
        try:
            m = _run_one(name, "smoke", args.seed, args.device)
        except ScenarioViolation as exc:
            print(f"FAIL  {name}: {exc}")
            failed.append(name)
            continue
        print(f"ok    {name}: finished={m['finished']} "
              f"makespan={m['makespan']:.1f}s wall={m['wall_s']}s")
    if failed:
        print(f"{len(failed)}/{len(SCENARIOS)} scenarios failed: "
              f"{', '.join(failed)}")
        return 1
    print(f"all {len(SCENARIOS)} scenarios passed at smoke scale")
    return 0


def cmd_run(args) -> int:
    try:
        m = _run_one(args.name, args.scale, args.seed, args.device)
    except ScenarioViolation as exc:
        print(f"FAIL  {args.name}: {exc}")
        return 1
    print(json.dumps(m, indent=2, sort_keys=True))
    return 0


def cmd_record(args) -> int:
    scales = ("smoke", "bench") if args.scale == "both" else (args.scale,)
    for name in SCENARIOS:
        path = Path(args.out) / name / "baseline.json"
        for scale in scales:
            m = _run_one(name, scale, args.seed, args.device, check_baseline=False)
            m.pop("wall_s")
            record_baseline(path, scale, m, rel_tol=args.rel_tol)
            print(f"recorded {name}/{scale} -> {path}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.scenarios")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list scenario names")

    def with_device(p):
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", default=None,
                       help="where the simulators run (default: the CUDA card)")
        return p

    with_device(sub.add_parser("smoke", help="run every scenario at smoke scale"))

    p = with_device(sub.add_parser("run", help="run one scenario"))
    p.add_argument("name", choices=SCENARIOS)
    p.add_argument("--scale", choices=("smoke", "bench"), default="smoke")

    p = with_device(sub.add_parser("record", help="record baseline envelopes under --out"))
    p.add_argument("--out", required=True,
                   help="directory to write <name>/baseline.json into")
    p.add_argument("--scale", choices=("smoke", "bench", "both"), default="both")
    p.add_argument("--rel-tol", type=float, default=DEFAULT_REL_TOL)

    args = ap.parse_args(argv)
    return {"list": cmd_list, "smoke": cmd_smoke,
            "run": cmd_run, "record": cmd_record}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
