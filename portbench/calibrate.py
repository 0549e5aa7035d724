"""The readings that a cell's correctness limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 12 [--control] [--dump DIR]

In one process (the weights are allocated once and refilled from each
seed): for each seed a short window of the cell's own traffic at its own
sizes, then the judgement as a run makes it (``judge``), and with
``--control`` the control beside it: the plain reference in float8
(``reference``, ``precision="fp8"``) over the same lanes and tokens, the
gap of the token it puts first read on the float32 reference's logits.
One JSON line a seed: the numbers a run compares (``token_gap``,
``token_miss``, ``lane_miss_max``), the control's, the largest mean gap
of one lane on both sides, and quantiles of the gaps.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))


def _lane_miss_max(g, lane) -> float:
    import numpy as np

    _, at = np.unique(lane, return_inverse=True)
    return float((np.bincount(at, weights=(g > 0).astype(np.float64)) / np.bincount(at)).max())


def main(argv) -> int:
    import argparse

    import numpy as np
    import torch

    from portbench import harness, judge, model
    from portbench.cells import resolve
    from portbench.reference import Reference
    from portbench.window import Driver

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--dump", help="a directory for each seed's gaps, lanes and control gaps (.npz)")
    args = p.parse_args(argv)
    harness._env()
    cell = resolve(harness.ROOT, args.workload)
    cfg = cell.config
    moe = bool(cfg.get("n_routed_experts"))
    lm = None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        lm, engine, traffic, tap = harness.setup(cell, seed, "cuda", lm=lm)
        try:
            rec = Driver(engine, traffic, tap).run(args.seconds)
        finally:
            tap.close()
        engine.cache = None
        del engine
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        numbers, pred = judge.check_queue(torch, rec, cfg["vocab_size"])
        W = model.named_weights(lm)
        ref = Reference(W, cfg, "fp32")
        ctl = Reference(W, cfg, "fp8") if args.control else None
        res = judge.check_model(torch, ref, rec, pred, cell.limits["sample"], moe, seed, "cuda", control=ctl)
        g, lane = res["gaps"], res["lanes"]
        out = {"seed": seed, **numbers, "token_gap": res["token_gap"], "token_miss": res["token_miss"],
               "lane_gap_mean_max": res["lane_gap_mean_max"], "lane_miss_max": _lane_miss_max(g, lane),
               "lane_gap_untrimmed_max": float(judge.lane_gap_means(g, lane, 0).max()),
               "tokens_compared": res["tokens_compared"], "batches": rec.n_window - rec.first,
               "window_s": rec.window_s, "run_s": t1 - t0, "judge_s": time.perf_counter() - t1}
        if ctl is not None:
            c = res["control_gaps"]
            out |= {"control_gap": res["control"]["token_gap"], "control_miss": res["control"]["token_miss"],
                    "control_lane_gap_mean_max": res["control"]["lane_gap_mean_max"],
                    "control_lane_miss_max": _lane_miss_max(c, lane),
                    "control_lane_gap_untrimmed_max": float(judge.lane_gap_means(c, lane, 0).max()),
                    "gap_q": [float(np.quantile(g, q)) for q in (0.5, 0.99, 0.999)],
                    "control_q": [float(np.quantile(c, q)) for q in (0.5, 0.99, 0.999)]}
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            np.savez_compressed(os.path.join(args.dump, f"{seed}.npz"), gaps=g, lanes=lane,
                                **({"control_gaps": res["control_gaps"]} if ctl is not None else {}))
        print(json.dumps(out), flush=True)
        del W, ref, ctl
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
