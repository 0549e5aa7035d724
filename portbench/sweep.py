"""The sweep that finds an open-loop cell's knee, on the card.

    python3 portbench/sweep.py --workload <cell> --rates 6,8,10,12 --seconds 40 --seed 1

One process: the weights once, then for each offered rate (requests a
second, in place of the mix's ``rate_rps``) a window of the cell's
traffic. One JSON line a rate: the requests due in the window and those
served, each a second of the window, the requests waiting at its open
and at its close, tokens a second, the turnaround's mean and 95th
percentile, and the lanes filled. The knee is the most requests a second
that the engine serves, the plateau that the served rate reaches as the
offered rate rises past it; the cell offers four fifths of it.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))


def main(argv) -> int:
    import argparse

    import torch

    from portbench import harness
    from portbench.cells import reader, resolve
    from portbench.view import View
    from portbench.window import Driver

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    harness._env()
    cell = resolve(harness.ROOT, args.workload)
    lm = None
    for rate in [float(r) for r in args.rates.split(",")]:
        mix = dict(cell.mix, rate_rps=rate)
        lm, engine, traffic, tap = harness.setup(cell, args.seed, "cuda", lm=lm, mix=mix)
        try:
            rec = Driver(engine, traffic, tap).run(args.seconds)
        finally:
            tap.close()
        view = View(record=rec, cfg=cell.config, mix=mix, setup_s=0.0)
        open_then = [r for r in rec.requests.values() if r.due < rec.open_t and (r.batch is None or r.batch >= rec.first)]
        late = [r for r in view.due if not view.served_in_window(r)]
        served = sum(b.served for b in view.batches)
        out = {"rate_rps": rate, "offered_rps": len(view.due) / rec.window_s, "served_rps": served / rec.window_s,
               "due": len(view.due), "waiting_at_open": len(open_then),
               "waiting_at_close": len(late), "waiting_at_close_tenant0": sum(r.user == "tenant0" for r in late),
               "served": served, "batches": rec.n_window - rec.first,
               "plens": [b.plen for b in view.batches], "window_s": rec.window_s, "late_s": rec.late_s,
               "step_ms": reader(harness.ROOT, "step_ms")(view)}
        for name in ("tokens_per_s", "request_turnaround_mean_s", "request_turnaround_p95_s", "queue_wait_p95_s", "batch_fill"):
            out[name] = reader(harness.ROOT, name)(view)
        print(json.dumps(out), flush=True)
        engine.cache = None
        del engine
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
