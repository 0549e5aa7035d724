#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (PATH or $CUDA_HOME/bin) and the checkout's
``src/``; it builds the kernels into ``build/repro_torch/`` first.

1. Build and load the kernel library from the checkout's sources.
2. Hold every kernel against its plain PyTorch version on the card and
   time both (CUDA events, median of 5 runs of 10 back-to-back launches
   after a warm-up): at the main path's shapes (10,000 jobs × 256 sites,
   10,000 queued jobs), then at 100,000 jobs × 1,024 sites and 10^7
   queued jobs, whose numbers go into the ``kernels`` line.
3. Drive the scheduler's main path through the entry points a user
   calls, at the bulk bench's configuration (10,000 jobs × 256 sites,
   seed 0) with every launch counter set to 0 before and read after;
   check what it returns against the port on the host, against an
   independent NumPy plane and against the paper's Fig 4/Fig 6 values.

Prints the card, each phase's results and times, a ``{"kernels": …}``
line and, last, ``{"ok": true, "device": …}``. Any failed check raises,
so the script exits non-zero and prints no result line. Runs with no
CUDA device or outside a checkout also exit non-zero.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, no sparsity, at the 700 W limit):
# HBM3 3.35 TB/s, FP32 67 TFLOP/s, FP64 34 TFLOP/s outside the tensor cores
# (a division or square root is counted as one operation: a lower bound).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f32": 67e12, "f64": 34e12}

SEED = 0
BENCH_JOBS, BENCH_SITES = 10_000, 256
BIG_JOBS, BIG_SITES = 100_000, 1024
REQUEUE_L = 10_000_000
FIG4_CAPS = {"A": 100.0, "B": 200.0, "C": 400.0, "D": 600.0}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def bench_grid(P, jobs: int, sites: int, seed: int = 0):
    """The bulk placement bench's generator (benchmarks/bulk_placement_bench.py)
    over the port's classes: same draws, same order, same values."""
    rng = np.random.default_rng(seed)
    site_d, link_d = {}, {}
    for i in range(sites):
        name = f"s{i:03d}"
        site_d[name] = P.SiteState(
            name=name, capacity=float(rng.integers(50, 2000)),
            queue_length=float(rng.integers(0, 50)),
            waiting_work=float(rng.uniform(0, 500)),
            load=float(rng.uniform(0, 1)),
            alive=bool(rng.uniform() > 0.05),
        )
        link_d[name] = P.NetworkLink(
            bandwidth_Bps=float(rng.uniform(1e8, 1e10)),
            loss_rate=0.0 if rng.uniform() < 0.3 else float(rng.uniform(1e-4, 0.05)),
            rtt_s=float(rng.uniform(0.005, 0.3)),
        )
    if not any(s.alive for s in site_d.values()):
        next(iter(site_d.values())).alive = True
    job_list = [
        P.Job(user=f"u{i % 7}", compute_work=float(rng.uniform(0.1, 100)),
              input_bytes=float(rng.uniform(0, 30e9)),
              output_bytes=float(rng.uniform(0, 2e9)))
        for i in range(jobs)
    ]
    return site_d, link_d, job_list


def kernel_ms(torch, fn, reps: int = 5, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, on CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_s(torch, fn, reps: int = 3):
    """Median wall time of ``fn`` ending in a synchronize, after a warm-up
    call; returns (seconds, last result)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, a, b) -> float:
    """Largest |a − b| over cells finite in both; non-finite cells must
    match exactly (inf where inf, NaN where NaN)."""
    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    same_nonfinite = torch.equal(a[~fin].nan_to_num(0.0, 1.0, -1.0), b[~fin].nan_to_num(0.0, 1.0, -1.0))
    check(same_nonfinite, "non-finite cells differ between kernel and plain version")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def f64_cell_ops(jp, S: int) -> float:
    """Float64 operations the class_total plane needs for this run's job
    classes: DATA 2 a cell (div, add), COMPUTE 3, BOTH 5; 13 a site."""
    counts = {c: 0 for c in ("compute", "data", "both")}
    for c in jp.classes:
        counts[c.value] += 1
    return S * (2 * counts["data"] + 3 * counts["compute"] + 5 * counts["both"]) + 13 * S


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"phase 1 build: {lib_path.relative_to(ROOT)} in {secs:.3f} s")
    log = (lib_path.parent / "nvcc.log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or line.startswith("=="):
                print("  " + line.strip())


def phase_kernels(torch, P, J: int, S: int, L: int):
    """Every kernel against its plain version on the card: the cost
    kernels at J jobs × S sites, the requeue kernel at L queued jobs."""
    from repro_torch.core import batch as B
    from repro_torch.kernels import _build
    from repro_torch.kernels.cost_matrix import ops as cm_ops, ref as cm_ref
    from repro_torch.kernels.priority_requeue import ops as pr_ops, ref as pr_ref

    dev = torch.device("cuda")
    lib = _build.library()
    stream = _build.stream_of(dev)
    out = {}

    def raw(entry: str, *args):
        """One launch through the C entry alone (for timing): tensors go
        in as pointers, the stream last, and a CUDA error raises."""
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        fn = getattr(lib, entry)
        return lambda: _build.check(fn(*c_args, stream), entry)

    # -- K1 at J × S ------------------------------------------------------------
    site_d, link_d, jobs = bench_grid(P, J, S, seed=1)
    sp = B.SitePack.from_scheduler(site_d, link_d, device=dev)
    jp = B.JobPack.from_jobs(jobs, device=dev)
    rows = sp.pack_rows()
    w = dict(w_queue=1.0, w_work=1.0, w_load=1.0)
    f64_args = (jp.bytes_, jp.work, jp.cls, rows, sp.alive)

    for mask_dead in (True, False):
        k = cm_ops.cost_matrix_f64(*f64_args, mask_dead=mask_dead, **w)
        p = cm_ref.cost_matrix_f64_ref(*f64_args, 1.0, 1.0, 1.0, mask_dead)
        torch.cuda.synchronize()
        check(torch.equal(k, p), f"cost_matrix_f64 (mask_dead={mask_dead}) != plain version")
    err_f64 = max_abs_err(torch, k, p)
    del k, p
    plane = torch.empty((J, S), dtype=torch.float64, device=dev)
    ms = kernel_ms(torch, raw("repro_cost_matrix_f64", *f64_args, plane, J, S, 1.0, 1.0, 1.0, 1))
    del plane
    plain_ms = kernel_ms(torch, lambda: cm_ref.cost_matrix_f64_ref(*f64_args), reps=3, inner=2)
    ops = f64_cell_ops(jp, S)
    b_ms, b_by = bound(J * 17 + S * 65 + J * S * 8, ops, "f64")
    out["cost_matrix_f64"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err_f64,
                                  bound_ms=b_ms, bound_by=b_by, shape=[J, S])

    bk, ck = cm_ops.cost_argmin_f64(*f64_args, **w)
    bp, cp = cm_ref.cost_argmin_f64_ref(*f64_args)
    torch.cuda.synchronize()
    check(torch.equal(bk, bp) and torch.equal(ck, cp), "cost_argmin_f64 != plain version")
    best = torch.empty(J, dtype=torch.int64, device=dev)
    cost = torch.empty(J, dtype=torch.float64, device=dev)
    ms = kernel_ms(torch, raw("repro_cost_argmin_f64", *f64_args, best, cost, J, S, 1.0, 1.0, 1.0))
    plain_ms = kernel_ms(torch, lambda: cm_ref.cost_argmin_f64_ref(*f64_args), reps=3, inner=2)
    b_ms, b_by = bound(J * 17 + S * 65 + J * 16, ops + J * S, "f64")
    out["cost_argmin_f64"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs_err(torch, ck, cp),
                                  bound_ms=b_ms, bound_by=b_by, shape=[J, S])

    f32 = lambda t: t.float().contiguous()  # noqa: E731
    jobs32 = [f32(jp.bytes_), f32(jp.work), f32(jp.wcomp), f32(jp.wdtc)]
    sites32 = [f32(getattr(sp, f)) for f in ("cap", "queue", "work", "load", "bw", "loss", "rtt")]
    mss32 = f32(sp.mss)
    ck, bk = cm_ops.cost_matrix_classed(*jobs32, *sites32, sp.alive, mss32, **w)
    rows9 = torch.stack([*sites32, sp.alive.float(), mss32])
    cp = cm_ref.cost_matrix_f32_ref(*jobs32, rows9)
    bp = torch.argmin(cp, dim=1).to(torch.int32)
    torch.cuda.synchronize()
    check(torch.equal(bk, bp), "cost_matrix_classed argmin != plain version")
    check(torch.allclose(ck, cp, rtol=1e-6, atol=0.0), "cost_matrix_classed != plain version (rtol 1e-6)")
    exact32 = torch.equal(ck, cp)
    err32 = max_abs_err(torch, ck, cp)
    del ck, cp
    plane32 = torch.empty((J, S), dtype=torch.float32, device=dev)
    ms = kernel_ms(torch, raw("repro_cost_matrix_f32", *jobs32, rows9, plane32, J, S, 1.0, 1.0, 1.0))
    del plane32
    plain_ms = kernel_ms(torch, lambda: cm_ref.cost_matrix_f32_ref(*jobs32, rows9), reps=3, inner=2)
    b_ms, b_by = bound(J * 16 + S * 36 + J * S * 4, J * S * 7 + S * 13, "f32")
    out["cost_matrix_f32"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err32, exact=exact32,
                                  bound_ms=b_ms, bound_by=b_by, shape=[J, S])
    del jp, sp, rows, f64_args, jobs32, sites32, rows9
    torch.cuda.empty_cache()

    # -- K2 at L (f32, the kernel's type; f64 against the host twin) ------------
    rng = np.random.default_rng(SEED)
    n = rng.integers(1, 50, L).astype(np.float64)
    q = rng.uniform(10, 5000, L)
    t = rng.uniform(1, 64, L)
    Q, T = float(q.sum()), float(t.sum())
    for name, dt, kind in (("priority_requeue", torch.float32, "f32"),
                           ("priority_requeue_f64", torch.float64, "f64")):
        nt, qt, tt = (torch.as_tensor(a, dtype=dt, device=dev) for a in (n, q, t))
        prk, bandk = pr_ops.priority_requeue(nt, qt, tt, Q, T)
        prp, bandp = pr_ref.priority_requeue_ref(nt, qt, tt, Q, T)
        torch.cuda.synchronize()
        check(torch.equal(bandk, bandp), f"{name}: bands != plain version")
        check(torch.equal(prk, prp), f"{name}: priorities != plain version")
        if dt == torch.float64:
            pr_np, band_np = P.reprioritize_np(n, q, t, Q, T)
            check(np.array_equal(prk.cpu().numpy(), pr_np), "priority_requeue f64 != reprioritize_np")
            check(np.array_equal(bandk.cpu().numpy(), band_np), "priority_requeue f64 bands != reprioritize_np")
        err = max_abs_err(torch, prk, prp)
        sz = nt.element_size()
        pr_out = torch.empty(L, dtype=dt, device=dev)
        band_out = torch.empty(L, dtype=torch.int32, device=dev)
        ms = kernel_ms(torch, raw(f"repro_priority_requeue_{kind}", nt, qt, tt, Q, T, pr_out, band_out, L))
        plain_ms = kernel_ms(torch, lambda: pr_ref.priority_requeue_ref(nt, qt, tt, Q, T), reps=3, inner=2)
        b_ms, b_by = bound(L * (4 * sz + 4), L * 6, kind)
        out[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b_ms,
                         bound_by=b_by, shape=[L])
        del nt, qt, tt, prk, bandk, prp, bandp, pr_out, band_out

    for name, r in out.items():
        print(f"phase 2 {name} {r['shape']}: kernel {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']!r}"
              + (f", bit-equal {r['exact']}" if "exact" in r else ""))
    return out


def phase_fig6(P) -> None:
    """The paper's Fig 6 triple through the requeue kernel."""
    pr6, band6 = P.reprioritize([2, 2, 1], [1900, 1900, 1700], [1, 5, 1], 3600.0, 7.0, device="cuda")
    pr6 = pr6.cpu().numpy()
    check(np.allclose(pr6, [0.4586, -0.6305, 0.6974], atol=1e-4), f"Fig 6 priorities {pr6}")
    check(band6.cpu().tolist() == [1, 3, 0], f"Fig 6 bands {band6.tolist()}")
    print(f"phase 2 Fig 6 through the kernel: pr {pr6.tolist()} bands {band6.tolist()}")


def numpy_plane(sp, jp) -> np.ndarray:
    """Independent float64 NumPy plane with the reference's semantics
    (cost_components + class_total, dead columns +inf)."""
    cap, queue, work, load, bw, loss, rtt, mss = (getattr(sp, f).cpu().numpy() for f in
                                                   ("cap", "queue", "work", "load", "bw", "loss", "rtt", "mss"))
    alive = sp.alive.cpu().numpy()
    net = (loss / bw) * 1.0e6
    with np.errstate(divide="ignore", invalid="ignore"):
        mathis = mss / (rtt * np.sqrt(loss))
    eff = np.where(loss > 0.0, np.minimum(bw, mathis), bw)
    comp_site = 1.0 * queue / cap + 1.0 * work / cap + 1.0 * load
    dtc = jp.bytes_.cpu().numpy()[:, None] / eff[None, :]
    comp = comp_site[None, :] + jp.work.cpu().numpy()[:, None] / cap[None, :]
    cls = np.asarray([c.value for c in jp.classes])[:, None]
    cost = np.where(cls == "data", dtc + net, np.where(cls == "compute", comp + net, (net + comp) + dtc))
    cost[:, ~alive] = np.inf
    return cost


def bulk_groups(P, seed: int, n: int = 100):
    r = np.random.default_rng(seed)
    return [
        P.BulkGroup(
            user=f"u{g % 7}",
            jobs=[P.Job(user=f"u{g % 7}", t=1.0, compute_work=float(r.uniform(0.5, 5)),
                        input_bytes=float(r.uniform(0, 5e9)))
                  for _ in range(int(r.integers(1, 60)))],
            group_id=f"g{g}",
            division_factor=int(r.integers(1, 5)),
        )
        for g in range(n)
    ]


def main_path(torch, P, site_d, link_d, jobs):
    """One run of the scheduler's main path on the card; returns what it
    produced, for checking."""
    from repro_torch.core import batch as B

    gpu = P.DianaScheduler(copy.deepcopy(site_d), dict(link_d), device="cuda")
    res = {"select": gpu.select_sites_batch(jobs), "rank": gpu.rank_sites_batch(jobs)}
    jp = B.JobPack.from_jobs(jobs, device="cuda")
    sp = B.SitePack.from_scheduler(gpu.sites, gpu.links, device="cuda")
    res["screen_f32"] = gpu.engine.cost_matrix(jp, sp, backend="kernel")
    res["exact"] = gpu.engine.cost_matrix(jp, sp)
    placed_jobs = copy.deepcopy(jobs)
    res["place"] = gpu.place_batch(placed_jobs)
    res["place_state"] = {n: (s.queue_length, s.waiting_work) for n, s in gpu.sites.items()}
    # §X over the backlog just placed: one quota per user, t per job.
    quotas = {f"u{k}": float(v) for k, v in enumerate(np.random.default_rng(SEED).uniform(100, 5000, 7))}
    counts: dict[str, int] = {}
    for j in placed_jobs:
        counts[j.user] = counts.get(j.user, 0) + 1
    n = [counts[j.user] for j in placed_jobs]
    q = [quotas[j.user] for j in placed_jobs]
    t = [j.t for j in placed_jobs]
    Q, T = sum(quotas[u] for u in counts), sum(t)
    res["reprioritize_args"] = (n, q, t, Q, T)
    res["reprioritize"] = P.reprioritize(n, q, t, Q, T, device="cuda")
    bulk = P.BulkScheduler(P.DianaScheduler(copy.deepcopy(site_d), dict(link_d), device="cuda"))
    res["groups"] = bulk.schedule_groups(bulk_groups(P, SEED + 1))
    res["groups_state"] = {n: s.queue_length for n, s in bulk.diana.sites.items()}
    fig4 = P.DianaScheduler(
        {k: P.SiteState(name=k, capacity=c) for k, c in FIG4_CAPS.items()},
        {k: P.NetworkLink(bandwidth_Bps=1e9, loss_rate=0.001) for k in FIG4_CAPS},
        device="cuda",
    )
    group = P.BulkGroup(user="u", jobs=[P.Job(user="u", t=1, compute_work=1.0) for _ in range(10_000)],
                        group_id="fig4", division_factor=10)
    res["fig4"] = P.BulkScheduler(fig4).schedule_groups([group])[0]
    torch.cuda.synchronize()
    return res


def phase_main_path(torch, P):
    from repro_torch.kernels.cost_matrix import ops as cm_ops
    from repro_torch.kernels.priority_requeue import ops as pr_ops

    counters = {
        "cost_matrix_f32": cm_ops.cost_matrix_classed,
        "cost_matrix_f64": cm_ops.cost_matrix_f64,
        "cost_argmin_f64": cm_ops.cost_argmin_f64,
        "priority_requeue": pr_ops.priority_requeue,
    }
    site_d, link_d, jobs = bench_grid(P, BENCH_JOBS, BENCH_SITES, SEED)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = main_path(torch, P, site_d, link_d, jobs)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"phase 3 main path at {BENCH_JOBS} jobs x {BENCH_SITES} sites (seed {SEED}): "
          f"{wall:.3f} s, launches {launches}")
    for name, count in launches.items():
        check(count > 0, f"main path never launched {name}")

    # Checks: the port on the host, an independent NumPy plane, the paper.
    from repro_torch.core import batch as B

    cpu = P.DianaScheduler(copy.deepcopy(site_d), dict(link_d), device="cpu")
    sel, sel_cpu = res["select"], cpu.select_sites_batch(jobs)
    check(sel.sites == sel_cpu.sites and sel.costs.tolist() == sel_cpu.costs.tolist(),
          "select_sites_batch on the card != on the host")
    jp_h = B.JobPack.from_jobs(jobs, device="cpu")
    sp_h = B.SitePack.from_scheduler(cpu.sites, cpu.links, device="cpu")
    ref_plane = numpy_plane(sp_h, jp_h)
    check(np.array_equal(res["exact"].cpu().numpy(), ref_plane), "exact plane != independent NumPy plane")
    check(sel.site_indices.cpu().tolist() == np.argmin(ref_plane, axis=1).tolist(),
          "select != argmin of the NumPy plane")
    for j in range(0, BENCH_JOBS, 97):
        d = cpu.select_site(jobs[j])
        check((d.site, d.cost) == (sel.sites[j], float(sel.costs[j])), f"select != scalar select_site (job {j})")
    check(res["rank"] == cpu.rank_sites_batch(jobs), "rank_sites_batch on the card != on the host")
    alive = sp_h.alive.numpy()
    screen = res["screen_f32"].cpu().numpy()
    check(np.all(np.isinf(screen[:, ~alive])), "f32 screen: dead columns not +inf")
    check(np.allclose(screen[:, alive], ref_plane[:, alive], rtol=2e-4, atol=1e-4),
          "f32 screen plane != f64 plane within rtol 2e-4")
    agree = float(np.mean(np.argmin(screen, axis=1) == np.argmin(ref_plane, axis=1)))
    placed_cpu = copy.deepcopy(jobs)
    place_cpu = cpu.place_batch(placed_cpu)
    place = res["place"]
    check(place.sites == place_cpu.sites and place.costs.tolist() == place_cpu.costs.tolist(),
          "place_batch on the card != on the host")
    check(res["place_state"] == {n: (s.queue_length, s.waiting_work) for n, s in cpu.sites.items()},
          "place_batch final site state != on the host")
    n, q, t, Q, T = res["reprioritize_args"]
    pr, band = res["reprioritize"]
    pr_h, band_h = P.reprioritize(n, q, t, Q, T, device="cpu")
    check(torch.equal(pr.cpu(), pr_h) and torch.equal(band.cpu(), band_h), "reprioritize on the card != on the host")
    pr_np, _ = P.reprioritize_np(n, q, t, Q, T)
    check(np.allclose(pr.cpu().numpy(), pr_np, rtol=1e-5, atol=1e-6), "reprioritize f32 far from the f64 twin")
    bulk_cpu = P.BulkScheduler(P.DianaScheduler(copy.deepcopy(site_d), dict(link_d), device="cpu"))
    groups_cpu = bulk_cpu.schedule_groups(bulk_groups(P, SEED + 1))
    same = all(
        a.split == b.split and a.sites == b.sites
        and {s: len(js) for s, js in a.assignments.items()} == {s: len(js) for s, js in b.assignments.items()}
        for a, b in zip(res["groups"], groups_cpu)
    )
    check(same and len(groups_cpu) == 100, "schedule_groups on the card != on the host")
    check(res["groups_state"] == {n: s.queue_length for n, s in bulk_cpu.diana.sites.items()},
          "schedule_groups final site state != on the host")
    fig4 = {s: len(js) for s, js in res["fig4"].assignments.items()}
    check(fig4 == {"A": 769, "B": 1539, "C": 3077, "D": 4615}, f"Fig 4 split {fig4}")
    spans = [P.average_makespan(P.allocate_proportional(10_000, k, FIG4_CAPS), FIG4_CAPS) for k in (1, 2, 10)]
    check(all(abs(a - b) < 0.005 for a, b in zip(spans, (16.67, 10.0, 7.69))), f"Fig 4 makespans {spans}")
    print(f"  select/rank/place/schedule_groups identical to the host run; exact plane == NumPy plane; "
          f"f32 screen argmin agrees on {agree:.6f} of rows; Fig 4 {fig4}, makespans {spans}; "
          f"bands histogram {torch.bincount(band.cpu(), minlength=4).tolist()}")

    # Times: each step again, median of 3 after a warm-up call. The
    # stateful steps get fresh copies, made outside the timed calls.
    gpu = P.DianaScheduler(copy.deepcopy(site_d), dict(link_d), device="cuda")
    jp = B.JobPack.from_jobs(jobs, device="cuda")
    sp = B.SitePack.from_scheduler(gpu.sites, gpu.links, device="cuda")
    fresh_place = [(P.DianaScheduler(copy.deepcopy(site_d), dict(link_d), device="cuda"),
                    copy.deepcopy(jobs)) for _ in range(4)]
    fresh_groups = [(P.BulkScheduler(P.DianaScheduler(copy.deepcopy(site_d), dict(link_d), device="cuda")),
                     bulk_groups(P, SEED + 1)) for _ in range(4)]
    steps = {
        "select_sites_batch": lambda: gpu.select_sites_batch(jobs),
        "rank_sites_batch": lambda: gpu.rank_sites_batch(jobs),
        "cost_matrix(kernel f32)": lambda: gpu.engine.cost_matrix(jp, sp, backend="kernel"),
        "place_batch (launch-bound replay)": lambda: (lambda d, js: d.place_batch(js))(*fresh_place.pop()),
        "schedule_groups (100 groups)": lambda: (lambda b, gs: b.schedule_groups(gs))(*fresh_groups.pop()),
        "reprioritize (10k backlog)": lambda: P.reprioritize(n, q, t, Q, T, device="cuda"),
    }
    times = {}
    for name, fn in steps.items():
        times[name], _ = host_s(torch, fn)
        print(f"  {name}: {times[name]:.6f} s (median of 3)")
    return launches, times


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as P

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    phase_build()
    phase_kernels(torch, P, BENCH_JOBS, BENCH_SITES, BENCH_JOBS)   # the main path's shapes
    kernels = phase_kernels(torch, P, BIG_JOBS, BIG_SITES, REQUEUE_L)
    phase_fig6(P)
    launches, _ = phase_main_path(torch, P)

    meta = {
        "cost_matrix_f32": ("src/repro_torch/kernels/cost_matrix/csrc/cost_matrix.cu",
                            "src/repro/kernels/cost_matrix/cost_matrix.py:52"),
        "cost_matrix_f64": ("src/repro_torch/kernels/cost_matrix/csrc/cost_matrix.cu",
                            "src/repro/kernels/cost_matrix/cost_matrix.py:52"),
        "cost_argmin_f64": ("src/repro_torch/kernels/cost_matrix/csrc/cost_matrix.cu",
                            "src/repro/kernels/cost_matrix/cost_matrix.py:52"),
        "priority_requeue": ("src/repro_torch/kernels/priority_requeue/csrc/priority_requeue.cu",
                             "src/repro/kernels/priority_requeue/priority_requeue.py:34"),
    }
    line = []
    for name, (source, replaces) in meta.items():
        r = kernels[name]
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, shape=r["shape"],
        ))
    f64 = kernels["priority_requeue_f64"]
    print(f"priority_requeue f64 instance (not on the main path): ms {f64['ms']!r} plain_ms "
          f"{f64['plain_ms']!r} bound_ms {f64['bound_ms']!r}, bit-equal to reprioritize_np")
    check(all(math.isfinite(k["ms"]) for k in line), "a kernel time is not finite")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
