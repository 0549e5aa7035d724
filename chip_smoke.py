#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (PATH or $CUDA_HOME/bin) and the checkout's
``src/``; it builds the kernels into ``build/repro_torch/`` first.

1. Build and load the kernel library from the checkout's sources.
2. Hold every kernel against its plain PyTorch version on the card and
   time both (CUDA events, median of 5 runs of 10 back-to-back launches
   after a warm-up): at the main path's shapes (10,000 jobs × 256 sites,
   10,000 queued jobs, seed 0), then at 100,000 jobs × 1,024 sites
   (seed 1) and 10^7 queued jobs, whose numbers go into the ``kernels``
   line. The fused f64 argmin's screen is also run as its plain model
   (its skipped share), its FP64-pipe floor is read from the SASS of
   the built library, and both f64 entries are held bit for bit to
   their plain versions on the adversarial sets of
   ``repro_torch.kernels.cost_matrix.cases`` and on ragged shapes; the
   f32 plane likewise (NaN where NaN, the same argmin) on every set of
   that module and on ragged shapes, and its whole wrapper is timed.
3. Drive the scheduler's main path through the entry points a user
   calls, at the bulk bench's configuration (10,000 jobs × 256 sites,
   seed 0) with every launch counter set to 0 before and read after;
   check what it returns against the port on the host, against an
   independent NumPy plane and against the paper's Fig 4/Fig 6 values.
2b. Hold the flash- and decode-attention kernels against their plain
   versions on the JAX kernel tests' cases (2e-5 float32, 2e-2 bf16),
   on float32 rows over many key tiles and splits, then at gemma2-9b's
   shapes: an 8192-token prefill (B 1, H 16/8, D 256, bf16, soft-cap 50;
   causal, and a 4096 window) and 4-slot decode over an 8192 cache and a
   4096 ring. q and k are drawn with a standard deviation of 1.5, so
   scores spread over several units as a trained model's do, and the
   mean error must also stay under 1% of the mean |output| (rounding
   gives about 0.2% in bf16; a missing rescale between key tiles moves
   the output by a large share of itself).
   bf16 cases at every head dim with ragged lengths (77, 200, 1000)
   exercise the bf16 flash body's tensor maps, swizzles and masked edge
   tiles, and GQA rep 3 and 16 the decode kernel's head groups.
   Times (CUDA events) go beside the plain version, the bound and
   scaled_dot_product_attention at soft-cap 0 (with the backend it
   chose, from a profiler trace; for the window-4096 layer with a
   boolean band mask), with each kernel's share of its bound; the
   decode rows also time the split pass at other split sizes.
4. Serve gemma2-9b at its published width and depth in bf16 (weights
   from a seeded generator on the card) through ``ServingEngine``:
   launch/serve.py's 16 requests of two tenants, 4 slots, max_len 64,
   8-token prompts, 8 new tokens; then one 8192-token prefill through
   ``LM.forward(last_only=True)``, with both attention kernels' launch
   counters set to 0 before and read after. Checks the stats, the
   launch counts and that a second run with the same seed gives the
   same tokens; prints tokens/s and the median decode step beside the
   weight-streaming bound.
5. Rebuild gemma2-9b in float32 and hold LM.forward's logits (flash
   kernel) against a decode_step loop (decode kernel), B 2, 16 tokens,
   rtol = atol = 2e-3.
6. Run the §XI simulator (``repro_torch.sim.GridSim``) on the card and
   on the port's CPU twin, every kernel counter set to 0 before and read
   after, and hold it to the reference's committed results: Figs 7–8 at
   n = 25/50/100/250 and the CMS case study (every ``:.0f`` string of
   ``BENCH_fig7_8_queue_exec.json``/``BENCH_cms_case_study.json``),
   Figs 9–11 (``BENCH_fig9_11_migration.json``), one migration tick of
   the congested 10,000-job × 256-site grid (8,416 moves, the snapshot
   equal to the CPU twin's; its device operations, kernels and copies,
   counted by ``torch.profiler``), the event-horizon loop ≡ the per-event loop (64
   sites × 4,000 jobs, 227 migrations), and hier ≡ flat: GridSim at
   256/16 and 1,000/50 sites/tiers, then ``DianaScheduler`` at 10,000
   sites × 100 tiers × 10,000 jobs (the flat select through the fused
   f64 argmin kernel). The generators of ``benchmarks/`` are rebuilt
   over the port's classes (the same draws); each part prints its wall
   time on the card and on the CPU twin.

Prints the card, each phase's results and times, a ``{"kernels": …}``
line and, last, ``{"ok": true, "device": …}``. Any failed check raises,
so the script exits non-zero and prints no result line. Runs with no
CUDA device or outside a checkout also exit non-zero.
"""
from __future__ import annotations

import copy
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense, no sparsity, at the 700 W limit):
# HBM3 3.35 TB/s, FP32 67 TFLOP/s, FP64 34 TFLOP/s outside the tensor cores
# (a division or square root is counted as one operation: a lower bound),
# BF16 989 TFLOP/s on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"f32": 67e12, "f64": 34e12, "bf16": 989e12}

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


def equal_nan(torch, a, b) -> bool:
    """Equal values, with NaN where NaN (of any sign or payload)."""
    an, bn = a.isnan(), b.isnan()
    return torch.equal(an, bn) and torch.equal(a[~an], b[~bn])


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
        entry = ""
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_\d+_\w+?_cu_\w{8}\d+", "", line.split("'")[1])[:48]
            elif "registers" in line or "spill" in line:
                print(f"  {entry}: {line.strip()}")
            elif line.startswith("=="):
                print("  " + line.strip())


def phase_kernels(torch, P, J: int, S: int, L: int, seed: int):
    """Every kernel against its plain version on the card: the cost
    kernels at J jobs × S sites (the bench's generator, ``seed``), the
    requeue kernel at L queued jobs."""
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
    site_d, link_d, jobs = bench_grid(P, J, S, seed=seed)
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
    scratch = torch.empty(cm_ops.scratch_doubles(S, J), dtype=torch.float64, device=dev)
    ms = kernel_ms(torch, raw("repro_cost_matrix_f64", *f64_args, plane, J, S, 1.0, 1.0, 1.0, 1, scratch))
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
    ms = kernel_ms(torch, raw("repro_cost_argmin_f64", *f64_args, best, cost, J, S, 1.0, 1.0, 1.0, scratch))
    plain_ms = kernel_ms(torch, lambda: cm_ref.cost_argmin_f64_ref(*f64_args), reps=3, inner=2)
    b_ms, b_by = bound(J * 17 + S * 65 + J * 16, ops + J * S, "f64")
    # The screen's model (ref.py, plain PyTorch) on the same inputs: the
    # same picks, and the share of cells whose exact divisions it saved.
    bm, cm, skipped = cm_ref.cost_argmin_f64_screen_model(*f64_args)
    check(torch.equal(bm, bp) and torch.equal(cm, cp), "cost_argmin_f64 screen model != plain version")
    classes = torch.bincount(jp.cls.long(), minlength=3).tolist()
    out["cost_argmin_f64"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=max_abs_err(torch, ck, cp),
                                  bound_ms=b_ms, bound_by=b_by, shape=[J, S],
                                  skipped_share=skipped / (J * S), classes=classes)
    del bm, cm, scratch

    f32 = lambda t: t.float().contiguous()  # noqa: E731
    jobs32 = [f32(jp.bytes_), f32(jp.work), f32(jp.wcomp), f32(jp.wdtc)]
    sites32 = [f32(getattr(sp, f)) for f in ("cap", "queue", "work", "load", "bw", "loss", "rtt")]
    mss32 = f32(sp.mss)
    args32 = (*jobs32, *sites32, sp.alive, mss32)
    ck, bk = cm_ops.cost_matrix_classed(*args32, **w)
    cp, bp = cm_ref.cost_matrix_classed_ref(*args32, **w)
    torch.cuda.synchronize()
    check(torch.equal(bk, bp), "cost_matrix_classed argmin != plain version")
    check(equal_nan(torch, ck, cp), "cost_matrix_classed != plain version (bit for bit)")
    err32 = max_abs_err(torch, ck, cp)
    del ck, cp
    rows9 = cm_ref.site_rows_f32(*sites32, sp.alive, mss32)
    plane32 = torch.empty((J, S), dtype=torch.float32, device=dev)
    scratch32 = torch.empty(cm_ops.scratch_floats(S), dtype=torch.float32, device=dev)
    ms = kernel_ms(torch, raw("repro_cost_matrix_f32", *jobs32, rows9, plane32, J, S, 1.0, 1.0, 1.0, scratch32))
    del plane32
    # The whole wrapper: its stack of the 9 site rows, scratch and output
    # allocation, the launch and torch.argmin over the plane.
    wrapper_ms = kernel_ms(torch, lambda: cm_ops.cost_matrix_classed(*args32, **w))
    plain_ms = kernel_ms(torch, lambda: cm_ref.cost_matrix_f32_ref(*jobs32, rows9), reps=3, inner=2)
    b_ms, b_by = bound(J * 16 + S * 36 + J * S * 4, J * S * 7 + S * 13, "f32")
    out["cost_matrix_f32"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err32, wrapper_ms=wrapper_ms,
                                  bound_ms=b_ms, bound_by=b_by, shape=[J, S])
    del jp, sp, rows, f64_args, jobs32, sites32, rows9, args32
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
        print(f"phase 2 {name} {r['shape']} (seed {seed}): kernel {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']!r}"
              + (f", whole wrapper (stack, kernel, argmin) {r['wrapper_ms']:.6f} ms" if "wrapper_ms" in r else "")
              + (f", screen skipped {r['skipped_share']!r} of cells" if "skipped_share" in r else ""))
    return out


# The float64 kernels' edges, beside the adversarial sets of cases.py:
# every size of the pad and the odd-S pairing, a J past many waves.
F64_SHAPES = [(1, 1), (63, 31), (65, 33), (64, 255), (100_003, 1025), (65, 4097)]


def phase_f64_edges(torch):
    """Both f64 entries bit-equal to their plain versions over the
    adversarial sets (repro_torch.kernels.cost_matrix.cases) and ragged
    shapes, NaN and +inf picks included."""
    from repro_torch.kernels.cost_matrix import cases, ops as cm_ops, ref as cm_ref

    named = [(n, cases.adversarial(n)) for n in cases.ADVERSARIAL]
    shaped = [(f"ragged {J}x{S}", cases.ragged(J, S, seed=J + S)) for J, S in F64_SHAPES]
    for name, case in named + shaped:
        args, w = cases.tensors(case, "cuda")
        wq, ww, wl = w.values()
        for mask_dead in (True, False):
            k = cm_ops.cost_matrix_f64(*args, mask_dead=mask_dead, **w)
            p = cm_ref.cost_matrix_f64_ref(*args, wq, ww, wl, mask_dead)
            check(equal_nan(torch, k, p), f"cost_matrix_f64 != plain version on {name} (mask_dead={mask_dead})")
        bk, ck = cm_ops.argmin_f64_unchecked(*args, **w)
        bp, cp = cm_ref.cost_argmin_f64_ref(*args, wq, ww, wl)
        check(torch.equal(bk, bp) and equal_nan(torch, ck, cp), f"cost_argmin_f64 != plain version on {name}")
    torch.cuda.synchronize()
    print(f"phase 2 f64 edges: plane and argmin bit-equal to their plain versions on "
          f"{len(named)} adversarial sets and {len(shaped)} ragged shapes {F64_SHAPES}")


# The f32 plane's ragged shapes: rows misaligned (S % 4 != 0) and several
# column tiles.
F32_SHAPES = [(1, 1), (7, 5), (33, 1027), (257, 4099)]


def phase_f32_edges(torch):
    """The f32 plane bit-equal to its plain version, NaN where NaN, with
    the same argmin, over every edge set of cases.py (the f64 sets cast
    to float32 and the f32 sets) and ragged shapes."""
    from repro_torch.kernels.cost_matrix import cases, ops as cm_ops, ref as cm_ref

    named = [(n, cases.adversarial(n)) for n in cases.ADVERSARIAL + cases.ADVERSARIAL_F32]
    shaped = [(f"ragged {J}x{S}", cases.ragged(J, S, seed=J + S)) for J, S in F32_SHAPES]
    for name, case in named + shaped:
        args, w = cases.tensors_f32(case, "cuda")
        ck, bk = cm_ops.cost_matrix_classed(*args, **w)
        cp, bp = cm_ref.cost_matrix_classed_ref(*args, **w)
        check(equal_nan(torch, ck, cp), f"cost_matrix_classed != plain version on {name}")
        check(torch.equal(bk, bp), f"cost_matrix_classed argmin != plain version on {name}")
    torch.cuda.synchronize()
    print(f"phase 2 f32 edges: plane bit-equal to its plain version, same argmin, on "
          f"{len(named)} edge sets and {len(shaped)} ragged shapes {F32_SHAPES}")


FP64_OPS = {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"}


def sass_fp64_counts() -> dict | None:
    """FP64-pipe instructions of the never-launched probe kernels (one
    cell's screen; one cell's exact evaluation and merge per job class),
    from ``cuobjdump -sass`` of the built library, each counted up to
    its first EXIT (the division's slow path lies after it). None when
    the toolkit has no cuobjdump."""
    import os
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    if not Path(tool).is_file():
        return None
    sass = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True, text=True, check=True).stdout
    counts, fn, done = {}, None, False
    for line in sass.splitlines():
        if "Function :" in line:
            fn, done = line.split("Function :")[1].strip(), False
            continue
        if fn is None or not fn.startswith("repro_probe_") or done or "/*" not in line:
            continue
        body = line.split("*/", 1)[1].strip().lstrip("{").strip()
        if body.startswith("@"):
            body = body.split(None, 1)[1]
        op = body.split(None, 1)[0].split(".")[0] if body else ""
        if op == "EXIT":
            done = True
        elif op in FP64_OPS:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def fp64_floor(torch, r: dict) -> None:
    """The fused argmin's FP64-pipe floor at its phase-2 shape: per-cell
    FP64 instructions from the SASS of the probes, the screened cells at
    the screen's measured skipped share, over 64 FP64 lanes an SM at the
    card's maximum SM clock."""
    counts = sass_fp64_counts()
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    if not counts:
        print(f"phase 2 cost_argmin_f64 FP64-pipe floor: not measured (no cuobjdump); clocks {clock}")
        return
    J, S = r["shape"]
    mhz = float(clock.split(",")[0].split()[0])
    lanes_per_s = torch.cuda.get_device_properties(0).multi_processor_count * 64 * mhz * 1e6
    exact = sum(n * counts.get(f"repro_probe_exact_f64_{c}", 0)
                for n, c in zip(r["classes"], ("compute", "data", "both"))) * S
    screen = counts.get("repro_probe_screen_f64", 0) * J * S
    floor_ms = (screen + (1.0 - r["skipped_share"]) * exact) / lanes_per_s * 1e3
    print(f"phase 2 cost_argmin_f64 FP64-pipe floor at {J}x{S}: {floor_ms:.6f} ms screened "
          f"(skipped share {r['skipped_share']!r}), {exact / lanes_per_s * 1e3:.6f} ms with every cell exact; "
          f"bound() {r['bound_ms']:.6f} ms; SASS FP64 instructions a cell {json.dumps(counts)}; "
          f"clocks.max.sm, clocks.sm {clock}")


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


# -- the serving slice: attention kernels and gemma2-9b ----------------------------

# tests/kernels/test_kernels.py ATTN_CASES / DECODE_CASES (the JAX kernel
# tests' cases) and the main path's shapes, with the JAX kernel tests'
# tolerances: 2e-5 float32, 2e-2 bfloat16.
ATTN_CASES = [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap, dtype)
    (1, 128, 128, 4, 4, 64, True, 0, 0.0, "float32"),
    (2, 256, 256, 4, 2, 64, True, 0, 0.0, "float32"),
    (1, 128, 128, 8, 1, 128, True, 64, 0.0, "float32"),
    (1, 256, 256, 4, 4, 128, True, 0, 50.0, "float32"),
    (1, 128, 128, 4, 4, 256, True, 0, 0.0, "bfloat16"),
    (1, 128, 256, 2, 2, 64, False, 0, 0.0, "float32"),
]
DECODE_CASES = [
    # (B, S, H, KV, D, pos, window, softcap, dtype)
    (1, 128, 4, 4, 64, 0, 0, 0.0, "float32"),
    (2, 512, 8, 2, 64, 100, 0, 0.0, "float32"),
    (1, 512, 8, 1, 128, 511, 64, 0.0, "float32"),
    (2, 256, 16, 8, 256, 200, 0, 50.0, "float32"),
    (1, 512, 8, 8, 128, 300, 0, 0.0, "bfloat16"),
]
# bf16 cases at every head dim with ragged lengths, a window edge inside
# a key tile or chunk, non-causal Sq < Sk and GQA rep 3 and 16; the main
# path's own shapes: phase 5's float32 prefill (B 2, 16 tokens, a global
# and a local layer), the engine's decode over its 64-slot caches (first
# prefill step, last decode step) and phase 5's 24-slot caches.
# Then float32 rows over many of the flash kernel's 64-key tiles and the
# decode kernel's 256-key splits, where the rescale between them shows.
ATTN_CASES += [
    (1, 77, 77, 4, 2, 32, True, 0, 0.0, "bfloat16"),
    (1, 200, 200, 4, 2, 64, True, 100, 50.0, "bfloat16"),
    (1, 1000, 1000, 8, 2, 128, True, 0, 0.0, "bfloat16"),
    (2, 200, 1000, 4, 2, 256, False, 0, 50.0, "bfloat16"),
    (2, 16, 16, 16, 8, 256, True, 0, 50.0, "float32"),
    (2, 16, 16, 16, 8, 256, True, 4096, 50.0, "float32"),
    (1, 2048, 2048, 16, 8, 256, True, 0, 50.0, "float32"),
    (1, 2048, 2048, 16, 8, 256, True, 512, 50.0, "float32"),
]
DECODE_CASES += [
    (2, 77, 6, 2, 128, 76, 0, 0.0, "bfloat16"),
    (1, 1000, 32, 2, 256, 999, 45, 50.0, "bfloat16"),
    (4, 64, 16, 8, 256, 0, 0, 50.0, "bfloat16"),
    (4, 64, 16, 8, 256, 62, 0, 50.0, "bfloat16"),
    (2, 24, 16, 8, 256, 15, 0, 50.0, "float32"),
    (2, 8192, 16, 8, 256, 8191, 0, 50.0, "float32"),
    (1, 8192, 16, 8, 256, 6000, 4096, 50.0, "float32"),
]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
QK_STD = 1.5          # q and k: scores of spread ~2.25 at any D
REL_BOUND = 0.01      # mean |kernel − plain| ≤ REL_BOUND · mean |plain|
# gemma2-9b at its published width: prefill of one 8192-token prompt
# (max_seq_len), decode of 4 slots over an 8192 linear cache and a 4096 ring.
PREFILL = dict(B=1, S=8192, H=16, KV=8, D=256, cap=50.0)
DECODE = dict(B=4, S=8192, H=16, KV=8, D=256, cap=50.0, W=4096, ring_pos=6000)
SERVE = dict(requests=16, slots=4, max_len=64, prompt_len=8, new_tokens=8)
GEMMA2_PARAMS = 9_241_404_928             # the reference's LM.init tree, counted
GEMMA2_WEIGHT_BYTES = GEMMA2_PARAMS * 2    # bf16, read once a decode step


def within(torch, out, ref, tol: float) -> bool:
    """|out − ref| ≤ tol + tol·|ref| everywhere (assert_allclose's rule)."""
    return bool(((out.float() - ref.float()).abs() <= tol + tol * ref.float().abs()).all())


def agree(torch, out, ref, tol: float, what: str) -> tuple[float, float]:
    """An attention kernel's output against its plain version: within
    ``tol`` everywhere and mean |out − ref| ≤ REL_BOUND · mean |ref|.
    Returns (max_abs_err, mean |out − ref| / mean |ref|)."""
    err = max_abs_err(torch, out, ref)
    rel = float((out.float() - ref.float()).abs().mean() / ref.float().abs().mean())
    check(within(torch, out, ref, tol), f"{what} != plain version within {tol}")
    check(rel <= REL_BOUND, f"{what}: mean error is {rel!r} of mean |plain| (limit {REL_BOUND})")
    return err, rel


def sdpa_backend(torch, fn) -> str:
    """The backend scaled_dot_product_attention ran, read from the aten
    operator one call dispatched to (torch.profiler, host activity)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {e.key for e in prof.key_averages()}
    for backend in ("cudnn", "flash", "efficient"):
        if f"aten::_scaled_dot_product_{backend}_attention" in ops:
            return backend
    if "aten::_scaled_dot_product_attention_math" in ops:
        return "math"
    return "not measured (no SDPA backend operator in the trace)"


def attn_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks let through."""
    total = 0
    for qp in range(Sq):
        hi = min(qp, Sk - 1) if causal else Sk - 1
        lo = max(0, qp - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def phase_attention_kernels(torch):
    """Flash and decode kernels against their plain versions on the card:
    the JAX kernel tests' cases, then gemma2-9b's shapes (timed)."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def draw(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    for case in ATTN_CASES:
        B, Sq, Sk, H, KV, D, causal, window, cap, name = case
        q, k = draw((B, Sq, H, D), dt[name], QK_STD), draw((B, Sk, KV, D), dt[name], QK_STD)
        v = draw((B, Sk, KV, D), dt[name])
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
        ref = fa_ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
        torch.cuda.synchronize()
        err, rel = agree(torch, out, ref, ATTN_TOL[name], f"flash_attention {case}")
        print(f"phase 2 flash_attention {case}: max_abs_err {err!r} ({rel!r} mean error / mean |plain|)")
        del q, k, v, out, ref
    for case in DECODE_CASES:
        B, S, H, KV, D, pos, window, cap, name = case
        q, k = draw((B, H, D), dt[name], QK_STD), draw((B, S, KV, D), dt[name], QK_STD)
        v = draw((B, S, KV, D), dt[name])
        out = da_ops.decode_attention(q, k, v, pos, window=window, softcap=cap)
        ref = da_ref.decode_attention_ref(q, k, v, pos, window=window, softcap=cap)
        torch.cuda.synchronize()
        err, rel = agree(torch, out, ref, ATTN_TOL[name], f"decode_attention {case}")
        print(f"phase 2 decode_attention {case}: max_abs_err {err!r} ({rel!r} mean error / mean |plain|)")
    torch.cuda.empty_cache()

    bf = torch.bfloat16
    out = {}

    # -- flash at prefill scale: a global layer (causal) and a local one (window 4096)
    B, S, H, KV, D, cap = (PREFILL[k] for k in ("B", "S", "H", "KV", "D", "cap"))
    q, k, v = draw((B, S, H, D), bf, QK_STD), draw((B, S, KV, D), bf, QK_STD), draw((B, S, KV, D), bf)
    o = torch.empty_like(q)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    rows = {}
    for window in (0, 4096):
        kern = fa_ops.flash_attention(q, k, v, window=window, softcap=cap)
        plain = fa_ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
        torch.cuda.synchronize()
        err, rel = agree(torch, kern, plain, 2e-2, f"flash_attention at prefill scale (window {window})")
        del kern, plain
        torch.cuda.empty_cache()
        pairs = attn_pairs(S, S, True, window)
        b_ms, b_by = bound((2 * B * S * H * D + 2 * B * S * KV * D) * 2, 4 * B * H * D * pairs, "bf16")
        rows[window] = dict(
            ms=kernel_ms(torch, fa_ops.launcher(q, k, v, o, window=window, softcap=cap), reps=5, inner=5),
            plain_ms=kernel_ms(torch, lambda: fa_ref.flash_attention_ref(q, k, v, window=window, softcap=cap),
                               reps=3, inner=1),
            ms_softcap0=kernel_ms(torch, fa_ops.launcher(q, k, v, o, window=window), reps=5, inner=5),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, mean_rel_err=rel, pairs=pairs)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)  # noqa: E731
    rows[0]["library_ms"] = kernel_ms(torch, sdpa, reps=5, inner=5)
    rows[0]["library_backend"] = sdpa_backend(torch, sdpa)
    # The local layer's yardstick: SDPA with a boolean band mask (S² bools).
    pos = torch.arange(S, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < 4096)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)  # noqa: E731
    rows[4096]["library_ms"] = kernel_ms(torch, sdpa, reps=3, inner=2)
    rows[4096]["library_backend"] = sdpa_backend(torch, sdpa)
    out["flash_attention"] = dict(rows[0], shape=[B, S, H, KV, D], window_4096=rows[4096])
    del q, k, v, o, qt, kt, vt, band
    torch.cuda.empty_cache()

    # -- decode at serving scale: an 8192 linear cache (pos S−1) and a 4096 ring past its wrap
    B, S, H, KV, D, cap, W = (DECODE[k] for k in ("B", "S", "H", "KV", "D", "cap", "W"))
    q = draw((B, H, D), bf, QK_STD)
    rows = {}
    for name, L, pos in (("linear", S, S - 1), ("ring", W, min(DECODE["ring_pos"], W - 1))):
        cache = torch.stack([draw((B, L, KV, D), bf, QK_STD), draw((B, L, KV, D), bf)])
        k, v = cache[0], cache[1]
        kern = da_ops.decode_attention(q, k, v, pos, softcap=cap)
        plain = da_ref.decode_attention_ref(q, k, v, pos, softcap=cap)
        torch.cuda.synchronize()
        err, rel = agree(torch, kern, plain, 2e-2, f"decode_attention {name} at serving scale")
        o = torch.empty_like(q)

        visible = pos + 1
        b_ms, b_by = bound(2 * B * visible * KV * D * 2 + 2 * B * H * D * 2,
                           4 * B * H * D * visible, "bf16")
        qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        sdpa = lambda qs=qs, ks=ks, vs=vs: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)  # noqa: E731
        split = da_ops.split_size(B, KV, L)
        sweep = {s: kernel_ms(torch, da_ops.launcher(q, k, v, o, pos, softcap=cap, split=s))
                 for s in (L // 64, L // 32, L // 16, L // 8, L // 4, split)}
        rows[name] = dict(
            split=split, split_sweep_ms=sweep,
            ms=kernel_ms(torch, da_ops.launcher(q, k, v, o, pos, softcap=cap)),
            ms_softcap0=kernel_ms(torch, da_ops.launcher(q, k, v, o, pos)),
            plain_ms=kernel_ms(torch, lambda: da_ref.decode_attention_ref(q, k, v, pos, softcap=cap),
                               reps=3, inner=2),
            library_ms=kernel_ms(torch, sdpa), library_backend=sdpa_backend(torch, sdpa),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, mean_rel_err=rel,
            pos=pos, cache_len=L)
        del cache, k, v, kern, plain
    out["decode_attention"] = dict(rows["linear"], shape=[B, S, H, KV, D], ring_4096=rows["ring"])
    torch.cuda.empty_cache()

    for r in (out["flash_attention"], out["flash_attention"]["window_4096"], out["decode_attention"],
              out["decode_attention"]["ring_4096"]):
        r["bound_share"] = r["bound_ms"] / r["ms"]
    for name, r in out.items():
        extra = r.get("window_4096") or r.get("ring_4096")
        print(f"phase 2 {name} {r['shape']}: kernel {r['ms']:.6f} ms (softcap 0: {r['ms_softcap0']:.6f} ms), "
              f"plain {r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
              f"SDPA softcap 0 {r['library_ms']:.6f} ms ({r['library_backend']}), "
              f"max_abs_err {r['max_abs_err']!r} ({r['mean_rel_err']!r} mean error / mean |plain|)")
        print(f"  second shape: {json.dumps(extra)}")
    return out


def step_trace(torch, fn, steps: int) -> dict:
    """CUDA kernels a call of ``fn`` launches and the device time they
    take (torch.profiler, summed over kernels, averaged over ``steps``
    calls), with the six kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return dict(kernels=sum(e.count for e in kern) / steps,
                busy_ms=sum(e.self_device_time_total for e in kern) / 1e3 / steps,
                top=[[e.key[:60], e.count // steps, e.self_device_time_total / 1e3 / steps] for e in top])


def serve_once(torch, lm, seed: int):
    """launch/serve.py's traffic through the engine: two tenants of
    quota 100, random prompts from NumPy's generator(seed)."""
    from repro_torch.serving import InferenceRequest, ServingEngine

    rng = np.random.default_rng(seed)
    engine = ServingEngine(lm, num_slots=SERVE["slots"], max_len=SERVE["max_len"],
                           quotas={"tenant-a": 100.0, "tenant-b": 100.0})
    reqs = []
    for i in range(SERVE["requests"]):
        r = InferenceRequest(user=f"tenant-{'ab'[i % 2]}",
                             prompt=rng.integers(0, lm.cfg.vocab_size, SERVE["prompt_len"]).astype(np.int32),
                             max_new_tokens=SERVE["new_tokens"])
        reqs.append(r)
        engine.submit(r, now=float(i))
    t0 = time.perf_counter()
    stats = engine.run_until_drained()
    torch.cuda.synchronize()
    return engine, reqs, stats, time.perf_counter() - t0


def phase_serving(torch):
    """gemma2-9b at its published width and depth, bf16, random weights
    from a seeded generator on the card: the engine serves launch/serve.py's
    traffic, then one 8192-token prefill through LM.forward(last_only=True)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import LM, decode

    dev = torch.device("cuda")
    cfg = get_config("gemma2-9b")
    t0 = time.perf_counter()
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"phase 4 gemma2-9b: {cfg.num_layers} layers, d {cfg.d_model}, {n_params} parameters "
          f"({n_params * 2 / 1e9:.2f} GB bf16) on the card in {time.perf_counter() - t0:.3f} s")
    check(n_params == GEMMA2_PARAMS, f"gemma2-9b has {n_params} parameters")

    counters = {"flash_attention": fa_ops.flash_attention, "decode_attention": da_ops.decode_attention}
    for fn in counters.values():
        fn.launches = 0
    engine, reqs, stats, wall = serve_once(torch, lm, SEED)
    prompt = torch.as_tensor(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (1, PREFILL["S"])),
                             device=dev)
    t0 = time.perf_counter()
    logits, _ = lm.forward(prompt, last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    tokens = sum(len(r.generated) for r in reqs)
    print(f"phase 4 served {stats.served}/{len(reqs)} in {stats.batches} batches, {stats.decode_steps} decode "
          f"steps, {tokens} tokens in {wall:.6f} s ({tokens / wall:.3f} tokens/s); prefill of "
          f"{PREFILL['S']} tokens {prefill_s:.6f} s; launches {launches}")
    check(stats.served == 16 and stats.batches == 4 and stats.decode_steps == 28 and tokens == 128,
          f"serving stats {stats}, {tokens} tokens")
    check(all(r.done and len(r.generated) == 8 and all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in reqs), "a request did not get 8 tokens in the vocabulary")
    check(tuple(logits.shape) == (1, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
          "prefill logits not finite of shape (1, 1, V)")
    check(float(logits.abs().max()) <= cfg.final_logit_softcap, "prefill logits beyond the soft-cap")
    # prefill-by-decode: 8 steps per batch plus 7 decode steps, 42 layers each
    check(launches["decode_attention"] == 4 * (8 + 7) * cfg.num_layers,
          f"decode kernel launched {launches['decode_attention']} times")
    check(launches["flash_attention"] == cfg.num_layers, f"flash kernel launched {launches['flash_attention']} times")

    # Median decode step (one token for the 4 slots at pos 32 of the 64
    # cache), host clock around a synchronize, after the run.
    tok = torch.zeros((SERVE["slots"], 1), dtype=torch.int64, device=dev)
    times = []
    for _ in range(21):
        t0 = time.perf_counter()
        decode.decode_step(lm, tok, engine.cache, 32)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times[1:]) * 1e3
    bound_ms = GEMMA2_WEIGHT_BYTES / HBM_BYTES_PER_S * 1e3
    print(f"phase 4 decode step (4 slots, pos 32): median {step_ms:.6f} ms of 20, weight-streaming bound "
          f"{bound_ms:.6f} ms ({GEMMA2_WEIGHT_BYTES / 1e9:.2f} GB / 3.35 TB/s)")
    trace = step_trace(torch, lambda: decode.decode_step(lm, tok, engine.cache, 32), steps=3)
    busy_ms = trace["busy_ms"]
    idle = 1.0 - busy_ms / step_ms if busy_ms else None
    print(f"phase 4 decode step trace (torch.profiler, 3 steps): {trace['kernels']:.1f} CUDA kernels and "
          f"{busy_ms:.6f} ms of device time a step; device idle share of the median step "
          f"{'not measured' if idle is None else f'{idle:.6f}'}; top kernels {json.dumps(trace['top'])}")

    first = [list(r.generated) for r in reqs]
    lm.init(torch.Generator(device=dev).manual_seed(SEED))
    _, reqs2, stats2, wall2 = serve_once(torch, lm, SEED)
    check([r.generated for r in reqs2] == first, "a second run with the same seed gave other tokens")
    print(f"phase 4 second run, same seed: identical tokens ({wall2:.6f} s); first request {first[0]}")
    del engine, lm, logits
    return dict(launches=launches, tokens_per_s=tokens / wall, step_ms=step_ms, step_bound_ms=bound_ms,
                prefill_s=prefill_s, wall_s=wall, step_busy_ms=busy_ms, step_idle_share=idle)


def phase_prefill_equals_decode(torch):
    """gemma2-9b at full width in float32 (36.97 GB): LM.forward's logits
    (flash kernel) against a decode_step loop (decode kernel), B 2,
    16 tokens, rtol = atol = 2e-3 (tests/models/test_smoke_archs.py)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import LM, decode

    dev = torch.device("cuda")
    cfg = get_config("gemma2-9b").replace(param_dtype="float32", compute_dtype="float32")
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    B, T = 2, 16
    toks = torch.as_tensor(np.random.default_rng(SEED + 2).integers(0, cfg.vocab_size, (B, T)), device=dev)
    for fn in (fa_ops.flash_attention, da_ops.decode_attention):
        fn.launches = 0
    full, _ = lm.forward(toks)
    cache = decode.init_cache(lm, B, T + 8)
    steps = []
    for t in range(T):
        lt, cache = decode.decode_step(lm, toks[:, t : t + 1], cache, t)
        steps.append(lt[:, 0])
    dec = torch.stack(steps, dim=1)
    torch.cuda.synchronize()
    launches = {"flash_attention": fa_ops.flash_attention.launches,
                "decode_attention": da_ops.decode_attention.launches}
    err = float((dec - full).abs().max())
    print(f"phase 5 float32 prefill vs decode at full width ({B} x {T}): max |diff| {err!r}, "
          f"max |logit| {float(full.abs().max())!r}, launches {launches}")
    check(launches == {"flash_attention": cfg.num_layers, "decode_attention": T * cfg.num_layers},
          f"phase 5 launches {launches}")
    check(bool(torch.isfinite(full).all()), "phase 5 logits not finite")
    check(within(torch, dec, full, 2e-3), "prefill logits != decode logits within 2e-3")
    del lm, cache
    return launches



# -- phase 6: the §XI simulator on the card ----------------------------------------
#
# The benchmarks' own generators (benchmarks/*.py import the reference, so
# ``repro_torch.sim.bench_inputs`` rebuilds them over the port's classes:
# the same draws in the same order), the results held against the
# committed BENCH_*.json of the reference and against the port's CPU twin.

POLICIES = ("diana", "fcfs", "greedy", "local")


def bench_json(name: str) -> dict:
    return json.loads((ROOT / name).read_text())


def twin(torch, fn):
    """``fn(device)`` on the card and on the port's CPU twin: (card
    result, CPU result, card seconds, CPU seconds)."""
    t0 = time.perf_counter()
    card = fn("cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cpu = fn("cpu")
    return card, cpu, t1 - t0, time.perf_counter() - t1


def sim_trace(res) -> list:
    return [(j.user, j.arrival, j.exec_site, j.start, j.finish, j.migrated) for j in res.jobs]


HIER_CORE = (10_000, 100, 10_000)     # sites, tiers, jobs (the bench's 100,000 jobs cut to 10,000)


def phase_sim(torch, P) -> dict:
    """Phase 6: GridSim's results on the card against the committed
    reference results and the CPU twin; returns the part times."""
    import repro_torch.sim as S
    from repro_torch.kernels.cost_matrix import ops as cm_ops
    from repro_torch.sim import bench_inputs as BI

    out: dict = {}

    def report(part: str, t_card: float, t_cpu: float, extra: str = "") -> None:
        out[part] = {"card_s": t_card, "cpu_s": t_cpu}
        print(f"phase 6 {part}: card {t_card:.3f} s, CPU twin {t_cpu:.3f} s{extra}")

    # 1. Figs 7-8: queue and execution time against n, four policies.
    derived = {r["name"]: r["derived"] for r in bench_json("BENCH_fig7_8_queue_exec.json")["rows"]}
    t_card = t_cpu = 0.0
    for n in (25, 50, 100, 250):
        def fig(device, n=n):
            return {p: S.GridSim(S.paper_grid_spec(), config=S.SimConfig(policy=p),
                                 device=device).run(BI.fig78_workload(n)) for p in POLICIES}
        rows, rows_cpu, a, b = twin(torch, fig)
        t_card, t_cpu = t_card + a, t_cpu + b
        for p in POLICIES:
            check(sim_trace(rows[p]) == sim_trace(rows_cpu[p]), f"fig 7-8 n={n} {p}: card != CPU twin")
        q = "queue_s=" + "/".join(f"{rows[p].avg_queue_time:.0f}" for p in POLICIES) + \
            ";order=diana/fcfs/greedy/local"
        e = "exec_s=" + "/".join(f"{rows[p].avg_exec_time:.0f}" for p in POLICIES) + \
            f";diana_turnaround_s={rows['diana'].avg_turnaround:.0f}"
        check(q == derived[f"fig7_queue_time_n{n}"], f"fig 7 n={n}: {q} != {derived[f'fig7_queue_time_n{n}']}")
        check(e == derived[f"fig8_exec_time_n{n}"], f"fig 8 n={n}: {e} != {derived[f'fig8_exec_time_n{n}']}")
        if n == 100:
            print(f"phase 6 fig 7-8 n=100: {q}; {e}")
    report("fig7_8 (n 25/50/100/250, 4 policies)", t_card, t_cpu, ", every string = BENCH_fig7_8_queue_exec.json")

    # 2. The CMS case study.
    derived = {r["name"]: r["derived"] for r in bench_json("BENCH_cms_case_study.json")["rows"]}
    def cms(device):
        return {p: S.GridSim(S.paper_grid_spec(), config=S.SimConfig(policy=p), device=device).run(
            S.cms_case_study(scale=0.6, seed=7)) for p in POLICIES}
    rows, rows_cpu, a, b = twin(torch, cms)
    for p in POLICIES:
        res = rows[p]
        got = (f"jobs={len(res.jobs)};turnaround_s={res.avg_turnaround:.0f};"
               f"queue_s={res.avg_queue_time:.0f};exec_s={res.avg_exec_time:.0f};"
               f"throughput_jobs_s={res.throughput:.4f}")
        check(got == derived[f"cms_{p}"], f"cms {p}: {got} != {derived[f'cms_{p}']}")
        check(sim_trace(res) == sim_trace(rows_cpu[p]), f"cms {p}: card != CPU twin")
    report("cms_case_study (scale 0.6, seed 7)", a, b,
           f", diana turnaround {rows['diana'].avg_turnaround:.0f} s, fcfs {rows['fcfs'].avg_turnaround:.0f} s")

    # 3. Figs 9-11: export/import under overload, then a big site.
    def fig911(device):
        cfg = dict(policy="diana", quotas=BI.QUOTAS, migration_interval_s=30.0,
                   congestion_window_s=120.0)
        res = S.GridSim(S.paper_grid_spec(), config=S.SimConfig(**cfg), device=device).run(
            BI.overload_workload())
        res2 = S.GridSim(dict(S.paper_grid_spec(), big=50), config=S.SimConfig(**cfg),
                         device=device).run(BI.overload_workload())
        exported = {s: sum(res.timeline[s]["exported"]) for s in res.timeline}
        imported = {s: sum(res.timeline[s]["imported"]) for s in res.timeline}
        executed = {s: sum(res.timeline[s]["executed"]) for s in res.timeline}
        return {
            "bench": "fig9_11_migration",
            "exported_total": sum(exported.values()),
            "imported_total": sum(imported.values()),
            "migrations": res.migrations(),
            "big_site_imports": sum(res2.timeline["big"]["imported"]),
            "busiest_site": max(executed, key=executed.get),
            "completed": sum(1 for j in res.jobs if j.finish >= 0),
            "jobs": len(res.jobs),
        }
    got, got_cpu, a, b = twin(torch, fig911)
    expect = bench_json("BENCH_fig9_11_migration.json")["result"]
    check(got == expect, f"figs 9-11: {got} != {expect}")
    check(got_cpu == got, "figs 9-11: card != CPU twin")
    report("fig9_11", a, b, f", {got['migrations']} migrations, busiest {got['busiest_site']}, "
           f"{got['completed']}/{got['jobs']} completed")

    # 4. One migration tick at 10,000 jobs x 256 sites (not cut).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    expect = bench_json("BENCH_migration.json")
    J, Sn = expect["jobs"], expect["sites"]
    card, now = BI.congested_sim(J, Sn, 0, device="cuda")
    lazy, _ = BI.congested_sim(J, Sn, 0, device="cuda", placement="hier")
    profiled = copy.deepcopy(card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card._on_migrate_check(now + 60.0, [])
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled._on_migrate_check(now + 60.0, [])
        torch.cuda.synchronize()
    # The raw device events: key_averages() parses the tick's ~1.4 million
    # events into Python objects, which took minutes; the counts and
    # durations are the same.
    kern = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    t_prof = time.perf_counter() - t0
    launches = len(kern)
    busy_s = sum(e.duration_ns() for e in kern) / 1e9
    cpu, now = BI.congested_sim(J, Sn, 0, device="cpu")
    t0 = time.perf_counter()
    cpu._on_migrate_check(now + 60.0, [])
    t_cpu = time.perf_counter() - t0
    snap = BI.migration_snapshot(card)
    moves = sum(1 for _, m in snap["moves"] if m)
    check(moves == expect["migrations"], f"migration tick: {moves} migrations != {expect['migrations']}")
    check(snap == BI.migration_snapshot(cpu), "migration tick: card != CPU twin")
    check(BI.migration_snapshot(profiled) == snap, "migration tick: profiled run differs")
    out["tick"] = {"launches": launches, "device_busy_s": busy_s, "migrations": moves}
    report(f"migration tick {J} x {Sn}", t_card, t_cpu,
           f", {moves} migrations, {launches} device operations (kernels and copies; "
           f"{launches / moves:.1f} a move), "
           f"device busy {busy_s:.6f} s; the profiled run and its event count {t_prof:.3f} s")
    # The same tick under placement="hier" takes the lazy candidate-column
    # pass; it must decide exactly as the dense one (and so as the CPU twin).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lazy._on_migrate_check(now + 60.0, [])
    torch.cuda.synchronize()
    t_lazy = time.perf_counter() - t0
    snap_lazy = BI.migration_snapshot(lazy)
    moves_lazy = sum(1 for _, m in snap_lazy["moves"] if m)
    check(moves_lazy == expect["migrations"],
          f"lazy migration tick: {moves_lazy} migrations != {expect['migrations']}")
    check(snap_lazy == snap, "lazy migration tick (placement='hier') != the dense tick")
    out["tick_lazy"] = {"card_s": t_lazy, "migrations": moves_lazy}
    print(f"phase 6 migration tick {J} x {Sn}, placement='hier' (lazy pass): card {t_lazy:.3f} s, "
          f"{moves_lazy} migrations, snapshot == the dense tick's == the CPU twin's")

    # 5. Event-horizon identity (benchmarks/streaming_bench.py:check_equivalence, GridSim half).
    expect = bench_json("BENCH_streaming.json")["equivalence"]
    nodes = BI.streaming_grid(expect["sites"])
    base = dict(policy="diana", migration_interval_s=60.0, congestion_window_s=120.0)
    def stream(device):
        w = BI.streaming_workload(sorted(nodes), expect["jobs"])
        return [S.GridSim(nodes, config=S.SimConfig(horizon=h, **base), device=device).run(
            copy.deepcopy(w)) for h in (False, True)]
    (ev, hz), (ev_cpu, hz_cpu), a, b = twin(torch, stream)
    placements = lambda r: sorted((j.user, j.arrival, j.exec_site, j.start, j.finish, j.migrated)  # noqa: E731
                                  for j in r.jobs)
    check(placements(ev) == placements(hz), "streaming: horizon loop != per-event loop on the card")
    check(placements(hz) == placements(hz_cpu) == placements(ev_cpu), "streaming: card != CPU twin")
    check(hz.migrations() == expect["gridsim"]["migrations"],
          f"streaming: {hz.migrations()} migrations != {expect['gridsim']['migrations']}")
    report(f"streaming equivalence {expect['sites']} sites x {expect['jobs']} jobs", a, b,
           f", horizon == per-event, {hz.migrations()} migrations")

    # 6. hier == flat: GridSim at 256/16 and 1000/50, then the core at 10k sites.
    for n_sites, tiers_n in ((256, 16), (1000, 50)):
        spec, links, topo, jobs = BI.hier_sim_grid(n_sites, tiers_n, 0)
        def hier(device):
            traces = {}
            for placement in ("flat", "hier"):
                cfg = S.SimConfig(policy="diana", placement=placement, topology=topo,
                                  migration_interval_s=30.0, congestion_window_s=120.0)
                res = S.GridSim(dict(spec), links=dict(links), config=cfg, device=device).run(
                    copy.deepcopy(jobs))
                traces[placement] = [(j.user, j.arrival, j.exec_site, j.finish, j.migrated)
                                     for j in res.jobs]
            return traces
        tr, tr_cpu, a, b = twin(torch, hier)
        check(tr["flat"] == tr["hier"], f"hier sim {n_sites}/{tiers_n}: hier != flat on the card")
        check(tr == tr_cpu, f"hier sim {n_sites}/{tiers_n}: card != CPU twin")
        report(f"GridSim hier == flat at {n_sites} sites / {tiers_n} tiers (flat + hier runs)", a, b,
               f", {sum(m for *_, m in tr['hier'])} migrations")

    sites_n, tiers_n, jobs_n = HIER_CORE
    site_d, link_d, job_list, tier_d = BI.hier_core_grid(sites_n, tiers_n, jobs_n)
    argmin_before = cm_ops.cost_argmin_f64.launches
    def core(device):
        res = {}
        for mode in ("flat", "hier"):
            kw = {"mode": "hier", "tiers": tier_d} if mode == "hier" else {}
            d = P.DianaScheduler(copy.deepcopy(site_d), dict(link_d), device=device)
            t0 = time.perf_counter()
            sel = d.select_sites_batch(job_list, **kw)
            t1 = time.perf_counter()
            d = P.DianaScheduler(copy.deepcopy(site_d), dict(link_d), device=device)
            pl = d.place_batch(copy.deepcopy(job_list), **kw)
            t2 = time.perf_counter()
            res[mode] = (sel.sites, sel.costs.tolist(), pl.sites, pl.costs.tolist(),
                         [(s.queue_length, s.waiting_work) for s in d.sites.values()],
                         t1 - t0, t2 - t1)
        return res
    c, c_cpu, a, b = twin(torch, core)
    check(cm_ops.cost_argmin_f64.launches > argmin_before, "hier core: the flat select launched no f64 argmin")
    for mode in ("flat", "hier"):
        check(c[mode][:5] == c_cpu[mode][:5], f"hier core {mode}: card != CPU twin")
    check(c["flat"][:2] == c["hier"][:2], "hier core: select_sites_batch hier != flat (fused f64 argmin)")
    check(c["flat"][2:5] == c["hier"][2:5], "hier core: place_batch hier != flat")
    times = {f"{m}_{k}": v for m in ("flat", "hier") for k, v in (("select_s", c[m][5]), ("place_s", c[m][6]))}
    times_cpu = {f"{m}_{k}": v for m in ("flat", "hier") for k, v in (("select_s", c_cpu[m][5]), ("place_s", c_cpu[m][6]))}
    out["hier_core"] = {"card": times, "cpu": times_cpu}
    report(f"core hier == flat at {sites_n} sites / {tiers_n} tiers x {jobs_n} jobs", a, b,
           f"; card {json.dumps({k: round(v, 6) for k, v in times.items()})}, "
           f"CPU {json.dumps({k: round(v, 6) for k, v in times_cpu.items()})}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as P

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 products in float32 (phase 5)
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    phase_build()
    phase_kernels(torch, P, BENCH_JOBS, BENCH_SITES, BENCH_JOBS, SEED)   # the main path's shapes
    kernels = phase_kernels(torch, P, BIG_JOBS, BIG_SITES, REQUEUE_L, seed=1)
    fp64_floor(torch, kernels["cost_argmin_f64"])
    phase_f64_edges(torch)
    phase_f32_edges(torch)
    phase_fig6(P)
    launches, _ = phase_main_path(torch, P)
    attn = phase_attention_kernels(torch)
    serving = phase_serving(torch)
    gc.collect()
    torch.cuda.empty_cache()
    phase_prefill_equals_decode(torch)
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 6 is this slice's path: every kernel counter at 0 before it,
    # read after (the CPU twin's calls run the plain versions, uncounted).
    from repro_torch.kernels.cost_matrix import ops as cm_ops
    from repro_torch.kernels.priority_requeue import ops as pr_ops

    sim_counters = {"cost_matrix_f32": cm_ops.cost_matrix_classed, "cost_matrix_f64": cm_ops.cost_matrix_f64,
                    "cost_argmin_f64": cm_ops.cost_argmin_f64, "priority_requeue": pr_ops.priority_requeue}
    for fn in sim_counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    phase_sim(torch, P)
    sim_launches = {name: fn.launches for name, fn in sim_counters.items()}
    print(f"phase 6 in {time.perf_counter() - t0:.3f} s, launches {sim_launches}")
    check(sim_launches["cost_argmin_f64"] > 0, "phase 6 never launched cost_argmin_f64")

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
    attn_meta = {
        "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/flash_attention.py:72"),
        "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/decode_attention.py:65"),
    }
    line = []
    for name, (source, replaces) in meta.items():
        r = kernels[name]
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=None, shape=r["shape"], launches_sim=sim_launches[name],
            **({"wrapper_ms": r["wrapper_ms"]} if "wrapper_ms" in r else {}),
        ))
    for name, (source, replaces) in attn_meta.items():
        r = attn[name]
        line.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=serving["launches"][name], launches_sim=0, **r))
    for k in line:
        k["bound_share"] = k["bound_ms"] / k["ms"]
        k["launches_x_gap_ms"] = k["launches"] * (k["ms"] - k["bound_ms"])
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
