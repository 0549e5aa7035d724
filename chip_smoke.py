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
7. Decentralized P2P scheduling and the scenario packs on the card,
   every kernel counter set to 0 before and read after (``launches_p2p``):
   the ``PeerScheduler`` API at 10,000 jobs × 256 sites (select through
   the fused f64 argmin, rank through the f64 plane, place; the single
   peer bit-identical to ``DianaScheduler`` and to the CPU twin); the
   1-peer identity and chaos smokes of ``benchmarks/p2p_bench.py``
   (16 sites × 3 peers × 200 jobs, whole traces against the CPU twin);
   ``BENCH_p2p.json``'s configuration (256 sites × 8 peers × 4,000 jobs,
   intervals 30/120/480 s, both wires: every field but ``run_s`` equal to
   the committed file, the delta wire's ``bytes_sent`` plus 8 bytes an
   ack'd packet for wire v2; the CPU twin at the 30 s interval); the six
   scenario packs at bench scale (every metric equal to the committed
   ``BENCH_<name>.json``, each verifier's invariants held); and the P2P
   halves of the streaming (horizon ≡ per-event, 589 migrations) and
   hier (hier ≡ flat at 256 sites / 16 tiers, 8 peers) benches.
8. The other single-card model families at their published width and
   depth, weights from a seeded generator on the card (cross layers'
   tanh gates set to 0.5: the reference initialises them to 0, which
   would hide the cross layers), each freed before the next: every
   kernel counter set to 0 before the phase and read after, and both
   attention kernels' counters around each part. recurrentgemma-2b
   (26 layers, rep 10 over one kv head, window 2048) and mamba2-780m (48
   layers) serve launch/serve.py's 16 requests through ServingEngine
   twice with identical tokens, prefill 8,192 and 4,096 tokens through
   LM.forward and time a decode step against its weight-streaming
   bound and its device share (profiler); llama-3.2-vision-11b (40
   layers) prefills 2,048 tokens over 1,601 image tokens (Sq > Sk on its
   8 cross layers) and decodes 32 steps over init_cache's image K/V;
   whisper-base (6 + 6 layers) encodes 1,500 frames, runs a 448-token
   decoder forward and decodes to 448. Each family in float32 holds
   LM.forward against a decode_step loop (2e-3; recurrentgemma also
   with local_window cut to 16, so that its ring wraps); the pod
   runtime runs examples/grid_schedule.py's scenario through
   ``repro_torch.grid`` against the reference's decisions pinned in
   ``repro_torch.grid.example``. Phase 2 first holds both attention
   kernels at every shape phase 8 gives them, and times flash at the
   vision cross layer and whisper's encoder layer and the decode kernel
   at recurrentgemma's ring and the two cross layers.
9. The moe family at its published width, depth cut to fit one card,
   weights from a seeded generator, every kernel counter set to 0
   before the phase and read after, each model freed before the next:
   deepseek-v2-236b in bf16 with 6 of its 60 layers (1 dense + 5 MoE,
   42.5 GB) serves launch/serve.py's 16 requests twice with identical
   tokens, prefills 4,096 tokens through LM.forward (6 launches of the
   flash kernel's (192, 128) instance) and times a decode step beside
   two weight-streaming bounds (every expert; the experts the step's
   routing hit) and its device share; in float32 with 3 layers and a
   dropless capacity factor (37.3 GB) it holds LM.forward against a
   decode_step loop (absorbed MLA decode), 2e-3; deepseek-v3-671b
   (sigmoid router) in bf16 with 4 of its 61 layers (3 dense + 1 MoE,
   30.2 GB) prefills 1,024 tokens and decodes 16 greedy steps, twice
   with identical tokens. Phase 2 first holds the (192, 128) instance
   against its plain version at lengths 77 to 4,096, causal and not,
   in both types, and times it at deepseek-v2's prefill layer (B 1,
   S 4,096, 128 heads) beside its bound, plain version and SDPA.

2c. Hold flash attention's backward kernel (csrc/flash_attention_bwd.cu)
   against its plain version before phase 10 relies on it: every
   (D, Dv) instance in float32 and bf16, causal and not, window edges
   inside a 32-row tile, soft-cap 0 and 50, GQA rep 1, 2, 3, 10 and 16,
   ragged lengths 77, 200 and 1,000, Sq < Sk non-causal, k and v two
   column ranges of one buffer; each of dq, dk and dv within 1e-4 (f32)
   or 2e-2 (bf16, and the mean error under 1%) of max |plain|. Then time
   it at gemma2-9b's two training layers (B 1, S 8,192, H 16/8, D 256,
   bf16, cap 50; causal, and a 4,096 window) beside its bound, its plain
   version and the backward alone of SDPA at cap 0.
10. Train gemma2-9b at its published width on the card, every kernel
   counter set to 0 before the phase and read after, each model freed
   before the next: 8 of its 42 layers (4 local + 4 global; all 42 with
   f32 AdamW moments need about 111 GB) in bf16, ``build_train_step``
   with ``TrainConfig`` defaults and remat, B 1 × S 8,192 from
   ``SyntheticLMDataset(256000, 8192, seed=1)`` for 20 steps: every loss
   finite and the last five's mean below the first five's by more than
   0.1, 16 flash forward launches (8 and 8 remat recomputes) and 8
   backward a step, the median step beside its FLOP bound (6·P·tokens
   plus attention's forward and backward at 989 TFLOP/s), tokens/s, a
   step's device time and idle share (profiler) and the peak memory.
   Then in float32 with one local and one global layer (B 1 × S 512) the
   loss and every gradient through the kernels against the same with
   attention through the plain version (loss 1e-5 relative, each leaf
   1e-3 of its max |g|); in bf16 with 2 layers, 6 steps with
   ``CheckpointManager`` saving at step 3, restored and run on to step
   6, parameters and moments bit-equal to the unbroken run; and
   launch/train.py's ``main`` on the card (reduced, 20 steps, with a
   checkpoint directory).

The flash wrapper also counts its launches per (D, Dv) instance
(``flash_attention.by_pair``): the kernels line splits them into a row
for the instances with v as wide as q and k and one for (192, 128), each
with every phase's measured counts (``launches_by_pair``); the (192, 128)
row's ``launches_x_gap_ms`` counts only its launches at the timed shape
(``gap_launches``, deepseek-v2's 4,096-token prefill). The backward
kernel's row carries every phase's count (``launches`` is phase 10's)
and its lost time over phase 10's 20 steps at the two timed layers.

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
# Phase 8's shapes, each before the phase relies on it: recurrentgemma-2b's
# local layers (rep 10 over one kv head, D 256, window 2048; the f32
# checks' 16 and 24 tokens, the cut window of 16), llama-3.2-vision's self
# layers (D 128, 32/8) and cross layers (non-causal, Sk 1,601 against a
# longer prompt: Sq > Sk), whisper-base's encoder (non-causal 1,500 x
# 1,500, D 64, 8/8), decoder self and cross layers (Sq 448, Sk 1,500); the
# decode kernel at rep 10 over the engine's 64-slot ring and the 2,048
# ring, and at the cross layers' last positions 1,600 and 1,499.
ATTN_CASES += [
    (1, 4096, 4096, 10, 1, 256, True, 2048, 0.0, "bfloat16"),
    (2, 16, 16, 10, 1, 256, True, 2048, 0.0, "float32"),
    (2, 24, 24, 10, 1, 256, True, 16, 0.0, "float32"),
    (1, 2048, 2048, 32, 8, 128, True, 0, 0.0, "bfloat16"),
    (1, 2048, 1601, 32, 8, 128, False, 0, 0.0, "bfloat16"),
    (2, 16, 1601, 32, 8, 128, False, 0, 0.0, "float32"),
    (1, 1500, 1500, 8, 8, 64, False, 0, 0.0, "bfloat16"),
    (2, 1500, 1500, 8, 8, 64, False, 0, 0.0, "float32"),
    (1, 448, 448, 8, 8, 64, True, 0, 0.0, "bfloat16"),
    (1, 448, 1500, 8, 8, 64, False, 0, 0.0, "bfloat16"),
    (2, 16, 1500, 8, 8, 64, False, 0, 0.0, "float32"),
]
DECODE_CASES += [
    (4, 64, 10, 1, 256, 63, 0, 0.0, "bfloat16"),
    (1, 2048, 10, 1, 256, 2047, 0, 0.0, "bfloat16"),
    (2, 24, 10, 1, 256, 15, 0, 0.0, "float32"),
    (2, 16, 10, 1, 256, 15, 0, 0.0, "float32"),
    (1, 64, 32, 8, 128, 31, 0, 0.0, "bfloat16"),
    (1, 1601, 32, 8, 128, 1600, 0, 0.0, "bfloat16"),
    (2, 1601, 32, 8, 128, 1600, 0, 0.0, "float32"),
    (1, 448, 8, 8, 64, 447, 0, 0.0, "bfloat16"),
    (1, 1500, 8, 8, 64, 1499, 0, 0.0, "bfloat16"),
    (2, 1500, 8, 8, 64, 1499, 0, 0.0, "float32"),
]
# Phase 8's two new flash shapes, timed beside their bound, plain version
# and SDPA: llama-3.2-vision's cross layer (its 2,048-token prompt over
# the 1,601 image tokens) and whisper-base's encoder layer.
FLASH_ROWS = {
    "vision_cross_d128": dict(B=1, Sq=2048, Sk=1601, H=32, KV=8, D=128, causal=False),
    "whisper_encoder_d64": dict(B=1, Sq=1500, Sk=1500, H=8, KV=8, D=64, causal=False),
}
# Phase 9's flash instance, MLA's (DQK 192, DV 128), before the phase relies
# on it: ragged lengths 77, 200, 1,000 and 4,096, causal and not, both
# types, k and v two column ranges of one (B, S, KV, 320) buffer as
# models.mla builds them; then phase 9's own shapes: the f32 oracle (B 2,
# 16 tokens, 128 heads) and deepseek-v3's 1,024-token prefill.
MLA_CASES = [
    # (B, Sq, Sk, H, KV, causal, dtype)
    *((1, S, S, 4, 4, c, "bfloat16") for S in (77, 200, 1000, 4096) for c in (True, False)),
    *((2, S, S, 2, 2, c, "float32") for S in (77, 200, 1000, 4096) for c in (True, False)),
    (2, 16, 16, 128, 128, True, "float32"),
    (1, 1024, 1024, 128, 128, True, "bfloat16"),
]
# deepseek-v2's 4,096-token prefill layer, timed beside its bound (B 1,
# 128 heads, causal: 8,390,656 pairs x 128 heads x 2 x (192 + 128)
# operations), its plain version and SDPA.
MLA_ROW = dict(B=1, S=4096, H=128, DQK=192, DV=128)
# The decode kernel at phase 8's shapes, timed (DECODE_CASES holds them):
# recurrentgemma's ring (rep 10 over one kv head, read to its last slot)
# and the vision and whisper cross layers read to the last image token or
# frame, all at the engine's 4 slots.
DECODE_ROWS = {
    "recurrentgemma_ring_rep10": dict(B=4, S=2048, H=10, KV=1, D=256, pos=2047),
    "vision_cross_d128": dict(B=4, S=1601, H=32, KV=8, D=128, pos=1600),
    "whisper_cross_d64": dict(B=4, S=1500, H=8, KV=8, D=64, pos=1499),
}
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


def mla_qkv(draw, B: int, Sq: int, Sk: int, H: int, KV: int, dtype):
    """q (B, Sq, H, 192) and k (B, Sk, KV, 192), v (B, Sk, KV, 128) as two
    column ranges of one buffer, as models.mla builds them."""
    import torch

    kv = torch.cat([draw((B, Sk, KV, 192), dtype, QK_STD), draw((B, Sk, KV, 128), dtype)], dim=-1)
    return draw((B, Sq, H, 192), dtype, QK_STD), kv[..., :192], kv[..., 192:]


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
    for case in MLA_CASES:
        B, Sq, Sk, H, KV, causal, name = case
        q, k, v = mla_qkv(draw, B, Sq, Sk, H, KV, dt[name])
        out = fa_ops.flash_attention(q, k, v, causal=causal)
        ref = fa_ref.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, rel = agree(torch, out, ref, ATTN_TOL[name], f"flash_attention (192, 128) {case}")
        print(f"phase 2 flash_attention (192, 128) {case}: max_abs_err {err!r} ({rel!r} mean error / mean |plain|)")
        del q, k, v, out, ref
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

    # -- flash at phase 8's new shapes (non-causal, no soft-cap)
    for name, c in FLASH_ROWS.items():
        B_, Sq, Sk, H_, KV_, D_ = (c[k] for k in ("B", "Sq", "Sk", "H", "KV", "D"))
        q = draw((B_, Sq, H_, D_), bf, QK_STD)
        k, v = draw((B_, Sk, KV_, D_), bf, QK_STD), draw((B_, Sk, KV_, D_), bf)
        kern = fa_ops.flash_attention(q, k, v, causal=c["causal"])
        plain = fa_ref.flash_attention_ref(q, k, v, causal=c["causal"])
        torch.cuda.synchronize()
        err, rel = agree(torch, kern, plain, 2e-2, f"flash_attention {name}")
        o = torch.empty_like(q)
        pairs = attn_pairs(Sq, Sk, c["causal"], 0)
        b_ms, b_by = bound((2 * B_ * Sq * H_ * D_ + 2 * B_ * Sk * KV_ * D_) * 2, 4 * B_ * H_ * D_ * pairs, "bf16")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True)  # noqa: E731
        out["flash_attention"][name] = dict(
            ms=kernel_ms(torch, fa_ops.launcher(q, k, v, o, causal=c["causal"])),
            plain_ms=kernel_ms(torch, lambda: fa_ref.flash_attention_ref(q, k, v, causal=c["causal"]),
                               reps=3, inner=2),
            library_ms=kernel_ms(torch, sdpa), library_backend=sdpa_backend(torch, sdpa),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, mean_rel_err=rel, shape=[B_, Sq, Sk, H_, KV_, D_])
        out["flash_attention"][name]["bound_share"] = b_ms / out["flash_attention"][name]["ms"]
        del q, k, v, o, kern, plain, qt, kt, vt
    torch.cuda.empty_cache()

    # -- flash's (192, 128) instance at deepseek-v2's prefill layer
    B, S, H, DQK, DV = (MLA_ROW[k] for k in ("B", "S", "H", "DQK", "DV"))
    q, k, v = mla_qkv(draw, B, S, S, H, H, bf)
    kern = fa_ops.flash_attention(q, k, v)
    plain = fa_ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    err, rel = agree(torch, kern, plain, 2e-2, "flash_attention (192, 128) at deepseek-v2's prefill")
    del kern, plain
    torch.cuda.empty_cache()
    pairs = attn_pairs(S, S, True, 0)
    b_ms, b_by = bound(2 * B * S * H * (DQK + DV) * 2, 2 * B * H * pairs * (DQK + DV), "bf16")
    o = q.new_empty((B, S, H, DV))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
    mla = dict(ms=kernel_ms(torch, fa_ops.launcher(q, k, v, o)),
               plain_ms=kernel_ms(torch, lambda: fa_ref.flash_attention_ref(q, k, v), reps=3, inner=1),
               library_ms=kernel_ms(torch, sdpa), library_backend=sdpa_backend(torch, sdpa),
               bound_ms=b_ms, bound_by=b_by, max_abs_err=err, mean_rel_err=rel, pairs=pairs,
               shape=[B, S, H, H, DQK, DV])
    mla["bound_share"] = b_ms / mla["ms"]
    out["flash_attention_mla"] = mla
    print(f"phase 2 flash_attention (192, 128) {mla['shape']}: {json.dumps(mla)}")
    del q, k, v, o, qt, kt, vt
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

    # -- decode at phase 8's shapes (no soft-cap)
    for name, c in DECODE_ROWS.items():
        B_, S_, H_, KV_, D_, pos = (c[k] for k in ("B", "S", "H", "KV", "D", "pos"))
        q = draw((B_, H_, D_), bf, QK_STD)
        k, v = draw((B_, S_, KV_, D_), bf, QK_STD), draw((B_, S_, KV_, D_), bf)
        kern = da_ops.decode_attention(q, k, v, pos)
        plain = da_ref.decode_attention_ref(q, k, v, pos)
        torch.cuda.synchronize()
        err, rel = agree(torch, kern, plain, 2e-2, f"decode_attention {name}")
        o = torch.empty_like(q)
        visible = pos + 1
        b_ms, b_by = bound(2 * B_ * visible * KV_ * D_ * 2 + 2 * B_ * H_ * D_ * 2,
                           4 * B_ * H_ * D_ * visible, "bf16")
        qs, ks, vs = q[:, :, None], k[:, :visible].transpose(1, 2), v[:, :visible].transpose(1, 2)
        sdpa = lambda qs=qs, ks=ks, vs=vs: F.scaled_dot_product_attention(qs, ks, vs, enable_gqa=True)  # noqa: E731
        r = dict(ms=kernel_ms(torch, da_ops.launcher(q, k, v, o, pos)), split=da_ops.split_size(B_, KV_, S_),
                 plain_ms=kernel_ms(torch, lambda: da_ref.decode_attention_ref(q, k, v, pos), reps=3, inner=2),
                 library_ms=kernel_ms(torch, sdpa), library_backend=sdpa_backend(torch, sdpa),
                 bound_ms=b_ms, bound_by=b_by, max_abs_err=err, mean_rel_err=rel, shape=[B_, S_, H_, KV_, D_],
                 pos=pos)
        r["bound_share"] = b_ms / r["ms"]
        out["decode_attention"][name] = r
        print(f"phase 2 decode_attention {name}: {json.dumps(r)}")
        del q, k, v, o, kern, plain, qs, ks, vs
    torch.cuda.empty_cache()

    for r in (out["flash_attention"], out["flash_attention"]["window_4096"], out["decode_attention"],
              out["decode_attention"]["ring_4096"]):
        r["bound_share"] = r["bound_ms"] / r["ms"]
    for name in ("flash_attention", "decode_attention"):
        r = out[name]
        extra = r.get("window_4096") or r.get("ring_4096")
        print(f"phase 2 {name} {r['shape']}: kernel {r['ms']:.6f} ms (softcap 0: {r['ms_softcap0']:.6f} ms), "
              f"plain {r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
              f"SDPA softcap 0 {r['library_ms']:.6f} ms ({r['library_backend']}), "
              f"max_abs_err {r['max_abs_err']!r} ({r['mean_rel_err']!r} mean error / mean |plain|)")
        print(f"  second shape: {json.dumps(extra)}")
    for name in FLASH_ROWS:
        print(f"phase 2 flash_attention {name}: {json.dumps(out['flash_attention'][name])}")
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
    zero_counts(counters)
    engine, reqs, stats, wall = serve_once(torch, lm, SEED)
    prompt = torch.as_tensor(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (1, PREFILL["S"])),
                             device=dev)
    t0 = time.perf_counter()
    logits, _ = lm.forward(prompt, last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    pairs = flash_pairs()
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
    check(pairs == {"256x256": cfg.num_layers}, f"phase 4 flash launches by instance {pairs}")

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
    return dict(launches=launches, pairs=pairs, tokens_per_s=tokens / wall, step_ms=step_ms, step_bound_ms=bound_ms,
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
    zero_counts({"flash_attention": fa_ops.flash_attention, "decode_attention": da_ops.decode_attention})
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


# -- phase 7: decentralized P2P scheduling and the scenario packs on the card ----
#
# The benchmarks' generators again through ``repro_torch.sim.bench_inputs``;
# every result held to the reference's committed BENCH_*.json as the
# reference produces it today, and parts 1-2 and one interval of part 3
# also to the port's CPU twin.

P2P_INTERVALS = (30.0, 120.0, 480.0)          # benchmarks/p2p_bench.py's defaults


def p2p_bench_record(S, BI, device, intervals, sites=256, peers=8, jobs=4000, latency=2.0):
    """benchmarks/p2p_bench.py:bench over the port on ``device``: the
    same record (``run_s`` per run on the host clock, ending in a
    synchronize), plus each run's trace for the twin comparison."""
    import torch

    nodes = BI.p2p_grid(sites)
    workload = BI.p2p_workload(sorted(nodes), jobs)
    t0 = time.perf_counter()
    base = S.GridSim(nodes, config=S.SimConfig(policy="diana"), device=device).run(
        copy.deepcopy(workload))
    base_s = time.perf_counter() - t0
    rec = {"bench": "p2p", "sites": sites, "peers": peers, "jobs": len(workload),
           "exchange_latency_s": latency,
           "baseline": {"makespan": round(base.makespan, 1),
                        "avg_turnaround": round(base.avg_turnaround, 1), "run_s": round(base_s, 2)},
           "intervals": []}
    traces = {"baseline": sim_trace(base)}
    for iv in intervals:
        row: dict = {"exchange_interval_s": iv}
        for wire in ("full", "delta"):
            sim = S.P2PGridSim(nodes, config=S.SimConfig(
                num_peers=peers, exchange_interval_s=iv, exchange_latency_s=latency,
                gossip_wire=wire), device=device)
            t0 = time.perf_counter()
            res = sim.run(copy.deepcopy(workload))
            if device != "cpu":
                torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            st = sim.exchange.stats
            row[wire] = {
                "makespan": round(res.makespan, 1),
                "makespan_degradation": round(res.makespan / base.makespan, 4),
                "avg_turnaround": round(res.avg_turnaround, 1),
                "turnaround_degradation": round(res.avg_turnaround / base.avg_turnaround, 4),
                "migrations": res.migrations(), "exchange_rounds": st.rounds,
                "adverts_sent": st.adverts_sent, "bytes_sent": st.bytes_sent,
                "heartbeats_sent": st.heartbeats_sent, "acks_sent": st.acks_sent,
                "full_syncs": st.full_syncs, "run_s": round(run_s, 2),
            }
            traces[(iv, wire)] = (sim_trace(res), st.as_dict())
        row["bytes_reduction"] = round(row["full"]["bytes_sent"] / max(1, row["delta"]["bytes_sent"]), 1)
        row["delta_vs_full_makespan"] = round(row["delta"]["makespan"] / row["full"]["makespan"], 4)
        rec["intervals"].append(row)
    return rec, traces


def without_run_s(rec):
    if isinstance(rec, dict):
        return {k: without_run_s(v) for k, v in rec.items() if k != "run_s"}
    if isinstance(rec, list):
        return [without_run_s(v) for v in rec]
    return rec


def phase_p2p(torch, P, counters: dict) -> dict:
    """Phase 7: the peers' placement API, P2PGridSim and the six scenario
    packs on the card; returns the part times and, under
    ``peer_launches``, the kernel counts of the peer's own select, rank
    and place on the card (``counters`` zeroed just before them)."""
    import repro_torch.scenarios as Sc
    import repro_torch.sim as S
    from repro_torch.core import batch as B
    from repro_torch.scenarios.common import check_all_reconverged
    from repro_torch.sim import bench_inputs as BI

    out: dict = {}

    def report(part: str, t_card: float, t_cpu=None, extra: str = "") -> None:
        out[part] = {"card_s": t_card, "cpu_s": t_cpu}
        twin_s = "not run" if t_cpu is None else f"{t_cpu:.3f} s"
        print(f"phase 7 {part}: card {t_card:.3f} s, CPU twin {twin_s}{extra}")

    # 1. The PeerScheduler API at the bulk bench's 10,000 jobs x 256 sites.
    site_d, link_d, jobs = bench_grid(P, BENCH_JOBS, BENCH_SITES, SEED)

    def api(device):
        times = {}
        # The DianaScheduler twin runs first, so that the counts read
        # below are the peer's own launches.
        d = P.DianaScheduler(copy.deepcopy(site_d), dict(link_d), device=device)
        dsel, drank = d.select_sites_batch(jobs), d.rank_sites_batch(jobs)
        dpl = d.place_batch(copy.deepcopy(jobs))
        peer = P.single_peer(copy.deepcopy(site_d), dict(link_d), device=device)
        if device == "cuda":
            for fn in counters.values():
                fn.launches = 0
        t0 = time.perf_counter()
        sel = peer.select_sites_batch(jobs)
        t1 = time.perf_counter()
        rank = peer.rank_sites_batch(jobs)
        t2 = time.perf_counter()
        placed = copy.deepcopy(jobs)
        pl = peer.place_batch(placed)
        t3 = time.perf_counter()
        if device == "cuda":
            out["peer_launches"] = {name: fn.launches for name, fn in counters.items()}
        times.update(select_s=t1 - t0, rank_s=t2 - t1, place_s=t3 - t2)
        state = [(s.queue_length, s.waiting_work) for s in peer.authoritative.values()]
        check(sel.sites == dsel.sites and sel.costs.tolist() == dsel.costs.tolist(),
              f"peer select != DianaScheduler ({device})")
        check(rank == drank, f"peer rank != DianaScheduler ({device})")
        check(pl.sites == dpl.sites and pl.costs.tolist() == dpl.costs.tolist()
              and state == [(s.queue_length, s.waiting_work) for s in d.sites.values()]
              and [j.site for j in placed] == pl.sites, f"peer place != DianaScheduler ({device})")
        return (sel.sites, sel.costs.tolist(), rank, pl.sites, pl.costs.tolist(), state), times

    (card, times), (cpu, times_cpu), a, b = twin(torch, api)
    check(card == cpu, "peer API at 10k x 256: card != CPU twin")
    sp_h = B.SitePack.from_scheduler(site_d, link_d, device="cpu")
    jp_h = B.JobPack.from_jobs(jobs, device="cpu")
    check(card[0] == [sp_h.names[i] for i in np.argmin(numpy_plane(sp_h, jp_h), axis=1)],
          "peer select != argmin of the independent NumPy plane")
    out["api"] = {"card": times, "cpu": times_cpu}
    peer_launches = out["peer_launches"]
    for name in ("cost_argmin_f64", "cost_matrix_f64"):
        check(peer_launches[name] > 0, f"the peer's select/rank/place never launched {name}")
    report(f"PeerScheduler API at {BENCH_JOBS} x {BENCH_SITES} (select, rank, place; "
           f"single peer == DianaScheduler)", a, b,
           f"; card {json.dumps({k: round(v, 6) for k, v in times.items()})}, "
           f"CPU {json.dumps({k: round(v, 6) for k, v in times_cpu.items()})}, "
           f"the peer's own launches on the card {json.dumps(peer_launches)}")

    # 2. The 1-peer identity and the chaos smoke (benchmarks/p2p_bench.py
    #    smoke/chaos_smoke at 16 sites x 3 peers x 200 jobs, scripts/ci.sh).
    nodes = BI.p2p_grid(16)
    work = BI.p2p_workload(sorted(nodes), 200)

    def smokes(device):
        got = {}
        base = S.GridSim(nodes, config=S.SimConfig(policy="diana"), device=device).run(
            copy.deepcopy(work))
        got["base"] = sim_trace(base)
        for wire in ("full", "delta"):
            one = S.P2PGridSim(nodes, config=S.SimConfig(num_peers=1, exchange_interval_s=60.0,
                                                         gossip_wire=wire), device=device)
            res = one.run(copy.deepcopy(work))
            check([j.exec_site for j in res.jobs] == [j.exec_site for j in base.jobs]
                  and [j.finish for j in res.jobs] == [j.finish for j in base.jobs],
                  f"1-peer P2PGridSim ({wire} wire) != GridSim on {device}")
            got[f"one_{wire}"] = sim_trace(res)
        sim = S.P2PGridSim(nodes, config=S.SimConfig(num_peers=3, exchange_interval_s=120.0,
                                                     exchange_latency_s=2.0), device=device)
        res = sim.run(copy.deepcopy(work))
        check(all(j.finish >= 0 for j in res.jobs), "3-peer run left unfinished jobs")
        got["three"] = (sim_trace(res), sim.exchange.stats.as_dict())
        for wire in ("full", "delta"):
            runs = []
            for tf in (None, S.TransportFaults(seed=7)):
                sim = S.P2PGridSim(nodes, config=S.SimConfig(
                    num_peers=3, exchange_interval_s=60.0, exchange_latency_s=2.0,
                    gossip_wire=wire, transport_faults=tf), device=device)
                runs.append(sim_trace(sim.run(copy.deepcopy(work))))
            check(runs[0] == runs[1], f"zero-rate TransportFaults ({wire}) != no transport on {device}")
        sim = S.P2PGridSim(nodes, config=S.SimConfig(
            num_peers=3, exchange_interval_s=60.0, exchange_latency_s=2.0,
            transport_faults=S.TransportFaults(seed=1, loss=0.10, duplicate=0.02,
                                               reorder_jitter_s=3.0)), device=device)
        res = sim.run(copy.deepcopy(work))
        st = sim.exchange.stats
        check(all(j.finish >= 0 for j in res.jobs), "lossy run left unfinished jobs")
        check(st.dropped > 0 and st.retransmits > 0, "lossy run: no drops or retransmits")
        rounds = check_all_reconverged(sim, res)
        got["chaos"] = (sim_trace(res), st.as_dict(), rounds)
        return got

    card, cpu, a, b = twin(torch, smokes)
    check(card == cpu, "p2p smoke / chaos smoke: card != CPU twin (whole traces)")
    ch = card["chaos"][1]
    report("p2p smoke + chaos smoke, 16 sites x 3 peers x 200 jobs", a, b,
           f"; 1-peer == GridSim on both wires, zero-rate transport == none, lossy: dropped "
           f"{ch['dropped']}, retransmits {ch['retransmits']}, reconverged in {card['chaos'][2]} rounds")

    # 3. BENCH_p2p.json's configuration at full size: 256 sites x 8 peers x
    #    4,000 jobs, latency 2 s, both wires at each interval.
    expect = bench_json("BENCH_p2p.json")
    t0 = time.perf_counter()
    rec, traces = p2p_bench_record(S, BI, "cuda", P2P_INTERVALS)
    t_card = time.perf_counter() - t0
    # The committed file predates wire v2 (a 4-byte pair sequence number
    # and a 4-byte CRC32 in every packet, core/p2p.py _HEADER/_CRC): the
    # delta wire's bytes_sent is now larger by 8 bytes an ack'd packet.
    want = json.loads(json.dumps(expect))
    for row in want["intervals"]:
        row["delta"]["bytes_sent"] += 8 * row["delta"]["acks_sent"]
        row["bytes_reduction"] = round(row["full"]["bytes_sent"] / row["delta"]["bytes_sent"], 1)
    check(without_run_s(rec) == without_run_s(want),
          f"BENCH_p2p configuration: {json.dumps(without_run_s(rec))} != {json.dumps(without_run_s(want))}")
    t0 = time.perf_counter()
    rec_cpu, traces_cpu = p2p_bench_record(S, BI, "cpu", P2P_INTERVALS[:1])
    t_cpu = time.perf_counter() - t0
    check(without_run_s(rec_cpu["intervals"]) == without_run_s(rec["intervals"][:1]),
          "BENCH_p2p 30 s interval: card != CPU twin")
    check(all(traces[k] == traces_cpu[k] for k in traces_cpu), "BENCH_p2p 30 s interval: traces card != CPU twin")
    out["p2p_bench"] = {"card": {str(r["exchange_interval_s"]): {w: r[w]["run_s"] for w in ("full", "delta")}
                                 for r in rec["intervals"]} | {"baseline": rec["baseline"]["run_s"]},
                        "cpu": {"30.0": {w: rec_cpu["intervals"][0][w]["run_s"] for w in ("full", "delta")},
                                "baseline": rec_cpu["baseline"]["run_s"]}}
    report("BENCH_p2p configuration, 256 sites x 8 peers x 4,000 jobs, intervals 30/120/480 s, both wires "
           "(CPU twin: the baseline and the 30 s interval)", t_card, t_cpu,
           f"; baseline makespan {rec['baseline']['makespan']}, turnaround {rec['baseline']['avg_turnaround']}; "
           f"delta bytes_sent {[r['delta']['bytes_sent'] for r in rec['intervals']]}; "
           f"run_s card {json.dumps(out['p2p_bench']['card'])}, CPU {json.dumps(out['p2p_bench']['cpu'])}")

    # 4. The six scenario packs at --scale bench, seed 0, on the card.
    times = {}
    for name in Sc.SCENARIOS:
        t0 = time.perf_counter()
        _, _, _, metrics = Sc.run_scenario(name, scale="bench", seed=0, device="cuda")
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        committed = bench_json(f"BENCH_{name}.json")["metrics"]
        check(set(metrics) == set(committed) and all(repr(metrics[k]) == repr(v) for k, v in committed.items()),
              f"scenario {name}: {metrics} != BENCH_{name}.json {committed}")
        keys = [k for k in metrics if "ratio" in k or "reconverge" in k or k in ("sync_escalations", "makespan")]
        print(f"phase 7 scenario {name} (bench scale): {times[name]:.3f} s, every metric = BENCH_{name}.json; "
              + ", ".join(f"{k} {metrics[k]!r}" for k in keys))
    out["scenarios"] = times
    report("six scenario packs at bench scale", sum(times.values()))

    # 5. The P2P halves of the streaming and hier benches.
    expect = bench_json("BENCH_streaming.json")["equivalence"]
    snodes = BI.streaming_grid(expect["sites"])
    w = BI.streaming_workload(sorted(snodes), expect["jobs"])
    cfg = dict(migration_interval_s=60.0, congestion_window_s=120.0, num_peers=4,
               exchange_interval_s=45.0, exchange_latency_s=2.0)
    t0 = time.perf_counter()
    ev, hz = (S.P2PGridSim(snodes, config=S.SimConfig(horizon=h, **cfg), device="cuda").run(
        copy.deepcopy(w)) for h in (False, True))
    t_stream = time.perf_counter() - t0
    placements = lambda r: sorted((j.user, j.arrival, j.exec_site, j.start, j.finish, j.migrated)  # noqa: E731
                                  for j in r.jobs)
    check(placements(ev) == placements(hz), "P2P streaming: horizon loop != per-event loop")
    check(hz.migrations() == expect["p2p"]["migrations"],
          f"P2P streaming: {hz.migrations()} migrations != {expect['p2p']['migrations']}")
    report(f"P2PGridSim horizon == per-event, {expect['sites']} sites x {expect['jobs']} jobs (2 runs)", t_stream,
           extra=f", {hz.migrations()} migrations")
    spec, links, topo, jobs_h = BI.hier_sim_grid(256, 16, 0)
    t0 = time.perf_counter()
    tr = {}
    for placement in ("flat", "hier"):
        c = S.SimConfig(policy="diana", placement=placement, topology=topo, migration_interval_s=30.0,
                        congestion_window_s=120.0, num_peers=8, exchange_interval_s=60.0)
        res = S.P2PGridSim(dict(spec), links=dict(links), config=c, device="cuda").run(copy.deepcopy(jobs_h))
        tr[placement] = [(j.user, j.arrival, j.exec_site, j.finish, j.migrated) for j in res.jobs]
    t_hier = time.perf_counter() - t0
    check(tr["flat"] == tr["hier"], "P2PGridSim hier != flat at 256 sites / 16 tiers")
    report("P2PGridSim hier == flat at 256 sites / 16 tiers, 8 peers (2 runs)", t_hier,
           extra=f", {sum(m for *_, m in tr['hier'])} migrations")
    # The bench's grid migrates nothing at 256 sites: the same generator at
    # 48 sites / 8 tiers with its first 600 jobs does, so the
    # staleness-gated migration under placement="hier" runs on the card,
    # held to the CPU twin's trace.
    spec, links, topo, jobs_h = BI.hier_sim_grid(48, 8, 9)
    jobs_h = jobs_h[:600]

    def hier_migrating(device):
        c = S.SimConfig(policy="diana", placement="hier", topology=topo, migration_interval_s=30.0,
                        congestion_window_s=120.0, num_peers=8, exchange_interval_s=60.0)
        sim = S.P2PGridSim(dict(spec), links=dict(links), config=c, device=device)
        return sim_trace(sim.run(copy.deepcopy(jobs_h))), sim.exchange.stats.as_dict()

    card, cpu, a, b = twin(torch, hier_migrating)
    moves = sum(m for *_, m in card[0])
    check(card == cpu, "P2PGridSim hier at 48 sites / 8 tiers: card != CPU twin (whole traces)")
    check(moves > 0, "P2PGridSim hier at 48 sites / 8 tiers made no migration")
    report("P2PGridSim placement=hier with migration, 48 sites / 8 tiers x 600 jobs, 8 peers", a, b,
           extra=f", {moves} migrations, trace == CPU twin")
    return out


# -- phase 8: the pod runtime and the hybrid, ssm, vlm and encdec families ------

# The reference's LM.init trees, counted (tests/test_torch_families.py
# holds the port's full-width models to the same counts).
FAMILY_PARAMS = {"recurrentgemma-2b": 2_894_481_920, "mamba2-780m": 780_382_464,
                 "llama-3.2-vision-11b": 9_775_157_256, "whisper-base": 83_250_182}
VISION_PROMPT = 2048          # Sq > Sk = 1,601 image tokens on every cross layer
HYBRID_PREFILL = 8192         # 8 local layers at window 2048
SSM_PREFILL = 4096            # 16 chunks of 256
WHISPER_TOKENS = 448          # the decoder's max target length (configs/shapes.py)
CROSS_GATE = 0.5              # tanh gates of the cross layers (the reference initialises 0)


def attn_counters():
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return {"flash_attention": fa_ops.flash_attention, "decode_attention": da_ops.decode_attention}


def train_counters():
    """The attention counters and the flash backward's (phase 10)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return dict(attn_counters(), flash_attention_bwd=fa_ops.flash_attention_bwd)


def zero_counts(counters: dict) -> None:
    """Every counter of ``counters`` to 0, the flash wrapper's per-instance
    counts (``by_pair``) with its total."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "by_pair"):
            fn.by_pair = {}


def flash_pairs() -> dict:
    """The flash wrapper's launches since its counts were last zeroed, by
    instance: {"DxDv": count}."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    return {f"{d}x{dv}": n for (d, dv), n in sorted(fa_ops.flash_attention.by_pair.items())}


def pair_sum(pairs: dict, mla: bool) -> int:
    """Launches in ``pairs`` of the (192, 128) instance (``mla``) or of
    every instance with v as wide as q and k."""
    return sum(n for key, n in pairs.items() if (key == MLA_PAIR) == mla)


def counted(torch, fn, pairs: dict | None = None, counters: dict | None = None):
    """``fn()`` with the attention kernels' counters (or ``counters``) set
    to 0 just before and read just after: (result, wall seconds ending in
    a synchronize, launches); ``pairs``, when given, receives the flash
    launches by instance. The counts held before are added back after, so
    that the counts around the whole phase keep every launch inside it."""
    counters = counters or attn_counters()
    flash = counters["flash_attention"]
    held = {n: (c.launches, dict(getattr(c, "by_pair", {}))) for n, c in counters.items()}
    zero_counts(counters)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    if pairs is not None:
        pairs.update({f"{d}x{dv}": n for (d, dv), n in sorted(flash.by_pair.items())})
    for n, c in counters.items():
        c.launches += held[n][0]
        for key, k in held[n][1].items():
            c.by_pair[key] = c.by_pair.get(key, 0) + k
    return res, wall, launches


def build_family(torch, arch: str, dtype: str = "bfloat16", **overrides):
    """A family at its published width and depth on the card, weights from
    a seeded generator; cross layers' tanh gates set to CROSS_GATE."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config(arch).replace(param_dtype=dtype, compute_dtype=dtype, **overrides)
    lm = LM(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(SEED))
    for blocks in (getattr(lm, "cross_blocks", ()), getattr(lm, "dec_cross", ())):
        for b in blocks:
            b.xgate.fill_(CROSS_GATE)
    return cfg, lm


def family_inputs(torch, cfg, B: int):
    """Seeded image or audio embeddings (B, N, d) on the card, or none."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    if cfg.family == "vlm":
        n = cfg.num_image_tokens
    elif cfg.family == "encdec":
        n = cfg.encoder_seq_len
    else:
        return {}
    x = (torch.randn((B, n, cfg.d_model), generator=gen, device="cuda") * 0.1).to(cfg.cdtype)
    return {"image_embeds" if cfg.family == "vlm" else "audio_embeds": x}


def prefill_equals_decode(torch, arch: str, T: int = 16, max_len: int = 24, **overrides) -> dict:
    """The reference's own oracle at full width in float32: LM.forward's
    logits (flash kernel) against a decode_step loop (decode kernel),
    B 2, ``T`` tokens, rtol = atol = 2e-3."""
    from repro_torch.models import decode

    cfg, lm = build_family(torch, arch, "float32", **overrides)
    B = 2
    toks = torch.as_tensor(np.random.default_rng(SEED + 2).integers(0, cfg.vocab_size, (B, T)), device="cuda")
    kw = family_inputs(torch, cfg, B)

    def run():
        full, _ = lm.forward(toks, **kw)
        cache = decode.init_cache(lm, B, max_len, **kw)
        steps = [decode.decode_step(lm, toks[:, t : t + 1], cache, t)[0][:, 0] for t in range(T)]
        return full, torch.stack(steps, dim=1)

    (full, dec), wall, launches = counted(torch, run)
    err = float((dec - full).abs().max())
    check(bool(torch.isfinite(full).all()), f"{arch} f32 logits not finite")
    check(within(torch, dec, full, 2e-3), f"{arch}: f32 prefill logits != decode logits within 2e-3 ({err!r})")
    del lm
    return dict(max_abs_diff=err, max_logit=float(full.abs().max()), wall_s=wall, launches=launches,
                tokens=T, overrides=overrides)


def decode_step_profile(torch, lm, tok, cache, pos: int, arch: str, weight_bytes: float | None = None) -> dict:
    """Median of 20 decode steps (host clock around a synchronize) beside
    the weight-streaming bound (``weight_bytes``, by default every
    parameter in bf16), and a profiled step's device time."""
    from repro_torch.models import decode

    times = []
    for _ in range(21):
        t0 = time.perf_counter()
        decode.decode_step(lm, tok, cache, pos)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times[1:]) * 1e3
    bound_ms = (weight_bytes or FAMILY_PARAMS[arch] * 2) / HBM_BYTES_PER_S * 1e3
    trace = step_trace(torch, lambda: decode.decode_step(lm, tok, cache, pos), steps=3)
    return dict(step_ms=step_ms, bound_ms=bound_ms, kernels=trace["kernels"], busy_ms=trace["busy_ms"],
                device_share=trace["busy_ms"] / step_ms if trace["busy_ms"] else None, top=trace["top"])


def serve_family(torch, arch: str) -> dict:
    """A recurrent family at full width in bf16: launch/serve.py's 16
    requests through ServingEngine twice with the same seed (identical
    tokens), one long prefill through LM.forward, and a decode step's
    median time and device share."""
    cfg, lm = build_family(torch, arch)
    n_params = sum(p.numel() for p in lm.parameters())
    check(n_params == FAMILY_PARAMS[arch], f"{arch} has {n_params} parameters")
    (engine, reqs, stats, _), wall, launches = counted(torch, lambda: serve_once(torch, lm, SEED))
    tokens = sum(len(r.generated) for r in reqs)
    check(stats.served == 16 and stats.batches == 4 and stats.decode_steps == 28 and tokens == 128,
          f"{arch} serving stats {stats}, {tokens} tokens")
    check(all(r.done and len(r.generated) == 8 and all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in reqs), f"{arch}: a request did not get 8 tokens in the vocabulary")
    n_attn = cfg.num_layers // 3 if cfg.family == "hybrid" else 0
    check(launches == {"flash_attention": 0, "decode_attention": 4 * (8 + 7) * n_attn},
          f"{arch} serving launches {launches}")
    first = [list(r.generated) for r in reqs]
    lm.init(torch.Generator(device="cuda").manual_seed(SEED))
    _, reqs2, _, wall2 = serve_once(torch, lm, SEED)
    check([r.generated for r in reqs2] == first, f"{arch}: a second run with the same seed gave other tokens")
    S = HYBRID_PREFILL if cfg.family == "hybrid" else SSM_PREFILL
    prompt = torch.as_tensor(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (1, S)), device="cuda")
    (logits, _), prefill_s, prefill_launches = counted(torch, lambda: lm.forward(prompt, last_only=True))
    check(tuple(logits.shape) == (1, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
          f"{arch} prefill logits not finite of shape (1, 1, V)")
    check(prefill_launches == {"flash_attention": n_attn, "decode_attention": 0},
          f"{arch} prefill launches {prefill_launches}")
    tok = torch.zeros((SERVE["slots"], 1), dtype=torch.int64, device="cuda")
    prof = decode_step_profile(torch, lm, tok, engine.cache, 32, arch)
    del engine, lm, logits
    return dict(params=n_params, serve_s=wall, serve_s_second=wall2, tokens_per_s=tokens / wall,
                serve_launches=launches, prefill_tokens=S, prefill_s=prefill_s,
                prefill_launches=prefill_launches, first_request=first[0], **prof)


def vision_family(torch) -> dict:
    """llama-3.2-vision-11b at full width in bf16: a 2,048-token prompt
    over 1,601 image tokens through LM.forward, then init_cache over the
    image and 32 decode steps (B 1)."""
    from repro_torch.models import decode

    arch = "llama-3.2-vision-11b"
    cfg, lm = build_family(torch, arch)
    n_params = sum(p.numel() for p in lm.parameters())
    check(n_params == FAMILY_PARAMS[arch], f"{arch} has {n_params} parameters")
    kw = family_inputs(torch, cfg, 1)
    n_cross = cfg.num_layers // cfg.cross_attn_every
    prompt = torch.as_tensor(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (1, VISION_PROMPT)),
                             device="cuda")
    (logits, _), prefill_s, prefill_launches = counted(torch, lambda: lm.forward(prompt, last_only=True, **kw))
    check(tuple(logits.shape) == (1, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
          f"{arch} prefill logits not finite of shape (1, 1, V)")
    check(prefill_launches == {"flash_attention": cfg.num_layers, "decode_attention": 0},
          f"{arch} prefill launches {prefill_launches}")

    def run_decode():
        cache = decode.init_cache(lm, 1, 64, **kw)
        tok, outs = prompt[:, :1], []
        for t in range(32):
            lt, cache = decode.decode_step(lm, tok, cache, t)
            tok = lt[:, 0].argmax(dim=-1, keepdim=True)
            outs.append(lt)
        return cache, torch.cat(outs, dim=1)

    (cache, dec), decode_s, decode_launches = counted(torch, run_decode)
    check(bool(torch.isfinite(dec).all()), f"{arch} decode logits not finite")
    check(tuple(cache["cross_k"].shape) == (n_cross, 1, cfg.num_image_tokens, cfg.num_kv_heads, cfg.head_dim_),
          f"{arch} cross cache {tuple(cache['cross_k'].shape)}")
    check(decode_launches == {"flash_attention": 0, "decode_attention": 32 * cfg.num_layers},
          f"{arch} decode launches {decode_launches}")
    prof = decode_step_profile(torch, lm, prompt[:, :1], cache, 32, arch)
    del lm, cache, logits, dec
    return dict(params=n_params, prefill_tokens=VISION_PROMPT, prefill_s=prefill_s,
                prefill_launches=prefill_launches, decode_steps=32, decode_s=decode_s,
                decode_launches=decode_launches, **prof)


def whisper_family(torch) -> dict:
    """whisper-base at full width in bf16: an encoder pass over 1,500
    frames, a 448-token decoder forward, init_cache over the frames and
    greedy decode to 448 (B 1)."""
    from repro_torch.models import decode

    arch = "whisper-base"
    cfg, lm = build_family(torch, arch)
    n_params = sum(p.numel() for p in lm.parameters())
    check(n_params == FAMILY_PARAMS[arch], f"{arch} has {n_params} parameters")
    kw = family_inputs(torch, cfg, 1)
    L, E = cfg.num_layers, cfg.num_encoder_layers
    enc, enc_s, enc_launches = counted(torch, lambda: lm.encode(kw["audio_embeds"]))
    check(tuple(enc.shape) == (1, cfg.encoder_seq_len, cfg.d_model) and bool(torch.isfinite(enc).all()),
          f"{arch} encoder output not finite of shape (1, 1500, d)")
    check(enc_launches == {"flash_attention": E, "decode_attention": 0}, f"{arch} encoder launches {enc_launches}")
    toks = torch.as_tensor(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (1, WHISPER_TOKENS)),
                           device="cuda")
    (logits, _), fwd_s, fwd_launches = counted(torch, lambda: lm.forward(toks, **kw))
    check(tuple(logits.shape) == (1, WHISPER_TOKENS, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
          f"{arch} decoder logits not finite of shape (1, 448, V)")
    check(fwd_launches == {"flash_attention": E + 2 * L, "decode_attention": 0},
          f"{arch} forward launches {fwd_launches}")

    def run_decode():
        cache = decode.init_cache(lm, 1, WHISPER_TOKENS, **kw)
        tok, n = toks[:, :1], 0
        for t in range(WHISPER_TOKENS):
            lt, cache = decode.decode_step(lm, tok, cache, t)
            tok = lt[:, 0].argmax(dim=-1, keepdim=True)
            n += 1
        return cache, lt, n

    (cache, last, n), decode_s, decode_launches = counted(torch, run_decode)
    check(n == WHISPER_TOKENS and bool(torch.isfinite(last).all()), f"{arch} decode to 448 not finite")
    check(decode_launches == {"flash_attention": E, "decode_attention": WHISPER_TOKENS * 2 * L},
          f"{arch} decode launches {decode_launches}")
    prof = decode_step_profile(torch, lm, toks[:, :1], cache, WHISPER_TOKENS - 1, arch)
    del lm, cache, logits, enc
    return dict(params=n_params, encoder_s=enc_s, encoder_launches=enc_launches, forward_tokens=WHISPER_TOKENS,
                forward_s=fwd_s, forward_launches=fwd_launches, decode_steps=n, decode_s=decode_s,
                decode_launches=decode_launches, **prof)


def phase_families(torch) -> dict:
    """Phase 8: each family at its published width and depth, freed before
    the next one starts, and the pod runtime's example scenario."""
    import repro_torch.grid as G
    from repro_torch.grid.example import PINNED, run_example

    out = {}

    def part(name, fn):
        t0 = time.perf_counter()
        r = fn()
        gc.collect()
        torch.cuda.empty_cache()
        r["part_s"] = time.perf_counter() - t0
        out[name] = r
        print(f"phase 8 {name}: {json.dumps(r)}")

    part("recurrentgemma-2b serving (bf16)", lambda: serve_family(torch, "recurrentgemma-2b"))
    part("recurrentgemma-2b f32 prefill == decode",
         lambda: prefill_equals_decode(torch, "recurrentgemma-2b"))
    # cut: local_window 16 so that the decode ring wraps within 24 tokens
    part("recurrentgemma-2b f32 prefill == decode, local_window cut to 16",
         lambda: prefill_equals_decode(torch, "recurrentgemma-2b", T=24, max_len=32, local_window=16))
    part("mamba2-780m serving (bf16)", lambda: serve_family(torch, "mamba2-780m"))
    part("mamba2-780m f32 prefill == decode", lambda: prefill_equals_decode(torch, "mamba2-780m"))
    print("phase 8 mamba2-780m: this path launches no kernel (the SSD scan and the recurrence are "
          "stock PyTorch operations; the reference has no Pallas kernel for them)")
    part("llama-3.2-vision-11b (bf16)", lambda: vision_family(torch))
    part("llama-3.2-vision-11b f32 prefill == decode",
         lambda: prefill_equals_decode(torch, "llama-3.2-vision-11b"))
    part("whisper-base (bf16)", lambda: whisper_family(torch))
    part("whisper-base f32 prefill == decode", lambda: prefill_equals_decode(torch, "whisper-base"))

    t0 = time.perf_counter()
    got = run_example(G)
    check(got == PINNED, f"grid example scenario {got} != the reference's pinned decisions {PINNED}")
    out["grid"] = {"wall_s": time.perf_counter() - t0, "moved": len(got["moved"]), "orphans": len(got["orphans"])}
    print(f"phase 8 grid: examples/grid_schedule.py's scenario through repro_torch.grid == the reference's "
          f"pinned decisions (bulk split {json.dumps({p: len(v) for p, v in got['bulk'].items()})}, prod on "
          f"{got['prod']}, {len(got['moved'])} moved, {len(got['orphans'])} orphans re-placed) in "
          f"{out['grid']['wall_s']:.6f} s")
    return out


# -- phase 9: the moe family (MLA attention, routed experts) ----------------------

# Both deepseek configurations at their published width, depth cut so that
# the model fits one 80 GB card; the reference's LM.init trees at these
# depths, counted. deepseek-v2 in bf16: 6 of 60 layers (1 dense + 5 MoE,
# 42.5 GB); in float32: 3 layers (1 dense + 2 MoE, 37.3 GB); deepseek-v3
# in bf16: 4 of 61 layers (3 dense + 1 MoE, 30.2 GB).
MOE_CUTS = {"deepseek-v2-236b": dict(num_layers=6), "deepseek-v2-236b f32": dict(num_layers=3),
            "deepseek-v3-671b": dict(num_layers=4)}
MOE_PARAMS = {"deepseek-v2-236b": 21_247_144_960, "deepseek-v2-236b f32": 9_330_795_520,
              "deepseek-v3-671b": 15_111_101_696}
MOE_PREFILL = {"deepseek-v2-236b": 4096, "deepseek-v3-671b": 1024}
DROPLESS = 64.0       # the f32 oracle's capacity_factor (tests/models/test_smoke_archs.py:87-90)
MLA_PAIR = "192x128"  # the flash instance of MLA's prefill, DQK 192 / DV 128, as flash_pairs() names it


def moe_cut(cfg) -> str:
    from repro_torch.configs import get_config

    return (f"depth cut to {cfg.num_layers} layers ({cfg.first_k_dense} dense + "
            f"{cfg.num_layers - cfg.first_k_dense} MoE) of the published {get_config(cfg.name).num_layers}")


def expert_hits(torch, fn) -> list:
    """``fn()`` with the router spied on: the number of distinct routed
    experts each MoE layer's routing picked, in call order."""
    from repro_torch.models import moe

    hits, real = [], moe._route

    def spy(params, xt, cfg):
        gates, idx, probs = real(params, xt, cfg)
        hits.append(int(idx.unique().numel()))
        return gates, idx, probs

    moe._route = spy
    try:
        fn()
    finally:
        moe._route = real
    return hits


def moe_serving(torch) -> dict:
    """deepseek-v2-236b at full width in bf16, depth cut to 6 layers:
    launch/serve.py's 16 requests through ServingEngine twice with the same
    seed (identical tokens), a 4,096-token prefill through LM.forward, and
    a decode step's median time beside two weight-streaming bounds and its
    device share."""
    arch = "deepseek-v2-236b"
    cfg, lm = build_family(torch, arch, **MOE_CUTS[arch])
    n_params = sum(p.numel() for p in lm.parameters())
    check(n_params == MOE_PARAMS[arch], f"{arch} (6 layers) has {n_params} parameters")
    print(f"phase 9 {arch}: {moe_cut(cfg)}, d {cfg.d_model}, {cfg.num_heads} heads, {cfg.num_experts} experts "
          f"top-{cfg.top_k} + {cfg.num_shared_experts} shared, {n_params} parameters ({n_params * 2 / 1e9:.2f} GB bf16)")
    (engine, reqs, stats, _), wall, launches = counted(torch, lambda: serve_once(torch, lm, SEED))
    tokens = sum(len(r.generated) for r in reqs)
    check(stats.served == 16 and stats.batches == 4 and stats.decode_steps == 28 and tokens == 128,
          f"{arch} serving stats {stats}, {tokens} tokens")
    check(all(r.done and len(r.generated) == 8 and all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in reqs), f"{arch}: a request did not get 8 tokens in the vocabulary")
    check(launches == {"flash_attention": 0, "decode_attention": 0}, f"{arch} serving launches {launches}")
    first = [list(r.generated) for r in reqs]
    lm.init(torch.Generator(device="cuda").manual_seed(SEED))
    _, reqs2, _, wall2 = serve_once(torch, lm, SEED)
    check([r.generated for r in reqs2] == first, f"{arch}: a second run with the same seed gave other tokens")
    S = MOE_PREFILL[arch]
    prompt = torch.as_tensor(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (1, S)), device="cuda")
    prefill_pairs: dict = {}
    (logits, aux), prefill_s, prefill_launches = counted(torch, lambda: lm.forward(prompt, last_only=True),
                                                         prefill_pairs)
    check(tuple(logits.shape) == (1, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all()),
          f"{arch} prefill logits not finite of shape (1, 1, V)")
    check(bool(torch.isfinite(aux)) and float(aux) > 0, f"{arch} prefill aux loss {float(aux)}")
    check(prefill_launches == {"flash_attention": cfg.num_layers, "decode_attention": 0}
          and prefill_pairs == {MLA_PAIR: cfg.num_layers},
          f"{arch} prefill launches {prefill_launches}, by instance {prefill_pairs}")
    del logits
    # Bounds of one decode step (4 slots at pos 32): (a) every weight but
    # the embedding table (4 rows of it are read), as the dense dispatch
    # reads every expert of every layer; (b) the same with only the routed
    # experts this step's routing hit.
    tok = torch.zeros((SERVE["slots"], 1), dtype=torch.int64, device="cuda")
    from repro_torch.models import decode

    hits = expert_hits(torch, lambda: decode.decode_step(lm, tok, engine.cache, 32))
    expert_bytes = 3 * cfg.d_model * cfg.moe_d_ff * 2
    bytes_a = (n_params - cfg.padded_vocab * cfg.d_model) * 2
    bytes_b = bytes_a - sum(cfg.num_experts - h for h in hits) * expert_bytes
    prof = decode_step_profile(torch, lm, tok, engine.cache, 32, arch, weight_bytes=bytes_a)
    prof.update(bound_hit_ms=bytes_b / HBM_BYTES_PER_S * 1e3, bytes_all=bytes_a, bytes_hit=bytes_b,
                experts_hit=hits)
    print(f"phase 9 {arch} decode step (4 slots, pos 32, {moe_cut(cfg)}): median {prof['step_ms']:.6f} ms of 20; "
          f"bound (a) every expert {prof['bound_ms']:.6f} ms ({bytes_a / 1e9:.3f} GB / 3.35 TB/s), (b) the experts "
          f"hit {prof['bound_hit_ms']:.6f} ms ({bytes_b / 1e9:.3f} GB; experts hit per layer {hits} of "
          f"{cfg.num_experts}); {prof['kernels']:.1f} CUDA kernels and {prof['busy_ms']:.6f} ms of device time a "
          f"step (share {prof['device_share']}); top kernels {json.dumps(prof['top'])}")
    del engine, lm
    return dict(params=n_params, cuts=moe_cut(cfg), serve_s=wall, serve_s_second=wall2,
                tokens_per_s=tokens / wall, serve_launches=launches, prefill_tokens=S, prefill_s=prefill_s,
                prefill_launches=prefill_launches, prefill_pairs=prefill_pairs, prefill_aux=float(aux),
                first_request=first[0], **prof)


def moe_oracle(torch) -> dict:
    """deepseek-v2-236b at full width in float32, depth cut to 3 layers and
    capacity_factor to dropless: LM.forward (flash (192, 128) in f32)
    against a decode_step loop (absorbed MLA decode), B 2, 16 tokens."""
    arch = "deepseek-v2-236b"
    r = prefill_equals_decode(torch, arch, capacity_factor=DROPLESS, **MOE_CUTS[arch + " f32"])
    check(r["launches"] == {"flash_attention": 3, "decode_attention": 0}, f"{arch} f32 launches {r['launches']}")
    r["cuts"] = f"3 layers (1 dense + 2 MoE) of 60, capacity_factor {DROPLESS} (dropless)"
    return r


def moe_v3(torch) -> dict:
    """deepseek-v3-671b at full width in bf16 (sigmoid router with
    router_bias), depth cut to 4 layers: a 1,024-token prefill and 16
    greedy decode steps from a fresh cache, twice from the same seed."""
    from repro_torch.models import decode

    arch = "deepseek-v3-671b"
    cfg, lm = build_family(torch, arch, **MOE_CUTS[arch])
    n_params = sum(p.numel() for p in lm.parameters())
    check(n_params == MOE_PARAMS[arch], f"{arch} (4 layers) has {n_params} parameters")
    S = MOE_PREFILL[arch]
    prompt = torch.as_tensor(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (1, S)), device="cuda")

    def run():
        logits, _ = lm.forward(prompt, last_only=True)
        cache = decode.init_cache(lm, 1, 64)
        tok, toks, outs = prompt[:, :1], [], []
        for t in range(16):
            lt, cache = decode.decode_step(lm, tok, cache, t)
            tok = lt[:, 0].argmax(dim=-1, keepdim=True)
            toks.append(int(tok))
            outs.append(lt)
        return logits, torch.cat(outs, dim=1), toks

    (logits, dec, toks), wall, launches = counted(torch, run)
    check(tuple(logits.shape) == (1, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(dec).all()), f"{arch} logits not finite")
    check(launches == {"flash_attention": cfg.num_layers, "decode_attention": 0}, f"{arch} launches {launches}")
    lm.init(torch.Generator(device="cuda").manual_seed(SEED))
    (logits2, dec2, toks2), wall2, _ = counted(torch, run)
    check(toks2 == toks, f"{arch}: a second run with the same seed gave other tokens")
    diff = max(float((logits2 - logits).abs().max()), float((dec2 - dec).abs().max()))
    print(f"phase 9 {arch} ({moe_cut(cfg)}, {n_params} parameters): prefill {S} + 16 decode steps {wall:.6f} s, "
          f"again {wall2:.6f} s, same tokens {toks}; max |logit difference| between the runs {diff!r}")
    del lm
    return dict(params=n_params, cuts=moe_cut(cfg), prefill_tokens=S, wall_s=wall, wall_s_second=wall2,
                launches=launches, tokens=toks, max_run_diff=diff)


def phase_moe(torch) -> dict:
    """Phase 9: deepseek-v2-236b in bf16 (served, prefilled, a decode step
    profiled) and in float32 (prefill ≡ decode), then deepseek-v3-671b,
    each at full width with its depth cut, freed before the next."""
    out = {}
    for name, fn in (("deepseek-v2-236b (bf16)", moe_serving),
                     ("deepseek-v2-236b f32 prefill == decode", moe_oracle),
                     ("deepseek-v3-671b (bf16)", moe_v3)):
        t0 = time.perf_counter()
        r = fn(torch)
        gc.collect()
        torch.cuda.empty_cache()
        r["part_s"] = time.perf_counter() - t0
        out[name] = r
        print(f"phase 9 {name}: {json.dumps(r)}")
    return out


# -- phase 2c / 10: flash attention's backward kernel and training -----------------

# The backward kernel (csrc/flash_attention_bwd.cu) against its plain
# version, before phase 10 relies on it: every (D, Dv) instance in both
# types, causal and not, window edges inside a 32-row tile, soft-cap 0
# and 50, GQA rep 1, 2, 3, 10 and 16, ragged lengths 77, 200 and 1,000,
# Sq < Sk non-causal; k and v always two column ranges of one buffer (as
# MLA's), q and k drawn with a standard deviation of 1.5.
BWD_CASES = [
    # (B, Sq, Sk, H, KV, D, Dv, causal, window, softcap)
    (1, 77, 77, 4, 2, 32, 32, True, 0, 0.0),
    (2, 200, 200, 6, 2, 64, 64, True, 50, 50.0),
    (1, 77, 200, 8, 8, 64, 64, False, 0, 50.0),
    (1, 1000, 1000, 10, 1, 256, 256, True, 333, 50.0),
    (1, 200, 200, 16, 1, 256, 256, False, 0, 0.0),
    (1, 77, 200, 16, 1, 128, 128, False, 0, 0.0),
    (2, 130, 130, 3, 1, 128, 128, True, 45, 30.0),
    (1, 1000, 1000, 16, 8, 256, 256, True, 0, 50.0),
    (1, 200, 200, 8, 8, 192, 128, True, 0, 0.0),
    (1, 1000, 1000, 16, 16, 192, 128, False, 0, 0.0),
    (1, 77, 200, 4, 4, 192, 128, False, 0, 0.0),
    (2, 64, 64, 2, 2, 32, 32, True, 2, 50.0),
]
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of max |plain|, for each of dq, dk, dv
# gemma2-9b's training layer: B 1, S 8,192 (max_seq_len), H 16 / KV 8,
# D 256, bf16, soft-cap 50; global (causal) and local (window 4,096).
BWD_ROW = dict(B=1, S=8192, H=16, KV=8, D=256, cap=50.0)


def bwd_ops(H: int, D: int, Dv: int, pairs: int) -> float:
    """Operations of the backward: five products a (query, key) pair and
    head (S, dP, dV, dQ, dK), 2·(3·D + 2·Dv)."""
    return 2 * (3 * D + 2 * Dv) * H * pairs


def grads_agree(torch, got, want, name: str, what: str) -> tuple[float, float]:
    """Each of dq, dk, dv within BWD_TOL[name] of max |plain|, and in bf16
    the mean error under 1% of the mean |plain|; returns the largest
    (max_abs_err, max |diff| / max |plain|)."""
    worst, worst_rel = 0.0, 0.0
    for g, a, b in zip(("dq", "dk", "dv"), got, want):
        err = max_abs_err(torch, a, b)
        big = float(b.float().abs().max())
        check(err <= BWD_TOL[name] * big, f"{what} {g}: max |diff| {err!r} > {BWD_TOL[name]} · {big!r}")
        if name == "bfloat16":
            rel = float((a.float() - b.float()).abs().mean() / b.float().abs().mean())
            check(rel < REL_BOUND, f"{what} {g}: mean error {rel!r} of mean |plain|")
        worst, worst_rel = max(worst, err), max(worst_rel, err / big)
    return worst, worst_rel


def phase_flash_backward(torch):
    """Phase 2c: the backward kernel against its plain version on
    BWD_CASES, then timed at gemma2-9b's two training layers beside its
    bound, its plain version and the backward alone of SDPA at cap 0."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def draw(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    for case in BWD_CASES:
        B, Sq, Sk, H, KV, D, Dv, causal, window, cap = case
        for name, dtype in dt.items():
            q = draw((B, Sq, H, D), dtype, QK_STD)
            kv = torch.cat([draw((B, Sk, KV, D), dtype, QK_STD), draw((B, Sk, KV, Dv), dtype)], dim=-1)
            k, v = kv[..., :D], kv[..., D:]
            do = draw((B, Sq, H, Dv), dtype)
            o = fa_ops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
            got = fa_ops.flash_attention_bwd(q, k, v, o, do, causal=causal, window=window, softcap=cap)
            want = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window, softcap=cap)
            torch.cuda.synchronize()
            err, rel = grads_agree(torch, got, want, name, f"flash_attention_bwd {case} {name}")
            print(f"phase 2 flash_attention_bwd {case} {name}: max_abs_err {err!r} ({rel!r} of max |plain|)")
    torch.cuda.empty_cache()

    bf = torch.bfloat16
    B, S, H, KV, D, cap = (BWD_ROW[k] for k in ("B", "S", "H", "KV", "D", "cap"))
    q, k, v = draw((B, S, H, D), bf, QK_STD), draw((B, S, KV, D), bf, QK_STD), draw((B, S, KV, D), bf)
    do = draw((B, S, H, D), bf)
    rows = {}
    for window in (0, 4096):
        o = fa_ops.flash_attention(q, k, v, window=window, softcap=cap)
        got = fa_ops.flash_attention_bwd(q, k, v, o, do, window=window, softcap=cap)
        want = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, window=window, softcap=cap)
        torch.cuda.synchronize()
        err, rel = grads_agree(torch, got, want, "bfloat16", f"flash_attention_bwd at gemma2's training layer "
                                                            f"(window {window})")
        del got, want
        torch.cuda.empty_cache()
        pairs = attn_pairs(S, S, True, window)
        nbytes = (4 * B * S * H * D + 4 * B * S * KV * D) * 2     # q, o, dO, dq; k, v, dk, dv
        b_ms, b_by = bound(nbytes, bwd_ops(H, D, D, pairs) * B, "bf16")
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        rows[window] = dict(
            ms=kernel_ms(torch, fa_ops.bwd_launcher(q, k, v, o, do, dq, dk, dv, window=window, softcap=cap),
                         reps=3, inner=2),
            ms_softcap0=kernel_ms(torch, fa_ops.bwd_launcher(q, k, v, fa_ops.flash_attention(q, k, v, window=window),
                                                             do, dq, dk, dv, window=window), reps=3, inner=2),
            plain_ms=kernel_ms(torch, lambda: fa_ref.flash_attention_bwd_ref(q, k, v, o, do, window=window,
                                                                             softcap=cap), reps=2, inner=1),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, max_rel_err=rel, pairs=pairs)
        rows[window]["bound_share"] = b_ms / rows[window]["ms"]
        del dq, dk, dv, o
        torch.cuda.empty_cache()
    # The yardstick: the backward alone of SDPA at cap 0 (the band mask for
    # the local layer), timed around autograd.grad of one forward.
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)
    pos = torch.arange(S, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < 4096)
    for window, kw in ((0, dict(is_causal=True)), (4096, dict(attn_mask=band))):
        fwd = lambda kw=kw: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **kw)  # noqa: E731
        out = fwd()
        rows[window]["library_ms"] = kernel_ms(
            torch, lambda out=out: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), reps=3, inner=2)
        rows[window]["library_backend"] = sdpa_backend(torch, fwd)
        del out
    del q, k, v, do, qt, kt, vt, band
    torch.cuda.empty_cache()
    row = dict(rows[0], shape=[B, S, H, KV, D], window_4096=rows[4096])
    for r in (row, rows[4096]):
        print(f"phase 2 flash_attention_bwd {row['shape']} window {4096 if r is rows[4096] else 0}: "
              f"kernel {r['ms']:.6f} ms (softcap 0: {r['ms_softcap0']:.6f} ms), plain {r['plain_ms']:.6f} ms, "
              f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}, share {r['bound_share']:.4f}), SDPA backward "
              f"softcap 0 {r['library_ms']:.6f} ms ({r['library_backend']}), max_abs_err {r['max_abs_err']!r}")
    return row


# Phase 10: gemma2-9b training at its published width, depth cut: 8 of 42
# layers (4 local + 4 global) in bf16 with f32 AdamW moments: 2.503 B
# parameters, 5.0 GB of weights, 5.0 GB of gradients and 20.0 GB of
# moments, beside the 8,192 x 256,000 cross-entropy chunk (8.4 GB in
# float32) and its gradient; all 42 layers would need about 111 GB.
TRAIN = dict(layers=8, B=1, S=8192, steps=20, data_seed=1)
TRAIN_ORACLE = dict(layers=2, B=1, S=512)        # f32: the kernels against the plain route
TRAIN_RESTART = dict(layers=2, B=1, S=1024, steps=6, save_at=3)


def gemma2_train(torch, layers: int, dtype: str = "bfloat16"):
    """gemma2-9b at its published width with ``layers`` layers (L, G
    alternating), weights from a seeded generator on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config("gemma2-9b").replace(num_layers=layers, param_dtype=dtype, compute_dtype=dtype)
    return cfg, LM(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(SEED))


def train_bound_ops(cfg, n_params: int, B: int, S: int) -> float:
    """6·P·tokens (forward and backward of every weight, the tied head
    once) plus attention's products: forward 4·D and backward
    2·(3·D + 2·D) a pair and head, global layers causal, local ones
    within the window."""
    from repro_torch.models.common import layer_flags

    attn = 0.0
    for g in layer_flags(cfg)["is_global"]:
        pairs = attn_pairs(S, S, True, 0 if g else cfg.local_window)
        attn += (4 * cfg.head_dim_ + bwd_ops(1, cfg.head_dim_, cfg.head_dim_, 1)) * cfg.num_heads * pairs * B
    return 6.0 * n_params * B * S + attn


def train_main(torch) -> dict:
    """Phase 10.1: 20 steps of build_train_step (TrainConfig defaults,
    remat on) at B 1 x S 8,192 from SyntheticLMDataset(256000, 8192,
    seed=1): losses finite and falling, 16 flash forwards and 8 backwards
    a step, the step beside its bound, its device share, peak memory."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.runtime import TrainConfig, build_train_step, init_opt_state

    B, S, steps = TRAIN["B"], TRAIN["S"], TRAIN["steps"]
    cfg, lm = gemma2_train(torch, TRAIN["layers"])
    check(cfg.remat and cfg.max_seq_len == S, "phase 10 trains with remat at max_seq_len")
    n_params = sum(p.numel() for p in lm.parameters())
    step = build_train_step(lm, TrainConfig())
    opt = init_opt_state(lm)
    ds = SyntheticLMDataset(cfg.vocab_size, S, seed=TRAIN["data_seed"])
    losses, times = [], []
    counters = train_counters()

    def run():
        for s in range(steps):
            batch = ds.batch(s, B)
            t0 = time.perf_counter()
            m = step(opt, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        # the instances launched, read before counted() restores the phase's counts
        return {n: {f"{d}x{dv}": k for (d, dv), k in sorted(c.by_pair.items())}
                for n, c in counters.items() if hasattr(c, "by_pair")}

    pairs, _, launches = counted(torch, run, counters=counters)
    check(all(math.isfinite(x) for x in losses), f"phase 10 loss not finite: {losses}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first - 0.1, f"phase 10 loss did not fall: first five {first!r}, last five {last!r}")
    L = cfg.num_layers
    check(launches["flash_attention"] == 2 * L * steps,
          f"phase 10 flash forward launches {launches['flash_attention']} != {2 * L} a step x {steps}")
    check(launches["flash_attention_bwd"] == L * steps,
          f"phase 10 flash backward launches {launches['flash_attention_bwd']} != {L} a step x {steps}")
    check(launches["decode_attention"] == 0, "phase 10 launched decode_attention")
    check(set(pairs["flash_attention"]) == {"256x256"} and set(pairs["flash_attention_bwd"]) == {"256x256"},
          f"phase 10 flash instances {pairs}")
    step_s = statistics.median(times)
    ops = train_bound_ops(cfg, n_params, B, S)
    bound_s = ops / PEAK_OPS["bf16"]
    batch = ds.batch(steps, B)
    trace = step_trace(torch, lambda: step(opt, batch), 1)
    out = dict(layers=L, cut=f"depth cut to {L} of {42} layers (4 local + 4 global)", params=n_params,
               weight_gb=n_params * 2 / 1e9, moment_gb=n_params * 8 / 1e9, losses=losses,
               first5=first, last5=last, step_s=step_s, step_times_s=times, bound_ops=ops, bound_s=bound_s,
               bound_share=bound_s / step_s, tokens_per_s=B * S / step_s, device_ms=trace["busy_ms"],
               device_share=trace["busy_ms"] / 1e3 / step_s, idle_share=1 - trace["busy_ms"] / 1e3 / step_s,
               kernels_a_step=trace["kernels"], top=trace["top"], launches_20_steps=launches,
               launches_by_pair=pairs, max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"phase 10 gemma2-9b bf16 {L} layers ({n_params} parameters), B {B} x S {S}: losses {losses}")
    print(f"phase 10 step median {step_s:.6f} s against its bound {bound_s:.6f} s ({ops:.6e} operations at "
          f"989 TFLOP/s; share {bound_s / step_s:.4f}), {B * S / step_s:.3f} tokens/s; device "
          f"{trace['busy_ms']:.3f} ms a step in {trace['kernels']:.0f} kernels (idle share "
          f"{out['idle_share']:.4f}); top {trace['top']}; peak memory {out['max_memory_gb']:.3f} GB; "
          f"launches over {steps} steps {launches}")
    del lm, opt, step
    return out


class plain_attention:
    """Inside the block, models.attention sends the card's attention to
    the plain version (``flash_attention_ref``), which autograd
    differentiates: the reference route for phase 10.2's oracle."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ref as fa_ref
        from repro_torch.models import attention

        self.mod, self.saved = attention, attention.flash_attention
        attention.flash_attention = fa_ref.flash_attention_ref
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.saved


def train_oracle(torch) -> dict:
    """Phase 10.2: float32, one local and one global layer, B 1 x S 512:
    the loss and every gradient with attention through the kernels
    (forward and backward) against the same with attention through the
    plain version, on the card."""
    from repro_torch.data import SyntheticLMDataset

    B, S = TRAIN_ORACLE["B"], TRAIN_ORACLE["S"]
    cfg, lm = gemma2_train(torch, TRAIN_ORACLE["layers"], "float32")
    lm.requires_grad_(True)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in SyntheticLMDataset(cfg.vocab_size, S, seed=TRAIN["data_seed"]).batch(0, B).items()}

    def loss_and_grads():
        lm.zero_grad(set_to_none=True)
        total, _ = lm.loss(batch)
        total.backward()
        return total.detach(), {k: p.grad.clone() for k, p in lm.named_parameters()}

    (k_loss, k_grads), _, k_launches = counted(torch, loss_and_grads, counters=train_counters())
    with plain_attention():
        (p_loss, p_grads), _, p_launches = counted(torch, loss_and_grads, counters=train_counters())
    L = cfg.num_layers
    check(k_launches["flash_attention"] == 2 * L and k_launches["flash_attention_bwd"] == L,
          f"phase 10 oracle kernel launches {k_launches}")
    check(not any(p_launches.values()), f"phase 10 oracle's plain route launched {p_launches}")
    loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    check(loss_rel <= 1e-5, f"phase 10 f32 loss {float(k_loss)!r} vs plain {float(p_loss)!r}")
    worst = 0.0
    for name, g in p_grads.items():
        big = float(g.abs().max())
        err = float((k_grads[name] - g).abs().max())
        check(err <= 1e-3 * big, f"phase 10 f32 gradient {name}: {err!r} > 1e-3 · {big!r}")
        worst = max(worst, err / big if big else 0.0)
    out = dict(layers=L, B=B, S=S, loss=float(k_loss), plain_loss=float(p_loss), loss_rel_err=loss_rel,
               worst_grad_rel_err=worst, launches=k_launches)
    print(f"phase 10 f32 oracle ({L} layers, B {B} x S {S}): loss {float(k_loss)!r} vs plain {float(p_loss)!r} "
          f"(rel {loss_rel!r}); worst gradient leaf max |diff| / max |g| {worst!r}; launches {k_launches}")
    del lm, k_grads, p_grads
    return out


def train_restart(torch) -> dict:
    """Phase 10.3: bf16, 2 layers, 6 steps with CheckpointManager saving at
    step 3; restored from it and run on to step 6, parameters and
    moments bit-equal to the unbroken run."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.runtime import TrainConfig, build_train_step, init_opt_state

    B, S, steps, save_at = (TRAIN_RESTART[k] for k in ("B", "S", "steps", "save_at"))
    cfg, lm_a = gemma2_train(torch, TRAIN_RESTART["layers"])
    ds = SyntheticLMDataset(cfg.vocab_size, S, seed=TRAIN["data_seed"])

    def run(lm, opt, start, mgr=None):
        step = build_train_step(lm, TrainConfig())
        for s in range(start, steps):
            step(opt, ds.batch(s, B))
            if mgr is not None and s + 1 == save_at:
                mgr.save_async(save_at, (dict(lm.named_parameters()), opt))
        torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=1)
        opt_a = init_opt_state(lm_a)
        t0 = time.perf_counter()
        run(lm_a, opt_a, 0, mgr)
        mgr.wait()
        run_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
        from repro_torch.models import LM

        lm_b = LM(cfg, device="cuda")
        t0 = time.perf_counter()
        (params, opt_b), step = mgr.restore((dict(lm_b.named_parameters()), init_opt_state(lm_b)), device="cuda")
        restore_s = time.perf_counter() - t0
        check(step == save_at, f"phase 10 restored step {step}, saved {save_at}")
        with torch.no_grad():
            for k, p in lm_b.named_parameters():
                p.copy_(params[k])
        del params
        run(lm_b, opt_b, save_at)
    for (k, a), (_, b) in zip(lm_a.named_parameters(), lm_b.named_parameters()):
        check(torch.equal(a, b), f"phase 10 restart: parameter {k} differs")
    for mom in ("m", "v"):
        for k in opt_a[mom]:
            check(torch.equal(opt_a[mom][k], opt_b[mom][k]), f"phase 10 restart: {mom} of {k} differs")
    check(int(opt_a["step"]) == int(opt_b["step"]) == steps, "phase 10 restart: step counts differ")
    out = dict(layers=cfg.num_layers, B=B, S=S, steps=steps, save_at=save_at, checkpoint_bytes=ckpt_bytes,
               run_s=run_s, restore_s=restore_s, bit_equal=True)
    print(f"phase 10 restart ({cfg.num_layers} layers, B {B} x S {S}): saved at step {save_at} "
          f"({ckpt_bytes} bytes), restored in {restore_s:.3f} s, run on to step {steps}: parameters and "
          f"moments bit-equal to the unbroken run")
    del lm_a, lm_b, opt_a, opt_b
    return out


def train_cli(torch) -> dict:
    """Phase 10.4: launch/train.py's main on the card (reduced gemma2, 20
    steps, a checkpoint directory)."""
    import tempfile

    from repro_torch.launch import train

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, opt = train.main(["--arch", "gemma2-9b", "--reduced", "--steps", "20", "--ckpt-dir", tmp,
                             "--device", "cuda"])
        wall = time.perf_counter() - t0
        saved = sorted(p.name for p in Path(tmp).iterdir())
    check(int(opt["step"]) == 20 and saved[-1] == "step_00000020", f"phase 10 CLI: step {int(opt['step'])}, {saved}")
    print(f"phase 10 launch/train.py --reduced --steps 20 on the card: {wall:.3f} s, checkpoints {saved}")
    return dict(wall_s=wall, checkpoints=saved)


def phase_train(torch) -> dict:
    """Phase 10: gemma2-9b training on the card, each model freed before
    the next."""
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for name, fn in (("bf16 main", train_main), ("f32 oracle", train_oracle), ("restart", train_restart),
                     ("cli", train_cli)):
        t0 = time.perf_counter()
        r = fn(torch)
        gc.collect()
        torch.cuda.empty_cache()
        r["part_s"] = time.perf_counter() - t0
        out[name] = r
        print(f"phase 10 {name} in {r['part_s']:.3f} s")
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
    bwd_row = phase_flash_backward(torch)
    # The backward kernel's count on the main path (phases 4-5, serving):
    # zeroed after phase 2's comparisons and read after phase 5.
    from repro_torch.kernels.flash_attention import ops as fa_ops

    zero_counts({"flash_attention_bwd": fa_ops.flash_attention_bwd})
    serving = phase_serving(torch)
    gc.collect()
    torch.cuda.empty_cache()
    phase_prefill_equals_decode(torch)
    gc.collect()
    torch.cuda.empty_cache()
    main_bwd = fa_ops.flash_attention_bwd.launches
    check(main_bwd == 0, f"serving launched the flash backward {main_bwd} times")

    # Phases 6-9 are each a slice's path: every kernel counter, the flash
    # wrapper's per-instance counts too, at 0 before it and read after (the
    # CPU twins' calls run the plain versions, uncounted).
    from repro_torch.kernels.cost_matrix import ops as cm_ops
    from repro_torch.kernels.priority_requeue import ops as pr_ops

    sim_counters = {"cost_matrix_f32": cm_ops.cost_matrix_classed, "cost_matrix_f64": cm_ops.cost_matrix_f64,
                    "cost_argmin_f64": cm_ops.cost_argmin_f64, "priority_requeue": pr_ops.priority_requeue}
    all_counters = dict(sim_counters, **train_counters())
    zero_counts(all_counters)
    t0 = time.perf_counter()
    phase_sim(torch, P)
    sim_launches = {name: fn.launches for name, fn in all_counters.items()}
    sim_pairs = flash_pairs()
    print(f"phase 6 in {time.perf_counter() - t0:.3f} s, launches {sim_launches}, flash by instance {sim_pairs}")
    check(sim_launches["cost_argmin_f64"] > 0, "phase 6 never launched cost_argmin_f64")

    zero_counts(all_counters)
    # Part 1 zeroes the scheduler counters again after its DianaScheduler
    # twin, so their counts are the peer's select/rank/place and the
    # simulators' (which launch none: their rows depend on each job's origin
    # through the link matrices).
    t0 = time.perf_counter()
    p2p = phase_p2p(torch, P, sim_counters)
    p2p_launches = {name: fn.launches for name, fn in all_counters.items()}
    p2p_pairs = flash_pairs()
    print(f"phase 7 in {time.perf_counter() - t0:.3f} s, launches {p2p_launches}, flash by instance {p2p_pairs} "
          f"(the peer's select/rank/place: {p2p['peer_launches']})")
    for name in ("cost_argmin_f64", "cost_matrix_f64"):
        check(p2p_launches[name] > 0, f"phase 7 never launched {name}")
    gc.collect()
    torch.cuda.empty_cache()

    # Each part of phase 8 also counts the attention kernels around itself.
    zero_counts(all_counters)
    t0 = time.perf_counter()
    phase_families(torch)
    ph8_launches = {name: fn.launches for name, fn in all_counters.items()}
    ph8_pairs = flash_pairs()
    print(f"phase 8 in {time.perf_counter() - t0:.3f} s, launches {ph8_launches}, flash by instance {ph8_pairs}")
    for name in attn_counters():
        check(ph8_launches[name] > 0, f"phase 8 never launched {name}")
    gc.collect()
    torch.cuda.empty_cache()

    zero_counts(all_counters)
    t0 = time.perf_counter()
    moe = phase_moe(torch)
    ph9_launches = {name: fn.launches for name, fn in all_counters.items()}
    ph9_pairs = flash_pairs()
    print(f"phase 9 in {time.perf_counter() - t0:.3f} s, launches {ph9_launches}, flash by instance {ph9_pairs}")
    check(ph9_pairs.get(MLA_PAIR, 0) > 0, "phase 9 never launched flash_attention (192, 128)")
    check(set(ph9_pairs) == {MLA_PAIR}, f"phase 9 launched other flash instances {ph9_pairs}")
    gc.collect()
    torch.cuda.empty_cache()

    zero_counts(all_counters)
    t0 = time.perf_counter()
    train = phase_train(torch)
    ph10_launches = {name: fn.launches for name, fn in all_counters.items()}
    ph10_pairs = flash_pairs()
    ph10_bwd_pairs = {f"{d}x{dv}": n for (d, dv), n in sorted(fa_ops.flash_attention_bwd.by_pair.items())}
    print(f"phase 10 in {time.perf_counter() - t0:.3f} s, launches {ph10_launches}, flash by instance "
          f"{ph10_pairs}, flash backward by instance {ph10_bwd_pairs}")
    check(ph10_launches["flash_attention_bwd"] > 0, "phase 10 never launched flash_attention_bwd")

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
            launches_p2p=p2p_launches[name], launches_ph8=ph8_launches[name],
            launches_ph9=ph9_launches[name], launches_ph10=ph10_launches[name],
            **({"wrapper_ms": r["wrapper_ms"]} if "wrapper_ms" in r else {}),
        ))
    # The flash rows split the wrapper's counts by instance: "flash_attention"
    # counts the instances with v as wide as q and k, "flash_attention
    # (192, 128)" MLA's, each per phase as measured (``launches_by_pair``).
    phase_pairs = {"main": serving["pairs"], "sim": sim_pairs, "p2p": p2p_pairs, "ph8": ph8_pairs, "ph9": ph9_pairs,
                   "ph10": ph10_pairs}
    source, replaces = attn_meta["flash_attention"]
    for name, mla, r in (("flash_attention", False, attn["flash_attention"]),
                         ("flash_attention (192, 128)", True, attn["flash_attention_mla"])):
        counts = {ph: pair_sum(pairs, mla) for ph, pairs in phase_pairs.items()}
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=counts["ph9" if mla else "main"],
            launches_sim=counts["sim"], launches_p2p=counts["p2p"], launches_ph8=counts["ph8"],
            launches_ph9=counts["ph9"], launches_ph10=counts["ph10"],
            launches_by_pair={ph: {key: n for key, n in pairs.items() if (key == MLA_PAIR) == mla}
                              for ph, pairs in phase_pairs.items()}, **r))
    source, replaces = attn_meta["decode_attention"]
    line.append(dict(name="decode_attention", route="cuda", source=source, replaces=replaces,
                     launches=serving["launches"]["decode_attention"], launches_sim=sim_launches["decode_attention"],
                     launches_p2p=p2p_launches["decode_attention"], launches_ph8=ph8_launches["decode_attention"],
                     launches_ph9=ph9_launches["decode_attention"], launches_ph10=ph10_launches["decode_attention"],
                     **attn["decode_attention"]))
    # The backward has no Pallas twin (the reference differentiates jnp
    # attention); it is the gradient of the forward TPU kernel's function.
    line.append(dict(name="flash_attention_bwd", route="cuda",
                     source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
                     replaces="src/repro/kernels/flash_attention/flash_attention.py:72",
                     replaces_note="no Pallas backward: the gradient of flash_attention_pallas's function",
                     launches=ph10_launches["flash_attention_bwd"], launches_main=main_bwd,
                     launches_sim=sim_launches["flash_attention_bwd"], launches_p2p=p2p_launches["flash_attention_bwd"],
                     launches_ph8=ph8_launches["flash_attention_bwd"], launches_ph9=ph9_launches["flash_attention_bwd"],
                     launches_ph10=ph10_launches["flash_attention_bwd"], launches_by_pair={"ph10": ph10_bwd_pairs},
                     **bwd_row))
    for k in line:
        k["bound_share"] = k["bound_ms"] / k["ms"]
        k["launches_x_gap_ms"] = k["launches"] * (k["ms"] - k["bound_ms"])
    # MLA's row: only the launches at the timed shape, deepseek-v2's
    # 4,096-token bf16 prefill; phase 9's others run at 16 and 1,024 tokens.
    k = next(k for k in line if k["name"] == "flash_attention (192, 128)")
    k["gap_launches"] = moe["deepseek-v2-236b (bf16)"]["prefill_pairs"][MLA_PAIR]
    k["launches_x_gap_ms"] = k["gap_launches"] * (k["ms"] - k["bound_ms"])
    # The backward's row: its lost time over phase 10's 20 training steps at
    # the timed shape, 4 global and 4 local layers a step.
    k = next(k for k in line if k["name"] == "flash_attention_bwd")
    per_kind = train["bf16 main"]["launches_20_steps"]["flash_attention_bwd"] // 2
    k["gap_launches"] = 2 * per_kind
    k["launches_x_gap_ms"] = per_kind * ((k["ms"] - k["bound_ms"]) +
                                         (k["window_4096"]["ms"] - k["window_4096"]["bound_ms"]))
    f64 = kernels["priority_requeue_f64"]
    print(f"priority_requeue f64 instance (not on the main path): ms {f64['ms']!r} plain_ms "
          f"{f64['plain_ms']!r} bound_ms {f64['bound_ms']!r}, bit-equal to reprioritize_np")
    check(all(math.isfinite(k["ms"]) for k in line), "a kernel time is not finite")
    print(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
