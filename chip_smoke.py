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
   sites × 100 tiers × 4,000 jobs (the flat select through the fused
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
   S 4,096, 128 heads) beside its bound, plain version and SDPA. Last,
   launch/serve.py --arch deepseek-v2-236b serves its reduced
   configuration (MLA's absorbed decode: no attention kernel), and that
   configuration prefills 128 tokens through LM.forward, its MLA widths
   (48, 32) on the padded route to the (64, 64) instance.

2c. Hold flash attention's backward kernels (csrc/flash_attention_bwd.cu)
   against their plain version before phase 10 relies on them, fed the
   forward kernel's row log-sum-exp (held to the plain version's within
   1e-4 of its largest magnitude): every (D, Dv) instance in float32 and
   bf16, causal and not, window edges inside a tile, a window of 1,
   soft-cap 0 and 50, GQA rep 1, 2, 3, 4, 10 and 16, ragged lengths 77,
   200 and 1,000, Sq < Sk and Sq > Sk non-causal, k and v two column
   ranges of one buffer; each of dq, dk and dv within 1e-4 (f32) or 2e-2 (bf16, and
   the mean error under 1%) of max |plain| (for a window of 1, of a
   tenth of the call's largest gradient where that is larger), and the
   same bits on a second call. The padded route for widths without an
   instance ((48, 32), (80, 80), (192, 64); the decode kernel at D 48 and
   80) against the plain version at the inputs' own widths. Then time
   the backward at gemma2-9b's two training layers (B 1, S 8,192,
   H 16/8, D 256, bf16, cap 50; causal, and a 4,096 window) beside its
   bound, its plain version, the backward alone of SDPA at cap 0 and its
   device time by kernel (profiler), and the forward with and without
   its lse write.
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
   6, parameters and moments bit-equal to the unbroken run;
   launch/train.py's ``main`` on the card (reduced, 20 steps, with a
   checkpoint directory); and launch/train.py --arch deepseek-v2-236b
   --reduced for 3 steps, its MLA widths (48, 32) padded forward and
   backward.
11. The dry run against the card, every kernel counter set to 0 before
   the phase and read after (``launches_ph11`` on every row of the
   kernels line). First ``runtime.serve.abstract_cache`` (built on the
   ``meta`` device through the attention kernels' shape-only route)
   against ``init_cache`` on the card, in shape and type, for every
   family at the configuration phases 8-9 serve it. 11.1: gemma2-9b at
   its published width and depth in bf16 through
   ``runtime.serve.build_serve_step``, B 4 over a max_len 8,192 cache:
   steps at positions 0-15 from an empty cache, then one at 8,191 over
   a cache filled from a seeded generator, the logits (and the cache)
   bit-equal to ``decode.decode_step`` on a copy, 42 decode launches a
   step, none padded. 11.2: three cells cut to one card, each run once
   on ``meta`` by ``launch.dryrun`` (``analyze_step``, ``cell_record``)
   and once on the card with tensors of ``input_specs``' shapes and
   types: (a) that decode step at 8,191, (b) a B 1 × S 8,192 prefill at
   42 layers, (c) phase 10's training step (8 layers, B 1 × S 8,192,
   remat, AdamW). For each, the FLOPs ``launch.op_analysis`` counts on
   the card (a separate pass) equal the dry run's exactly, and so do
   the kernels' charged work and the argument bytes (parameters,
   optimizer state, batch, cache); the dry run's high-water mark is
   within 10% of ``torch.cuda.max_memory_allocated`` over the timed
   steps (reset before them); the median step (host clock ending in a
   synchronize, without the analysis) is printed beside
   ``step_time_lower_bound_s`` and their ratio, and each cell's record
   on a line of its own.
12. The sharded decode paths on the one card. (a) In this process, the
   decode kernel's key-range entry (``key0``, ``lse=True``) at gemma2-9b's
   decode shape (B 4, S 8,192, H 16/8, D 256, bf16, soft-cap 50) cut into
   4 ranges of 2,048: each range against its plain version, the ranges'
   (out, lse) pairs combined against the whole-cache kernel and the plain
   version (2e-2), at pos 8,191 and 4,095 (two ranges see no key: out 0,
   lse −inf); each range's launch timed beside its byte bound. Then the
   one-process results, and four ranks spawned on the card
   (``launch.mesh.run_ranks``: a 2 × 2 ("data", "model") mesh, gloo on
   cuda:0, every rank's kernel counters set to 0 before its part and read
   after; the kernels line's ``launches_ph12`` are their sums), each held
   to them: (b) gemma2-9b at published width through
   ``build_serve_step(..., mesh=...)``, B 4 over max_len 8,192 caches filled
   from a seeded generator, steps at 0, 1, 4,095, 4,096, 4,097 and 8,191
   (across the 4,096 ring's wrap): in float32 with 2 layers each rank's
   logits rows within 2e-4 of the one-process ``decode_step`` and the same
   argmax, twice: with the tables cut as serving cuts them at this depth
   (vocab over 'model') and with serving's ZeRO forced (width over 'data'
   too, as published gemma2-9b is served: the weight-stationary lookup
   and logits); in bf16 with 4 layers within 2e-2 of the logits' largest
   magnitude and the same argmax but where the one-process logits' top two
   lie within that tolerance of each other; every step of every rank runs
   each layer through the sharded attention and MLP and launches the
   decode kernel once a layer, through the key-range entry; each rank's
   parameter and cache storage equals the rules' bytes
   (``launch.dryrun.argument_bytes``), printed beside what the rule
   before them held; (c) one
   deepseek-v2-236b MLA layer, ``mla_decode_sharded`` against ``mla_decode``
   (bf16, 2e-2 of the largest magnitude); (d) one deepseek-v2-236b moe
   layer, the a2a dispatch (2-D EP: 160 experts over the 4 ranks) on
   B 2 × S 512 against the gather dispatch in this process, capacity factor
   cut to 64 (dropless), output within 2e-2 and aux within 1e-3; (e)
   gemma2-9b through ``build_serve_step(..., mesh=...)`` on short caches
   that the rules cut otherwise than along S: in float32 with 2 layers,
   B 4 over max_len 128 on the 2 × 2 mesh (every cache along D: the
   float32 partial scores), and in bf16 with 4 layers, B 320 over max_len
   128 on a 1 × 4 mesh over the same ranks (every cache along its rows:
   the decode kernel on the rank's rows), each rank's rows within 2e-4
   (f32) and 2e-2 (bf16) of the largest one-process logit, the same
   greedy tokens (in bf16 but for top-two ties), and storage equal to the
   rules' bytes. Prints each
   rank's step times and peak memory: four processes time-sharing one card
   with their collectives staged through host memory, not the sharded
   step's speed, and held to no bound.
13. Sharded training and prefill of the dense family on the one card:
   four ranks again (2 × 2 mesh, gloo on cuda:0, each rank's kernel
   counters set to 0 before its sharded parts and read after; the kernels
   line's ``launches_ph13`` are their sums), gemma2-9b at its published
   width with 2 of 42 layers (L, G), each rank drawing the whole model
   from the seed and keeping its blocks (``build_train_step(...,
   mesh=...)``: Megatron over 'model', ZeRO-3 over 'data'). (a) bf16 with
   remat and ``TrainConfig``'s defaults, train_4k's batch cut to a global
   B 2 × S 2,048 (one row a data rank) from ``SyntheticLMDataset(256000,
   2048, seed=1)``, 2 steps (3 before phase 16 came): every loss within 2e-2 relative of the
   one-process step's (here, first) and the same learning rates; every
   sharded attention call launches the flash kernel (2 a layer a step
   with remat) and every layer its backward, at the (256, 256) instance,
   none padded. (b) float32 at S 512 with warmup 1: each step's loss and
   grad norm within 1e-5 relative of rank 0's one-process step from the
   same parameters and data (run after the sharded parts), the learning
   rate equal, and every parameter, gathered whole to rank 0, within 1e-1
   of its leaf's largest change over the 2 steps, at most 1e-6 of a leaf's
   elements beyond 1e-2 of it (AdamW magnifies the order of summation: the
   one-process step against itself in two microbatches spreads as far). (c) the prefill step
   under the mesh (B 2 × S 2,048): each rank's logits rows within 1e-4
   (float32) and 1e-2 (bf16) of the largest one-process logit. Prints each
   rank's losses, grad norms, step times, peak memory and launches:
   four processes sharing one card over gloo, held to no bound.
14. The hybrid, vlm and encdec families trained, at published width,
   with the cross layers' gates at 0.5. (a) In this process, float32, B 1
   × S 512: recurrentgemma-2b (3 of 26 layers, R R L, window cut to 128),
   llama-3.2-vision-11b (5 of 40, one cross layer over 1,601 image
   tokens), whisper-base (6 + 6, 1,500 frames): the loss within 1e-5
   relative and every gradient within 1e-3 of its leaf's max |g| of the
   same with attention through the plain version (phase 10's oracle),
   the forward and backward kernels at each family's instance ((256,
   256), (128, 128), (64, 64)) and the plain route launching nothing.
   Then four ranks on the 2 × 2 mesh as in phase 13: (b) bf16, remat,
   ``TrainConfig``'s defaults, 2 steps of a global B 2: recurrentgemma-2b
   with 5 layers (R R L R R) at S 1,024, llama-3.2-vision-11b with 5 at S
   1,024, whisper-base whole at S 448, every loss and grad norm within
   2e-2 relative of the one-process steps (here, first), the same
   learning rates; (c) whisper-base in float32, 3 steps at S 448 against
   rank 0's one-process steps to phase 13's f32 limits; (d) each
   family's prefill under the mesh on (b)'s first batch within 1e-2 of
   the largest one-process logit (whisper-base in float32 too, 1e-4);
   (e) ``build_serve_step(..., mesh=...)`` in float32, B 4 over max_len
   1,024, 3 steps: recurrentgemma-2b (3 layers), llama-3.2-vision-11b (5)
   and whisper-base, ``init_cache`` under the mesh over the seeded image
   embeddings and 1,500 audio frames (whisper's encoder on the rank's
   blocks, each cross layer's block of K/V), every other cache from a
   seed: each rank's logits rows within 2e-4 of one process's and the
   same argmax, every layer through its sharded body (the RG-LRU
   channel-parallel; whisper's cross K/V cut along N through the
   key-range entry, vision's 1,601 image tokens along D through the
   float32 partial scores), and each rank's parameter and cache storage
   equal to the rules' bytes, beside the rule before them; then again on
   short caches that the rules cut along D (recurrentgemma-2b's ring of
   128 across its wrap, whisper-base's self caches of 32), each self layer
   through the float32 partial scores. (f) Every
   sharded attention call of (b)-(d) launches the flash kernel and every
   training layer its backward, each at its family's instance, none
   padded; ``rglru_sharded`` runs once a recurrent layer a forward. The
   kernels line's ``launches_ph14`` are (a)'s kernel route and the four
   ranks' sums.
15. The moe and ssm families under a mesh, at published width. (a) In
   this process, float32, deepseek-v2-236b with 2 of 60 layers (the
   dense first and one MoE layer), B 1 × S 512, the gather dispatch at
   the published capacity factor 1.25: the loss within 1e-5 relative and
   every gradient within 1e-3 of its leaf's max |g| of the plain route's,
   the (192, 128) forward and backward launching and the plain route
   nothing; the tokens the two routes send to other experts are counted,
   and where there are any both run again at the dropless capacity factor
   64. Then four ranks on the 2 × 2 mesh: (b) bf16, remat, a global B 2:
   deepseek-v2-236b (2 layers, S 1,024, adamw8) 2 steps of the gather
   dispatch of the sharded batch at 1.25, which must drop tokens, then 1
   step of the a2a at 27, above E / K, where a shard's capacity holds all
   its tokens (dropless); mamba2-780m with 8 of 48 layers at S
   1,024, 2 steps; every loss and grad norm within 2e-2 relative of the
   one-process steps (here, first), the same learning rates; (c)
   mamba2-780m in float32, 4 layers, S 512, 3 steps against rank 0's
   one-process steps to phase 13's f32 limits; (d) each prefill under the
   mesh (mamba2 in float32 too); (e) ``build_serve_step(..., mesh=...)``,
   B 4 over max_len 1,024, a prompt then decode steps: deepseek-v2-236b in
   bf16 (``mla_decode_sharded``, the gather dispatch of one token a row;
   again over max_len 256, where the rules cut c_kv along its latent
   dimension and k_rope along S, ROADMAP C14's layout) and mamba2-780m in
   bf16 and float32, within phase 12's limits, each
   rank's storage equal to the rules' bytes (beside the rule before them)
   and every Mamba-2 layer through ``mamba_decode_sharded`` (its state cut
   along N); (f)
   every ``mla_sharded`` call launches the (192, 128) instance and every
   training layer its backward, none padded, and ``mamba_sharded`` and
   the dispatch counters equal the layers run. The kernels line's
   ``launches_ph15`` are (a)'s kernel route and the four ranks' sums.

16. The int8 pod-compressed training step (``compress_pod_grads``) and
   the per-rank dry run, four ranks on the one card over gloo with mesh
   {"pod": 2, "data": 1, "model": 2}: gemma2-9b at phase 13's cut (2 layers, bf16,
   remat), a global B 2 × S 2,048, AdamW with no warmup, labels unmasked.
   (a) From one state, a compressed and an uncompressed step: the losses
   within 2e-2 relative, the grad norms within the quantization bound
   (each element within (1/n)·Σ_p (s_p/2 + 127·|s̄ − s_p|) of the pods'
   mean: the reference dequantizes every pod's codes with the mean scale
   s̄) plus 2e-2, and each rank's parameters the two steps moved the same
   way within one learning rate beyond one bf16 unit in the last place
   (AdamW's first step bounds it; an element whose codes summed to 0
   moves by weight decay alone; the shares moved alike and opposite, and
   beyond 1e-2 and 1e-1 of lr, are printed). (b) Each rank's synced
   gradient of the reference's blocks/attn/wk (both layers, one scale)
   bit for bit a NumPy twin of the reference's arithmetic fed the pods'
   gradients gathered whole. (c) A counted compressed step, and a counted
   step of phase 13's cell on the 2 × 2 ('data', 'model') mesh of the same
   ranks, against the per-rank ``meta`` dry run of each cell run in this
   process (``launch.dryrun.analyze_rank_step``): bytes received by kind
   and the largest call to the byte, FLOPs and argument bytes exactly;
   phase 13's logged steps against its cell's meta run too. Prints the
   int32 bytes received over 'pod' beside the uncompressed step's bf16
   bytes. The kernels line's ``launches_ph16`` are the four ranks' sums.

Phases 12-16 log each sharded step's bytes received on each rank
(``launch.mesh.received``: in all, by collective kind, the most one call
received) and print them per rank. The tables stay where they stand: no
call of a training step receives more than the rank's (V/m, d) rows of a
table, no call of a prefill or decode step as much, and no decode step as
much in all.

The attention wrappers count their padded calls too (``padded``): the
flash and backward rows carry them for phases 9 and 10
(``launches_padded``).

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

import contextlib
import copy
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
        pairs = fa_ops.visible_pairs(S, S, True, window)
        flops, nbytes = fa_ops.work(B, S, S, H, KV, D, D, window=window)
        b_ms, b_by = bound(nbytes, flops, "bf16")
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
        flops, nbytes = fa_ops.work(B_, Sq, Sk, H_, KV_, D_, D_, causal=c["causal"])
        b_ms, b_by = bound(nbytes, flops, "bf16")
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
    pairs = fa_ops.visible_pairs(S, S, True, 0)
    flops, nbytes = fa_ops.work(B, S, S, H, H, DQK, DV)
    b_ms, b_by = bound(nbytes, flops, "bf16")
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

        flops, nbytes = da_ops.work(B, H, KV, D, pos)
        b_ms, b_by = bound(nbytes, flops, "bf16")
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
        flops, nbytes = da_ops.work(B_, H_, KV_, D_, pos)
        b_ms, b_by = bound(nbytes, flops, "bf16")
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


HIER_CORE = (10_000, 100, 4_000)      # sites, tiers, jobs (the bench's 100,000 jobs cut to 4,000)


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
    counts (``by_pair``), the padded route's (``padded``) and the decode
    kernel's key-range entry's (``ranged``) with its total."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "by_pair"):
            fn.by_pair = {}
        if hasattr(fn, "padded"):
            fn.padded = 0
        if hasattr(fn, "ranged"):
            fn.ranged = 0


def padded_counts(counters: dict) -> dict:
    """Calls of each attention wrapper that took the padded route since its
    counts were last zeroed."""
    return {name: fn.padded for name, fn in counters.items() if hasattr(fn, "padded")}


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
    held = {n: (c.launches, dict(getattr(c, "by_pair", {})), getattr(c, "padded", 0)) for n, c in counters.items()}
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
        if hasattr(c, "padded"):
            c.padded += held[n][2]
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


REDUCED_MLA_PAIR = "64x64"   # the instance the reduced MLA widths (48, 32) are padded to (C6)


def moe_cli(torch) -> dict:
    """launch/serve.py --arch deepseek-v2-236b on the card (the CLI's
    reduced configuration: the engine's prefill is a lockstep decode, so
    MLA's absorbed decode runs it and no attention kernel), then that
    configuration's 128-token prefill through LM.forward, whose MLA
    widths (48, 32) have no flash instance and take the padded route to
    (64, 64)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models import LM

    (stats, reqs), wall, launches = counted(torch, lambda: serve.main(["--arch", "deepseek-v2-236b",
                                                                       "--device", "cuda"]))
    tokens = sum(len(r.generated) for r in reqs)
    check(stats.served == 16 and tokens == 128, f"serve.py deepseek-v2-236b: {stats}, {tokens} tokens")
    check(launches == {"flash_attention": 0, "decode_attention": 0}, f"serve.py deepseek-v2-236b launches {launches}")
    cfg = get_config("deepseek-v2-236b", reduced=True).replace(remat=False)
    lm = LM(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(SEED))
    prompt = torch.as_tensor(np.random.default_rng(SEED + 2).integers(0, cfg.vocab_size, (2, 128)), device="cuda")
    pairs: dict = {}
    before = fa_ops.flash_attention.padded
    (logits, _), prefill_s, prefill_launches = counted(torch, lambda: lm.forward(prompt), pairs)
    padded = fa_ops.flash_attention.padded - before
    check(bool(torch.isfinite(logits).all()), "reduced deepseek-v2 prefill logits not finite")
    check(prefill_launches["flash_attention"] == cfg.num_layers and padded == cfg.num_layers
          and pairs == {REDUCED_MLA_PAIR: cfg.num_layers},
          f"reduced deepseek-v2 prefill: launches {prefill_launches}, by instance {pairs}, padded {padded}")
    print(f"phase 9 launch/serve.py --arch deepseek-v2-236b (reduced) on the card: {wall:.3f} s, {stats.served} "
          f"served, {tokens} tokens, attention launches {launches}; its 128-token prefill through LM.forward: "
          f"{prefill_s:.3f} s, flash launches {pairs}, all {padded} padded (MLA widths 48 / 32 on 64 / 64)")
    del lm, logits
    return dict(wall_s=wall, served=stats.served, tokens=tokens, launches=launches, prefill_s=prefill_s,
                prefill_pairs=pairs, padded=padded)


def phase_moe(torch) -> dict:
    """Phase 9: deepseek-v2-236b in bf16 (served, prefilled, a decode step
    profiled) and in float32 (prefill ≡ decode), then deepseek-v3-671b,
    each at full width with its depth cut, freed before the next; then the
    serving CLI's reduced deepseek-v2 through the padded route."""
    out = {}
    for name, fn in (("deepseek-v2-236b (bf16)", moe_serving),
                     ("deepseek-v2-236b f32 prefill == decode", moe_oracle),
                     ("deepseek-v3-671b (bf16)", moe_v3),
                     ("launch/serve.py deepseek-v2-236b", moe_cli)):
        t0 = time.perf_counter()
        r = fn(torch)
        gc.collect()
        torch.cuda.empty_cache()
        r["part_s"] = time.perf_counter() - t0
        out[name] = r
        print(f"phase 9 {name}: {json.dumps(r)}")
    return out


# -- phase 2c / 10: flash attention's backward kernel and training -----------------

# The backward kernels (csrc/flash_attention_bwd.cu) against their plain
# version, before phase 10 relies on them, each fed the forward kernel's
# log-sum-exp (itself held to the plain version's): every (D, Dv)
# instance in both types, causal and not, window edges inside a tile,
# soft-cap 0 and 50, GQA rep 1, 2, 3, 4, 10 and 16, ragged lengths 77,
# 200 and 1,000, Sq < Sk and Sq > Sk non-causal (a cross layer's
# shapes), a window of 1 (each row sees only itself: P is one-hot, so dq
# and dk are zero but for rounding and are held against a floor of a
# tenth of the call's largest gradient, as tests/test_torch_flash_bwd.py
# holds them); k and v always two column ranges of one buffer (as MLA's),
# q and k drawn with a standard deviation of 1.5.
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
    (2, 64, 64, 2, 2, 32, 32, True, 1, 50.0),
    (2, 200, 77, 8, 2, 128, 128, False, 0, 0.0),
]
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # of max |plain|, for each of dq, dk, dv
LSE_TOL = 1e-4                                   # the forward's lse, of max |plain lse|
# The padded route (C6): widths with no instance run the smallest one
# that covers them on zero-padded inputs at the true width's scale:
# MLA's reduced (48, 32), the 100m preset's head_dim 80, and (192, 64);
# forward and backward in both types; the decode kernel at D 48 and 80.
PADDED_CASES = [
    # (B, Sq, Sk, H, KV, D, Dv, causal, window, softcap)
    (1, 200, 200, 4, 2, 48, 32, True, 0, 0.0),
    (2, 130, 130, 8, 4, 80, 80, True, 50, 50.0),
    (1, 77, 200, 4, 4, 192, 64, False, 0, 0.0),
]
PADDED_DECODE = [
    # (B, S, H, KV, D, pos, window, softcap)
    (4, 300, 8, 2, 48, 250, 0, 50.0),
    (4, 300, 8, 4, 80, 299, 100, 0.0),
]
# gemma2-9b's training layer: B 1, S 8,192 (max_seq_len), H 16 / KV 8,
# D 256, bf16, soft-cap 50; global (causal) and local (window 4,096).
BWD_ROW = dict(B=1, S=8192, H=16, KV=8, D=256, cap=50.0)


def grads_agree(torch, got, want, name: str, what: str, floor: float = 0.0) -> tuple[float, float]:
    """Each of dq, dk, dv within BWD_TOL[name] of max(max |plain|, floor)
    (``floor``: a tenth of the call's largest gradient where a window of 1
    makes dq and dk zero but for rounding, else 0), and in bf16, where the
    floor does not bind, the mean error under 1% of the mean |plain|;
    returns the largest (max_abs_err, max |diff| / that reference)."""
    worst, worst_rel = 0.0, 0.0
    for g, a, b in zip(("dq", "dk", "dv"), got, want):
        err = max_abs_err(torch, a, b)
        big = float(b.float().abs().max())
        ref = max(big, floor)
        check(err <= BWD_TOL[name] * ref, f"{what} {g}: max |diff| {err!r} > {BWD_TOL[name]} · {ref!r}")
        if name == "bfloat16" and big >= floor:
            rel = float((a.float() - b.float()).abs().mean() / b.float().abs().mean())
            check(rel < REL_BOUND, f"{what} {g}: mean error {rel!r} of mean |plain|")
        worst, worst_rel = max(worst, err), max(worst_rel, err / ref)
    return worst, worst_rel


def phase_flash_backward(torch):
    """Phase 2c: the backward kernels against their plain version on
    BWD_CASES (the forward's lse against the plain version's; the same
    bits on a second call), the padded route on PADDED_CASES and
    PADDED_DECODE, then the backward timed at gemma2-9b's two training
    layers beside its bound, its plain version and the backward alone of
    SDPA at cap 0, and the forward with and without its lse write."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def draw(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def one_case(case, name, dtype):
        """The forward with its lse and the backward from it, against the
        plain versions; returns (max_abs_err, relative, lse error)."""
        B, Sq, Sk, H, KV, D, Dv, causal, window, cap = case
        opts = dict(causal=causal, window=window, softcap=cap)
        q = draw((B, Sq, H, D), dtype, QK_STD)
        kv = torch.cat([draw((B, Sk, KV, D), dtype, QK_STD), draw((B, Sk, KV, Dv), dtype)], dim=-1)
        k, v = kv[..., :D], kv[..., D:]
        do = draw((B, Sq, H, Dv), dtype)
        o, lse = fa_ops.flash_attention(q, k, v, return_lse=True, **opts)
        plain_o, plain_lse = fa_ref.flash_attention_ref(q, k, v, return_lse=True, **opts)
        agree(torch, o, plain_o, ATTN_TOL[name], f"flash_attention {case} {name}")
        lse_err = max_abs_err(torch, lse, plain_lse)
        check(lse_err <= LSE_TOL * float(plain_lse.abs().max()), f"flash_attention {case} {name}: lse {lse_err!r}")
        got = fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **opts)
        again = fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse, **opts)
        want = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, **opts)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"flash_attention_bwd {case} {name}: "
              "a second call gave other bits")
        floor = 0.1 * max(float(w.float().abs().max()) for w in want) if window == 1 else 0.0
        err, rel = grads_agree(torch, got, want, name, f"flash_attention_bwd {case} {name}", floor)
        return err, rel, lse_err

    for case in BWD_CASES:
        for name, dtype in dt.items():
            err, rel, lse_err = one_case(case, name, dtype)
            print(f"phase 2 flash_attention_bwd {case} {name}: max_abs_err {err!r} ({rel!r} of max |plain|); "
                  f"forward lse max_abs_err {lse_err!r}; the same bits twice")
    for case in PADDED_CASES:
        for name, dtype in dt.items():
            pair = fa_ops.instance(case[5], case[6])
            before = (fa_ops.flash_attention.padded, fa_ops.flash_attention_bwd.padded,
                      fa_ops.flash_attention_bwd.by_pair.get(pair, 0))
            err, rel, lse_err = one_case(case, name, dtype)
            after = (fa_ops.flash_attention.padded, fa_ops.flash_attention_bwd.padded,
                     fa_ops.flash_attention_bwd.by_pair.get(pair, 0))
            check(after[0] - before[0] >= 1 and after[1] - before[1] == 2 and after[2] - before[2] == 2,
                  f"padded {case} {name}: the padded route did not run ({before} -> {after})")
            print(f"phase 2 padded flash_attention {case[5:7]} on instance {pair} {case} {name}: backward "
                  f"max_abs_err {err!r} ({rel!r} of max |plain|), forward lse max_abs_err {lse_err!r}")
    for case in PADDED_DECODE:
        B, S, H, KV, D, pos, window, cap = case
        for name, dtype in dt.items():
            q, k, v = draw((B, H, D), dtype, QK_STD), draw((B, S, KV, D), dtype, QK_STD), draw((B, S, KV, D), dtype)
            before = da_ops.decode_attention.padded
            out = da_ops.decode_attention(q, k, v, pos, window=window, softcap=cap)
            check(da_ops.decode_attention.padded == before + 1, f"padded decode {case}: the route did not run")
            err, rel = agree(torch, out, da_ref.decode_attention_ref(q, k, v, pos, window=window, softcap=cap),
                             ATTN_TOL[name], f"padded decode_attention {case} {name}")
            print(f"phase 2 padded decode_attention D {D} on instance {da_ops.instance(D)} {case} {name}: "
                  f"max_abs_err {err!r} ({rel!r} mean error / mean |plain|)")
    torch.cuda.empty_cache()

    bf = torch.bfloat16
    B, S, H, KV, D, cap = (BWD_ROW[k] for k in ("B", "S", "H", "KV", "D", "cap"))
    q, k, v = draw((B, S, H, D), bf, QK_STD), draw((B, S, KV, D), bf, QK_STD), draw((B, S, KV, D), bf)
    do = draw((B, S, H, D), bf)
    rows = {}
    for window in (0, 4096):
        o, lse = fa_ops.flash_attention(q, k, v, window=window, softcap=cap, return_lse=True)
        got = fa_ops.flash_attention_bwd(q, k, v, o, do, window=window, softcap=cap, lse=lse)
        want = fa_ref.flash_attention_bwd_ref(q, k, v, o, do, window=window, softcap=cap)
        torch.cuda.synchronize()
        err, rel = grads_agree(torch, got, want, "bfloat16", f"flash_attention_bwd at gemma2's training layer "
                                                            f"(window {window})")
        del got, want
        torch.cuda.empty_cache()
        pairs = fa_ops.visible_pairs(S, S, True, window)
        flops, nbytes = fa_ops.bwd_work(B, S, S, H, KV, D, D, window=window)
        b_ms, b_by = bound(nbytes, flops, "bf16")
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        run = fa_ops.bwd_launcher(q, k, v, o, do, dq, dk, dv, lse=lse, window=window, softcap=cap)
        o0, lse0 = fa_ops.flash_attention(q, k, v, window=window, return_lse=True)
        o2 = torch.empty_like(o)
        rows[window] = dict(
            ms=kernel_ms(torch, run, reps=5, inner=4),
            ms_softcap0=kernel_ms(torch, fa_ops.bwd_launcher(q, k, v, o0, do, dq, dk, dv, lse=lse0, window=window),
                                  reps=5, inner=4),
            plain_ms=kernel_ms(torch, lambda: fa_ref.flash_attention_bwd_ref(q, k, v, o, do, window=window,
                                                                             softcap=cap), reps=2, inner=1),
            # the forward's own time without and with its lse write (the
            # serving path passes none; training writes it)
            fwd_ms=kernel_ms(torch, fa_ops.launcher(q, k, v, o2, window=window, softcap=cap)),
            fwd_lse_ms=kernel_ms(torch, fa_ops.launcher(q, k, v, o2, lse=torch.empty_like(lse0), window=window,
                                                        softcap=cap)),
            # device time by kernel of one backward call (Δ, kernel A, kernel B)
            kernels=step_trace(torch, run, 2)["top"],
            bound_ms=b_ms, bound_by=b_by, max_abs_err=err, max_rel_err=rel, pairs=pairs)
        rows[window]["bound_share"] = b_ms / rows[window]["ms"]
        del dq, dk, dv, o, o0, o2, lse, lse0
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
              f"softcap 0 {r['library_ms']:.6f} ms ({r['library_backend']}), max_abs_err {r['max_abs_err']!r}; "
              f"by kernel {json.dumps(r['kernels'])}; the forward {r['fwd_ms']:.6f} ms, with its lse write "
              f"{r['fwd_lse_ms']:.6f} ms")
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
    once) plus attention's products (the flash kernels' ``work``: forward
    4·D and backward 2·(3·D + 2·D) a pair and head), global layers causal,
    local ones within the window."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.common import layer_flags

    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    attn = 0.0
    for g in layer_flags(cfg)["is_global"]:
        window = 0 if g else cfg.local_window
        attn += (fa_ops.work(B, S, S, H, KV, D, D, window=window)[0]
                 + fa_ops.bwd_work(B, S, S, H, KV, D, D, window=window)[0])
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


def train_cli_moe(torch) -> dict:
    """Phase 10.5: launch/train.py --arch deepseek-v2-236b --reduced on the
    card, 3 steps: MLA's reduced widths (48, 32) through the padded route,
    forward and backward."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train

    counters = train_counters()
    held = padded_counts(counters)
    (_, opt), wall, launches = counted(torch, lambda: train.main(["--arch", "deepseek-v2-236b", "--reduced",
                                                                   "--steps", "3", "--device", "cuda"]),
                                       counters=counters)
    padded = {n: c - held[n] for n, c in padded_counts(counters).items()}
    check(int(opt["step"]) == 3, f"train.py deepseek-v2-236b: step {int(opt['step'])}")
    check(launches["flash_attention_bwd"] > 0 and padded["flash_attention_bwd"] == launches["flash_attention_bwd"]
          and padded["flash_attention"] == launches["flash_attention"],
          f"train.py deepseek-v2-236b: launches {launches}, padded {padded}")
    bad = [k for k, m in opt["m"].items() if not bool(torch.isfinite(m).all())]
    check(not bad, f"train.py deepseek-v2-236b: moments not finite in {bad[:4]}")
    print(f"phase 10 launch/train.py --arch deepseek-v2-236b --reduced --steps 3 on the card: {wall:.3f} s, "
          f"launches {launches}, padded {padded} (MLA's 48 / 32 on the {fa_ops.instance(48, 32)} instance)")
    return dict(wall_s=wall, launches=launches, padded=padded)


def phase_train(torch) -> dict:
    """Phase 10: gemma2-9b training on the card, each model freed before
    the next; then the training CLI's reduced deepseek-v2 through the
    padded route."""
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for name, fn in (("bf16 main", train_main), ("f32 oracle", train_oracle), ("restart", train_restart),
                     ("cli", train_cli), ("cli deepseek-v2-236b", train_cli_moe)):
        t0 = time.perf_counter()
        r = fn(torch)
        gc.collect()
        torch.cuda.empty_cache()
        r["part_s"] = time.perf_counter() - t0
        out[name] = r
        print(f"phase 10 {name} in {r['part_s']:.3f} s")
    return out


# -- phase 11: the serve step and the dry run against the card ----------------------
#
# 11.1: gemma2-9b at its published width and depth (42 layers, bf16) through
# runtime.serve.build_serve_step, B 4 over a max_len 8,192 cache: steps at
# positions 0-15 from an empty cache, then one at 8,191 over a cache filled
# from a seeded generator, each bit-equal to decode.decode_step on a copy of
# the same cache. 11.2: three cells cut to one card, each run once on the
# meta device by launch.dryrun and once on the card with arguments of
# input_specs' shapes and types: (a) that decode step at 8,191, (b) a B 1 x
# S 8,192 prefill at 42 layers, (c) phase 10's training step (8 layers, B 1
# x S 8,192, remat, AdamW).
SERVE11 = dict(B=4, max_len=8192, steps=16, seed=11)
PEAK_TOL = 0.10       # |meta high-water − card peak| ≤ PEAK_TOL · card peak


def cache_tree(tree) -> dict:
    """{name: (shape, type)} of a cache tree."""
    return {k: cache_tree(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype)) for k, v in tree.items()}


def tree_leaves(tree):
    for v in tree.values():
        yield from (tree_leaves(v) if isinstance(v, dict) else (v,))


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def abstract_caches(torch) -> dict:
    """runtime.serve.abstract_cache against init_cache on the card, in shape
    and type, for every family at the configuration phases 8-9 serve it
    (each model allocated, not initialised, and freed before the next):
    recurrentgemma-2b and mamba2-780m at the engine's 4 slots x 64,
    llama-3.2-vision-11b at 1 x 64 over its image tokens, whisper-base at
    1 x 448 over 448 frames (the reference's stub gives max_len frames),
    deepseek-v2 (6 layers) and v3 (4 layers) at 4 x 64."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM, decode
    from repro_torch.runtime.serve import abstract_cache

    out = {}
    for arch, (B, max_len), cut in (("recurrentgemma-2b", (4, 64), {}), ("mamba2-780m", (4, 64), {}),
                                    ("llama-3.2-vision-11b", (1, 64), {}), ("whisper-base", (1, WHISPER_TOKENS), {}),
                                    ("deepseek-v2-236b", (4, 64), MOE_CUTS["deepseek-v2-236b"]),
                                    ("deepseek-v3-671b", (4, 64), MOE_CUTS["deepseek-v3-671b"])):
        cfg = get_config(arch).replace(**cut)
        lm = LM(cfg, device="cuda")
        kw = {}
        if cfg.family == "vlm":
            kw["image_embeds"] = torch.zeros((B, cfg.num_image_tokens, cfg.d_model), dtype=cfg.cdtype, device="cuda")
        if cfg.family == "encdec":
            kw["audio_embeds"] = torch.zeros((B, max_len, cfg.d_model), dtype=cfg.cdtype, device="cuda")
        with torch.no_grad():
            cache = decode.init_cache(lm, B, max_len, **kw)
        want, got = cache_tree(cache), cache_tree(abstract_cache(lm, B, max_len))
        check(want == got, f"phase 11 {arch}: abstract_cache {got} != init_cache {want}")
        out[arch] = dict(batch=B, max_len=max_len, cache_bytes=tree_bytes(cache))
        del lm, cache, kw
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 11 abstract_cache == init_cache on the card (shape, type): {json.dumps(out)}")
    return out


def serve_step_phase(torch, lm) -> tuple[dict, dict]:
    """11.1 on gemma2-9b (42 layers, bf16, on the card): returns (results,
    the filled cache after its step at max_len − 1)."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.models import decode
    from repro_torch.runtime.serve import build_serve_step

    cfg = lm.cfg
    B, max_len = SERVE11["B"], SERVE11["max_len"]
    dev = torch.device("cuda")
    step, cache_abs = build_serve_step(lm, B, max_len)
    cache = decode.init_cache(lm, B, max_len)
    check(cache_tree(cache_abs) == cache_tree(cache), "phase 11 abstract_cache != init_cache for gemma2-9b")
    twin = {k: v.clone() for k, v in cache.items()}
    rng = np.random.default_rng(SERVE11["seed"])
    kernel = da_ops.decode_attention
    per_step = []

    def one(pos):
        nonlocal cache, twin
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32), device=dev)
        n0, p0 = kernel.launches, kernel.padded
        got, cache = step(tok, cache, pos)
        torch.cuda.synchronize()
        per_step.append((kernel.launches - n0, kernel.padded - p0))
        want, twin = decode.decode_step(lm, tok, twin, pos)
        check(torch.equal(got, want), f"phase 11 serve step at pos {pos} != decode_step")
        check(tuple(got.shape) == (B, 1, cfg.padded_vocab) and bool(torch.isfinite(got).all()),
              f"phase 11 serve step logits at pos {pos}")

    t0 = time.perf_counter()
    for pos in range(SERVE11["steps"]):
        one(pos)
    gen = torch.Generator(device=dev).manual_seed(SERVE11["seed"])
    for k in cache:
        cache[k].copy_(torch.randn(cache[k].shape, generator=gen, device=dev).to(cache[k].dtype))
        twin[k].copy_(cache[k])
    one(max_len - 1)
    for k in cache:
        check(torch.equal(cache[k], twin[k]), f"phase 11 serve step cache {k} != decode_step's")
    wall = time.perf_counter() - t0
    check(all(p == (cfg.num_layers, 0) for p in per_step),
          f"phase 11 decode launches (count, padded) a serve step {per_step}")
    print(f"phase 11.1 gemma2-9b serve step (B {B}, max_len {max_len}): positions 0-{SERVE11['steps'] - 1} and "
          f"{max_len - 1} bit-equal to decode_step, {cfg.num_layers} decode launches a step (padded 0), "
          f"{wall:.3f} s")
    del twin
    return dict(steps=len(per_step), launches_per_step=cfg.num_layers, padded=0, wall_s=wall), cache


def dry_cell(torch, lm_card, sh, args: dict, *, reps: int) -> dict:
    """11.2 for one cell: the dry run on a meta twin of ``lm_card`` against
    the card: FLOPs (exact), argument bytes (exact), high-water mark (within
    PEAK_TOL of max_memory_allocated), the measured median step beside
    step_time_lower_bound_s. The step is timed without the analysis and
    counted in a separate pass."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import mesh_from_arg
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models import LM

    cfg = lm_card.cfg
    t0 = time.perf_counter()
    lm_meta = LM(cfg, device="meta")
    cost, meta_args, outs, _ = dryrun.analyze_step(lm_meta, sh)
    total, active = dryrun.count_params(lm_meta, cfg)
    rec = dryrun.cell_record(cfg, sh, mesh_from_arg("1"), cost, meta_args, outs, total, active)
    meta_s = time.perf_counter() - t0
    card_args = sum(tree_bytes(v) for v in args.values())
    check(card_args == rec["memory"]["argument_bytes"],
          f"phase 11 {sh.name}: argument bytes on the card {card_args} != dry run's {rec['memory']['argument_bytes']}")
    step = dryrun.make_step(lm_card, sh)
    with OpAnalysis() as mode:
        step(args)
        torch.cuda.synchronize()
    check(mode.cost.flops == rec["cost"]["hlo_flops"],
          f"phase 11 {sh.name}: FLOPs on the card {mode.cost.flops} != dry run's {rec['cost']['hlo_flops']}")
    check(mode.cost.by_kernel == rec["kernels"], f"phase 11 {sh.name}: kernel work {mode.cost.by_kernel} != "
                                                  f"dry run's {rec['kernels']}")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(reps):
        t1 = time.perf_counter()
        step(args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated()
    pred = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
    check(abs(pred - peak) <= PEAK_TOL * peak, f"phase 11 {sh.name}: dry-run high-water {pred} vs card peak {peak}")
    step_s = statistics.median(times)
    bound_s = rec["step_time_lower_bound_s"]
    r = dict(cell=sh.name, kind=sh.kind, seq_len=sh.seq_len, batch=sh.global_batch, layers=cfg.num_layers,
             flops=mode.cost.flops, argument_bytes=card_args, meta_high_water=pred, card_peak=peak,
             card_allocated_before=base, peak_ratio=pred / peak, step_s=step_s, step_times_s=times,
             step_time_lower_bound_s=bound_s, dominant_term=rec["dominant_term"], step_over_bound=step_s / bound_s,
             meta_analysis_s=meta_s, kernels=rec["kernels"])
    print(f"phase 11.2 {sh.name}: FLOPs {mode.cost.flops} (meta = card), argument bytes {card_args} (meta = card), "
          f"high-water {pred} vs card peak {peak} (ratio {pred / peak:.6f}); step median {step_s:.6f} s of {reps}, "
          f"bound {bound_s:.6f} s ({rec['dominant_term']}), step / bound {step_s / bound_s:.6f}")
    print(f"phase 11.2 record {sh.name}: {json.dumps(rec)}")
    return r


def phase_dryrun_on_card(torch) -> dict:
    """Phase 11: abstract caches of every family, the serve step (11.1),
    then the three dry-run cells against the card (11.2)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import Shape, input_specs
    from repro_torch.models import LM
    from repro_torch.runtime import init_opt_state

    out = {"abstract_caches": abstract_caches(torch)}
    dev = torch.device("cuda")
    cfg = get_config("gemma2-9b")
    lm = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    out["serve_step"], cache = serve_step_phase(torch, lm)

    def card_batch(sh, drop=()):
        """Tensors of input_specs' shapes and types on the card: tokens
        (and labels) from a seeded generator."""
        rng = np.random.default_rng(SEED + 11)
        return {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, tuple(v.shape)).astype(np.int32), device=dev)
                for k, v in input_specs(cfg, sh).items() if k not in drop}

    B, max_len = SERVE11["B"], SERVE11["max_len"]
    sh = Shape("decode_8k_b4", max_len, B, "decode")
    out["decode"] = dry_cell(torch, lm, sh, {"params": dict(lm.named_parameters()), "cache": cache,
                                             "batch": card_batch(sh)}, reps=10)
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    sh = Shape("prefill_8k_b1", PREFILL["S"], 1, "prefill")
    out["prefill"] = dry_cell(torch, lm, sh, {"params": dict(lm.named_parameters()), "batch": card_batch(sh)},
                              reps=3)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    cfg, lm = gemma2_train(torch, TRAIN["layers"])
    sh = Shape("train_8k_b1", TRAIN["S"], TRAIN["B"], "train")
    opt = init_opt_state(lm)
    out["train"] = dry_cell(torch, lm, sh, {"params": dict(lm.named_parameters()), "opt": opt,
                                            "batch": card_batch(sh)}, reps=3)
    del lm, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 12: the sharded decode paths, four ranks on the one card -------------------
#
# (a) In this process: the decode kernel's key-range entry at gemma2-9b's
# decode shape, the 8,192-key cache cut into 4 ranges of 2,048, each
# range's (out, lse) combined and held against the whole-cache kernel and
# the plain version, at pos 8,191 and at 4,095 (two ranges see no key);
# each range's launch timed beside its byte bound. (b)-(d) four spawned
# ranks on a 2 x 2 ("data", "model") mesh, gloo on cuda:0
# (launch.mesh.run_ranks), each against this process's one-process
# result: gemma2-9b at published width through build_serve_step(...,
# mesh=...), B 4 over max_len 8,192 caches filled from a seeded generator,
# steps at positions that cross the 4,096 ring's wrap; one deepseek-v2-236b
# MLA layer (mla_decode_sharded against mla_decode); one deepseek-v2-236b
# moe layer, the a2a dispatch (2-D EP, 160 experts over 4 ranks) on
# B 2 x S 512 against the gather dispatch. (e) Short caches that the rules
# cut otherwise than along S (PH12_SHORT): gemma2-9b at published width
# with every cache along D (f32, B 4 over max_len 128 on the 2 x 2 mesh)
# and along its rows (bf16, B 320 over max_len 128 on a TP-only 1 x 4 mesh
# over the same ranks; B above 256, the head width, and small enough that
# the rows' logits, gathered whole along V, stay below the rank's rows of
# the table that check_received holds a decode step under), each rank's
# rows held to one process on the card (written to a file the ranks
# read), storage held to the rules' bytes.
PH12 = dict(mesh={"data": 2, "model": 2}, B=4, max_len=8192, steps=(0, 1, 4095, 4096, 4097, 8191), seed=12,
            layers={"float32": 2, "bfloat16": 4})
RANGE12 = dict(B=4, S=8192, H=16, KV=8, D=256, cap=50.0, ranges=4, positions=(8191, 4095))
MLA12 = dict(B=4, max_len=8192, steps=(0, 4095, 4096, 8191))
MOE12 = dict(B=2, S=512, capacity_factor=64.0)   # the dropless cut: neither dispatch drops a token
# Phase 12 (b)'s serve passes: (name, dtype, serving's ZeRO forced). The third holds the weight-stationary
# tables (vocab over 'model', width over 'data', as published gemma2-9b is served on 2 x 2) to float32's limits.
PASSES12 = (("float32", "float32", False), ("bfloat16", "bfloat16", False), ("float32_zero3", "float32", True))
# (e): (name, dtype, mesh, B, max_len, positions, layers, the dimension the rules cut each cache along over 'model')
PH12_SHORT = (("float32_d", "float32", {"data": 2, "model": 2}, 4, 128, (0, 1, 127), 2, 3),
              ("bfloat16_rows", "bfloat16", {"data": 1, "model": 4}, 320, 128, (0, 1, 127), 4, 0))
F32_TOL = 2e-4        # the reference test's decode tolerance (tests/models/test_sharded_decode.py)
BF16_REL = 2e-2       # bf16: max |sharded − one process| ≤ BF16_REL · max |one process|
AUX_RTOL = 1e-3


def combine_ranges(torch, pairs):
    """The ranks' combine of (out, lse) pairs: M = max lse, w = e^(lse − M),
    out = Σ w·out / Σ w (models.attention.decode_attention_sharded)."""
    outs, lses = torch.stack([o for o, _ in pairs]), torch.stack([m for _, m in pairs])
    M = lses.amax(0)
    w = torch.exp(lses - torch.where(torch.isfinite(M), M, torch.zeros_like(M)))
    return (w[..., None] * outs).sum(0) / w.sum(0)[..., None]


def range_entry(torch) -> dict:
    """12a: the key-range entry at gemma2-9b's decode shape, in this process."""
    from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    B, S, H, KV, D, cap, m = (RANGE12[k] for k in ("B", "S", "H", "KV", "D", "cap", "ranges"))
    bf = torch.bfloat16
    q = (torch.randn((B, H, D), generator=gen, device=dev) * QK_STD).to(bf)
    k = (torch.randn((B, S, KV, D), generator=gen, device=dev) * QK_STD).to(bf)
    v = torch.randn((B, S, KV, D), generator=gen, device=dev).to(bf)
    n = S // m
    sl = [slice(r * n, (r + 1) * n) for r in range(m)]
    out = {"checks": {}}
    for pos in RANGE12["positions"]:
        pairs = [da_ops.decode_attention(q, k[:, s], v[:, s], pos, softcap=cap, key0=s.start, lse=True) for s in sl]
        plain = [da_ref.decode_attention_ref(q, k[:, s], v[:, s], pos, softcap=cap, key0=s.start, lse=True) for s in sl]
        torch.cuda.synchronize()
        lse_err, empty = 0.0, []
        for r, ((o, lse), (po, pl)) in enumerate(zip(pairs, plain)):
            check(not bool(torch.isnan(o).any() or torch.isnan(lse).any()), f"phase 12a range {r} at {pos}: NaN")
            if da_ops.visible_keys(pos, key0=sl[r].start, S=n) == 0:
                check(torch.equal(o, torch.zeros_like(o)) and bool((lse == float("-inf")).all())
                      and bool((pl == float("-inf")).all()), f"phase 12a range {r} at {pos}: not (0, -inf)")
                empty.append(r)
                continue
            agree(torch, o, po, ATTN_TOL["bfloat16"], f"phase 12a range {r} at {pos} out")
            lse_err = max(lse_err, max_abs_err(torch, lse, pl))
        check(lse_err <= 1e-4 * float(plain[0][1].abs().max()) + 1e-4, f"phase 12a lse error {lse_err!r}")
        got = combine_ranges(torch, pairs).to(bf)
        whole = da_ops.decode_attention(q, k, v, pos, softcap=cap)
        ref = da_ref.decode_attention_ref(q, k, v, pos, softcap=cap)
        torch.cuda.synchronize()
        e_w, _ = agree(torch, got, whole, ATTN_TOL["bfloat16"], f"phase 12a combined at {pos} vs the whole-cache kernel")
        e_p, _ = agree(torch, got, ref, ATTN_TOL["bfloat16"], f"phase 12a combined at {pos} vs the plain version")
        out["checks"][str(pos)] = dict(empty_ranges=empty, max_abs_err_whole=e_w, max_abs_err_plain=e_p,
                                       lse_max_abs_err=lse_err)
    pos = RANGE12["positions"][0]
    o = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    ms = [kernel_ms(torch, da_ops.launcher(q, k[:, s], v[:, s], o, pos, softcap=cap, key0=s.start, lse=lse))
          for s in sl]
    flops, nbytes = da_ops.work(B, H, KV, D, pos, key0=sl[0].start, S=n, lse=True)
    b_ms, b_by = bound(nbytes, flops, "bf16")
    r0 = sl[0]
    plain_ms = kernel_ms(torch, lambda: da_ref.decode_attention_ref(q, k[:, r0], v[:, r0], pos, softcap=cap, lse=True),
                         reps=3, inner=2)
    # the library: one cuDNN SDPA call that returns the lse, on range 0 (every key visible at pos 8,191), at
    # soft-cap 0 (SDPA has none); a kv head's query heads are its query rows, so K and V are read once
    qg, kg, vg = q.view(B, KV, H // KV, D), k[:, r0].transpose(1, 2), v[:, r0].transpose(1, 2)
    library = lambda: torch.ops.aten._scaled_dot_product_cudnn_attention(qg, kg, vg, None, True)[:2]  # noqa: E731
    lib_o, lib_lse = library()
    own_o, own_lse = da_ops.decode_attention(q, k[:, r0], v[:, r0], pos, key0=0, lse=True)
    torch.cuda.synchronize()
    lib_err, _ = agree(torch, lib_o.reshape(B, H, D), own_o.to(bf), ATTN_TOL["bfloat16"],
                       "phase 12a key-range entry at cap 0 vs cuDNN SDPA")
    lib_lse_err = max_abs_err(torch, lib_lse.reshape(B, H), own_lse)
    check(lib_lse_err <= 1e-2, f"phase 12a key-range lse at cap 0 vs cuDNN SDPA's: {lib_lse_err!r}")
    out.update(shape=[B, n, H, KV, D], ranges=m, cache_len=S, pos=pos, ms_per_range=ms, ms=statistics.median(ms),
               bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / statistics.median(ms), plain_ms=plain_ms,
               ms_softcap0=kernel_ms(torch, da_ops.launcher(q, k[:, r0], v[:, r0], o, pos, key0=0, lse=lse)),
               library_ms=kernel_ms(torch, library), library_backend="cudnn", library_max_abs_err=lib_err,
               library_lse_max_abs_err=lib_lse_err, max_abs_err=out["checks"][str(pos)]["max_abs_err_plain"],
               whole_cache_ms=kernel_ms(torch, lambda: da_ops.decode_attention(q, k, v, pos, softcap=cap)))
    print(f"phase 12a key-range entry {out['shape']} x {m} ranges: {json.dumps(out)}")
    del q, k, v, o, lse
    torch.cuda.empty_cache()
    return out


def gemma12(torch, dtype: str, dev, layers: int | None = None):
    """gemma2-9b at published width, depth cut to PH12's layers (or
    ``layers``), from the seed."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config("gemma2-9b").replace(num_layers=layers or PH12["layers"][dtype], param_dtype=dtype,
                                          compute_dtype=dtype)
    return cfg, LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(PH12["seed"]))


def cache12(torch, lm, B: int = PH12["B"], max_len: int = PH12["max_len"]) -> dict:
    """The global caches of B x max_len, every slot from a seeded generator."""
    from repro_torch.models import decode

    cache = decode.init_cache(lm, B, max_len)
    gen = torch.Generator(device=lm.device).manual_seed(PH12["seed"] + 1)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=lm.device).to(t.dtype))
    return cache


def tokens12(vocab: int, B: int = PH12["B"], steps: int = len(PH12["steps"])) -> np.ndarray:
    return np.random.default_rng(PH12["seed"]).integers(0, vocab, (B, steps)).astype(np.int32)


def short12_want(torch, dev, work: Path) -> dict:
    """(e)'s one-process logits of each PH12_SHORT pass, stacked by step,
    written to ``work``/<name>.npy for the ranks; returns their files."""
    from repro_torch.models import decode

    out = {}
    for name, dtype, _, B, max_len, positions, layers, _ in PH12_SHORT:
        cfg, lm = gemma12(torch, dtype, dev, layers)
        toks = tokens12(cfg.vocab_size, B, len(positions))
        cache = cache12(torch, lm, B, max_len)
        rows = []
        for n, pos in enumerate(positions):
            logits, cache = decode.decode_step(lm, torch.as_tensor(toks[:, n:n + 1], device=dev), cache, pos)
            rows.append(logits.float().cpu().numpy())
        out[name] = str(work / f"{name}.npy")
        np.save(out[name], np.stack(rows))
        del lm, cache, logits, rows
        gc.collect()
        torch.cuda.empty_cache()
    return out


def short12_rank(torch, mesh, files: dict) -> dict:
    """(e) on this rank: each PH12_SHORT pass through ``build_serve_step``
    under its mesh (the 1 x 4 one made over the same ranks), its caches'
    cut, holding, counts and times, and its rows' largest error against the
    one-process logits in ``files`` beside their largest |logit|, whether
    the greedy tokens agree and, where not, whether the one process's two
    largest logits lie within the limit of each other."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention, decode
    from repro_torch.runtime.pspec import logical_axis_rules
    from repro_torch.runtime.serve import build_serve_step
    from repro_torch.runtime.sharding import block_index, local_block

    res = {}
    for name, dtype, shape, B, max_len, positions, layers, _ in PH12_SHORT:
        on = mesh if shape == dict(mesh) else make_mesh(shape)
        cfg, lm = gemma12(torch, dtype, on.device, layers)
        toks = tokens12(cfg.vocab_size, B, len(positions))
        step, (_, csh, tsh, _), _ = build_serve_step(lm, B, max_len, mesh=on)
        full = cache12(torch, lm, B, max_len)
        with logical_axis_rules(on):
            cache = decode.init_cache(lm, B, max_len)
        for k in cache:
            cache[k].copy_(local_block(full[k], csh[k], on))
        del full, lm
        gc.collect()
        torch.cuda.empty_cache()
        held = holding(torch, step, cache, cfg, on, B, max_len, f"phase 12e {name}")
        want = np.load(files[name], mmap_mode="r")
        idx, blocks = block_index(on, tsh[0], on.coords)
        lo = idx * (B // blocks)
        errs, big, same, ties, counts, times = 0.0, 0.0, 0, 0, [], []
        for n, pos in enumerate(positions):
            tok = local_block(torch.as_tensor(toks[:, n:n + 1], device=on.device), tsh, on)
            before = (attention.decode_attention_sharded.calls, attention.decode_mlp_sharded.calls,
                      decode.gathered_layer.calls, da_ops.decode_attention.launches, da_ops.decode_attention.ranged)
            torch.cuda.synchronize()
            zero_received()
            t1 = time.perf_counter()
            logits, cache = step(tok, cache, pos)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            log_received("decode", cfg, on, n)
            after = (attention.decode_attention_sharded.calls, attention.decode_mlp_sharded.calls,
                     decode.gathered_layer.calls, da_ops.decode_attention.launches, da_ops.decode_attention.ranged)
            counts.append(dict(zip(("attention", "mlp", "gathered", "decode_launches", "range_launches"),
                                   (a - b for a, b in zip(after, before)))))
            got = logits.float().cpu().numpy()
            ref = np.asarray(want[n, lo:lo + got.shape[0]])
            errs, big = max(errs, float(np.abs(got - ref).max())), max(big, float(np.abs(ref).max()))
            top2 = np.sort(ref, axis=-1)[..., -2:]
            agree_ = got.argmax(-1) == ref.argmax(-1)
            picked = np.take_along_axis(ref, got.argmax(-1)[..., None], -1)[..., 0]
            tie = (top2[..., 1] - top2[..., 0]) <= BF16_REL * np.abs(ref).max()
            same += int(agree_.sum())
            ties += int((~agree_ & ~(tie & (top2[..., 1] - picked <= BF16_REL * np.abs(ref).max()))).sum())
        del step, cache, logits, want
        gc.collect()
        torch.cuda.empty_cache()
        res[name] = dict(max_abs_err=errs, max_abs_ref=big, argmax_same=same, argmax_off_outside_ties=ties,
                         rows=B // blocks, counts=counts,
                         step_s=times, holding=held, layers=layers,
                         cuts={k: v for k, v in decode.cache_cuts(cfg, csh, on).items()})
    return res


def mla12(torch, dev):
    """One deepseek-v2-236b MLA layer at published width (bf16), its global
    latent caches and the steps' inputs, from seeded generators."""
    from repro_torch.configs import get_config
    from repro_torch.models.mla import init_mla, init_mla_

    cfg = get_config("deepseek-v2-236b")
    gen = torch.Generator(device=dev).manual_seed(PH12["seed"] + 2)
    p = init_mla(cfg, dev)
    init_mla_(p, cfg, gen)
    for name in ("q_norm", "kv_norm"):
        p[name].normal_(0.0, 0.1, generator=gen)
    B, L = MLA12["B"], MLA12["max_len"]
    caches = {"c_kv": torch.randn((B, L, cfg.kv_lora_rank), generator=gen, device=dev).to(cfg.cdtype),
              "k_rope": torch.randn((B, L, cfg.qk_rope_head_dim), generator=gen, device=dev).to(cfg.cdtype)}
    xs = [(torch.randn((B, 1, cfg.d_model), generator=gen, device=dev) * 0.3).to(cfg.cdtype) for _ in MLA12["steps"]]
    return cfg, dict(p), caches, xs


def moe12_cfg():
    from repro_torch.configs import get_config

    return get_config("deepseek-v2-236b").replace(capacity_factor=MOE12["capacity_factor"])


def moe12(torch, dev, experts=None):
    """One deepseek-v2-236b moe layer at published width (bf16), capacity
    factor cut to 64: the router, the ``experts`` (all by default; each
    expert's weights from a generator seeded by its index, so that a rank
    draws its block alone), the shared experts, and x (B, S, d) of
    standard deviation 0.3."""
    cfg = moe12_cfg()
    E, d, f, dt = cfg.num_experts, cfg.d_model, cfg.moe_d_ff, cfg.pdtype
    experts = range(E) if experts is None else experts
    gen = torch.Generator(device=dev)

    def w(shape, fan_in, seed, dtype=dt):
        gen.manual_seed(seed)
        return (torch.randn(shape, generator=gen, device=dev) / math.sqrt(fan_in)).to(dtype)

    base = PH12["seed"] * 10_000
    p = {"router": w((d, E), d, base, torch.float32)}
    for j, (name, shape, fan) in enumerate((("w_gate", (d, f), d), ("w_up", (d, f), d), ("w_down", (f, d), f))):
        t = torch.empty((len(experts), *shape), dtype=dt, device=dev)
        for i, e in enumerate(experts):
            t[i] = w(shape, fan, base + 1 + 3 * e + j)
        p[name] = t
    fs = f * cfg.num_shared_experts
    p["shared"] = {"w_gate": w((d, fs), d, base - 1), "w_up": w((d, fs), d, base - 2), "w_down": w((fs, d), fs, base - 3)}
    gen.manual_seed(base - 4)
    x = (torch.randn((MOE12["B"], MOE12["S"], d), generator=gen, device=dev) * 0.3).to(dt)
    return cfg, p, x


def kernel_counters() -> dict:
    from repro_torch.kernels.cost_matrix import ops as cm_ops
    from repro_torch.kernels.priority_requeue import ops as pr_ops

    return dict(train_counters(), cost_matrix_f32=cm_ops.cost_matrix_classed, cost_matrix_f64=cm_ops.cost_matrix_f64,
                cost_argmin_f64=cm_ops.cost_argmin_f64, priority_requeue=pr_ops.priority_requeue)


@contextlib.contextmanager
def serving_zero3(force: bool):
    """Serving's ZeRO (the tables' width cut over 'data' too) forced inside
    where ``force``: the port's serving budget set to 0 bytes."""
    from repro_torch.runtime import sharding

    held = sharding._SERVE_ZERO3_BUDGET
    if force:
        sharding._SERVE_ZERO3_BUDGET = 0
    try:
        yield
    finally:
        sharding._SERVE_ZERO3_BUDGET = held


# -- a sharded serve step's holdings ----------------------------------------------
#
# Phases 12 (b), 14 (e) and 15 (e) read each rank's parameter and cache storage
# and hold it to the rules' bytes (launch.dryrun.argument_bytes: param_specs(...,
# serve=True) and cache_specs), printed beside the bytes the rule before them
# held (the attention, MLA and MLP blocks the sharded decode bodies read by their
# own specs, the tables as serving cuts them, every other parameter whole; a
# self-attention cache cut along S where S/m >= 128, every other cache by rows).

def _leaf_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def rules_holding(torch, cfg, mesh_shape: dict, B: int, max_len: int, frames=None) -> dict:
    """The bytes a rank holds of the serve step's parameters and caches under
    the rules (``launch.dryrun.argument_bytes``), from ``meta`` tensors."""
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.models import LM
    from repro_torch.runtime.serve import abstract_cache

    lm = LM(cfg, device="meta")
    args = {"params": dict(lm.named_parameters()), "cache": abstract_cache(lm, B, max_len, frames=frames),
            "batch": {"tokens": torch.empty((B, 1), dtype=torch.int32, device="meta")}}
    groups = argument_bytes(mesh_shape, args, "decode")
    return {"params": groups["params"], "cache": groups["cache"]}


def parent_holding(torch, cfg, mesh_shape: dict, B: int, max_len: int, frames=None) -> dict:
    """The bytes a rank held under the rule before the rules' blocks (see above)."""
    from repro_torch.models import LM
    from repro_torch.models.attention import _decode_bspec, decode_attention_specs, decode_mlp_specs
    from repro_torch.models.mla import mla_decode_specs
    from repro_torch.runtime.serve import abstract_cache
    from repro_torch.runtime.sharding import block_shape, param_specs

    lm = LM(cfg, device="meta")
    m, W = mesh_shape.get("model", 1), min(cfg.local_window, max_len)
    sharded = lambda S: m > 1 and S % m == 0 and S // m >= 128  # noqa: E731
    rules = param_specs(mesh_shape, lm, serve=True)
    specs = {n: rules[n] if n in ("embed", "unembed") else (None,) * p.dim() for n, p in lm.named_parameters()}
    attn, mlp = decode_attention_specs(cfg, mesh_shape, B), decode_mlp_specs(cfg, mesh_shape, B)
    fam, L = cfg.family, cfg.num_layers
    if fam == "dense":
        pat = cfg.layer_pattern * (L // len(cfg.layer_pattern))
        selfs = [(f"blocks.{i}", W if c == "L" and cfg.local_window else max_len) for i, c in enumerate(pat)]
    elif fam == "vlm":
        k = cfg.cross_attn_every
        selfs = [(f"self_blocks.{p}.{j}", max_len) for p in range(L // k) for j in range(k - 1)]
    elif fam == "hybrid":
        selfs = [(f"attn_blocks.{p}", W) for p in range(L // 3)]
    elif fam == "encdec":
        selfs = [(f"dec_self.{i}", max_len) for i in range(L)]
    else:
        selfs = []
    for prefix, S in selfs:
        for w in ("wq", "wk", "wv", "wo"):
            if sharded(S):
                specs[f"{prefix}.attn.{w}"] = attn[w]
        for w in ("w_gate", "w_up", "w_down"):
            if m > 1 and f"{prefix}.mlp.{w}" in specs:
                specs[f"{prefix}.mlp.{w}"] = mlp[w]
    if fam == "moe":
        mla = mla_decode_specs(cfg, mesh_shape, B)
        experts = param_specs(mesh_shape, lm, zero3=True)
        for n in specs:
            parts = n.split(".")
            if parts[0] not in ("dense_blocks", "moe_blocks"):
                continue
            if parts[2] == "attn" and sharded(max_len):
                specs[n] = mla[parts[3]]
            elif parts[2] == "moe" and parts[3] in ("w_gate", "w_up", "w_down"):
                specs[n] = experts[n]
            elif parts[2] == "mlp" and m > 1:
                specs[n] = mlp[parts[3]]
    params = sum(math.prod(block_shape(lm.get_parameter(n).shape, sp, mesh_shape)) * lm.get_parameter(n).element_size()
                 for n, sp in specs.items())
    bspec = _decode_bspec(mesh_shape, B)
    attn_caches = {"k", "v", "local_k", "local_v", "global_k", "global_v", "ring_k", "ring_v", "c_kv", "k_rope"}

    def cache_bytes(name, t, lead):
        spec = [None] * t.dim()
        spec[lead] = bspec
        if name in attn_caches and sharded(t.shape[lead + 1]):
            spec[lead + 1] = "model"
        return math.prod(block_shape(t.shape, tuple(spec), mesh_shape)) * t.element_size()

    lead2 = {"dense": ("local_k", "local_v", "global_k", "global_v"), "vlm": ("k", "v"), "hybrid": ("h", "conv")}
    cache = 0
    for name, t in abstract_cache(lm, B, max_len, frames=frames).items():
        for leaf, u in (t.items() if isinstance(t, dict) else [(name, t)]):
            cache += cache_bytes(leaf, u, 2 if leaf in lead2.get(fam, ()) else 1)
    return {"params": params, "cache": cache}


def holding(torch, step, cache, cfg, mesh, B: int, max_len: int, what: str, frames=None) -> dict:
    """This rank's parameter storage (``serve_step.lm``) and cache storage
    against the rules' bytes (equal, checked) and the parent rule's."""
    held = {"params": sum(p.numel() * p.element_size() for p in step.lm.parameters()), "cache": _leaf_bytes(cache)}
    shape = dict(mesh)
    rules = rules_holding(torch, cfg, shape, B, max_len, frames)
    check(held == rules, f"{what} rank {dict(mesh.coords)}: holds {held} bytes, the rules count {rules}")
    return dict(held=held, rules=rules, parent=parent_holding(torch, cfg, shape, B, max_len, frames))


def phase12_rank(mesh, short_files: dict) -> dict:
    """One rank of phase 12 (b)-(e), on its blocks; every kernel counter set
    to 0 before and read after. Returns this rank's outputs (its rows, its
    MLA rows, its moe tokens, (e)'s errors against ``short_files``),
    per-step counts and times, and peak memory."""
    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.models import attention, decode, moe
    from repro_torch.models.mla import mla_decode_sharded, mla_decode_specs
    from repro_torch.runtime.pspec import logical_axis_rules
    from repro_torch.runtime.serve import build_serve_step
    from repro_torch.runtime.sharding import block_index, local_block

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    counters = kernel_counters()
    zero_counts(counters)
    RECEIVED.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = {"coords": dict(mesh.coords), "backend": mesh.backend, "device": str(dev)}
    B, max_len = PH12["B"], PH12["max_len"]
    for name, dtype, zero3 in PASSES12:
        cfg, lm = gemma12(torch, dtype, dev)
        toks = tokens12(cfg.vocab_size)
        with serving_zero3(zero3):
            step, (psh, csh, tsh, _), _ = build_serve_step(lm, B, max_len, mesh=mesh)
        full = cache12(torch, lm)
        with logical_axis_rules(mesh):
            cache = decode.init_cache(lm, B, max_len)
        for k in cache:
            cache[k].copy_(local_block(full[k], csh[k], mesh))
        del full
        with serving_zero3(zero3):
            held = holding(torch, step, cache, cfg, mesh, B, max_len, f"phase 12b {name}")
        rows, counts, times = [], [], []
        for n, pos in enumerate(PH12["steps"]):
            tok = local_block(torch.as_tensor(toks[:, n:n + 1], device=dev), tsh, mesh)
            before = (attention.decode_attention_sharded.calls, attention.decode_mlp_sharded.calls,
                      da_ops.decode_attention.launches, da_ops.decode_attention.ranged)
            torch.cuda.synchronize()
            zero_received()
            t1 = time.perf_counter()
            logits, cache = step(tok, cache, pos)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            log_received("decode (serving's ZeRO)" if zero3 else "decode", cfg, mesh, n)
            counts.append(dict(attention=attention.decode_attention_sharded.calls - before[0],
                               mlp=attention.decode_mlp_sharded.calls - before[1],
                               decode_launches=da_ops.decode_attention.launches - before[2],
                               range_launches=da_ops.decode_attention.ranged - before[3]))
            rows.append(logits.float().cpu().numpy())
        res[name] = dict(logits=np.stack(rows), counts=counts, step_s=times, layers=cfg.num_layers,
                         table_spec=list(psh["embed"]),
                         cut_params=sum(any(e is not None for e in sp) for sp in psh.values()), holding=held,
                         cache_specs={k: [list(e) if isinstance(e, tuple) else e for e in v] for k, v in csh.items()})
        del lm, step, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
    # (e) the short caches
    res["short"] = short12_rank(torch, mesh, short_files)
    # (c) one MLA layer
    cfg, p, caches, xs = mla12(torch, dev)
    specs = mla_decode_specs(cfg, mesh, MLA12["B"])
    local = {w: local_block(t, specs[w], mesh).clone() for w, t in p.items()}
    ckv, kr = (local_block(caches[k], specs["cache"], mesh).clone() for k in ("c_kv", "k_rope"))
    del p, caches
    ys = []
    with logical_axis_rules(mesh):
        for x, pos in zip(xs, MLA12["steps"]):
            y, ckv, kr = mla_decode_sharded(local, local_block(x, specs["x"], mesh), ckv, kr, pos, cfg,
                                            batch=MLA12["B"])
            ys.append(y.float().cpu().numpy())
    res["mla"] = np.stack(ys)
    del local, ckv, kr, xs
    gc.collect()
    torch.cuda.empty_cache()
    # (d) one moe layer, the a2a dispatch
    cfg = moe12_cfg()
    specs = moe.moe_a2a_specs(cfg, mesh)
    e_idx, e_n = block_index(mesh, specs["w_gate"][0], mesh.coords)
    E_loc = cfg.num_experts // e_n
    _, p, x = moe12(torch, dev, experts=range(e_idx * E_loc, (e_idx + 1) * E_loc))
    moe.set_moe_impl("a2a")
    try:
        with logical_axis_rules(mesh):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y, aux = moe.moe_layer(p, local_block(x, specs["x"], mesh), cfg)
            torch.cuda.synchronize()
            res["moe_s"] = time.perf_counter() - t1
    finally:
        moe.set_moe_impl("gather")
    res["moe"], res["moe_aux"] = y.float().cpu().numpy(), float(aux)
    res["ep2d"] = specs["w_gate"][0] == ("model", "data")
    del p, x, y
    res["launches"] = {name: fn.launches for name, fn in counters.items()}
    res["flash_pairs"] = flash_pairs()
    res["range_launches"] = da_ops.decode_attention.ranged
    res["received"] = list(RECEIVED)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["wall_s"] = time.perf_counter() - t0
    return res


def rows_of(a: np.ndarray, coords: dict, mesh_shape: dict, spec) -> np.ndarray:
    """The block of a one-process result that the rank at ``coords`` holds."""
    import torch
    from repro_torch.runtime.sharding import local_block

    return local_block(torch.from_numpy(np.ascontiguousarray(a)), spec, mesh_shape, coords).numpy()


def bf16_close(got: np.ndarray, want: np.ndarray, what: str) -> float:
    """max |got − want| ≤ BF16_REL · max |want|; returns that error over max |want|."""
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    check(rel <= BF16_REL, f"{what}: max error {rel!r} of max |one process| (limit {BF16_REL})")
    return rel


def summed(counts: list) -> dict:
    """The sum of the count dicts ``counts``, key by key."""
    out: dict = {}
    for c in counts:
        for key, n in c.items():
            out[key] = out.get(key, 0) + n
    return out


def card_ranks(fn, mesh: dict) -> tuple[list, float]:
    """``run_ranks(fn)`` over gloo, every rank on the one card, each rank's
    caching allocator giving freed segments back (four share the card):
    (the ranks' results, seconds)."""
    from repro_torch.launch.mesh import run_ranks

    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        return run_ranks(fn, mesh, backend="gloo", timeout=900), time.perf_counter() - t0
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc


# Phases 12-15's seconds when every rank gathered the tables whole at use (H100 80GB HBM3, 700.00 W), printed
# beside this run's.
GATHERED_TABLES_S = {12: 19.570, 13: 147.340, 14: 103.618, 15: 147.489}
# In a rank: each sharded step's bytes received (launch.mesh.received), appended by log_received.
RECEIVED: list = []


def zero_received() -> None:
    from repro_torch.launch.mesh import received

    received.zero()


def log_received(what: str, cfg, mesh, step: int) -> None:
    """The bytes this rank received since ``zero_received``, in RECEIVED:
    in all, by collective kind, the most one call received, and the rank's
    (V/m, d) rows of a table of ``cfg`` in bytes."""
    from repro_torch.launch.mesh import received

    r = received.read()
    RECEIVED.append(dict(what=what, model=f"{cfg.name} {cfg.param_dtype}", step=step, total=r["total"],
                         by_kind=r["by_kind"], largest=r["largest"],
                         rows=cfg.padded_vocab // mesh["model"] * cfg.d_model * cfg.pdtype.itemsize))


def check_received(phase: str, c: dict, log: list) -> dict:
    """A rank's RECEIVED, whatever collective moved the bytes: no call of a
    training step receives more than the rank's (V/m, d) rows of a table
    (its 'data' gather and that gather's backward receive at most them),
    no call of a prefill or decode step as much (a table gathered over
    'model' would receive them), and no decode step as much in all (no
    table moves there). Returns the log by (what, model): each step's
    (total, largest) bytes and its bytes by kind."""
    check(bool(log), f"phase {phase} rank {c}: no sharded step logged its bytes")
    out: dict = {}
    for e in log:
        at = f"phase {phase} rank {c} {e['what']} {e['model']} step {e['step']}"
        what = e["what"].split()[0]
        if what == "train":
            check(e["largest"] <= e["rows"], f"{at}: one collective received {e['largest']} bytes, more than the "
                                             f"rank's rows of a table ({e['rows']})")
        else:
            check(e["largest"] < e["rows"], f"{at}: one collective received {e['largest']} bytes, as much as the "
                                            f"rank's rows of a table ({e['rows']})")
        check(what != "decode" or e["total"] < e["rows"],
              f"{at}: the step received {e['total']} bytes, as much as the rank's rows of a table ({e['rows']})")
        out.setdefault(f"{e['what']} {e['model']}", []).append([e["total"], e["largest"], e["by_kind"]])
    return out


def phase_sharded(torch) -> dict:
    """Phase 12 (b)-(d): the one-process results here, then four ranks on
    the card, each held to them."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import decode, moe
    from repro_torch.models.attention import _decode_bspec
    from repro_torch.models.mla import mla_decode

    t0 = time.perf_counter()
    out = {}
    dev = torch.device("cuda")
    B, steps = PH12["B"], PH12["steps"]
    want = {}
    for dtype in ("float32", "bfloat16"):
        cfg, lm = gemma12(torch, dtype, dev)
        toks = tokens12(cfg.vocab_size)
        cache = cache12(torch, lm)
        rows = []
        for n, pos in enumerate(steps):
            logits, cache = decode.decode_step(lm, torch.as_tensor(toks[:, n:n + 1], device=dev), cache, pos)
            rows.append(logits.float().cpu().numpy())
        want[dtype] = np.stack(rows)
        del lm, cache
        gc.collect()
        torch.cuda.empty_cache()
    cfg, p, caches, xs = mla12(torch, dev)
    ys = []
    with torch.no_grad():
        for x, pos in zip(xs, MLA12["steps"]):
            y, _, _ = mla_decode(p, x, caches["c_kv"], caches["k_rope"], pos, cfg)
            ys.append(y.float().cpu().numpy())
    want["mla"] = np.stack(ys)
    del p, caches, xs
    cfg, p, x = moe12(torch, dev)
    with torch.no_grad():
        y, aux = moe.moe_layer(p, x, cfg)
    want["moe"], want["moe_aux"] = y.float().cpu().numpy(), float(aux)
    del p, x, y
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="phase12_") as work:
        short_files = short12_want(torch, dev, Path(work))
        one_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        ranks = run_ranks(phase12_rank, PH12["mesh"], backend="gloo", args=(short_files,), timeout=900)
        ranks_s = time.perf_counter() - t1
    mesh = PH12["mesh"]
    rows_spec = (_decode_bspec(mesh, B), None, None)
    moe_spec = moe.moe_a2a_specs(cfg, mesh)["x"]
    per_rank = []
    for r in ranks:
        c = r["coords"]
        check(r["backend"] == "gloo" and r["device"].startswith("cuda"),
              f"phase 12 rank {c}: {r['backend']} {r['device']}")
        ref = rows_of(want["float32"], c, mesh, (None,) + rows_spec)
        f32_errs = {}
        for name in ("float32", "float32_zero3"):
            got = r[name]["logits"]
            f32_errs[name] = max_abs_err(torch, torch.from_numpy(got), torch.from_numpy(ref))
            check(bool(np.all(np.abs(got - ref) <= F32_TOL + F32_TOL * np.abs(ref))),
                  f"phase 12b rank {c} {name} logits differ from the one-process step by {f32_errs[name]!r}")
            check(np.array_equal(got.argmax(-1), ref.argmax(-1)), f"phase 12b rank {c} {name} argmax differs")
        f32_err = f32_errs["float32"]
        for name, _, zero3 in PASSES12:
            check(r[name]["table_spec"] == ["model", "data" if zero3 else None],
                  f"phase 12b rank {c} {name}: the table's spec {r[name]['table_spec']}")
        got, ref = r["bfloat16"]["logits"], rows_of(want["bfloat16"], c, mesh, (None,) + rows_spec)
        bf_rel = bf16_close(got, ref, f"phase 12b rank {c} bf16 logits")
        # the same greedy token, but where the one-process logits' two largest
        # lie within the tolerance of each other (a tie the rounding may turn)
        top2 = np.sort(ref, axis=-1)[..., -2:]
        tie = (top2[..., 1] - top2[..., 0]) <= BF16_REL * np.abs(ref).max()
        same = got.argmax(-1) == ref.argmax(-1)
        picked = np.take_along_axis(ref, got.argmax(-1)[..., None], -1)[..., 0]
        check(bool(np.all(same | (tie & (top2[..., 1] - picked <= BF16_REL * np.abs(ref).max())))),
              f"phase 12b rank {c} bf16 argmax differs outside a tie")
        for name, _, _ in PASSES12:
            L = r[name]["layers"]
            for n, k in enumerate(r[name]["counts"]):
                check(k == dict(attention=L, mlp=L, decode_launches=L, range_launches=L),
                      f"phase 12b rank {c} {name} step {steps[n]}: {k}, want {L} of each")
        mla_rel = bf16_close(r["mla"], rows_of(want["mla"], c, mesh, (None,) + rows_spec), f"phase 12c rank {c} MLA")
        moe_rel = bf16_close(r["moe"], rows_of(want["moe"], c, mesh, moe_spec), f"phase 12d rank {c} moe a2a")
        check(abs(r["moe_aux"] - want["moe_aux"]) <= AUX_RTOL * abs(want["moe_aux"]),
              f"phase 12d rank {c} aux {r['moe_aux']!r} vs {want['moe_aux']!r}")
        check(r["ep2d"], f"phase 12d rank {c}: not 2-D expert parallelism")
        # (e) each short pass within its type's limit of the largest |logit|, the caches cut as it is there for,
        # the self layers through the kernel on the rank's rows or through the partial scores along D
        for name, dtype, _, _, _, positions, L, cut in PH12_SHORT:
            sh = r["short"][name]
            lim = (F32_TOL if dtype == "float32" else BF16_REL) * sh["max_abs_ref"]
            check(sh["max_abs_err"] <= lim and (dtype != "float32" or sh["argmax_same"] == sh["rows"] * len(positions))
                  and sh["argmax_off_outside_ties"] == 0,
                  f"phase 12e rank {c} {name}: max |diff| {sh['max_abs_err']!r} (limit {lim!r}), greedy tokens "
                  f"{sh['argmax_same']} of {sh['rows'] * len(positions)} the same")
            check(sh["cuts"] == {"local": (cut,), "global": (cut,)}, f"phase 12e rank {c} {name}: cuts {sh['cuts']}")
            want_k = dict(attention=L, mlp=L, gathered=0, decode_launches=L if cut == 0 else 0, range_launches=0)
            check(all(k == want_k for k in sh["counts"]), f"phase 12e rank {c} {name}: {sh['counts']}, want {want_k}")
        received = check_received("12", c, r["received"])
        per_rank.append(dict(coords=c, f32_max_abs_err=f32_err, zero3_f32_max_abs_err=f32_errs["float32_zero3"],
                             bf16_rel_err=bf_rel, bf16_ties=int(tie.sum()),
                             bf16_argmax_same=int(same.sum()), mla_rel_err=mla_rel, moe_rel_err=moe_rel,
                             aux=r["moe_aux"], peak_bytes=r["peak_bytes"], wall_s=r["wall_s"],
                             step_s={d: r[d]["step_s"] for d, _, _ in PASSES12}, moe_s=r["moe_s"],
                             counts={d: r[d]["counts"] for d, _, _ in PASSES12},
                             cut_params={d: r[d]["cut_params"] for d, _, _ in PASSES12},
                             holding={d: r[d]["holding"] for d, _, _ in PASSES12},
                             cache_specs=r["bfloat16"]["cache_specs"], received=received,
                             short={k: dict(v, rel_err=v["max_abs_err"] / v["max_abs_ref"], counts=v["counts"][0])
                                    for k, v in r["short"].items()}))
        print(f"phase 12 rank {c}: {json.dumps(per_rank[-1])}")
    launches = summed([r["launches"] for r in ranks])
    pairs = summed([r["flash_pairs"] for r in ranks])
    out.update(ranks=per_rank, launches=launches, flash_pairs=pairs,
               range_launches=sum(r["range_launches"] for r in ranks),
               short_launches=sum(k["decode_launches"] for r in ranks for v in r["short"].values() for k in v["counts"]),
               one_process_s=one_s, ranks_s=ranks_s, wall_s=time.perf_counter() - t0, aux=want["moe_aux"])
    print(f"phase 12 four ranks on one card (2 x 2 mesh, gloo, collectives staged through host memory): the step "
          f"times above are four processes time-sharing one card, not the sharded step's speed, and are held to no "
          f"bound; ranks {ranks_s:.3f} s, one-process references {one_s:.3f} s, phase {out['wall_s']:.3f} s, "
          f"launches {launches}, key-range launches {out['range_launches']}, (e)'s launches on the ranks' rows "
          f"{out['short_launches']}")
    return out


# -- phase 13: sharded training and prefill of the dense family -------------------
#
# Four ranks on the one card (a 2 x 2 ("data", "model") mesh over gloo, as
# phase 12), gemma2-9b at its published width with the depth cut to 2 of 42
# layers (one local, one global) and train_4k's batch cut from 256 x 4,096
# to a global B 2 x S 2,048 (one row a data rank). (a) bf16 with remat and
# TrainConfig's defaults (phase 10's dtypes), 2 steps (cut from 3 to leave
# phase 16 its time): 1.314 B parameters
# (917.5 M of them the tied embedding), about 16 GB of state over the four
# ranks, plus each rank's gathered table (1.8 GB), its gradient and its
# float32 cross-entropy chunk (2.1 GB); (b) the f32 oracle at S 512 against
# the one-process step; (c) the prefill, f32 and bf16.
PH13 = dict(mesh={"data": 2, "model": 2}, layers=2, B=2, S=2048, steps=2, oracle_S=512, seed=13, data_seed=1)
# Each parameter after the steps against the one-process step's, in units of
# its leaf's largest change: AdamW's m/√v magnifies a gradient's last-place
# difference (another order of summation) where |g| is near it. The
# one-process step against itself with the batch in two microbatches
# differs by 0.0417 of the change on 6e-8 of the embedding's elements,
# under 0.0025 elsewhere (H100 80GB HBM3, 700 W).
PH13_PARAM_TOL = 1e-1
PH13_PARAM_SHARE = (1e-2, 1e-6)   # at most 1e-6 of a leaf's elements beyond 1e-2 of its largest change
PH13_LOSS_RTOL = 1e-5
PH13_BF16_LOSS_RTOL = 2e-2
PH13_PREFILL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}   # of the largest |logit|
PH13_ORACLE = dict(warmup_steps=1, total_steps=10)      # lr > 0 from step 1


def gemma13_cfg(dtype: str):
    """gemma2-9b at published width, 2 layers (L, G), in ``dtype``."""
    from repro_torch.configs import get_config

    return get_config("gemma2-9b").replace(num_layers=PH13["layers"], param_dtype=dtype, compute_dtype=dtype)


def gemma13(torch, dtype: str, dev):
    """``gemma13_cfg(dtype)`` and its model from PH13's seed."""
    from repro_torch.models import LM

    cfg = gemma13_cfg(dtype)
    return cfg, LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(PH13["seed"]))


def batches13(S: int) -> list:
    """PH13's global batches of B x S from SyntheticLMDataset(256000, S, seed=1)."""
    from repro_torch.data import SyntheticLMDataset

    ds = SyntheticLMDataset(256_000, S, seed=PH13["data_seed"])
    return [ds.batch(s, PH13["B"]) for s in range(PH13["steps"])]


def train13(torch, lm, tcfg, S: int, mesh=None) -> tuple:
    """PH13's steps of build_train_step (under ``mesh`` on this rank's rows):
    (metrics a step, seconds a step ending in a synchronize, the step)."""
    return train_steps(torch, lm, tcfg, batches13(S), mesh)


def train_steps(torch, lm, tcfg, batches: list, mesh=None) -> tuple:
    """build_train_step over ``batches`` (global batches; under ``mesh`` this
    rank's rows of each, each step's bytes received logged): (metrics a
    step, seconds a step ending in a synchronize, the optimizer state)."""
    from repro_torch.runtime.train import build_train_step, init_opt_state, shard_batch

    step = build_train_step(lm, tcfg) if mesh is None else build_train_step(lm, tcfg, mesh=mesh)[0]
    opt = init_opt_state(lm, tcfg.optimizer)
    gc.collect()
    torch.cuda.empty_cache()        # the whole model's storage, freed by the cut (four processes share the card)
    metrics, times = [], []
    for i, b in enumerate(batches):
        b = b if mesh is None else shard_batch(b, mesh)
        torch.cuda.synchronize()
        zero_received()
        t0 = time.perf_counter()
        m = step(opt, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if mesh is not None:
            log_received("train", lm.cfg, mesh, i)
        metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
    return metrics, times, opt


def prefill_logged(step, batch: dict, cfg, mesh) -> np.ndarray:
    """The prefill step's logits of ``batch`` on the host; under ``mesh``
    its bytes received logged."""
    zero_received()
    logits = step(batch)
    if mesh is not None:
        log_received("prefill", cfg, mesh, 0)
    return logits.float().cpu().numpy()


def prefill13(torch, dtype: str, dev, mesh=None) -> np.ndarray:
    """The prefill step's logits of PH13's first batch (this rank's rows under ``mesh``)."""
    from repro_torch.runtime.train import build_prefill_step, shard_batch

    _, lm = gemma13(torch, dtype, dev)
    batch = {"tokens": batches13(PH13["S"])[0]["tokens"]}
    if mesh is None:
        step = build_prefill_step(lm)
    else:
        step, _ = build_prefill_step(lm, mesh=mesh)
        batch = shard_batch(batch, mesh)
        gc.collect()
        torch.cuda.empty_cache()
    return prefill_logged(step, batch, lm.cfg, mesh)


def oracle13(torch, dev, finals: dict) -> dict:
    """Rank 0 alone, after the sharded parts: the one-process f32 steps of
    (b) from the same parameters and data, each leaf held to the gathered
    sharded result within PH13_PARAM_TOL of its largest change."""
    from repro_torch.runtime.train import TrainConfig

    _, lm = gemma13(torch, "float32", dev)
    before = {k: p.detach().clone() for k, p in lm.named_parameters()}
    metrics, times, opt = train13(torch, lm, TrainConfig(**PH13_ORACLE), PH13["oracle_S"])
    by_leaf = param_spread(torch, {k: finals[k].to(dev) for k in finals}, dict(lm.named_parameters()), before)
    del lm, opt, before
    worst = max(r["over_change"] for r in by_leaf.values())
    share = max(r["share_over_1e2"] for r in by_leaf.values())
    top = dict(sorted(by_leaf.items(), key=lambda kv: -kv[1]["over_change"])[:4])
    return dict(metrics=metrics, step_s=times, worst_over_change=worst, worst_share_over_1e2=share,
                leaves=len(by_leaf), worst_leaves=top)


def param_spread(torch, got: dict, want: dict, before: dict) -> dict:
    """Per leaf: max |got − want| over the leaf's largest change from
    ``before`` to ``want``, the share of elements beyond 1e-2 of it, and at
    the worst element its value before, in ``want`` and in ``got``."""
    out = {}
    for name, w in want.items():
        w = w.detach()
        change = float((w - before[name]).abs().max())
        check(change > 0, f"parameter {name} did not move")
        d = (got[name] - w).abs()
        i = int(d.argmax())
        out[name] = dict(over_change=float(d.max()) / change,
                         share_over_1e2=float((d > PH13_PARAM_SHARE[0] * change).float().mean()),
                         at=[float(before[name].flatten()[i]), float(w.flatten()[i]), float(got[name].flatten()[i])],
                         change=change)
    return out


def phase13_rank(mesh) -> dict:
    """One rank of phase 13 on its blocks: (a) bf16 training, (b) f32
    training with its final parameters gathered to rank 0, (c) the
    prefill in f32 and bf16, every kernel counter set to 0 before (a) and
    read after (c); then on rank 0 alone the one-process oracle of (b)."""
    import torch

    from repro_torch.models import attention
    from repro_torch.runtime.sharding import gather_blocks
    from repro_torch.runtime.train import TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    res = {"coords": dict(mesh.coords), "backend": mesh.backend, "device": str(dev)}
    counters = kernel_counters()
    zero_counts(counters)
    RECEIVED.clear()
    calls0 = attention.attention_sharded.calls, attention.mlp_sharded.calls
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # (a) bf16 at published width, TrainConfig's defaults, remat
    cfg, lm = gemma13(torch, "bfloat16", dev)
    check(cfg.remat, "phase 13a trains with remat")
    metrics, times, opt = train13(torch, lm, TrainConfig(), PH13["S"], mesh)
    say = print if mesh.coords == {"data": 0, "model": 0} else (lambda *a, **k: None)
    say(f"phase 13a rank 0 done at {time.perf_counter() - t0:.3f} s: {metrics}", flush=True)
    res["bf16"] = dict(metrics=metrics, step_s=times, cut=sum(any(e is not None for e in s)
                                                             for s in lm.placement.specs.values()),
                       block_params=sum(p.numel() for p in lm.parameters()), peak_bytes=torch.cuda.max_memory_allocated())
    del lm, opt
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the f32 oracle's sharded half
    torch.cuda.reset_peak_memory_stats()
    _, lm = gemma13(torch, "float32", dev)
    metrics, times, opt = train13(torch, lm, TrainConfig(**PH13_ORACLE), PH13["oracle_S"], mesh)
    res["f32"] = dict(metrics=metrics, step_s=times, peak_bytes=torch.cuda.max_memory_allocated())
    say(f"phase 13b rank 0 done at {time.perf_counter() - t0:.3f} s: {metrics}", flush=True)
    finals = gather_blocks(dict(lm.named_parameters()), lm.placement.specs, mesh,
                            keep=mesh.coords == {"data": 0, "model": 0}) or {}
    del lm, opt
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the prefill
    res["prefill"] = {dtype: prefill13(torch, dtype, dev, mesh) for dtype in ("float32", "bfloat16")}
    torch.cuda.synchronize()
    res["sharded_s"] = time.perf_counter() - t0
    res["launches"] = {name: fn.launches for name, fn in counters.items()}
    res["flash_pairs"] = flash_pairs()
    res["bwd_pairs"] = {f"{d}x{dv}": n for (d, dv), n in sorted(counters["flash_attention_bwd"].by_pair.items())}
    res["padded"] = padded_counts(counters)
    res["calls"] = (attention.attention_sharded.calls - calls0[0], attention.mlp_sharded.calls - calls0[1])
    res["received"] = list(RECEIVED)
    gc.collect()
    torch.cuda.empty_cache()
    if finals:
        t1 = time.perf_counter()
        res["oracle"] = oracle13(torch, dev, finals)
        res["oracle_s"] = time.perf_counter() - t1
    return res


def phase_sharded_train(torch) -> dict:
    """Phase 13: the one-process bf16 losses and prefill logits here, then
    four ranks on the card, each held to them (and rank 0 to its own
    one-process f32 oracle)."""
    from repro_torch.runtime.sharding import batch_specs
    from repro_torch.runtime.train import TrainConfig

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    _, lm = gemma13(torch, "bfloat16", dev)
    n_params = sum(p.numel() for p in lm.parameters())
    one_bf16, one_times, opt = train13(torch, lm, TrainConfig(), PH13["S"])
    del lm, opt
    gc.collect()
    torch.cuda.empty_cache()
    want = {}
    for dtype in ("float32", "bfloat16"):
        want[dtype] = prefill13(torch, dtype, dev)
        gc.collect()
        torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0

    ranks, ranks_s = card_ranks(phase13_rank, PH13["mesh"])
    mesh, L, steps = PH13["mesh"], PH13["layers"], PH13["steps"]
    rows = (batch_specs(mesh, {"x": torch.zeros(PH13["B"])})["x"][0], None, None)
    per_rank = []
    for r in ranks:
        c = r["coords"]
        check(r["backend"] == "gloo" and r["device"].startswith("cuda"), f"phase 13 rank {c}: {r['backend']} {r['device']}")
        a = np.asarray(r["bf16"]["metrics"])
        check(bool(np.isfinite(a).all()), f"phase 13a rank {c} metrics not finite: {a.tolist()}")
        one = np.asarray(one_bf16)
        bf_rel = float(np.abs(a[:, 0] - one[:, 0]).max() / np.abs(one[:, 0]).max())
        check(bf_rel <= PH13_BF16_LOSS_RTOL, f"phase 13a rank {c} bf16 losses {a[:, 0].tolist()} vs one process "
                                             f"{one[:, 0].tolist()}")
        check(np.array_equal(a[:, 2].astype(np.float32), one[:, 2].astype(np.float32)), f"phase 13a rank {c} lr")
        # every sharded attention call launched the flash kernel, and every
        # training layer its backward: (a) and (b) 2 forwards a layer a step
        # (remat), (c) one a layer a prefill
        fwd, bwd = r["launches"]["flash_attention"], r["launches"]["flash_attention_bwd"]
        check(fwd == r["calls"][0] == 2 * (2 * L * steps) + 2 * L and bwd == 2 * L * steps,
              f"phase 13 rank {c}: flash forward {fwd}, backward {bwd}, sharded attention calls {r['calls']}")
        check(not any(r["padded"].values()) and set(r["flash_pairs"]) == set(r["bwd_pairs"]) == {"256x256"},
              f"phase 13 rank {c} instances {r['flash_pairs']} {r['bwd_pairs']}, padded {r['padded']}")
        check(r["launches"]["decode_attention"] == 0, f"phase 13 rank {c} launched decode_attention")
        errs = {}
        for dtype, tol in PH13_PREFILL_TOL.items():
            ref = rows_of(want[dtype], c, mesh, rows)
            got = r["prefill"][dtype]
            errs[dtype] = float(np.abs(got - ref).max() / np.abs(ref).max())
            check(got.shape == ref.shape and errs[dtype] <= tol,
                  f"phase 13c rank {c} {dtype} prefill: {errs[dtype]!r} of the largest logit (limit {tol})")
        received = check_received("13", c, r["received"])
        per_rank.append(dict(coords=c, bf16_losses=a[:, 0].tolist(), bf16_grad_norms=a[:, 1].tolist(),
                             bf16_loss_rel_err=bf_rel, bf16_step_s=r["bf16"]["step_s"],
                             bf16_peak_gb=r["bf16"]["peak_bytes"] / 1e9, f32_peak_gb=r["f32"]["peak_bytes"] / 1e9,
                             f32_step_s=r["f32"]["step_s"], prefill_rel_err=errs, flash_forward=fwd,
                             flash_backward=bwd, cut_params=r["bf16"]["cut"],
                             block_params=r["bf16"]["block_params"], sharded_s=r["sharded_s"], received=received))
        print(f"phase 13 rank {c}: {json.dumps(per_rank[-1])}")
    # (b): every rank's metrics against rank 0's one-process oracle
    oracle = next(r["oracle"] for r in ranks if "oracle" in r)
    print(f"phase 13b one-process f32 oracle (rank 0): {json.dumps(oracle)}")
    want_m = np.asarray(oracle["metrics"])
    check(want_m[0, 2] == 0.0 and want_m[1, 2] > 0, f"phase 13b learning rates {want_m[:, 2].tolist()}")
    for r in ranks:
        got = np.asarray(r["f32"]["metrics"])
        rel = np.abs(got[:, :2] - want_m[:, :2]) / np.abs(want_m[:, :2])
        check(bool((rel <= PH13_LOSS_RTOL).all()) and np.array_equal(got[:, 2], want_m[:, 2]),
              f"phase 13b rank {r['coords']} f32 metrics {got.tolist()} vs one process {want_m.tolist()}")
    check(oracle["worst_over_change"] <= PH13_PARAM_TOL and oracle["worst_share_over_1e2"] <= PH13_PARAM_SHARE[1],
          f"phase 13b parameters: {oracle['worst_over_change']!r} of a leaf's largest change (limit {PH13_PARAM_TOL}), "
          f"{oracle['worst_share_over_1e2']!r} of a leaf beyond {PH13_PARAM_SHARE[0]} (limit {PH13_PARAM_SHARE[1]})")
    launches = summed([r["launches"] for r in ranks])
    pairs, bwd_pairs = summed([r["flash_pairs"] for r in ranks]), summed([r["bwd_pairs"] for r in ranks])
    out = dict(ranks=per_rank, params=n_params, one_process_bf16=one_bf16, one_process_bf16_step_s=one_times,
               oracle=oracle, oracle_f32_max_rel=float(np.max(np.abs(np.asarray(ranks[0]["f32"]["metrics"])[:, :2]
                                                                    - want_m[:, :2]) / np.abs(want_m[:, :2]))),
               launches=launches, flash_pairs=pairs, bwd_pairs=bwd_pairs, one_process_s=one_s, ranks_s=ranks_s,
               wall_s=time.perf_counter() - t0)
    print(f"phase 13 gemma2-9b {L} layers ({n_params} parameters), 2 x 2 mesh: one-process bf16 losses {one_bf16}; "
          f"f32 oracle {json.dumps(oracle)}; f32 metrics max relative difference {out['oracle_f32_max_rel']!r}")
    print(f"phase 13 four ranks on one card (2 x 2 mesh, gloo, collectives staged through host memory): the step "
          f"times above are four processes time-sharing one card, not the sharded step's speed, and are held to no "
          f"bound; ranks {ranks_s:.3f} s, one-process references {one_s:.3f} s, phase {out['wall_s']:.3f} s, "
          f"launches {launches}, flash by instance {pairs}, backward by instance {bwd_pairs}")
    return out


# -- phase 14: the hybrid, vlm and encdec families trained, and under a mesh ----
#
# At published width. (a) One process, float32, B 1 x S 512: the loss and
# every gradient with attention through the kernels (forward and backward)
# against the plain route (phase 10.2's oracle): recurrentgemma-2b with 3
# of 26 layers (R R L), its window cut to 128 so that it bites;
# llama-3.2-vision-11b with 5 of 40 (4 self, 1 cross over 1,601 image
# tokens); whisper-base whole (6 + 6, 1,500 frames). (b) Four ranks on the
# 2 x 2 mesh (gloo, one card), bf16, remat, TrainConfig's defaults, 2 steps
# of a global B 2 (one row a data rank) against the same steps in one
# process: recurrentgemma-2b with 5 of 26 layers (R R L + R R: rec_blocks,
# attn_blocks and extra_rec) at S 1,024 (the 2,048 window does not bite:
# (a) holds it), llama-3.2-vision-11b with 5 layers at S 1,024,
# whisper-base whole at S 448. (c) whisper-base's f32 oracle on the four
# ranks: 3 steps at S 448 against rank 0's one-process step, the encoder's
# non-causal, the decoder's causal and its cross attention on every rank's
# heads. (d) The prefill under the mesh on (b)'s first batch, bf16 each
# family, whisper-base in f32 too. The cross layers' gates at CROSS_GATE.
PH14 = dict(mesh={"data": 2, "model": 2}, B=2, steps=2, oracle_steps=3, oracle_S=512, data_seed=1)
PH14_ORACLE = {"recurrentgemma-2b": dict(num_layers=3, local_window=128),
               "llama-3.2-vision-11b": dict(num_layers=5), "whisper-base": {}}
PH14_TRAIN = {"recurrentgemma-2b": (dict(num_layers=5), 1024), "llama-3.2-vision-11b": (dict(num_layers=5), 1024),
              "whisper-base": ({}, WHISPER_TOKENS)}
PH14_PAIRS = {"recurrentgemma-2b": "256x256", "llama-3.2-vision-11b": "128x128", "whisper-base": "64x64"}
PH14_GRAD_TOL = 1e-3     # (a): each gradient leaf within 1e-3 of its max |g|, as phase 10.2
# (e): build_serve_step under the mesh in float32, B 4 over max_len 1,024 (the ring 1,024 too), 3 steps from
# caches filled from a seed but the cross K/V, which init_cache computes on the rank's blocks (whisper over its
# 1,500 frames: N over 'model', the key-range entry; vision over 1,601 image tokens, which do not divide: D)
PH14_SERVE = dict(B=4, max_len=1024, positions=(0, 511, 1023), seed=14,
                  layers={"recurrentgemma-2b": dict(num_layers=3), "llama-3.2-vision-11b": dict(num_layers=5),
                          "whisper-base": {}})
# (e) again on short caches that the rules cut along D (head_dim over max_len): recurrentgemma-2b's ring of 128
# across its wrap (256 > 128), whisper-base's self caches of 32 (64 > 32; its cross K/V over 1,500 frames along N)
PH14_SHORT = {"recurrentgemma-2b": dict(max_len=128, positions=(0, 127, 300)),
              "whisper-base": dict(max_len=32, positions=(0, 1, 31))}


def family_layers(cfg) -> tuple[int, int]:
    """(attention layers, RG-LRU layers) of one forward: self and cross
    attention, whisper's encoder too."""
    if cfg.family == "hybrid":
        n_p, rem = divmod(cfg.num_layers, 3)
        return n_p, 2 * n_p + rem
    if cfg.family == "encdec":
        return cfg.num_encoder_layers + 2 * cfg.num_layers, 0
    return cfg.num_layers, 0


def batches14(torch, cfg, S: int, n: int, B: int = PH14["B"]) -> list:
    """``n`` global batches of B x S from SyntheticLMDataset(vocab, S, seed=1),
    each with the family's seeded image or audio embeddings."""
    from repro_torch.data import SyntheticLMDataset

    ds = SyntheticLMDataset(cfg.vocab_size, S, seed=PH14["data_seed"])
    emb = family_inputs(torch, cfg, B)
    return [dict(ds.batch(s, B), **emb) for s in range(n)]


def oracle14(torch, arch: str) -> dict:
    """(a) for one family: float32, B 1 x S 512, the loss and every gradient
    through the kernels against the plain route, on the card."""
    cfg, lm = build_family(torch, arch, "float32", **PH14_ORACLE[arch])
    lm.requires_grad_(True)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batches14(torch, cfg, PH14["oracle_S"], 1, B=1)[0].items()}
    counters = train_counters()

    def loss_and_grads():
        lm.zero_grad(set_to_none=True)
        total, _ = lm.loss(batch)
        total.backward()
        bwd = {f"{d}x{dv}": n for (d, dv), n in sorted(counters["flash_attention_bwd"].by_pair.items())}
        return total.detach(), {k: p.grad.clone() for k, p in lm.named_parameters()}, bwd

    pairs = {}
    (k_loss, k_grads, bwd_pairs), k_s, k_launches = counted(torch, loss_and_grads, pairs, counters)
    with plain_attention():
        (p_loss, p_grads, _), _, p_launches = counted(torch, loss_and_grads, counters=counters)
    L, _ = family_layers(cfg)
    pair = PH14_PAIRS[arch]
    check(k_launches["flash_attention"] == 2 * L and k_launches["flash_attention_bwd"] == L
          and pairs == {pair: 2 * L} and bwd_pairs == {pair: L},
          f"phase 14a {arch}: kernel launches {k_launches}, instances {pairs} {bwd_pairs}")
    check(not any(p_launches.values()), f"phase 14a {arch}: the plain route launched {p_launches}")
    loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    check(loss_rel <= 1e-5, f"phase 14a {arch} f32 loss {float(k_loss)!r} vs plain {float(p_loss)!r}")
    worst, worst_leaf = 0.0, None
    for name, g in p_grads.items():
        big = float(g.abs().max())
        err = float((k_grads[name] - g).abs().max())
        check(err <= PH14_GRAD_TOL * big, f"phase 14a {arch} f32 gradient {name}: {err!r} > {PH14_GRAD_TOL} · {big!r}")
        if big and err / big >= worst:
            worst, worst_leaf = err / big, name
    out = dict(layers=cfg.num_layers, cuts=PH14_ORACLE[arch], S=PH14["oracle_S"], loss=float(k_loss),
               plain_loss=float(p_loss), loss_rel_err=loss_rel, worst_grad_rel_err=worst, worst_leaf=worst_leaf,
               leaves=len(p_grads), launches=k_launches, pairs=pairs, bwd_pairs=bwd_pairs, kernel_route_s=k_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"phase 14a {arch} f32 oracle: {json.dumps(out)}")
    del lm, k_grads, p_grads
    return out


def prefill14(torch, arch: str, dtype: str, mesh=None, hidden: bool = False):
    """The prefill step's logits of (b)'s first batch (this rank's rows under
    ``mesh``); with ``hidden`` also the final position's hidden states
    before the final norm, as the step hands them to ``LM._logits``:
    (logits, hidden states)."""
    from repro_torch.runtime.train import build_prefill_step, shard_batch

    over, S = PH14_TRAIN[arch]
    cfg, lm = build_family(torch, arch, dtype, **over)
    batch = {k: v for k, v in batches14(torch, cfg, S, 1)[0].items() if k != "labels"}
    if mesh is None:
        step = build_prefill_step(lm)
    else:
        step, _ = build_prefill_step(lm, mesh=mesh)
        batch = shard_batch(batch, mesh)
        gc.collect()
        torch.cuda.empty_cache()
    seen, logits_of = [], lm._logits
    if hidden:
        def capture(x, rows=None):
            seen.append(x.float().cpu().numpy())
            return logits_of(x, rows)

        lm._logits = capture
    logits = prefill_logged(step, batch, lm.cfg, mesh)
    return (logits, seen[0]) if hidden else logits


def whisper14(torch, mesh=None) -> tuple:
    """(c): whisper-base in float32, PH13_ORACLE's schedule, 3 steps of B 2 x
    S 448: (metrics, step seconds, the model, its parameters before)."""
    from repro_torch.runtime.train import TrainConfig

    cfg, lm = build_family(torch, "whisper-base", "float32")
    before = {k: p.detach().clone() for k, p in lm.named_parameters()} if mesh is None else None
    metrics, times, _ = train_steps(torch, lm, TrainConfig(**PH13_ORACLE),
                                    batches14(torch, cfg, WHISPER_TOKENS, PH14["oracle_steps"]), mesh)
    return metrics, times, lm, before


def serve14(torch, arch: str, mesh=None, max_len: int = PH14_SERVE["max_len"],
            positions: tuple = PH14_SERVE["positions"]) -> dict:
    """(e) for one family: ``build_serve_step`` in float32 (under ``mesh`` on
    this rank's rows and blocks), B 4 over ``max_len``: ``init_cache`` over
    the family's seeded image embeddings or audio frames (under ``mesh`` the
    rank's rows: whisper's encoder on the rank's blocks, each cross layer's
    block of its K/V), every other cache from a seeded generator, steps at
    ``positions`` → {"logits": this rank's rows by step}, and under
    ``mesh`` each step's layers by body and decode launches, the caches'
    cuts (``decode.cache_cuts``) and the rank's holding against the rules'
    bytes."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.models import attention, decode, rglru
    from repro_torch.runtime.pspec import logical_axis_rules
    from repro_torch.runtime.serve import abstract_cache, build_serve_step
    from repro_torch.runtime.sharding import local_block

    cfg, lm = build_family(torch, arch, "float32", **PH14_SERVE["layers"][arch])
    B = PH14_SERVE["B"]
    emb = family_inputs(torch, cfg, B)
    frames = emb["audio_embeds"].shape[1] if "audio_embeds" in emb else None
    whole = abstract_cache(lm, B, max_len, frames=frames)
    if mesh is None:
        step, _ = build_serve_step(lm, B, max_len, frames=frames)
        cache = decode.init_cache(lm, B, max_len, **emb)
        csh, tsh = None, None
    else:
        step, (_, csh, tsh, _), _ = build_serve_step(lm, B, max_len, mesh=mesh, frames=frames)
        with logical_axis_rules(mesh):
            cache = decode.init_cache(lm, B, max_len, **{k: local_block(v, (tsh[0], None, None), mesh)
                                                         for k, v in emb.items()})
    gen = torch.Generator(device="cuda").manual_seed(PH14_SERVE["seed"])
    for k in sorted(k for k in cache if not k.startswith("cross")):
        full = torch.randn(whole[k].shape, generator=gen, device="cuda").to(cache[k].dtype)
        cache[k].copy_(full if csh is None else local_block(full, csh[k], mesh))
        del full
    out = {}
    if mesh is not None:
        out["holding"] = holding(torch, step, cache, cfg, mesh, B, max_len, f"phase 14e {arch}", frames)
        out["cuts"] = decode.cache_cuts(cfg, csh, mesh)
    del lm                      # the step holds this rank's blocks (the whole ones shared)
    gc.collect()
    torch.cuda.empty_cache()
    toks = np.random.default_rng(PH14_SERVE["seed"]).integers(0, cfg.vocab_size, (B, len(positions)))
    counters = (attention.decode_attention_sharded, attention.cross_decode_sharded, rglru.rglru_decode_sharded,
                attention.decode_mlp_sharded, decode.gathered_layer)
    rows, counts, times = [], [], []
    for n, pos in enumerate(positions):
        tok = torch.as_tensor(toks[:, n:n + 1], device="cuda")
        before = [f.calls for f in counters] + [da_ops.decode_attention.launches, da_ops.decode_attention.ranged]
        torch.cuda.synchronize()
        zero_received()
        t1 = time.perf_counter()
        logits, cache = step(tok if tsh is None else local_block(tok, tsh, mesh), cache, pos)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        after = [f.calls for f in counters] + [da_ops.decode_attention.launches, da_ops.decode_attention.ranged]
        counts.append(dict(zip(("attention", "cross", "rglru", "mlp", "gathered", "decode_launches",
                                "range_launches"), (a - b for a, b in zip(after, before)))))
        if mesh is not None:
            log_received("decode", cfg, mesh, n)
        rows.append(logits.float().cpu().numpy())
    del step, cache
    gc.collect()
    torch.cuda.empty_cache()
    return dict(out, logits=np.stack(rows), counts=counts, step_s=times, layers=cfg.num_layers)


def serve14_want(cfg, cuts: dict) -> dict:
    """(e)'s layers by body a step, by the caches' ``cuts``
    (``decode.cache_cuts``): each self-attention layer and each cross layer
    through the decode kernel where its cache is cut along S (N; the
    key-range entry) or its rows, through the plain partial scores where
    along D; every MLP sharded, nothing gathered at use."""
    L = cfg.num_layers
    if cfg.family == "hybrid":
        attn, cross, rec = L // 3, 0, L - L // 3
    elif cfg.family == "vlm":
        cross = L // cfg.cross_attn_every
        attn, rec = L - cross, 0
    else:
        attn, cross, rec = L, L, 0
    self_cut = (cuts.get("ring") or cuts["self"])[0]
    cross_cut = cuts["cross"][0] if cross else None
    launch = (attn if self_cut != 3 else 0) + (cross if cross_cut != 3 else 0)
    ranged = (attn if self_cut == 1 else 0) + (cross if cross_cut == 1 else 0)
    return dict(attention=attn, cross=cross, rglru=rec, mlp=L * (2 if cfg.family == "encdec" else 1), gathered=0,
                decode_launches=launch, range_launches=ranged)


def serve14_runs() -> list:
    """(e)'s runs: (key, arch, serve14's keywords), the short ones keyed
    '<arch> short'."""
    return [(a, a, {}) for a in PH14_SERVE["layers"]] + [(f"{a} short", a, kw) for a, kw in PH14_SHORT.items()]


def phase14_rank(mesh) -> dict:
    """One rank of phase 14 on its blocks: (b) each family's bf16 steps and
    (d) its bf16 prefill, (c) whisper-base's f32 steps with their final
    parameters gathered to rank 0 and its f32 prefill, every kernel counter
    set to 0 before and read after; then on rank 0 alone the one-process
    steps of (c)."""
    import torch

    from repro_torch.models import attention, rglru
    from repro_torch.runtime.sharding import gather_blocks
    from repro_torch.runtime.train import TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    first = mesh.coords == {"data": 0, "model": 0}
    say = print if first else (lambda *a, **k: None)
    res = {"coords": dict(mesh.coords), "backend": mesh.backend, "device": str(mesh.device), "train": {},
           "prefill": {}}
    counters = kernel_counters()
    zero_counts(counters)
    RECEIVED.clear()
    calls0 = attention.attention_sharded.calls, rglru.rglru_sharded.calls
    t0 = time.perf_counter()
    for arch, (over, S) in PH14_TRAIN.items():
        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, lm = build_family(torch, arch, "bfloat16", **over)
        check(cfg.remat, f"phase 14b {arch} trains with remat")
        metrics, times, opt = train_steps(torch, lm, TrainConfig(), batches14(torch, cfg, S, PH14["steps"]), mesh)
        part = dict(metrics=metrics, step_s=times, block_params=sum(p.numel() for p in lm.parameters()),
                    peak_bytes=torch.cuda.max_memory_allocated())
        del lm, opt
        gc.collect()
        torch.cuda.empty_cache()
        if arch == "whisper-base":
            res["prefill"][arch], res["whisper_hidden"] = prefill14(torch, arch, "bfloat16", mesh, hidden=True)
        else:
            res["prefill"][arch] = prefill14(torch, arch, "bfloat16", mesh)
        gc.collect()
        torch.cuda.empty_cache()
        part["part_s"] = time.perf_counter() - t1
        res["train"][arch] = part
        say(f"phase 14b {arch} rank 0 done at {time.perf_counter() - t0:.3f} s: {metrics}", flush=True)
    # (c) whisper-base's f32 oracle, sharded half
    torch.cuda.reset_peak_memory_stats()
    metrics, times, lm, _ = whisper14(torch, mesh)
    res["f32"] = dict(metrics=metrics, step_s=times, peak_bytes=torch.cuda.max_memory_allocated())
    finals = gather_blocks(dict(lm.named_parameters()), lm.placement.specs, mesh, keep=first) or {}
    del lm
    res["prefill"]["whisper-base f32"] = prefill14(torch, "whisper-base", "float32", mesh)
    gc.collect()
    torch.cuda.empty_cache()
    # (e) the serve steps under the mesh
    res["serve"] = {}
    for key, arch, short in serve14_runs():
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        res["serve"][key] = serve14(torch, arch, mesh, **short)
        res["serve"][key].update(part_s=time.perf_counter() - t1, peak_bytes=torch.cuda.max_memory_allocated())
    torch.cuda.synchronize()
    res["sharded_s"] = time.perf_counter() - t0
    res["launches"] = {name: fn.launches for name, fn in counters.items()}
    res["flash_pairs"] = flash_pairs()
    res["bwd_pairs"] = {f"{d}x{dv}": n for (d, dv), n in sorted(counters["flash_attention_bwd"].by_pair.items())}
    res["padded"] = padded_counts(counters)
    res["calls"] = (attention.attention_sharded.calls - calls0[0], rglru.rglru_sharded.calls - calls0[1])
    res["received"] = list(RECEIVED)
    say(f"phase 14c rank 0 done at {res['sharded_s']:.3f} s: {metrics}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    if finals:
        t1 = time.perf_counter()
        metrics, times, lm, before = whisper14(torch)
        by_leaf = param_spread(torch, {k: finals[k].to(mesh.device) for k in finals}, dict(lm.named_parameters()),
                               before)
        del lm, before
        res["oracle"] = dict(metrics=metrics, step_s=times,
                             worst_over_change=max(r["over_change"] for r in by_leaf.values()),
                             worst_share_over_1e2=max(r["share_over_1e2"] for r in by_leaf.values()),
                             leaves=len(by_leaf),
                             worst_leaves=dict(sorted(by_leaf.items(), key=lambda kv: -kv[1]["over_change"])[:4]))
        res["oracle_s"] = time.perf_counter() - t1
    return res


def whisper_split14(torch, ranks: list, want: np.ndarray, rows: tuple) -> dict:
    """(d)'s whisper-base bf16 prefill error under the mesh, split: each
    rank's final hidden states (its rows, last position) projected here by
    the one process's whole table (``LM._logits``: the same product on the
    same rows that a rank ran when it gathered the table whole) against the
    one-process logits (the backbone's part) and against the rank's logits
    (the vocab-parallel product's part), each over the largest |logit| of
    the rank's rows, beside the total."""
    cfg, lm = build_family(torch, "whisper-base", "bfloat16", **PH14_TRAIN["whisper-base"][0])
    mesh = PH14["mesh"]
    out = {}
    for r in ranks:
        c = r["coords"]
        ref = rows_of(want, c, mesh, rows)
        got = r["prefill"]["whisper-base"]
        with torch.no_grad():
            whole = lm._logits(torch.from_numpy(r["whisper_hidden"]).to(lm.device, cfg.cdtype)).float().cpu().numpy()
        big = float(np.abs(ref).max())
        out[str(c)] = dict(total=float(np.abs(got - ref).max()) / big, backbone=float(np.abs(whole - ref).max()) / big,
                           logits=float(np.abs(got - whole).max()) / big)
    del lm
    return out


def phase_sharded_families(torch) -> dict:
    """Phase 14: (a) each family's f32 gradient oracle here, then the
    one-process bf16 steps and prefill logits (and whisper-base's f32
    prefill), then four ranks on the card, each held to them (and rank 0 to
    its own one-process f32 steps of (c))."""
    from repro_torch.models.attention import _decode_bspec
    from repro_torch.runtime.sharding import batch_specs
    from repro_torch.runtime.train import TrainConfig

    t0 = time.perf_counter()
    oracles = {}
    for arch in PH14_ORACLE:
        torch.cuda.reset_peak_memory_stats()
        oracles[arch] = oracle14(torch, arch)
        gc.collect()
        torch.cuda.empty_cache()
    oracle_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    one, want = {}, {}
    for arch, (over, S) in PH14_TRAIN.items():
        torch.cuda.reset_peak_memory_stats()
        cfg, lm = build_family(torch, arch, "bfloat16", **over)
        n_params = sum(p.numel() for p in lm.parameters())
        metrics, times, opt = train_steps(torch, lm, TrainConfig(), batches14(torch, cfg, S, PH14["steps"]))
        one[arch] = dict(metrics=metrics, step_s=times, params=n_params, layers=cfg.num_layers, S=S,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del lm, opt
        gc.collect()
        torch.cuda.empty_cache()
        want[arch] = prefill14(torch, arch, "bfloat16")
        gc.collect()
        torch.cuda.empty_cache()
    want["whisper-base f32"] = prefill14(torch, "whisper-base", "float32")
    gc.collect()
    torch.cuda.empty_cache()
    serve_want = {key: serve14(torch, arch, **short)["logits"] for key, arch, short in serve14_runs()}
    one_s = time.perf_counter() - t1

    ranks, ranks_s = card_ranks(phase14_rank, PH14["mesh"])
    mesh = PH14["mesh"]
    rows = (batch_specs(mesh, {"x": torch.zeros(PH14["B"])})["x"][0], None, None)
    # per rank: (b) 2 steps of two forwards a layer (remat) and a backward,
    # (c) 3 steps of whisper-base's, (d) one forward a layer a prefill
    from repro_torch.configs import get_config

    layers = {arch: family_layers(get_config(arch).replace(**over)) for arch, (over, _) in PH14_TRAIN.items()}
    steps, wsteps, (wL, _) = PH14["steps"], PH14["oracle_steps"], layers["whisper-base"]
    fwd_want = {PH14_PAIRS[a]: 2 * steps * L + L for a, (L, _) in layers.items()}
    fwd_want["64x64"] += 2 * wsteps * wL + wL
    # (e): init_cache under the mesh runs whisper's encoder as the sharded prefill does, a flash launch a layer
    fwd_want["64x64"] += sum(get_config(a).replace(**PH14_SERVE["layers"][a]).num_encoder_layers
                             for _, a, _ in serve14_runs() if a == "whisper-base")
    bwd_want = {PH14_PAIRS[a]: steps * L for a, (L, _) in layers.items()}
    bwd_want["64x64"] += wsteps * wL
    rec_want = sum((2 * steps + 1) * R for _, R in layers.values())
    per_rank = []
    for r in ranks:
        c = r["coords"]
        check(r["backend"] == "gloo" and r["device"].startswith("cuda"), f"phase 14 rank {c}: {r['backend']} {r['device']}")
        fams = {}
        for arch in PH14_TRAIN:
            a, o = np.asarray(r["train"][arch]["metrics"]), np.asarray(one[arch]["metrics"])
            check(bool(np.isfinite(a).all()), f"phase 14b {arch} rank {c} metrics not finite: {a.tolist()}")
            rel = np.abs(a[:, :2] - o[:, :2]) / np.abs(o[:, :2])
            check(bool((rel <= PH13_BF16_LOSS_RTOL).all()),
                  f"phase 14b {arch} rank {c} bf16 losses and norms {a[:, :2].tolist()} vs one process {o[:, :2].tolist()}")
            check(np.array_equal(a[:, 2].astype(np.float32), o[:, 2].astype(np.float32)), f"phase 14b {arch} rank {c} lr")
            fams[arch] = dict(losses=a[:, 0].tolist(), grad_norms=a[:, 1].tolist(), max_rel_err=float(rel.max()),
                              step_s=r["train"][arch]["step_s"], part_s=r["train"][arch]["part_s"],
                              peak_gb=r["train"][arch]["peak_bytes"] / 1e9,
                              block_params=r["train"][arch]["block_params"])
        errs = {}
        for key, got in r["prefill"].items():
            ref = rows_of(want[key], c, mesh, rows)
            tol = PH13_PREFILL_TOL["float32" if key.endswith("f32") else "bfloat16"]
            errs[key] = float(np.abs(got - ref).max() / np.abs(ref).max())
            check(got.shape == ref.shape and errs[key] <= tol,
                  f"phase 14d rank {c} {key} prefill: {errs[key]!r} of the largest logit (limit {tol})")
        # (e) every sharded attention call launched the flash kernel, every
        # training layer its backward, at the families' instances, unpadded
        fwd, bwd = r["launches"]["flash_attention"], r["launches"]["flash_attention_bwd"]
        check(fwd == r["calls"][0] == sum(fwd_want.values()) and r["flash_pairs"] == fwd_want
              and r["bwd_pairs"] == bwd_want and bwd == sum(bwd_want.values()),
              f"phase 14 rank {c}: flash forward {r['flash_pairs']} (want {fwd_want}), backward {r['bwd_pairs']} "
              f"(want {bwd_want}), sharded attention calls {r['calls'][0]}")
        check(r["calls"][1] == rec_want, f"phase 14 rank {c}: rglru_sharded ran {r['calls'][1]} times, not {rec_want}")
        check(not any(r["padded"].values()), f"phase 14 rank {c} took the padded route {r['padded']}")
        # (e) each serve step's rows within float32's limit of one process, the same greedy token; every layer
        # through its sharded body, the key-range entry for every self layer and N-cut cross layer
        srows = (None, _decode_bspec(mesh, PH14_SERVE["B"]), None, None)
        serve_err, launched = {}, 0
        for key, arch, short in serve14_runs():
            sv = r["serve"][key]
            got, ref = sv["logits"], rows_of(serve_want[key], c, mesh, srows)
            serve_err[key] = max_abs_err(torch, torch.from_numpy(got), torch.from_numpy(ref))
            check(got.shape == ref.shape and bool(np.all(np.abs(got - ref) <= F32_TOL + F32_TOL * np.abs(ref))),
                  f"phase 14e rank {c} {key}: logits differ from one process by {serve_err[key]!r}")
            check(np.array_equal(got.argmax(-1), ref.argmax(-1)), f"phase 14e rank {c} {key} argmax differs")
            cfg = get_config(arch).replace(**PH14_SERVE["layers"][arch])
            want_k = serve14_want(cfg, sv["cuts"])
            check(all(k == want_k for k in sv["counts"]), f"phase 14e rank {c} {key}: {sv['counts']}, want {want_k}")
            check(arch != "whisper-base" or sv["cuts"]["cross"] == (1,),
                  f"phase 14e rank {c}: whisper's cross K/V cut along {sv['cuts'].get('cross')}, not N")
            check(not short or (sv["cuts"].get("ring") or sv["cuts"]["self"]) == (3,),
                  f"phase 14e rank {c} {key}: self caches cut along {sv['cuts']}, not D")
            launched += sum(k["decode_launches"] for k in sv["counts"])
        check(r["launches"]["decode_attention"] == launched,
              f"phase 14 rank {c} launched decode_attention {r['launches']['decode_attention']} times, (e) {launched}")
        received = check_received("14", c, r["received"])
        per_rank.append(dict(coords=c, families=fams, f32_step_s=r["f32"]["step_s"],
                             f32_peak_gb=r["f32"]["peak_bytes"] / 1e9, prefill_rel_err=errs,
                             serve_max_abs_err=serve_err,
                             serve={a: dict(holding=v["holding"], cuts=v["cuts"], step_s=v["step_s"],
                                            part_s=v["part_s"], peak_gb=v["peak_bytes"] / 1e9, counts=v["counts"][0])
                                    for a, v in r["serve"].items()}, flash_forward=fwd,
                             flash_backward=bwd, rglru_calls=r["calls"][1], sharded_s=r["sharded_s"],
                             received=received))
        print(f"phase 14 rank {c}: {json.dumps(per_rank[-1])}")
    split = whisper_split14(torch, ranks, want["whisper-base"], rows)
    print(f"phase 14d whisper-base bf16 prefill error over the largest |logit|, split: {json.dumps(split)}")
    # (c): every rank's f32 metrics against rank 0's one-process steps
    r0 = next(r for r in ranks if "oracle" in r)
    oracle = r0["oracle"]
    print(f"phase 14c one-process f32 whisper-base (rank 0, {r0['oracle_s']:.3f} s): {json.dumps(oracle)}")
    want_m = np.asarray(oracle["metrics"])
    check(want_m[0, 2] == 0.0 and want_m[1, 2] > 0, f"phase 14c learning rates {want_m[:, 2].tolist()}")
    f32_rel = 0.0
    for r in ranks:
        got = np.asarray(r["f32"]["metrics"])
        rel = np.abs(got[:, :2] - want_m[:, :2]) / np.abs(want_m[:, :2])
        f32_rel = max(f32_rel, float(rel.max()))
        check(bool((rel <= PH13_LOSS_RTOL).all()) and np.array_equal(got[:, 2], want_m[:, 2]),
              f"phase 14c rank {r['coords']} f32 metrics {got.tolist()} vs one process {want_m.tolist()}")
    check(oracle["worst_over_change"] <= PH13_PARAM_TOL and oracle["worst_share_over_1e2"] <= PH13_PARAM_SHARE[1],
          f"phase 14c parameters: {oracle['worst_over_change']!r} of a leaf's largest change (limit {PH13_PARAM_TOL}), "
          f"{oracle['worst_share_over_1e2']!r} of a leaf beyond {PH13_PARAM_SHARE[0]} (limit {PH13_PARAM_SHARE[1]})")
    # the four ranks' counts and (a)'s kernel route's, in this process
    launches = summed([r["launches"] for r in ranks] + [o["launches"] for o in oracles.values()])
    pairs = summed([r["flash_pairs"] for r in ranks] + [o["pairs"] for o in oracles.values()])
    bwd_pairs = summed([r["bwd_pairs"] for r in ranks] + [o["bwd_pairs"] for o in oracles.values()])
    out = dict(oracles=oracles, one_process=one, ranks=per_rank, whisper_f32=oracle, whisper_f32_max_rel=f32_rel,
               whisper_bf16_split=split,
               launches=launches, flash_pairs=pairs, bwd_pairs=bwd_pairs, oracle_s=oracle_s, one_process_s=one_s,
               ranks_s=ranks_s, wall_s=time.perf_counter() - t0)
    print(f"phase 14 one-process bf16 references: {json.dumps(one)}")
    print(f"phase 14 four ranks on one card (2 x 2 mesh, gloo, collectives staged through host memory): the step "
          f"times above are four processes time-sharing one card, not the sharded step's speed, and are held to no "
          f"bound; (a) oracles {oracle_s:.3f} s, one-process references {one_s:.3f} s, ranks {ranks_s:.3f} s, "
          f"phase {out['wall_s']:.3f} s, launches {launches}, flash by instance {pairs}, backward by instance "
          f"{bwd_pairs}; whisper-base f32 metrics max relative difference {f32_rel!r}")
    return out


# -- phase 15: the moe and ssm families under a mesh, at published width ------
#
# (a) One process, float32, deepseek-v2-236b with 2 of 60 layers (the dense
# first layer and one MoE layer), B 1 x S 512, MOE_IMPL "gather" at the
# published capacity factor 1.25: the loss and every gradient with MLA's
# attention through the flash kernel's (192, 128) forward and backward
# against the plain route (phase 10.2's oracle); where the two routes pick
# different experts for a token the count is printed and both run again at
# the dropless capacity factor 64. (b) Four ranks on the 2 x 2 mesh (gloo,
# one card), bf16, remat, a global B 2 (one row a data rank) against the
# same steps in one process: deepseek-v2-236b (2 layers, S 1,024, adamw8:
# AdamW's float32 moments of one MoE layer alone would take 45 GB) 2 steps
# of the gather dispatch at 1.25, the global slots and capacity, then 1
# step of the a2a at a dropless cut (A2A_DROPLESS: the a2a's per-shard
# capacity cannot equal one process's otherwise); mamba2-780m with 8 of 48
# layers at S 1,024 (four chunks of 256), AdamW, 2 steps. (c) mamba2-780m's
# f32 oracle on the four ranks: 4 layers, S 512, 3 steps against rank 0's
# one-process steps, its parameters gathered. (d) Each prefill under the
# mesh on (b)'s first batch (bf16; mamba2 in f32 too). (e) build_serve_step
# under the mesh, B 4 over max_len 1,024: a prompt of PH15_SERVE["prompt"]
# tokens through the step, then PH15_SERVE["decode"] decode steps, deepseek
# in bf16 (over max_len 256 too: PH15_SERVE_RUNS), mamba2 in bf16 and f32.
# (f) Launches and layer counts.
PH15 = dict(mesh={"data": 2, "model": 2}, B=2, data_seed=1)
PH15_MOE = dict(num_layers=2)                             # of 60: the dense first layer and one MoE layer
PH15_ORACLE = dict(B=1, S=512)
PH15_MOE_TRAIN = dict(S=1024, gather_steps=2, a2a_steps=1)
PH15_SSM = dict(num_layers=8)                             # of 48
PH15_SSM_TRAIN = dict(S=1024, steps=2)
PH15_SSM_ORACLE = dict(num_layers=4, S=512, steps=3)
PH15_SERVE = dict(B=4, max_len=1024, prompt=4, decode=4, seed=15)
# (e)'s runs: (key, arch, dtype, max_len); at max_len 256 the rules cut deepseek's c_kv (B, 256, 512) along its
# latent dimension and k_rope (B, 256, 64) along S (ROADMAP C14's layout)
PH15_SERVE_RUNS = (("deepseek-v2-236b bfloat16", "deepseek-v2-236b", "bfloat16", 1024),
                   ("deepseek-v2-236b bfloat16 c14", "deepseek-v2-236b", "bfloat16", 256),
                   ("mamba2-780m bfloat16", "mamba2-780m", "bfloat16", 1024),
                   ("mamba2-780m float32", "mamba2-780m", "float32", 1024))
# The a2a step's capacity factor: above E / K = 160 / 6, so that a shard's capacity
# int(T_loc · K · cf / E) holds every one of its tokens and nothing drops. MOE12's 64
# (phase 12, forward only) ran out of memory here with four ranks training (H100 80GB HBM3, 700 W).
A2A_DROPLESS = 27.0


def moe15(torch, dtype: str, dev, capacity_factor: float | None = None):
    """deepseek-v2-236b at published width, PH15_MOE's depth, from the seed."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    over = dict(PH15_MOE) | ({} if capacity_factor is None else dict(capacity_factor=capacity_factor))
    cfg = get_config("deepseek-v2-236b").replace(param_dtype=dtype, compute_dtype=dtype, **over)
    return cfg, LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))


def ssm15(torch, dtype: str, dev, layers: int | None = None):
    """mamba2-780m at published width, ``layers`` of its 48 (PH15_SSM's by
    default), from the seed."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config("mamba2-780m").replace(param_dtype=dtype, compute_dtype=dtype,
                                            num_layers=layers or PH15_SSM["num_layers"])
    return cfg, LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))


def batches15(vocab: int, S: int, n: int, B: int = PH15["B"]) -> list:
    from repro_torch.data import SyntheticLMDataset

    ds = SyntheticLMDataset(vocab, S, seed=PH15["data_seed"])
    return [ds.batch(s, B) for s in range(n)]


def routed_ids(torch, fn) -> tuple:
    """``fn()`` with the router spied on: (its result, every routing's
    expert ids in call order, on the host)."""
    from repro_torch.models import moe

    ids, orig = [], moe._route

    def spy(params, xt, cfg, logits=None):
        gates, idx, probs = orig(params, xt, cfg, logits)
        ids.append(idx.cpu())
        return gates, idx, probs

    moe._route = spy
    try:
        return fn(), ids
    finally:
        moe._route = orig


def oracle15(torch) -> dict:
    """(a): deepseek-v2-236b f32, 2 layers, B 1 x S 512, gather at the
    published capacity factor: the loss and every gradient through the
    kernels against the plain route, on the card; at the dropless cut where
    the routes pick different experts for some token."""
    B, S = PH15_ORACLE["B"], PH15_ORACLE["S"]
    out = {}
    for cf in (None, DROPLESS):
        torch.cuda.reset_peak_memory_stats()
        cfg, lm = moe15(torch, "float32", "cuda", cf)
        lm.requires_grad_(True)
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in batches15(cfg.vocab_size, S, 1, B)[0].items()}
        counters = train_counters()

        def loss_and_grads(where=None):
            lm.zero_grad(set_to_none=True)
            total, parts = lm.loss(batch)
            total.backward()
            grads = {k: p.grad if where is None else p.grad.to(where) for k, p in lm.named_parameters()}
            lm.zero_grad(set_to_none=True)          # the gradients move to ``grads``: one copy on the card
            bwd = {f"{d}x{dv}": n for (d, dv), n in sorted(counters["flash_attention_bwd"].by_pair.items())}
            return total.detach(), float(parts["aux"].detach()), grads, bwd

        pairs = {}
        # the kernel route's gradients wait on the host while the plain route's are made
        ((k_loss, k_aux, k_grads, bwd_pairs), k_ids), k_s, k_launches = counted(
            torch, lambda: routed_ids(torch, lambda: loss_and_grads("cpu")), pairs, counters)
        with plain_attention():
            ((p_loss, p_aux, p_grads, _), p_ids), _, p_launches = counted(
                torch, lambda: routed_ids(torch, loss_and_grads), counters=counters)
        flips = sum(int((a != b).any(dim=-1).sum()) for a, b in zip(k_ids, p_ids))
        L = cfg.num_layers
        check(k_launches["flash_attention"] == 2 * L and k_launches["flash_attention_bwd"] == L
              and pairs == {MLA_PAIR: 2 * L} and bwd_pairs == {MLA_PAIR: L},
              f"phase 15a kernel launches {k_launches}, instances {pairs} {bwd_pairs}")
        check(not any(p_launches.values()), f"phase 15a: the plain route launched {p_launches}")
        print(f"phase 15a capacity factor {cfg.capacity_factor}: tokens routed to other experts by the plain route "
              f"{flips} (of {B * S} a routing, {len(k_ids)} routings)")
        if flips and cf is None:
            out["flips_at_1.25"] = flips
            del lm, k_grads, p_grads
            gc.collect()
            torch.cuda.empty_cache()
            continue
        loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
        check(loss_rel <= 1e-5, f"phase 15a f32 loss {float(k_loss)!r} vs plain {float(p_loss)!r}")
        worst, worst_leaf = 0.0, None
        for name, g in p_grads.items():
            big = float(g.abs().max())
            err = float((k_grads[name].to(g.device) - g).abs().max())
            check(err <= PH14_GRAD_TOL * big, f"phase 15a f32 gradient {name}: {err!r} > {PH14_GRAD_TOL} · {big!r}")
            if big and err / big >= worst:
                worst, worst_leaf = err / big, name
        out |= dict(layers=L, capacity_factor=cfg.capacity_factor, B=B, S=S, loss=float(k_loss),
                    plain_loss=float(p_loss), aux=k_aux, loss_rel_err=loss_rel, worst_grad_rel_err=worst,
                    worst_leaf=worst_leaf, leaves=len(p_grads), flips=flips, launches=k_launches, pairs=pairs,
                    bwd_pairs=bwd_pairs, kernel_route_s=k_s, params=sum(p.numel() for p in lm.parameters()),
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del lm, k_grads, p_grads
        gc.collect()
        torch.cuda.empty_cache()
        break
    print(f"phase 15a deepseek-v2-236b f32 oracle: {json.dumps(out)}")
    return out


def moe15_steps(torch, lm, mesh=None) -> tuple:
    """(b)'s deepseek-v2-236b steps (under ``mesh`` on this rank's rows):
    the gather dispatch at the published capacity factor, then the a2a at
    ``A2A_DROPLESS`` (one process: the gather at it, the same function);
    (metrics, seconds a step)."""
    from repro_torch.models import moe
    from repro_torch.runtime.train import TrainConfig, build_train_step, init_opt_state, shard_batch

    tcfg = TrainConfig(optimizer="adamw8")
    step = build_train_step(lm, tcfg) if mesh is None else build_train_step(lm, tcfg, mesh=mesh)[0]
    opt = init_opt_state(lm, tcfg.optimizer)
    gc.collect()
    torch.cuda.empty_cache()
    n_g, n_a = PH15_MOE_TRAIN["gather_steps"], PH15_MOE_TRAIN["a2a_steps"]
    metrics, times = [], []
    cfg = lm.cfg
    try:
        for i, b in enumerate(batches15(cfg.vocab_size, PH15_MOE_TRAIN["S"], n_g + n_a)):
            if i == n_g:
                lm.cfg = cfg.replace(capacity_factor=A2A_DROPLESS)
                moe.set_moe_impl("a2a")
            b = b if mesh is None else shard_batch(b, mesh)
            torch.cuda.synchronize()
            zero_received()
            t0 = time.perf_counter()
            m = step(opt, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if mesh is not None:
                log_received("train", cfg, mesh, i)
            metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
    finally:
        moe.set_moe_impl("gather")
        lm.cfg = cfg
    del opt
    return metrics, times


def prefill15(torch, arch: str, dtype: str, dev, mesh=None) -> np.ndarray:
    """The prefill step's logits of (b)'s first batch (this rank's rows under ``mesh``)."""
    from repro_torch.runtime.train import build_prefill_step, shard_batch

    if arch == "mamba2-780m":
        cfg, lm = ssm15(torch, dtype, dev)
        S = PH15_SSM_TRAIN["S"]
    else:
        cfg, lm = moe15(torch, dtype, dev)
        S = PH15_MOE_TRAIN["S"]
    batch = {"tokens": batches15(cfg.vocab_size, S, 1)[0]["tokens"]}
    if mesh is None:
        step = build_prefill_step(lm)
    else:
        step, _ = build_prefill_step(lm, mesh=mesh)
        batch = shard_batch(batch, mesh)
        gc.collect()
        torch.cuda.empty_cache()
    return prefill_logged(step, batch, lm.cfg, mesh)


def serve15(torch, arch: str, dtype: str, dev, mesh=None, max_len: int = PH15_SERVE["max_len"]) -> tuple:
    """(e): build_serve_step (under ``mesh`` on this rank's rows and blocks)
    over PH15_SERVE's prompt and decode steps from empty caches of
    ``max_len``: (each step's logits (this rank's rows), stacked; each
    step's routings, as (the global rows routed, their expert ids) on the
    host, under ``mesh`` the rows this rank routed; under ``mesh`` the
    rank's holding against the rules' bytes (``holding``) and its caches'
    cuts (``decode.cache_cuts``), else None and None)."""
    from repro_torch.models import decode, moe
    from repro_torch.runtime.pspec import logical_axis_rules
    from repro_torch.runtime.serve import build_serve_step
    from repro_torch.runtime.sharding import local_block

    cfg, lm = (ssm15 if arch == "mamba2-780m" else moe15)(torch, dtype, dev)
    B = PH15_SERVE["B"]
    n = PH15_SERVE["prompt"] + PH15_SERVE["decode"]
    toks = np.random.default_rng(PH15_SERVE["seed"]).integers(0, cfg.vocab_size, (B, n))
    if mesh is None:
        step, _ = build_serve_step(lm, B, max_len)
        cache = decode.init_cache(lm, B, max_len)
        cut, cuts = (lambda t: t), None  # noqa: E731
    else:
        step, (_, csh, tsh, _), _ = build_serve_step(lm, B, max_len, mesh=mesh)
        with logical_axis_rules(mesh):
            cache = decode.init_cache(lm, B, max_len)
        cut, cuts = (lambda t: local_block(t, tsh, mesh)), decode.cache_cuts(cfg, csh, mesh)  # noqa: E731
    held = None if mesh is None else holding(torch, step, cache, cfg, mesh, B, max_len, f"phase 15e {arch} {dtype}")
    del lm                      # the step holds this rank's blocks (the whole ones shared)
    gc.collect()
    torch.cuda.empty_cache()
    # a one-token step's routing: the rows are the global token indices (every row without a mesh)
    rows_of_call, orig = [], moe._gather_dispatch

    def spy(params, xt, tok, *args):
        rows_of_call.append(tok.cpu().numpy())
        return orig(params, xt, tok, *args)

    moe._gather_dispatch = spy
    logits_by_step, routes = [], []
    try:
        for pos in range(n):
            rows_of_call.clear()
            zero_received()
            (logits, cache), ids = routed_ids(torch, lambda: step(
                cut(torch.as_tensor(toks[:, pos:pos + 1], device=dev)), cache, pos))
            if mesh is not None:
                log_received("decode", cfg, mesh, pos)
            logits_by_step.append(logits.float().cpu().numpy())
            routes.append([(rows_of_call[i] if rows_of_call else np.arange(B), e.numpy()) for i, e in enumerate(ids)])
    finally:
        moe._gather_dispatch = orig
    del step, cache
    return np.stack(logits_by_step), routes, held, cuts


def rerouted(one_routes: list, rank_routes: list) -> set:
    """The (step, global row) pairs whose tokens the ranks sent to other
    experts than the one process did, at any moe layer."""
    out = set()
    for routes in rank_routes:
        for step, (calls, want) in enumerate(zip(routes, one_routes)):
            for (rows, ids), (_, want_ids) in zip(calls, want):
                for row, e in zip(rows, ids):
                    if row >= 0 and set(e.tolist()) != set(want_ids[row].tolist()):
                        out.add((step, int(row)))
    return out


def layer_counts() -> dict:
    """The sharded layers' calls so far, this process."""
    from repro_torch.models import decode, mla, moe, ssm

    return {"mla_sharded": mla.mla_sharded.calls, "mla_decode_sharded": mla.mla_decode_sharded.calls,
            "mamba_sharded": ssm.mamba_sharded.calls, "moe_gather_sharded": moe.moe_gather_sharded.calls,
            "moe_a2a_sharded": moe.moe_a2a_sharded.calls, "dropped": moe.moe_gather_sharded.dropped,
            "mamba_decode_sharded": ssm.mamba_decode_sharded.calls, "gathered_layer": decode.gathered_layer.calls}


def phase15_rank(mesh) -> dict:
    """One rank of phase 15 on its blocks: (b) each family's bf16 steps,
    (d) its prefills, (c) mamba2's f32 steps with their final parameters
    gathered to rank 0, (e) the serve steps; every kernel counter set to 0
    before and read after; then on rank 0 alone the one-process steps of
    (c)."""
    import torch

    from repro_torch.runtime.sharding import gather_blocks
    from repro_torch.runtime.train import TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    first = mesh.coords == {"data": 0, "model": 0}
    say = print if first else (lambda *a, **k: None)
    res = {"coords": dict(mesh.coords), "backend": mesh.backend, "device": str(dev), "train": {}, "prefill": {},
           "serve": {}}
    counters = kernel_counters()
    zero_counts(counters)
    calls0 = layer_counts()
    t0 = time.perf_counter()
    # (b) deepseek-v2-236b, then (d) its prefill
    torch.cuda.reset_peak_memory_stats()
    cfg, lm = moe15(torch, "bfloat16", dev)
    check(cfg.remat, "phase 15b trains with remat")
    dropped = layer_counts()["dropped"]
    RECEIVED.clear()
    metrics, times = moe15_steps(torch, lm, mesh)
    res["train"]["deepseek-v2-236b"] = dict(metrics=metrics, step_s=times, peak_bytes=torch.cuda.max_memory_allocated(),
                                            block_params=sum(p.numel() for p in lm.parameters()),
                                            dropped=layer_counts()["dropped"] - dropped)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 15b deepseek-v2-236b rank 0 done at {time.perf_counter() - t0:.3f} s: {metrics}", flush=True)
    res["prefill"]["deepseek-v2-236b"] = prefill15(torch, "deepseek-v2-236b", "bfloat16", dev, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    # (b) mamba2-780m, then (d) its prefills
    torch.cuda.reset_peak_memory_stats()
    cfg, lm = ssm15(torch, "bfloat16", dev)
    metrics, times, _ = train_steps(torch, lm, TrainConfig(),
                                    batches15(cfg.vocab_size, PH15_SSM_TRAIN["S"], PH15_SSM_TRAIN["steps"]), mesh)
    res["train"]["mamba2-780m"] = dict(metrics=metrics, step_s=times, peak_bytes=torch.cuda.max_memory_allocated(),
                                       block_params=sum(p.numel() for p in lm.parameters()))
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    say(f"phase 15b mamba2-780m rank 0 done at {time.perf_counter() - t0:.3f} s: {metrics}", flush=True)
    for dtype in ("bfloat16", "float32"):
        res["prefill"][f"mamba2-780m {dtype}"] = prefill15(torch, "mamba2-780m", dtype, dev, mesh)
        gc.collect()
        torch.cuda.empty_cache()
    # (c) mamba2's f32 oracle, sharded half
    torch.cuda.reset_peak_memory_stats()
    cfg, lm = ssm15(torch, "float32", dev, PH15_SSM_ORACLE["num_layers"])
    metrics, times, _ = train_steps(torch, lm, TrainConfig(**PH13_ORACLE), batches15(
        cfg.vocab_size, PH15_SSM_ORACLE["S"], PH15_SSM_ORACLE["steps"]), mesh)
    res["f32"] = dict(metrics=metrics, step_s=times, peak_bytes=torch.cuda.max_memory_allocated())
    finals = gather_blocks(dict(lm.named_parameters()), lm.placement.specs, mesh, keep=first) or {}
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    # (e) the serve steps
    res["routes"], res["holding"], res["cuts"] = {}, {}, {}
    for key, arch, dtype, max_len in PH15_SERVE_RUNS:
        t1 = time.perf_counter()
        res["serve"][key], res["routes"][key], res["holding"][key], res["cuts"][key] = \
            serve15(torch, arch, dtype, dev, mesh, max_len)
        res["serve"][f"{key} s"] = time.perf_counter() - t1
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    res["sharded_s"] = time.perf_counter() - t0
    res["launches"] = {name: fn.launches for name, fn in counters.items()}
    res["flash_pairs"] = flash_pairs()
    res["bwd_pairs"] = {f"{d}x{dv}": n for (d, dv), n in sorted(counters["flash_attention_bwd"].by_pair.items())}
    res["padded"] = padded_counts(counters)
    res["calls"] = {k: v - calls0[k] for k, v in layer_counts().items()}
    res["received"] = list(RECEIVED)
    say(f"phase 15 rank 0 sharded parts done at {res['sharded_s']:.3f} s", flush=True)
    if finals:
        t1 = time.perf_counter()
        cfg, lm = ssm15(torch, "float32", dev, PH15_SSM_ORACLE["num_layers"])
        before = {k: p.detach().clone() for k, p in lm.named_parameters()}
        metrics, times, _ = train_steps(torch, lm, TrainConfig(**PH13_ORACLE), batches15(
            cfg.vocab_size, PH15_SSM_ORACLE["S"], PH15_SSM_ORACLE["steps"]))
        by_leaf = param_spread(torch, {k: finals[k].to(dev) for k in finals}, dict(lm.named_parameters()), before)
        del lm, before
        res["oracle"] = dict(metrics=metrics, step_s=times,
                             worst_over_change=max(r["over_change"] for r in by_leaf.values()),
                             worst_share_over_1e2=max(r["share_over_1e2"] for r in by_leaf.values()),
                             leaves=len(by_leaf),
                             worst_leaves=dict(sorted(by_leaf.items(), key=lambda kv: -kv[1]["over_change"])[:4]))
        res["oracle_s"] = time.perf_counter() - t1
    return res


def phase_sharded_moe_ssm(torch) -> dict:
    """Phase 15: (a) deepseek-v2-236b's f32 gradient oracle here, then the
    one-process bf16 steps, prefills and serve steps (mamba2's f32 ones
    too), then four ranks on the card, each held to them (and rank 0 to its
    own one-process f32 steps of (c))."""
    from repro_torch.models.attention import _decode_bspec
    from repro_torch.runtime.sharding import batch_specs
    from repro_torch.runtime.train import TrainConfig

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    oracle = oracle15(torch)
    gc.collect()
    torch.cuda.empty_cache()
    oracle_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    one, want, serve = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    cfg, lm = moe15(torch, "bfloat16", dev)
    n_params = sum(p.numel() for p in lm.parameters())
    metrics, times = moe15_steps(torch, lm)
    one["deepseek-v2-236b"] = dict(metrics=metrics, step_s=times, params=n_params, layers=cfg.num_layers,
                                   S=PH15_MOE_TRAIN["S"], peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, lm = ssm15(torch, "bfloat16", dev)
    metrics, times, opt = train_steps(torch, lm, TrainConfig(),
                                      batches15(cfg.vocab_size, PH15_SSM_TRAIN["S"], PH15_SSM_TRAIN["steps"]))
    one["mamba2-780m"] = dict(metrics=metrics, step_s=times, params=sum(p.numel() for p in lm.parameters()),
                              layers=cfg.num_layers, S=PH15_SSM_TRAIN["S"],
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del lm, opt
    gc.collect()
    torch.cuda.empty_cache()
    for key, arch, dtype in (("deepseek-v2-236b", "deepseek-v2-236b", "bfloat16"),
                             ("mamba2-780m bfloat16", "mamba2-780m", "bfloat16"),
                             ("mamba2-780m float32", "mamba2-780m", "float32")):
        want[key] = prefill15(torch, arch, dtype, dev)
        gc.collect()
        torch.cuda.empty_cache()
    routes = {}
    for key, arch, dtype, max_len in PH15_SERVE_RUNS:
        serve[key], routes[key], _, _ = serve15(torch, arch, dtype, dev, max_len=max_len)
        gc.collect()
        torch.cuda.empty_cache()
    one_s = time.perf_counter() - t1

    ranks, ranks_s = card_ranks(phase15_rank, PH15["mesh"])
    mesh = PH15["mesh"]
    rows = (batch_specs(mesh, {"x": torch.zeros(PH15["B"])})["x"][0], None, None)
    srows = (None, _decode_bspec(mesh, PH15_SERVE["B"]), None, None)
    # per rank: (b) deepseek's 3 steps of two forwards an MLA layer (remat)
    # and a backward, (d) one forward a layer a prefill; the dispatch by
    # step: 2 gather and 1 a2a steps, two calls each (remat), the prefill
    # and every serve step through the gather
    moe_L = PH15_MOE["num_layers"]
    routed = moe_L - 1
    n_g, n_a = PH15_MOE_TRAIN["gather_steps"], PH15_MOE_TRAIN["a2a_steps"]
    n_serve = PH15_SERVE["prompt"] + PH15_SERVE["decode"]
    ssm_L, ssm_oL = PH15_SSM["num_layers"], PH15_SSM_ORACLE["num_layers"]
    moe_serves = sum(arch == "deepseek-v2-236b" for _, arch, _, _ in PH15_SERVE_RUNS)
    want_calls = {"mla_sharded": 2 * moe_L * (n_g + n_a) + moe_L, "mla_decode_sharded": moe_L * n_serve * moe_serves,
                  "mamba_sharded": 2 * ssm_L * PH15_SSM_TRAIN["steps"] + 2 * ssm_L
                  + 2 * ssm_oL * PH15_SSM_ORACLE["steps"],
                  "moe_gather_sharded": routed * (2 * n_g + 1 + n_serve * moe_serves),
                  "moe_a2a_sharded": 2 * routed * n_a,
                  "mamba_decode_sharded": 2 * ssm_L * n_serve, "gathered_layer": 0}
    # (e): the (step, row) pairs a bf16 near-tie at the top k sent to other experts under the mesh
    # (the moe layer is the last: the difference reaches that step's logits of that row alone)
    flips = {key: rerouted(one_routes, [r["routes"][key] for r in ranks]) for key, one_routes in routes.items()}
    print(f"phase 15e (step, row) pairs routed to other experts than in one process: "
          f"{ {k: sorted(v) for k, v in flips.items()} }")
    per_rank = []
    for r in ranks:
        c = r["coords"]
        check(r["backend"] == "gloo" and r["device"].startswith("cuda"), f"phase 15 rank {c}: {r['backend']} {r['device']}")
        fams = {}
        for arch in ("deepseek-v2-236b", "mamba2-780m"):
            a, o = np.asarray(r["train"][arch]["metrics"]), np.asarray(one[arch]["metrics"])
            check(bool(np.isfinite(a).all()), f"phase 15b {arch} rank {c} metrics not finite: {a.tolist()}")
            rel = np.abs(a[:, :2] - o[:, :2]) / np.abs(o[:, :2])
            check(bool((rel <= PH13_BF16_LOSS_RTOL).all()),
                  f"phase 15b {arch} rank {c} bf16 losses and norms {a[:, :2].tolist()} vs one process {o[:, :2].tolist()}")
            check(np.array_equal(a[:, 2].astype(np.float32), o[:, 2].astype(np.float32)), f"phase 15b {arch} rank {c} lr")
            fams[arch] = dict(losses=a[:, 0].tolist(), grad_norms=a[:, 1].tolist(), max_rel_err=float(rel.max()),
                              step_s=r["train"][arch]["step_s"], peak_gb=r["train"][arch]["peak_bytes"] / 1e9,
                              block_params=r["train"][arch]["block_params"])
        drops = r["train"]["deepseek-v2-236b"]["dropped"]
        check(drops > 0, f"phase 15b rank {c}: the gather dispatch dropped no token at capacity factor 1.25")
        errs = {}
        for key, got in r["prefill"].items():
            ref = rows_of(want[key], c, mesh, rows)
            tol = PH13_PREFILL_TOL["float32" if key.endswith("float32") else "bfloat16"]
            errs[key] = float(np.abs(got - ref).max() / np.abs(ref).max())
            check(got.shape == ref.shape and errs[key] <= tol,
                  f"phase 15d rank {c} {key} prefill: {errs[key]!r} of the largest logit (limit {tol})")
        serr = {}
        check(r["cuts"]["deepseek-v2-236b bfloat16 c14"] == {"dense": (2, 1), "moe": (2, 1)},
              f"phase 15e rank {c}: the c14 run's latent caches cut along {r['cuts']}")
        row0 = c["data"] * (PH15_SERVE["B"] // mesh["data"])
        for key, ref_all in serve.items():
            got, ref = r["serve"][key], rows_of(ref_all, c, mesh, srows)
            check(got.shape == ref.shape and bool(np.isfinite(got).all()), f"phase 15e rank {c} {key}: {got.shape}")
            same = np.array([[(t, row0 + j) not in flips[key] for j in range(got.shape[1])] for t in range(len(got))])
            check(same.mean() >= 0.5, f"phase 15e rank {c} {key}: most rows routed otherwise {flips[key]}")
            if key.endswith("float32"):
                check(bool(np.all(np.abs(got - ref)[same] <= F32_TOL + F32_TOL * np.abs(ref)[same])),
                      f"phase 15e rank {c} {key}: max |diff| {float(np.abs(got - ref)[same].max())!r}")
                serr[key] = float(np.abs(got - ref)[same].max())
            else:
                serr[key] = bf16_close(got[same], ref[same], f"phase 15e rank {c} {key}")
            if not same.all():
                serr[f"{key} rerouted"] = float(np.abs(got - ref)[~same].max() / np.abs(ref).max())
        # (f) every mla_sharded call launched the flash kernel's (192, 128)
        # instance, every training layer its backward; the layer counters
        fwd, bwd = r["launches"]["flash_attention"], r["launches"]["flash_attention_bwd"]
        want_fwd, want_bwd = want_calls["mla_sharded"], moe_L * (n_g + n_a)
        check(fwd == r["calls"]["mla_sharded"] == want_fwd and r["flash_pairs"] == {MLA_PAIR: want_fwd}
              and r["bwd_pairs"] == {MLA_PAIR: want_bwd} and bwd == want_bwd,
              f"phase 15 rank {c}: flash forward {r['flash_pairs']} backward {r['bwd_pairs']}, calls {r['calls']} "
              f"(want {want_fwd} and {want_bwd})")
        check({k: r["calls"][k] for k in want_calls} == want_calls,
              f"phase 15 rank {c}: sharded layer calls {r['calls']}, want {want_calls}")
        check(not any(r["padded"].values()), f"phase 15 rank {c} took the padded route {r['padded']}")
        check(r["launches"]["decode_attention"] == 0, f"phase 15 rank {c} launched decode_attention")
        received = check_received("15", c, r["received"])
        per_rank.append(dict(coords=c, families=fams, dropped=drops, f32_step_s=r["f32"]["step_s"],
                             f32_peak_gb=r["f32"]["peak_bytes"] / 1e9, prefill_rel_err=errs, serve_err=serr,
                             serve_s={k: v for k, v in r["serve"].items() if k.endswith(" s")},
                             serve_holding=r["holding"], serve_cuts=r["cuts"],
                             flash_forward=fwd, flash_backward=bwd, calls=r["calls"], sharded_s=r["sharded_s"],
                             received=received))
        print(f"phase 15 rank {c}: {json.dumps(per_rank[-1])}")
    # (c): every rank's f32 metrics against rank 0's one-process steps
    r0 = next(r for r in ranks if "oracle" in r)
    ssm_oracle = r0["oracle"]
    print(f"phase 15c one-process f32 mamba2-780m (rank 0, {r0['oracle_s']:.3f} s): {json.dumps(ssm_oracle)}")
    want_m = np.asarray(ssm_oracle["metrics"])
    check(want_m[0, 2] == 0.0 and want_m[1, 2] > 0, f"phase 15c learning rates {want_m[:, 2].tolist()}")
    f32_rel = 0.0
    for r in ranks:
        got = np.asarray(r["f32"]["metrics"])
        rel = np.abs(got[:, :2] - want_m[:, :2]) / np.abs(want_m[:, :2])
        f32_rel = max(f32_rel, float(rel.max()))
        check(bool((rel <= PH13_LOSS_RTOL).all()) and np.array_equal(got[:, 2], want_m[:, 2]),
              f"phase 15c rank {r['coords']} f32 metrics {got.tolist()} vs one process {want_m.tolist()}")
    check(ssm_oracle["worst_over_change"] <= PH13_PARAM_TOL
          and ssm_oracle["worst_share_over_1e2"] <= PH13_PARAM_SHARE[1],
          f"phase 15c parameters: {ssm_oracle['worst_over_change']!r} of a leaf's largest change (limit "
          f"{PH13_PARAM_TOL}), {ssm_oracle['worst_share_over_1e2']!r} of a leaf beyond {PH13_PARAM_SHARE[0]} "
          f"(limit {PH13_PARAM_SHARE[1]})")
    # the four ranks' counts and (a)'s kernel route's, in this process
    launches = summed([r["launches"] for r in ranks] + [oracle["launches"]])
    pairs = summed([r["flash_pairs"] for r in ranks] + [oracle["pairs"]])
    bwd_pairs = summed([r["bwd_pairs"] for r in ranks] + [oracle["bwd_pairs"]])
    out = dict(oracle=oracle, one_process=one, ranks=per_rank, mamba_f32=ssm_oracle, mamba_f32_max_rel=f32_rel,
               rerouted={k: len(v) for k, v in flips.items()},
               launches=launches, flash_pairs=pairs, bwd_pairs=bwd_pairs, oracle_s=oracle_s, one_process_s=one_s,
               ranks_s=ranks_s, wall_s=time.perf_counter() - t0)
    print(f"phase 15 one-process bf16 references: {json.dumps(one)}")
    print(f"phase 15 four ranks on one card (2 x 2 mesh, gloo, collectives staged through host memory): the step "
          f"times above are four processes time-sharing one card, not the sharded step's speed, and are held to no "
          f"bound; (a) oracle {oracle_s:.3f} s, one-process references {one_s:.3f} s, ranks {ranks_s:.3f} s, "
          f"phase {out['wall_s']:.3f} s, launches {launches}, flash by instance {pairs}, backward by instance "
          f"{bwd_pairs}; mamba2-780m f32 metrics max relative difference {f32_rel!r}")
    return out


# -- phase 16: the int8 pod-compressed training step, and the per-rank dry run --
#
# Four ranks on the one card over gloo, mesh {"pod": 2, "data": 1, "model": 2}
# (a pod's mesh cut to 2 pods of 2; NCCL refuses two ranks a card): gemma2-9b at
# phase 13's cut (2 of 42 layers, bf16, remat), a global B 2 × S 2,048 (a
# row a pod), AdamW with no warmup (the first step moves the parameters),
# labels unmasked (every pod counts as many). (a) From one initial state, one
# compressed step (``compress_pod_grads``) and one uncompressed step: the
# losses within phase 13's bf16 limit; the grad norms within the
# quantization bound plus phase 13's bf16 limit (the reference's sum
# dequantizes every pod's codes with the mean scale s̄, so an element lies
# within (1/n)·Σ_p (s_p/2 + 127·|s̄ − s_p|) of the pods' mean; the norms
# differ by at most the root of Σ over the leaves of their size times that
# squared); the parameters: AdamW's first step moves an element by
# lr·(g/(|g| + ε) + wd·p), so where both steps moved it the same way
# their results differ by less than lr beyond one bf16 unit in the last
# place (each result is rounded to bf16), which is held. Phase 13's limits
# (1e-1 and 1e-2 of the change) cannot hold: an element whose int8 codes
# summed to 0 moves by weight decay alone, one whose |g| is near ε by
# another share of lr, and bf16's unit exceeds lr where |p| > 0.04; the
# shares moved alike and opposite, and beyond 1e-2 and 1e-1 of lr, are
# printed. (b) On each rank the
# synced gradient of one leaf (the reference's blocks/attn/wk, both layers:
# its scale is the stacked leaf's) bit for bit a NumPy twin of the
# reference's arithmetic fed the per-pod gradients gathered whole (float32,
# then the leaf's bf16). (c) One more compressed step and one step of phase
# 13's cell (the 2 × 2 ('data', 'model') mesh over the same ranks), each
# counted under ``OpAnalysis`` with ``received`` zeroed, against the
# per-rank ``meta`` dry run of the same cell in this process: bytes received
# by kind and the largest call to the byte, FLOPs and the rank's argument
# bytes exactly. Prints the int32 bytes the compressed step receives over
# 'pod' beside the bf16 bytes the uncompressed one does.
# The mesh is a pod's cut to 2 pods of 2 'model' ranks ('data' 1: a mesh's axes are a suffix of (pod, data, model)).
PH16 = dict(mesh={"pod": 2, "data": 1, "model": 2}, cell13={"data": 2, "model": 2}, B=2, S=2048,
            leaf="blocks/attn/wk")
PH16_TCFG = dict(warmup_steps=0, total_steps=10)     # lr = peak at step 0


def ph16_shapes():
    from repro_torch.configs.shapes import Shape

    return Shape("phase16", PH16["S"], PH16["B"], "train")


def ph16_meta(torch) -> dict:
    """The per-rank meta dry run of phase 16's compressed cell and of phase
    13's cell (rank 0 each), in this process: FLOPs, bytes received by kind,
    the largest call, the argument bytes by group (held and by the rules),
    seconds."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun

    out = {}
    for name, shape, compress in (("ph16", PH16["mesh"], True), ("ph13", PH16["cell13"], False)):
        t0 = time.perf_counter()
        cost, coll, whole, held, _, _, _ = dryrun.analyze_rank_step(
            gemma13_cfg("bfloat16"), Shape("phase16", PH16["S"], PH16["B"], "train"), shape,
            compress_pod_grads=compress)
        out[name] = dict(flops=int(cost.flops), by_kind=coll["by_kind"], largest=coll["largest"], held=held,
                         rules=dryrun.argument_bytes(shape, whole, "train"), top=coll["top"][:3],
                         s=time.perf_counter() - t0)
    return out


def pod_bytes(calls: dict) -> dict:
    """Bytes received over 'pod', by type, from ``received.calls``."""
    out: dict = {}
    for desc, (count, nbytes) in calls.items():
        _, axis, rest = desc.split(" ", 2)
        if axis == "pod":
            dtype = rest.split("[", 1)[0]
            out[dtype] = out.get(dtype, 0) + count * nbytes
    return out


def sync_twin(per_pod: np.ndarray) -> np.ndarray:
    """The reference's ``sync`` of one leaf (src/repro/runtime/train.py:108-114)
    in NumPy, over its pods' float32 gradients stacked on axis 0."""
    n = per_pod.shape[0]
    qs, scales = [], []
    for x in per_pod:
        scale = np.maximum(np.max(np.abs(x)), np.float32(1e-12)) / np.float32(127.0)
        qs.append(np.clip(np.rint(x / scale), -127, 127).astype(np.int8).astype(np.int32))
        scales.append(scale)
    summed, scale_sum = sum(qs), np.float32(sum(scales))
    return (summed.astype(np.float32) * (scale_sum / np.float32(n))) / np.float32(n)


def ph16_twin(torch, seen: dict, names: list, psh: dict, mesh) -> list:
    """(b): the pods' whole gradients of phase 16's leaf gathered, the
    NumPy twin's sync of them, and each layer's count of bf16 elements of
    the rank's synced block that differ from the twin's."""
    from repro_torch.launch.mesh import all_gather, gather_dims
    from repro_torch.runtime.sharding import local_block

    with torch.no_grad():
        pods = [all_gather(gather_dims(seen["before"][k], psh[k], mesh)[None], "pod", mesh, dim=0) for k in names]
    per_pod = np.stack([t.float().cpu().numpy() for t in pods], axis=1)      # (pods, layers, ...)
    want = torch.from_numpy(sync_twin(per_pod)).to(torch.bfloat16)
    return [int((seen["after"][k].cpu().view(torch.int16) != local_block(want[i], psh[k], mesh).view(torch.int16))
                .sum()) for i, k in enumerate(names)]


def ph16_step(torch, mesh, compress: bool, *, steps: int = 1, count: bool = False, keep: bool = False) -> dict:
    """gemma2-9b at phase 13's cut on this rank under ``mesh``: ``steps``
    steps of phase 16's batch, compressed or not (the first step's bytes
    received kept; compressed under a pod axis, (b) on phase 16's leaf),
    then with ``count`` one more under ``OpAnalysis`` with ``received``
    zeroed; with ``keep`` the parameter blocks before and after on the card."""
    from repro_torch.launch.mesh import received
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.optim.adamw import stack_position
    from repro_torch.runtime import train
    from repro_torch.runtime.train import TrainConfig, build_train_step, init_opt_state, shard_batch

    _, lm = gemma13(torch, "bfloat16", mesh.device)
    tcfg = TrainConfig(compress_pod_grads=compress, **PH16_TCFG)
    step, (psh, _) = build_train_step(lm, tcfg, mesh=mesh)
    opt = init_opt_state(lm, tcfg.optimizer)
    batch = shard_batch(batches13(PH16["S"])[0], mesh)
    gc.collect()
    torch.cuda.empty_cache()
    res: dict = {"held": {"params": sum(p.numel() * p.element_size() for p in lm.parameters()),
                          "opt": tree_bytes(opt), "batch": tree_bytes(batch)}}
    if keep:     # on the host (four ranks share the card's memory)
        res["before"] = {k: p.detach().to("cpu", copy=True) for k, p in lm.named_parameters()}
    names = [k for k, _ in lm.named_parameters() if stack_position(k)
             and "/".join(stack_position(k)[0]) == PH16["leaf"]] if compress and "pod" in mesh else []
    orig, seen = train._int8_pod_sum, {}

    def capture(grads, layout, m):
        seen["before"] = {k: grads[k].detach().clone() for k in names}
        info = orig(grads, layout, m)
        seen["after"] = {k: grads[k].detach().clone() for k in names}
        seen["scales"] = {leaf: [float(a), float(b)] for leaf, (a, b) in info.items()}
        return info

    train._int8_pod_sum = capture
    try:
        metrics, times = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            received.zero()
            t0 = time.perf_counter()
            m = step(opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
            if i == 0:
                res["pod_bytes"], res["received"] = pod_bytes(received.calls), received.read()
    finally:
        train._int8_pod_sum = orig
    res.update(metrics=metrics, step_s=times)
    if names:
        res["twin_mismatches"] = ph16_twin(torch, seen, names, psh, mesh)
        res["twin_layers"] = len(names)
        res["scales"] = seen["scales"]
    seen.clear()
    if keep:
        res["after"] = {k: p.detach().to("cpu", copy=True) for k, p in lm.named_parameters()}
    if count:
        torch.cuda.synchronize()
        received.zero()
        with OpAnalysis() as mode:
            step(opt, batch)
        torch.cuda.synchronize()
        r = received.read()
        res["count"] = dict(flops=int(mode.cost.flops), by_kind=r["by_kind"], largest=r["largest"])
    del lm, opt
    gc.collect()
    torch.cuda.empty_cache()
    return res


def moved_alike(torch, comp: dict, plain: dict, dev, lr: float, chunk: int = 1 << 25) -> dict:
    """(a)'s parameters, leaf by leaf on the card from the host copies, in
    chunks of ``chunk`` elements (four ranks share the card's memory; both
    steps start from the same seed's parameters): the share of elements the
    two steps moved the same way, the share they moved opposite ways, and
    where they moved the same way |compressed − uncompressed| less one bf16
    unit in the last place of the larger result (each result is rounded to
    bf16), in units of the learning rate: worst, and shares beyond 1e-2
    and 1e-1."""
    out = {}
    for k, b0 in comp["before"].items():
        n, same_n, flip_n, over2, over1, worst = b0.numel(), 0, 0, 0, 0, 0.0
        flats = [t.reshape(-1) for t in (b0, plain["after"][k], comp["after"][k])]
        for i in range(0, n, chunk):
            b, au, ac = (t[i:i + chunk].to(dev).float() for t in flats)
            du, dc = au - b, ac - b
            su, sc = torch.sign(du), torch.sign(dc)
            same = (su == sc) & (su != 0)
            same_n += int(same.sum())
            flip_n += int(((su == -sc) & (su != 0)).sum())
            _, e = torch.frexp(torch.maximum(au.abs(), ac.abs()))
            d = (((dc - du).abs() - torch.ldexp(torch.ones_like(au), e - 8)).clamp_(min=0) / lr)[same]  # bf16: 8 bits
            if d.numel():
                worst = max(worst, float(d.max()))
                over2 += int((d > 1e-2).sum())
                over1 += int((d > 1e-1).sum())
        out[k] = dict(same_share=same_n / n, flip_share=flip_n / n, worst=worst,
                      share_over_1e2=over2 / max(same_n, 1), share_over_1e1=over1 / max(same_n, 1))
    return out


def phase16_rank(mesh) -> dict:
    """One rank of phase 16: (a)-(b) the compressed and uncompressed steps,
    (c) the counted steps of both cells (phase 13's on the ('data',
    'model') mesh of the same ranks); every kernel counter at 0 before and
    read after."""
    import torch

    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    counters = kernel_counters()
    zero_counts(counters)
    t0 = time.perf_counter()
    comp = ph16_step(torch, mesh, True, count=True, keep=True)
    plain = ph16_step(torch, mesh, False, keep=True)
    params = moved_alike(torch, comp, plain, mesh.device, plain["metrics"][0][2])
    for r in (comp, plain):
        r.pop("before", None)
        del r["after"]
    gc.collect()
    torch.cuda.empty_cache()
    ph13 = ph16_step(torch, make_mesh(PH16["cell13"], device_type="cuda"), False, steps=0, count=True)
    return {"coords": dict(mesh.coords), "backend": mesh.backend, "device": str(mesh.device),
            "wall_s": time.perf_counter() - t0, "comp": comp, "plain": plain, "ph13": ph13, "params": params,
            "launches": {name: fn.launches for name, fn in counters.items()}, "flash_pairs": flash_pairs(),
            "bwd_pairs": {f"{d}x{dv}": n for (d, dv), n in sorted(counters["flash_attention_bwd"].by_pair.items())}}


def phase_pod_compress(torch, strain: dict) -> dict:
    """Phase 16: the per-rank meta dry runs here, then four ranks on the
    card; (c) also holds phase 13's logged bytes to its cell's meta run."""
    from repro_torch.models import LM
    from repro_torch.optim.adamw import stack_position

    t0 = time.perf_counter()
    meta = ph16_meta(torch)
    meta_s = time.perf_counter() - t0
    ranks, ranks_s = card_ranks(phase16_rank, PH16["mesh"])
    sizes: dict = {}
    for name, p in LM(gemma13_cfg("bfloat16"), device="meta").named_parameters():
        pos = stack_position(name)
        key = "/".join(pos[0] if pos else (name,))
        sizes[key] = sizes.get(key, 0) + p.numel()
    scales: dict = {}
    for r in ranks:
        for leaf, (own, _) in r["comp"]["scales"].items():
            scales.setdefault(leaf, {})[r["coords"]["pod"]] = own
    P = PH16["mesh"]["pod"]
    bound_sq = 0.0
    for leaf, by_pod in scales.items():
        sc = [by_pod[p] for p in range(P)]
        mean = sum(sc) / P
        bound_sq += sizes[leaf] * (sum(s / 2 + 127 * abs(mean - s) for s in sc) / P) ** 2
    qbound = math.sqrt(bound_sq)
    per_rank = []
    for r in ranks:        # printed first, held after
        per_rank.append(dict(
            coords=r["coords"], loss=[r["comp"]["metrics"][0][0], r["plain"]["metrics"][0][0]],
            grad_norm=[r["comp"]["metrics"][0][1], r["plain"]["metrics"][0][1]], quantization_bound=qbound,
            step_s=[r["comp"]["step_s"], r["plain"]["step_s"]],
            pod_bytes={"compressed": r["comp"]["pod_bytes"], "uncompressed": r["plain"]["pod_bytes"]},
            params={k: max(v[k] for v in r["params"].values())
                    for k in ("same_share", "flip_share", "worst", "share_over_1e2", "share_over_1e1")},
            params_same_share_min=min(v["same_share"] for v in r["params"].values()),
            twin_mismatches=r["comp"]["twin_mismatches"], received=r["comp"]["received"]["total"],
            counts={"ph16": r["comp"]["count"], "ph13": r["ph13"]["count"]},
            held={"ph16": r["comp"]["held"], "ph13": r["ph13"]["held"]}, wall_s=r["wall_s"]))
        print(f"phase 16 rank {r['coords']}: {json.dumps(per_rank[-1])}")
    print(f"phase 16 meta dry run (this process, {meta_s:.3f} s): " + json.dumps(
        {k: {kk: v[kk] for kk in ("flops", "by_kind", "largest", "held", "rules", "top", "s")}
         for k, v in meta.items()}))
    print(f"phase 16 ranks {ranks_s:.3f} s")
    for r, e in zip(ranks, per_rank):
        c = r["coords"]
        check(r["backend"] == "gloo" and r["device"].startswith("cuda"), f"phase 16 rank {c}: {r['backend']}")
        (lc, nc, lrc), (lu, nu, lru) = r["comp"]["metrics"][0], r["plain"]["metrics"][0]
        check(all(math.isfinite(v) for v in (lc, nc, lu, nu)), f"phase 16a rank {c}: metrics not finite")
        check(abs(lc - lu) <= PH13_BF16_LOSS_RTOL * abs(lu), f"phase 16a rank {c}: losses {lc!r} (compressed) vs {lu!r}")
        check(lrc == lru > 0, f"phase 16a rank {c}: learning rates {lrc!r} {lru!r}")
        check(abs(nc - nu) <= qbound + PH13_BF16_LOSS_RTOL * nu,
              f"phase 16a rank {c}: grad norms {nc!r} vs {nu!r}, quantization bound {qbound!r}")
        check(e["params"]["worst"] < 1.0,
              f"phase 16a rank {c}: parameters the two steps moved the same way differ by {e['params']['worst']!r} "
              f"learning rates beyond a bf16 unit (AdamW's first step bounds it below 1)")
        check(r["comp"]["twin_mismatches"] and not any(r["comp"]["twin_mismatches"]),
              f"phase 16b rank {c}: the synced {PH16['leaf']} differs from the NumPy twin on "
              f"{r['comp']['twin_mismatches']} elements")
        for cell, got in e["counts"].items():
            want = meta[cell]
            check(got["by_kind"] == want["by_kind"] and got["largest"] == want["largest"],
                  f"phase 16c rank {c} {cell}: received {got['by_kind']} largest {got['largest']} on the card, "
                  f"{want['by_kind']} largest {want['largest']} on meta")
            check(got["flops"] == want["flops"], f"phase 16c rank {c} {cell}: {got['flops']} FLOPs on the card, "
                                                 f"{want['flops']} on meta")
        for cell, got in e["held"].items():
            check(got == meta[cell]["held"] == meta[cell]["rules"],
                  f"phase 16c rank {c} {cell}: argument bytes {got} on the card, {meta[cell]['held']} held on meta, "
                  f"{meta[cell]['rules']} by the rules")
    # (c) phase 13's four ranks logged their bf16 training steps' bytes: each step against its cell's meta run
    for r13 in strain["ranks"]:
        for total, largest, by_kind in r13["received"]["train gemma2-9b bfloat16"]:
            check(by_kind == meta["ph13"]["by_kind"] and largest == meta["ph13"]["largest"],
                  f"phase 16c: phase 13 rank {r13['coords']} logged {by_kind} (largest {largest}), its cell's meta "
                  f"run {meta['ph13']['by_kind']} (largest {meta['ph13']['largest']})")
    launches = summed([r["launches"] for r in ranks])
    pairs, bwd_pairs = summed([r["flash_pairs"] for r in ranks]), summed([r["bwd_pairs"] for r in ranks])
    check(set(pairs) == set(bwd_pairs) == {"256x256"}, f"phase 16 instances {pairs} {bwd_pairs}")
    r0 = per_rank[0]
    print(f"phase 16 over 'pod' a compressed step receives {r0['pod_bytes']['compressed']} bytes, an uncompressed "
          f"one {r0['pod_bytes']['uncompressed']} (int32 codes: 4 bytes an element, bf16 gradients: 2)")
    out = dict(ranks=per_rank, meta=meta, launches=launches, flash_pairs=pairs, bwd_pairs=bwd_pairs, ranks_s=ranks_s,
               meta_s=meta_s, wall_s=time.perf_counter() - t0)
    print(f"phase 16 four ranks on one card (pod 2 x data 1 x model 2 over gloo): ranks {ranks_s:.3f} s, phase "
          f"{out['wall_s']:.3f} s, launches {launches}, flash by instance {pairs}, backward by instance {bwd_pairs}")
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()
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
    ph9_padded = padded_counts(all_counters)
    check(ph9_pairs.get(MLA_PAIR, 0) > 0, "phase 9 never launched flash_attention (192, 128)")
    check(set(ph9_pairs) == {MLA_PAIR, REDUCED_MLA_PAIR} and ph9_padded["flash_attention"] == ph9_pairs[REDUCED_MLA_PAIR],
          f"phase 9 launched other flash instances {ph9_pairs} (padded {ph9_padded})")
    gc.collect()
    torch.cuda.empty_cache()

    zero_counts(all_counters)
    t0 = time.perf_counter()
    train = phase_train(torch)
    ph10_launches = {name: fn.launches for name, fn in all_counters.items()}
    ph10_pairs = flash_pairs()
    ph10_bwd_pairs = {f"{d}x{dv}": n for (d, dv), n in sorted(fa_ops.flash_attention_bwd.by_pair.items())}
    ph10_padded = padded_counts(all_counters)
    print(f"phase 10 in {time.perf_counter() - t0:.3f} s, launches {ph10_launches}, flash by instance "
          f"{ph10_pairs}, flash backward by instance {ph10_bwd_pairs}, padded {ph10_padded}")
    check(ph10_launches["flash_attention_bwd"] > 0, "phase 10 never launched flash_attention_bwd")
    gc.collect()
    torch.cuda.empty_cache()

    zero_counts(all_counters)
    t0 = time.perf_counter()
    dry = phase_dryrun_on_card(torch)
    ph11_launches = {name: fn.launches for name, fn in all_counters.items()}
    ph11_pairs = flash_pairs()
    ph11_padded = padded_counts(all_counters)
    print(f"phase 11 in {time.perf_counter() - t0:.3f} s, launches {ph11_launches}, flash by instance {ph11_pairs}, "
          f"padded {ph11_padded}")
    for name in attn_counters():
        check(ph11_launches[name] > 0, f"phase 11 never launched {name}")
    check(ph11_launches["flash_attention_bwd"] > 0, "phase 11 never launched flash_attention_bwd")
    check(not any(ph11_padded.values()), f"phase 11 took the padded route {ph11_padded}")
    print("phase 11 step / bound (" + smi + "): " + json.dumps(
        {k: {"step_s": r["step_s"], "step_time_lower_bound_s": r["step_time_lower_bound_s"],
             "ratio": r["step_over_bound"], "peak_ratio": r["peak_ratio"]}
         for k, r in dry.items() if k in ("decode", "prefill", "train")}))
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 12's path runs in four spawned ranks: each sets its counters to 0
    # before its part and reads them after; these are their sums.
    zero_counts(all_counters)
    t0 = time.perf_counter()
    entry = range_entry(torch)
    sharded = phase_sharded(torch)
    sharded["range_entry"] = entry
    ph12_launches, ph12_pairs = sharded["launches"], sharded["flash_pairs"]
    print(f"phase 12 in {time.perf_counter() - t0:.3f} s (tables gathered whole: {GATHERED_TABLES_S[12]} s), "
          f"launches (four ranks) {ph12_launches}, flash by instance "
          f"{ph12_pairs}, key-range launches {sharded['range_launches']}")
    check(sharded["range_launches"] > 0 and sharded["short_launches"] > 0
          and sharded["range_launches"] + sharded["short_launches"] == ph12_launches["decode_attention"],
          "phase 12 never launched decode_attention's key-range entry or its rows' launches (e), or launched another")
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 13's path runs in four spawned ranks too: each sets its counters
    # to 0 before its sharded parts and reads them after; these are their sums.
    zero_counts(all_counters)
    t0 = time.perf_counter()
    strain = phase_sharded_train(torch)
    ph13_launches, ph13_pairs, ph13_bwd_pairs = strain["launches"], strain["flash_pairs"], strain["bwd_pairs"]
    print(f"phase 13 in {time.perf_counter() - t0:.3f} s (tables gathered whole: {GATHERED_TABLES_S[13]} s), "
          f"launches (four ranks) {ph13_launches}, flash by instance "
          f"{ph13_pairs}, flash backward by instance {ph13_bwd_pairs}")
    check(ph13_launches["flash_attention"] > 0 and ph13_launches["flash_attention_bwd"] > 0,
          "phase 13 never launched the flash forward or backward")
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 14's path: (a) here, with the counters at 0 before each of its
    # parts and read after, and four spawned ranks, each with its counters
    # at 0 before its parts and read after; these are their sums.
    zero_counts(all_counters)
    t0 = time.perf_counter()
    fams = phase_sharded_families(torch)
    ph14_launches, ph14_pairs, ph14_bwd_pairs = fams["launches"], fams["flash_pairs"], fams["bwd_pairs"]
    print(f"phase 14 in {time.perf_counter() - t0:.3f} s (tables gathered whole: {GATHERED_TABLES_S[14]} s), "
          f"launches (oracles and four ranks) {ph14_launches}, flash by "
          f"instance {ph14_pairs}, flash backward by instance {ph14_bwd_pairs}")
    check(set(ph14_pairs) == set(ph14_bwd_pairs) == set(PH14_PAIRS.values()),
          f"phase 14 instances {ph14_pairs} {ph14_bwd_pairs}")
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 15's path: (a) here, with the counters at 0 before each of its
    # parts and read after, and four spawned ranks, each with its counters
    # at 0 before its parts and read after; these are their sums.
    zero_counts(all_counters)
    t0 = time.perf_counter()
    ms = phase_sharded_moe_ssm(torch)
    ph15_launches, ph15_pairs, ph15_bwd_pairs = ms["launches"], ms["flash_pairs"], ms["bwd_pairs"]
    print(f"phase 15 in {time.perf_counter() - t0:.3f} s (tables gathered whole: {GATHERED_TABLES_S[15]} s), "
          f"launches (oracle and four ranks) {ph15_launches}, flash by "
          f"instance {ph15_pairs}, flash backward by instance {ph15_bwd_pairs}")
    check(set(ph15_pairs) == set(ph15_bwd_pairs) == {MLA_PAIR}, f"phase 15 instances {ph15_pairs} {ph15_bwd_pairs}")
    gc.collect()
    torch.cuda.empty_cache()

    # Phase 16's path runs in four spawned ranks: each sets its counters to 0
    # before its parts and reads them after; these are their sums.
    zero_counts(all_counters)
    t0 = time.perf_counter()
    pod = phase_pod_compress(torch, strain)
    ph16_launches, ph16_pairs, ph16_bwd_pairs = pod["launches"], pod["flash_pairs"], pod["bwd_pairs"]
    print(f"phase 16 in {time.perf_counter() - t0:.3f} s, launches (four ranks) {ph16_launches}, flash by instance "
          f"{ph16_pairs}, flash backward by instance {ph16_bwd_pairs}")
    check(ph16_launches["flash_attention"] > 0 and ph16_launches["flash_attention_bwd"] > 0,
          "phase 16 never launched the flash forward or backward")

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
            launches_ph11=ph11_launches[name], launches_ph12=ph12_launches[name],
            launches_ph13=ph13_launches[name], launches_ph14=ph14_launches[name],
            launches_ph15=ph15_launches[name], launches_ph16=ph16_launches[name],
            **({"wrapper_ms": r["wrapper_ms"]} if "wrapper_ms" in r else {}),
        ))
    # The flash rows split the wrapper's counts by instance: "flash_attention"
    # counts the instances with v as wide as q and k, "flash_attention
    # (192, 128)" MLA's, each per phase as measured (``launches_by_pair``).
    phase_pairs = {"main": serving["pairs"], "sim": sim_pairs, "p2p": p2p_pairs, "ph8": ph8_pairs, "ph9": ph9_pairs,
                   "ph10": ph10_pairs, "ph11": ph11_pairs, "ph12": ph12_pairs, "ph13": ph13_pairs, "ph14": ph14_pairs,
                   "ph15": ph15_pairs, "ph16": ph16_pairs}
    source, replaces = attn_meta["flash_attention"]
    for name, mla, r in (("flash_attention", False, attn["flash_attention"]),
                         ("flash_attention (192, 128)", True, attn["flash_attention_mla"])):
        counts = {ph: pair_sum(pairs, mla) for ph, pairs in phase_pairs.items()}
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=counts["ph9" if mla else "main"],
            launches_sim=counts["sim"], launches_p2p=counts["p2p"], launches_ph8=counts["ph8"],
            launches_ph9=counts["ph9"], launches_ph10=counts["ph10"], launches_ph11=counts["ph11"],
            launches_ph12=counts["ph12"], launches_ph13=counts["ph13"], launches_ph14=counts["ph14"],
            launches_ph15=counts["ph15"], launches_ph16=counts["ph16"], launches_by_pair={ph: {key: n for key, n in pairs.items() if (key == MLA_PAIR) == mla}
                              for ph, pairs in phase_pairs.items()},
            launches_padded={} if mla else {"ph9": ph9_padded["flash_attention"],
                                            "ph10": ph10_padded["flash_attention"]}, **r))
    source, replaces = attn_meta["decode_attention"]
    line.append(dict(name="decode_attention", route="cuda", source=source, replaces=replaces,
                     launches=serving["launches"]["decode_attention"], launches_sim=sim_launches["decode_attention"],
                     launches_p2p=p2p_launches["decode_attention"], launches_ph8=ph8_launches["decode_attention"],
                     launches_ph9=ph9_launches["decode_attention"], launches_ph10=ph10_launches["decode_attention"],
                     launches_ph11=ph11_launches["decode_attention"],
                     launches_ph12=ph12_launches["decode_attention"], launches_ph13=ph13_launches["decode_attention"],
                     launches_ph14=ph14_launches["decode_attention"], launches_ph15=ph15_launches["decode_attention"],
                     launches_ph16=ph16_launches["decode_attention"],
                     launches_ph12_range_entry=sharded["range_launches"], launches_ph12_rows=sharded["short_launches"],
                     range_entry=sharded["range_entry"],
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
                     launches_ph10=ph10_launches["flash_attention_bwd"],
                     launches_ph11=ph11_launches["flash_attention_bwd"],
                     launches_ph12=ph12_launches["flash_attention_bwd"],
                     launches_ph13=ph13_launches["flash_attention_bwd"],
                     launches_ph14=ph14_launches["flash_attention_bwd"],
                     launches_ph15=ph15_launches["flash_attention_bwd"],
                     launches_ph16=ph16_launches["flash_attention_bwd"],
                     launches_by_pair={"ph10": ph10_bwd_pairs, "ph13": ph13_bwd_pairs, "ph14": ph14_bwd_pairs,
                                       "ph15": ph15_bwd_pairs, "ph16": ph16_bwd_pairs},
                     launches_padded={"ph10": ph10_padded["flash_attention_bwd"]}, **bwd_row))
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
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.3f} s")
    print(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
