#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py                 # from the root of a checkout
    python3 chip_smoke.py --profile       # where a federated round's time goes
    python3 chip_smoke.py --serving-only  # skip the federated-round phases
    python3 chip_smoke.py --scheduling-only  # phases 1, 2, 13 and 14 only
    python3 chip_smoke.py --ssm-only      # the SSD kernel and SSM serving only
    python3 chip_smoke.py --training-only # phases 1, 4 and 15-19 only
    python3 chip_smoke.py --tooling-only  # phase 16 and the tooling (21)
    python3 chip_smoke.py --conv-only     # the causal conv kernel (18b)

All five kernels (``fed_reduce``, ``decode_attention``, ``flash_attention``
with its backward, and ``ssd_scan`` with its backward, the last three with
tensor-core and plain-FMA paths, and ``causal_conv`` with its backward) are
built first from ``src/repro_torch/csrc`` with ``nvcc`` for ``sm_90a``, one
compiler per source, all at once; ptxas's registers and spills of the new
kernels and the tensor-core instructions in each library's SASS
(``cuobjdump``: HGMMA, HMMA) are printed.  Nineteen phases, run in their
numbered order; any failure raises and the script exits non-zero:

1. **Kernel.**  Runs ``fed_reduce`` on the card against its plain
   PyTorch version at every shape the slice's ``RoundPlan`` gives it: each
   distinct cohort-chunk row count (full 8192-row chunks and each ragged
   last chunk) x {the 256-wide ``w`` leaf, the 1-wide ``b`` leaf} x {f32,
   int8 with scales}, plus 8192 x 256 in bf16; zero weights included.
   Checks the error (<= 1e-4 of sum |w||U| per column), that two
   launches give the same bits and that a call is one kernel launch
   (``torch.profiler``), and times kernel, plain version,
   ``torch.mv`` (f32 only) and the HBM bound with CUDA events.
2. **Slice.**  The quickstart's federated CTR round (calibrate, allocate,
   ``HybridSimulation`` over DeviceFlow into ``AggregationService``) at the
   paper's size: 100 000 devices over two grades with the quickstart's one
   benchmarking device (q_i = 1) per grade, 20 records each, ``avazu_lr``
   at dim 256, cohorts of 8192 — 3 rounds on the f32 wire, then 3 on the
   int8 wire with error feedback.  The launch counter is zeroed before and
   read after, and must equal the (buffer, leaf) reductions the
   aggregations issued; every (rows, width, dtype) the aggregations reduced
   must be a shape the kernel phase checked; the test loss must fall every
   round.
3. **Cross-check.**  The same slice at 2 000 devices on the card and on the
   CPU (plain ``fed_reduce``): after every round the params agree within
   1e-6 absolute and the round's update within 1e-3 relative; aggregation
   counts, arrival times and shelf bytes are identical.
   **3b. The rest of the main path.**  Phase 2's f32 rounds again with
   ``recycle_buffers=True``: params, arrivals and bytes bitwise equal to
   phase 2's, the device-tier buffers in the same storage every round,
   and every round after the first asking the caching allocator for at
   least those buffers' bytes fewer than phase 2's (peaks printed); a ``Checkpointer`` save (sync
   and async) and restore of the global params and a live
   ``UpdateBuffer`` on the card, bitwise; two rounds at 2 000 devices
   with top-k compression as the ``payload_transform``: each chunk's
   top-k on the card equal bit for bit to the CPU's on the same rows, and
   the round's wire bytes to the CPU's; the quickstart example (sections
   1-5, 8, 9, 10) on the card against its CPU run: every line equal with
   the accuracies within 1e-4.  Each path's launches are zeroed before
   it and read after it (the audited ones must equal their expected
   count), and each wrapper records the shapes it launched at; every
   such shape no earlier case checked is then held against the plain
   version (phase 1's and phase 4's checks, seeded inputs).
4. **Attention kernels.**  ``decode_attention`` and ``flash_attention`` on
   the card against their plain versions on the card, at the serving runs'
   shapes (llama3.2-3b decode: q (16, 24, 128) vs a (16, 577, 8, 128) bf16
   cache with ragged lengths including 0 and 577; prefill: q (16, 512, 24,
   128) vs k/v (16, 512, 8, 128), causal; zamba2-1.2b's shared block: q
   (16, 32, 64) vs a (16, 577, 32, 64) cache and (16, 512, 32, 64) causal)
   and at the reference test cases (``tests/test_kernels.py`` FLASH_CASES,
   DECODE_CASES) in f32 and bf16: error within 3e-5 (f32) / 2e-2 (bf16),
   exact zeros for empty slots, stale-KV invariance of a reused slot
   (1e-6), bitwise repeatability; bf16 at d = 64 and 128 runs on the
   tensor-core flash kernel, the rest on the plain-FMA one; a
   ``decode_attention`` call is one kernel (``torch.profiler``).  Times
   both decode shapes (llama's, also at the continuous engine's own
   occupancy: 3 busy slots of 16) and both prefill shapes (llama's and
   zamba2's) with CUDA events: kernel (and, for flash, the plain-FMA
   kernel on the same bf16 inputs), plain version,
   ``F.scaled_dot_product_attention`` (GQA; a boolean length mask for
   decode) as the library yardstick, and the bound.
5. **Serving slice.**  llama3.2-3b at full width (28 layers, d_model 3072,
   24 query / 8 KV heads, vocab 128256 padded to 129024) in bf16, params
   from ``transformer.init`` with a seeded CUDA generator: a 64-request
   ``diurnal`` trace, prompts of 512 tokens, 64 decode tokens each, through
   ``ContinuousServer(ContinuousBatchingEngine(slots=16))`` and then
   ``BatchedServer(batch_size=16)``.  Per mode: the virtual-time report
   (which must equal the same trace's CPU run), wall ms per prefill call
   and per decode iteration, decode tokens/s and peak device memory; the
   launch counters are zeroed before each mode and must read 28 per decode
   iteration (``decode_attention``) and 28 per prefill (``flash_attention``,
   every one on the tensor-core kernel) after it, at shapes phase 4
   checked; the continuous p99 must be >= 2x better than the fixed
   batch's.  A short profiled window gives the
   device's idle share.
6. **Serving cross-check.**  Full width at 2 layers, the same params and
   prompts: the kernel path against the plain path (``attention_impl=
   "einsum"``, decode ``impl="ref"``), both on the card, prefill then 16
   teacher-forced decode steps: last-position logits within 2e-2 relative
   in bf16 (greedy-token agreement printed, not gated), and within 1e-4
   with identical greedy tokens in f32.
7. **SSD kernel.**  ``ssd_scan`` on the card against its chunked plain
   version and the sequential oracle on the card, in f32 and with bf16 x,
   B and C: the reference's SSD_CASES, both serving shapes (mamba2-1.3b
   (16, 512, 64 heads of 64, 1 group, state 128) and zamba2-1.2b (state
   64), chunk 128), a length that pads (500) and decays that overflow above
   the diagonal (A = -64, dt = 0.1).  y and the state within 3e-4 absolute
   in f32, y within 2e-2 relative in bf16, no NaN, two launches bitwise
   equal; bf16 at the models' shapes runs on the tensor-core kernel, the
   rest on the plain-FMA one.  Times the serving shapes (inputs cycled past
   the L2): kernel, the plain-FMA kernel on the same bf16 inputs, plain
   version and the bound; no PyTorch op computes the scan.
8. **SSM serving.**  mamba2-1.3b and then zamba2-1.2b at full width and 8
   layers (of 48 and 38, to fit the smoke's time limit) in
   bf16, params from each model's ``init`` with a seeded CUDA generator,
   the same trace through ``BatchedServer(batch_size=16)`` (the continuous
   engine's arena holds attention K/V only).  Per model: the report (equal
   to the CPU run's with the smoke-size model), wall ms per prefill and
   decode iteration, decode tokens/s, peak memory; launch counters zeroed
   before and read after: one ``ssd_scan`` per layer per prefill (8 x 4
   each), every one on the tensor-core kernel, two ``causal_conv`` per
   layer per prefill (x and B,C), and for zamba2 one
   tensor-core ``flash_attention`` per shared-block application per
   prefill (2 x 4) and one ``decode_attention`` per application per
   decode step (2 x 256), at shapes phases 4 and 7 checked; a profiled
   window (1 prefill + 20 decode steps) gives the idle share and shows
   each counted scan and decode call as one kernel.
9. **SSM cross-check.**  Each model at full width and 2 layers (zamba2 with
   its shared block at layer 0): the kernel path against the plain path
   (``block_prefill(impl="chunked")`` layer by layer; for zamba2's
   attention ``attention_impl="einsum"``), both on the card, prefill then
   16 teacher-forced decode steps: logits within 2e-2 relative in bf16
   (agreement printed), within 1e-4 with identical greedy tokens in f32.

10. **MoE serving.**  granite-moe-3b at full width (d_model 1536, 24/8
    heads of 64, 40 experts top-8) and 8 of its 32 layers (its host-bound
    decode grows with depth, and the smoke must fit its time limit) on
    phase 5's trace, continuous then fixed, with phase 5's checks: reports
    equal to the CPU run's, 8 launches per prefill and per decode
    iteration (tensor-core flash), shapes checked in phase 4; then phase
    6's cross-check at 2 layers with each path's own routing (f32 gated
    at 1e-4 with equal tokens; bf16 reported, with the pairs whose choice
    differed) and with the plain path replaying the kernel path's routing
    (gated: bf16 2e-2, f32 1e-4 with equal tokens).
11. **Encoder-decoder.**  seamless-m4t-medium at full width and depth (12
    + 12 layers, d_model 1024, 16/16 heads of 64): 16 sequences of 256
    seeded stub frames, decoder prompts of 64, ``prefill`` then 64 greedy
    ``decode_step``s: 36 ``flash_attention`` launches per prefill
    (encoder, self, cross; all tensor-core) and 24 ``decode_attention``
    per step (self, and cross at the full frame count), shapes checked in
    phase 4; wall ms per prefill and step, peak memory, profiled windows.
12. **Encoder-decoder cross-check.**  2 + 2 layers at full width, kernel
    against plain: bf16 2e-2, f32 1e-4 with equal greedy tokens.
13. **Scheduled rounds.**  Three federated tasks over phase 2's plan (100 000
    devices, q_i = 1, cohorts of 8192, two rounds each, chunks streamed
    into one streaming ``AggregationService`` per task behind a task
    router) contend for one pool through a preemptive, elastic
    ``TaskEngine`` on DeviceFlow's clock whose ``round_runner`` calls
    ``HybridSimulation.run_plan_round``: two priority-0 tasks freeze the
    whole pool and a priority-5 task arrives inside round 0.  The
    ``fed_reduce`` launches must equal the aggregations' (buffer, leaf)
    reductions at checked shapes, a task must be preempted and every
    task's test loss must fall every aggregation.  The same schedule is
    snapshotted mid-preemption (``Checkpointer.save(runtime_state=
    engine.state_dict(deviceflow=..., fleets=..., services=...))``),
    restored into a fresh world and run to the end: timeline exactly and
    params bitwise equal to the uninterrupted run's.  At 2 000 devices the
    card's timeline must equal the CPU's, params within 1e-6.
14. **Pooled rounds.**  Phase 2's f32 and int8 rounds with the cohort
    chunks in two worker processes on the card (``FleetWorkerPool``,
    ``WorkerSpec(smoke_tiers, {"device": "cuda"})``): params, dispatch
    groups and ``created_t`` stamps, shelf bytes, aggregations and
    ``fed_reduce`` launches equal to phase 2's bitwise; the segment ring
    recycles; at 2 000 devices with three workers, worker 1 is killed in
    round 1 and the round completes bitwise equal to the inline run; no
    segment is left in ``/dev/shm``.  If ``/dev/shm`` cannot hold a call's
    input segment the phase runs at the largest device count that fits and
    says so.

15. **Backward kernel.**  The forward kernel with its log-sum-exp against
    ``attention_fwd_lse``, then the flash backward (a prep pass, then the
    dK/dV and dQ kernels: ``wgmma`` with TMA for bf16 at d = 64, 128,
    plain FMAs otherwise) on the card against ``attention_bwd_ref`` on the
    card, from the forward kernel's own o and log-sum-exp: llama3.2-3b's
    training shape (1 x 4096, 24/8 heads of 128, causal) in bf16, the same
    at 6/2 heads in f32, granite's (16 x 512, 24/8 of 64), seamless's
    encoder (16 x 256, non-causal) and cross-attention (64 x 256), the
    smoke width (8 x 64 and 4 x 128, 6/2 of 16), a ragged 4 000 and a
    query offset: o, dQ, dK, dV within 3e-5 (f32) / 2e-2 (bf16), the
    log-sum-exp within 1e-3, two backward calls bitwise equal;
    ``torch.func.vmap(grad(...))`` through ``FlashAttention`` equal to a
    per-sample loop.  Times llama's training shape and the smoke width:
    kernel (and the plain-FMA kernels on the same bf16 inputs), plain
    version, SDPA's autograd backward, the
    forward with its log-sum-exp, SDPA's forward, and the bounds (10 d
    flops per pair per head).
16. **Cloud training.**  llama3.2-3b at full width and depth (28 layers,
    3.61 B params, seeded bf16 weights, f32 master, m and v) through
    ``launch/train.py``'s own step (``make_cloud_step``): sequences of 4096
    from ``TokenPipeline``, 8 microbatches of one (32 768 tokens a step),
    one warm-up and three timed steps, then one profiled step; per step the
    loss, lr and grad norm (finite), wall s, tokens/s, the share of 989
    TFLOP/s that 6 N tokens / wall gives, peak memory, and flash launches
    equal to the audit (448 forward and 224 backward per step under remat),
    the profiled step's kernels too.  Then 2 layers at full width, 2 steps,
    kernel path against plain path on the card: loss and grad norm per
    step, every updated leaf and each leaf's first-step gradient within
    2e-2 relative (bf16) and 1e-4 (f32); each leaf's change logged.
17. **The LM examples.**  ``examples/lm_pretrain.py`` on the card, 200
    steps with checkpoints every 50, straight through and in a process
    killed after its step-100 save, resumed through ``TrainingSupervisor``:
    the resumed losses bitwise equal; ``examples/lm_federation.py`` (5
    rounds, 8 clients, curve traffic, top-k 0.05) and ``--tasks 3
    --preemptive`` on the card against the same command on the CPU from the
    same params: every virtual-time line, the aggregations and the wire
    bytes equal, client losses within 2e-2; their ``fed_reduce`` and flash
    launches (forward and backward, under vmap) printed and nonzero.
18. **Scan backward kernel.**  The forward kernel against ``ssd_chunked``
    and the scan's backward on its route on the card against
    ``ssd_bwd_ref`` on the card: bf16 at the models' shapes on the tensor
    cores (six launches: each chunk's own state contributions, the
    cross-chunk recurrences, the chunks' gradients with the head-summed
    Wd, dB and dC per block of heads, their sums over each group's blocks,
    dA's sum; each row names its route and the route's launch count is
    checked), everything else on plain f32 FMAs (five launches: C B^T per
    group, the states and their cotangents per chunk, the chunks'
    gradients, the sums over each group's heads and over dA's parts): the
    reference's forward cases (g
    < h among them), a ragged 500, A = -64, mamba2-1.3b's training shape
    (1 x 4096, 64 heads of 64, state 128, chunk 128) in bf16 and f32 and
    zamba2-1.2b's (state 64), all but the training shapes with a nonzero
    cotangent of the final state: dx, ddt, dA, dB, dC finite, two calls
    bitwise equal, within 2e-2 (bf16) of the plain version's largest entry,
    and in f32 within 3e-4 of the plain version run in f64 (or twice the
    f32 plain version's own error where that is larger: dA at A = -64);
    ``torch.func.vmap(grad(...))`` through ``SsdScan`` equal to a
    per-sample loop.  Times mamba2's training shape with CUDA events,
    inputs cycled past the L2: the tensor-core route and the plain-FMA
    route on the same inputs (each with its share of the bound and its
    GFLOP/s), plain version, autograd through the chunked plain forward (no
    PyTorch call computes the scan's backward), the forward kernel, and the
    bound.
19. **SSM training.**  mamba2-1.3b at full width and depth (48 layers,
    d_model 2048, 64 heads of 64, state 128, 1.45 B params, seeded bf16
    weights, f32 master, m and v) through ``make_cloud_step`` on phase
    16's shape (8 microbatches of one 4096-token sequence), one warm-up,
    three timed steps and one profiled step: loss, lr and grad norm
    finite, wall s, tokens/s, the 6 N share of 989 TFLOP/s, peak memory,
    and ``ssd_scan`` launches equal to the audit (768 forward and 384
    backward per step under remat, all on the tensor-core kernels; per
    conv, 768 ``causal_conv`` forward and 384 backward calls), the
    profiled step's kernels too.  Then phase 16's cross-check for mamba2
    and for zamba2-1.2b (2 layers at full width, its shared block at layer
    0).  Then every forward and backward shape that phases 16, 17 and 19
    launched and phases 15 and 18 did not check is checked as they check
    their cases.

Phase 18b (after 18, and in ``--ssm-only``) holds ``causal_conv``, the
causal conv + bias + SiLU of a Mamba2 block, and its backward on the card
against the plain chain in bf16 at mamba2-1.3b's x (4096 channels) and B,C
(256) in a training microbatch (1 x 4096) and a prefill batch (8 x 4096):
y, dx, dw and db within 2e-2 of the plain version's largest entry, two
calls bitwise equal, one forward and two backward kernels a call
(``torch.profiler``); then times forward and backward kernels (inputs
cycled past the L2), the plain chain's forward and its autograd backward,
``F.conv1d`` + SiLU forward and backward as the library yardstick (timed,
never called by the port) and each bound (bytes / 3.35 TB/s), one
``{"causal_conv_case": ...}`` line per shape.

Phase 20 drives the sharded paths on a one-rank NCCL group
(``init_process_group("nccl", store=HashStore(), rank=0, world_size=1)``),
each against its unsharded path: ``fed_reduce(mesh=make_fleet_mesh(1))`` at
8192 x 256, f32 and int8 with scales (bitwise expected, held to 1e-6, each
call's device ms beside the call with no mesh); the federated rounds at
2 000 devices with the service and both tiers on that mesh (timeline and
params equal); llama3.2-3b at full width and depth through
``build_prefill_step`` and ``build_serve_step`` on a (1, 1) logical mesh,
one 16 x 512 prefill and 8 greedy decode steps (logits within 2e-2,
tokens equal); ``build_train_step(cfg, lmesh)`` for llama3.2-3b and
granite-moe (the expert-parallel block), 2 steps each at full width and 2
layers against ``build_train_step(cfg, None)`` (2e-2, bitwise expected;
each path's wall s per step); and granite-moe's sharded prefill.  Before
those it holds K2p (the decode kernel's partial output) on 2 and 4 blocks
of llama3.2-3b's decode cache against its plain version (each block's o,
m and l within 3e-5 / 2e-2 of their largest entry, empty blocks exactly
(0, NEG_INF, 0), the blocks combined against K2; timed on one of 2
blocks), and the forward scan and K4b on the 4 and 2 heads of a
tensor-parallel rank; after them mamba2-1.3b, zamba2-1.2b and
seamless-m4t-medium at full width and 2 layers go through the
tensor-parallel steps on the (1, 1) mesh (a prefill, 8 decode steps, 2
train steps; bitwise equal to unsharded, held; the SSM and hybrid families'
``causal_conv`` calls equal to their count: each layer's two convs once a
prefill, twice a microbatch forward and once backward), while two
processes on the card (a gloo group) decode llama3.2-3b at 2 layers with
the cache's sequence split over sp = 2: K2p on each rank's block and the
combine's all-reduces, within 2e-2 (bf16) and 1e-4 (f32) of the unsharded
decode.  Its K1, K2, K2p, K3, K3b, K4, K4b and ``causal_conv`` launches
join the kernels line (K2p's from the two-rank decode; ``causal_conv``'s
one a forward call and two a backward call).  One rank shows the sharded
paths equal to the unsharded ones and nothing more.

Phase 21 holds the port's tooling on the card.  (a) After phase 16's timed
steps one more llama3.2-3b step (full width and depth, 8 x 4096 tokens:
448 flash forward and 224 K3b launches, equal to the audit) runs under
``repro_torch.roofline.op_analysis.analyze``, untimed; the same unsharded
step is traced once on the meta device in a process of its own (its first
call allocates the f32 accumulator, which the memory tracker sees, and
runs the same ops as any later call), and flops, bytes and per-kernel work
must be exactly equal to the card's.  The step's roofline terms are printed
against phase 16's wall (the counted-flops share of 989 TFLOP/s beside the
6 N share, the memory term, the dominant term), and the meta tracker's
arguments + temp against ``torch.cuda.max_memory_allocated`` of the
analyzed step.  (b) Phase 3b's recycled f32 rounds at 2 000 devices with
the use-after-recycle sanitizer armed are bitwise equal to unarmed ones,
and a round-0 handle read after round 1 raises ``UseAfterRecycleError``.
(c) ``python -m repro_torch.launch.dryrun`` runs llama3.2-3b's
``train_4k`` and ``decode_32k`` at 16x16 (a fake process group of 256
ranks on the host's CPU), one process each, started with the phase; both
must PASS.  The phase's seconds (the analyzed card step's included) should
stay within 60.

``--training-only`` runs phases 1, 4 and 15-21; ``--sharded-only`` runs
the build and phase 20; ``--tooling-only`` the build, phase 16 and phase
21; ``--conv-only`` the build and phase 18b.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
card's name and power limit from ``nvidia-smi``, before that one JSON
line with the kernels' numbers (each kernel's launches summed over the
main paths that ran it, each path's counter read just after it), and
before that a ``{"phase_s": ...}`` line with the build's and each phase's
seconds.

``--compare-with DIR`` times the decode and scan kernels of the checkout at
DIR (e.g. the parent commit, unpacked by ``git archive``) against this
checkout's at the serving shapes, and the flash backward's route at
llama3.2-3b's training shape and the scan backward's at mamba2-1.3b's, each
keyed by its checkout's route, in turns (DIR, this, this, DIR), each in
its own process and build, and prints one ``{"kernel_ab": ...}`` line per
run.  ``--profile`` runs the federated slice alone instead: per wire, round 1
under ``torch.profiler`` (device busy time as the union of kernel
intervals, device idle share, device time by kernel) and round 2 under
``cProfile`` (host time by function).  It prints one JSON line per profiled
round and writes the full tables and a Chrome trace of the f32 round under
``chiprun_out/``.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data-sheet rates, as ``repro_torch.roofline.op_analysis`` names
# them (HBM_BW, F32_FLOPS, PEAK_FLOPS), which holds the kernels' work
# formulas and bounds.
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
L2_BYTES = 50 * 2**20
RECORDS = 20  # paper: 2 M records over 100 000 devices
COHORT = 8192
LEAF_WIDTHS = (256, 1)  # avazu_lr's w and b leaves
BF16_FLOPS = 989e12  # H100 SXM bf16 dense tensor-core peak
KERNEL_SOURCE = "src/repro_torch/csrc/fed_reduce.cu"
KERNEL_REPLACES = "src/repro/kernels/fed_reduce/fed_reduce.py:41"
KERNELS = ("fed_reduce", "decode_attention", "flash_attention", "ssd_scan",
           "causal_conv")
PROFILE_DIR = os.path.join(ROOT, "chiprun_out")


def log(*a):
    print(*a, flush=True)


PHASE_S: dict = {}  # each phase's seconds, printed before the kernels line


def passed(name: str, t0: float) -> None:
    """Logs that phase ``name``, started at ``t0``, passed, and keeps its
    seconds in ``PHASE_S``."""
    PHASE_S[name] = seconds = time.perf_counter() - t0
    log(f"{name} passed in {seconds:.1f}s")


# --------------------------------------------------------------------------
# timing

def time_ms(fn, iters: int = 40) -> float:
    """Device time per call of ``fn(i)``, back to back: the host enqueues
    every call while the card sleeps, so host launch overhead is hidden."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
# the round's plan and the shapes it gives the kernel

def grade_specs(n_devices: int, bench: int = 1):
    """Two grades (60 % High, 40 % Low), each with ``bench`` benchmarking
    devices (the quickstart's one by default), and resources scaled so that
    the allocator gives each grade's logical and device tier a share."""
    from repro_torch.core import GradeSpec

    n_high = n_devices * 3 // 5
    n_low = n_devices - n_high
    return [
        GradeSpec("High", n_high, benchmarking_devices=bench,
                  logical_bundles=max(1, n_high * 2 // 15),
                  bundles_per_device=4, physical_devices=max(1, n_high // 6)),
        GradeSpec("Low", n_low, benchmarking_devices=bench,
                  logical_bundles=max(1, n_low // 10),
                  bundles_per_device=2, physical_devices=max(1, n_low // 4)),
    ]


def calibrated_plan(specs):
    from repro_torch.core import RoundPlan, RuntimeCalibrator, solve_allocation
    from repro_torch.core.devicemodel import GRADES, DeviceFleet

    cal = RuntimeCalibrator()
    for g in ("High", "Low"):
        probe = DeviceFleet(GRADES[g], 64, seed=7)  # pre-measurement fleet
        for r in range(3):
            cal.observe_fleet(probe.run_round(r))
    alloc = solve_allocation(specs, cal.runtimes_for(specs))
    return cal, alloc, RoundPlan.from_allocation(alloc, specs)


def chunk_rows(plan, cohort: int) -> list[int]:
    """Distinct row counts of the round's update buffers: per grade, the
    logical rows and then the device-tier rows (physical and benchmarking)
    are cut into chunks of ``cohort`` (``HybridSimulation._run_split``)."""
    rows = set()
    for e in plan.entries:
        for n in (e.num_logical, e.num_physical + e.num_benchmarking):
            if n >= cohort:
                rows.add(cohort)
            if n % cohort:
                rows.add(n % cohort)
    return sorted(rows)


# --------------------------------------------------------------------------
# phase 1: the kernel against its plain version

def fed_reduce_case(dev, gen, n: int, d: int, dtype) -> tuple[dict, tuple]:
    """The kernel against its plain version at one shape on seeded inputs
    (a quarter of the rows undelivered): relative error <= 1e-4 and two
    launches bitwise equal.  Returns the case's row and its inputs."""
    import torch

    from repro_torch.kernels.fed_reduce.ops import fed_reduce

    scaled = dtype == torch.int8
    if scaled:
        U = torch.randint(-127, 128, (n, d), generator=gen, dtype=torch.int8)
    else:
        U = (torch.randn((n, d), generator=gen) * 1e-2).to(dtype)
    w = torch.rand(n, generator=gen) * 20.0
    w[torch.rand(n, generator=gen) < 0.25] = 0.0  # undelivered rows
    s = (torch.rand(n, generator=gen) * 1e-3 + 1e-5) if scaled else None
    U, w = U.to(dev), w.to(dev)
    s = None if s is None else s.to(dev)
    out1 = fed_reduce(U, w, scales=s, impl="cuda")
    out2 = fed_reduce(U, w, scales=s, impl="cuda")
    plain = fed_reduce(U, w, scales=s, impl="ref")
    torch.cuda.synchronize()
    wf = w if s is None else w * s
    mag = (wf.abs()[:, None] * U.float().abs()).sum(0).clamp_min(1e-30)
    err = (out1 - plain).abs()
    rel = float((err / mag).max())
    bitwise = bool(torch.equal(out1, out2))
    name = f"{n}x{d} {_dtype_name(dtype)}"
    if not (rel <= 1e-4):
        raise AssertionError(
            f"fed_reduce[{name}] disagrees with its plain version: "
            f"relative error {rel:.3e} > 1e-4")
    if not bitwise:
        raise AssertionError(f"fed_reduce[{name}] is not repeatable")
    row = {"case": name, "shape": [n, d], "dtype": _dtype_name(dtype),
           "max_abs_err": float(err.max()), "max_rel_err": rel,
           "bitwise_repeatable": bitwise}
    return row, (U, w, s)


def kernel_phase(dev, rows: list[int]) -> tuple[dict, set]:
    """Returns the kernel's JSON entry and the (rows, width, dtype) shapes
    it was checked at."""
    import torch

    from repro_torch.kernels.fed_reduce.ops import fed_reduce
    from repro_torch.roofline import op_analysis as oa

    cases = [(n, d, dt) for n in rows for d in LEAF_WIDTHS
             for dt in (torch.float32, torch.int8)]
    cases.append((COHORT, LEAF_WIDTHS[0], torch.bfloat16))
    gen = torch.Generator().manual_seed(0)
    results, checked, calls = [], set(), []
    for n, d, dtype in cases:
        row, (U, w, s) = fed_reduce_case(dev, gen, n, d, dtype)
        scaled = s is not None
        # Cycle through enough copies of the stack to exceed the L2, as the
        # round finds a chunk buffer written long before its reduction.
        nbytes = U.numel() * U.element_size()
        copies = max(1, min(64, math.ceil(3 * L2_BYTES / nbytes)))
        Us = [U.clone() for _ in range(copies)]
        ms = time_ms(lambda i: fed_reduce(Us[i % copies], w, scales=s,
                                          impl="cuda"))
        plain_ms = time_ms(lambda i: fed_reduce(Us[i % copies], w, scales=s,
                                                impl="ref"))
        library_ms = (time_ms(lambda i: torch.mv(Us[i % copies].t(), w))
                      if dtype == torch.float32 else None)
        bd = oa.bound(oa.fed_reduce_work(n, d, U.element_size(), scaled),
                      F32_FLOPS)
        row.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bd["bound_ms"], bound_by=bd["bound_by"],
                   bytes=bd["bytes"])
        row["bound_share"] = row["bound_ms"] / ms
        results.append(row)
        checked.add((n, d, row["dtype"]))
        log(json.dumps({"fed_reduce_case": row}))
        calls.append((U, w, s))
        del Us
    # One kernel launch per call: one call per case in a profiled window.
    launched = device_kernels(lambda: [fed_reduce(U, w, scales=s,
                                                  impl="cuda")
                                       for U, w, s in calls])
    per_kernel = {name: n for name, _, n in launched}
    if sum(per_kernel.values()) != len(calls) or not all(
            "fed_reduce_kernel" in k for k in per_kernel):
        raise AssertionError(f"{len(calls)} fed_reduce calls launched "
                             f"{launched}, not one fed_reduce_kernel each")
    log(f"fed_reduce: {len(calls)} calls, {sum(per_kernel.values())} kernel "
        f"launches ({', '.join(sorted(per_kernel))[:200]})")
    # The full f32 chunk buffer's w leaf: the main path's commonest call.
    main = next(r for r in results
                if r["shape"] == [max(rows), LEAF_WIDTHS[0]]
                and r["dtype"] == "float32")
    entry = {"name": "fed_reduce", "route": "cuda", "source": KERNEL_SOURCE,
             "replaces": KERNEL_REPLACES, "launches": 0,
             "max_abs_err": max(r["max_abs_err"] for r in results),
             "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
             "library_ms": main["library_ms"]}
    return entry, checked


# --------------------------------------------------------------------------
# phase 2/3: the federated round

def grade_data(specs, dim: int, device):
    """Per-grade ``{x, y, mask}`` moved to ``device`` once, and counts."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic_ctr import make_federated_ctr

    batches, counts = {}, {}
    for i, spec in enumerate(specs):
        data = make_federated_ctr(num_devices=spec.num_devices,
                                  records_per_device=RECORDS, dim=dim, seed=i)
        X, Y, c = data.stacked_shards(np.arange(spec.num_devices), RECORDS)
        mask = (np.arange(RECORDS)[None] < c[:, None]).astype(np.float32)
        batches[spec.grade] = {k: torch.from_numpy(v).to(device)
                               for k, v in (("x", X), ("y", Y),
                                            ("mask", mask))}
        counts[spec.grade] = c
    return batches, counts


class LaunchAudit:
    """DeviceFlow sink in front of the service: records which update buffers
    each aggregation consumed, so the expected number of ``fed_reduce``
    launches (one per buffer and leaf) and the shapes they reduce are known
    independently of the service's own code.  Host payloads (the q_i
    benchmarking devices' materialized updates) launch nothing."""

    def __init__(self, svc, n_leaves: int):
        self.svc = svc
        self.n_leaves = n_leaves
        self.buffers: dict[int, object] = {}
        self.expected = 0
        self.per_aggregation: list[int] = []
        self.shapes: set = set()  # (rows, width, dtype) reduced
        # Dispatch groups: (t, digest of the device ids, digest of the
        # created_t stamps) per delivery, to compare two runs group for group.
        self.groups: list[tuple] = []

    def __call__(self, d):
        import hashlib

        import numpy as np

        from repro_torch.core.updates import UpdateHandle

        buf = None
        if d.batch is not None:
            buf = d.batch.buffer
            self.groups.append((d.t, *(
                hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()
                for a in (d.batch.device_ids, d.batch.created_t))))
        else:
            self.groups.append((d.t, d.message.device_id,
                                d.message.created_t))
            if isinstance(d.message.payload, UpdateHandle):
                buf = d.message.payload.buffer
        if buf is not None:
            self.buffers[id(buf)] = buf
        before = len(self.svc.history)
        self.svc(d)
        if len(self.svc.history) > before:
            k = len(self.buffers) * self.n_leaves
            self.per_aggregation.append(k)
            self.expected += k
            for b in self.buffers.values():
                self.shapes.update(
                    (*leaf.shape, str(leaf.dtype).replace("torch.", ""))
                    for leaf in b.leaves2d)
            self.buffers = {}


class RoundProfiler:
    """``--profile``: round 1 of each wire under ``torch.profiler``, round 2
    under ``cProfile``; tables and the f32 trace go to ``chiprun_out/``."""

    def __init__(self, card: str):
        self.card = card
        self.profs: dict = {}
        os.makedirs(PROFILE_DIR, exist_ok=True)

    @contextlib.contextmanager
    def round(self, wire: str, rnd: int):
        if rnd == 1:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                yield
            self.profs[(wire, "torch")] = prof
        elif rnd == 2:
            import cProfile

            pr = cProfile.Profile()
            pr.enable()
            try:
                yield
            finally:
                pr.disable()
            self.profs[(wire, "cprofile")] = pr
        else:
            yield

    def report(self, wire: str, wall_ms: list[float]) -> None:
        import io
        import pstats

        prof = self.profs.get((wire, "torch"))
        if prof is not None:
            busy, n, by_name = kernel_time(cuda_events(prof))
            fed = [r for r in by_name if "fed_reduce" in r[0]]
            log(json.dumps({"round_profile": {
                "wire": wire, "round": 1, "wall_ms": wall_ms[1],
                "kernels": n, "device_busy_ms": busy,
                "device_idle_share": 1.0 - busy / wall_ms[1],
                "fed_reduce_ms": sum(r[1] for r in fed),
                "fed_reduce_kernel_launches": sum(r[2] for r in fed),
                "top_kernels_ms": by_name[:12],
                "card": self.card}}))
            with open(os.path.join(PROFILE_DIR, f"profile_{wire}_kernels.txt"),
                      "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="self_cuda_time_total", row_limit=40))
            if wire == "f32":
                prof.export_chrome_trace(
                    os.path.join(PROFILE_DIR, "profile_f32_round1.json"))
        pr = self.profs.get((wire, "cprofile"))
        if pr is not None:
            buf = io.StringIO()
            st = pstats.Stats(pr, stream=buf).sort_stats("cumulative")
            st.print_stats(40)
            with open(os.path.join(PROFILE_DIR, f"cprofile_{wire}.txt"),
                      "w") as f:
                f.write(buf.getvalue())
            rows = sorted(((f"{os.path.basename(k[0])}:{k[2]}", v[3])
                           for k, v in st.stats.items()),
                          key=lambda kv: -kv[1])
            log(json.dumps({"host_profile": {
                "wire": wire, "round": 2, "wall_ms": wall_ms[2],
                "cumulative_s_top": rows[:25], "card": self.card}}))


def run_slice(device, n_devices: int, *, dim: int, cohort: int, rounds: int,
              wires=("f32", "int8"), verbose: bool = True, bench: int = 1,
              profiler: "RoundProfiler | None" = None,
              recycle: bool = False, transform=None, pool=None,
              on_round=None, mesh=None) -> dict:
    """Quickstart sections 1-5 (and the int8 wire of section 9) through the
    port's public API, optionally with recycled update buffers, a payload
    transform (``transform()`` builds one per wire) or the cohort chunks in
    a worker pool (``pool``, a ``FleetWorkerPool`` shared by the wires and
    left open).  ``on_round(sim, rnd)`` runs before each round.  ``mesh``
    (a fleet mesh) shards the service's reductions and both tiers' cohort
    rows over its ``dp`` axis.  Returns per-wire results."""
    import numpy as np
    import torch

    from repro_torch.configs.avazu_lr import CONFIG
    from repro_torch.core import (AccumulatedStrategy, AggregationService,
                                  DeviceFlow, SampleThresholdTrigger)
    from repro_torch.core.devicemodel import GRADES
    from repro_torch.core.simulation import (DeviceTier, HybridSimulation,
                                             LogicalTier)
    from repro_torch.data.synthetic_ctr import make_federated_ctr
    from repro_torch.models import ctr

    dev = torch.device(device)
    specs = grade_specs(n_devices, bench)
    cal, alloc, plan = calibrated_plan(specs)
    if verbose:
        for e in plan.entries:
            log(f"allocation[{e.grade}]: {e.num_logical} logical / "
                f"{e.num_physical} physical / {e.num_benchmarking} "
                f"benchmarking")
        log(f"estimated makespan {alloc.makespan:.1f}s")
    t0 = time.perf_counter()
    batches, counts = grade_data(specs, dim, dev)
    test = make_federated_ctr(num_devices=64, dim=dim, seed=9)
    test_x = torch.from_numpy(test.features).to(dev)
    test_y = torch.from_numpy(test.labels).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if verbose:
        log(f"data: {n_devices} devices x {RECORDS} records x {dim} on "
            f"{dev} in {time.perf_counter() - t0:.1f}s")
    local_train = ctr.make_local_train_fn(lr=CONFIG.lr,
                                          epochs=CONFIG.local_epochs)
    out = {"plan": plan, "wires": {}}
    for wire in wires:
        svc = AggregationService(
            ctr.lr_init(dim, device=dev),
            trigger=SampleThresholdTrigger(n_devices * RECORDS // 2),
            mesh=mesh)
        audit = LaunchAudit(svc, n_leaves=2)
        flow = DeviceFlow(audit)
        flow.register_task(0, AccumulatedStrategy(thresholds=(1,)))
        sim = HybridSimulation(
            LogicalTier(local_train, cohort_size=cohort, device=dev,
                        mesh=mesh, data_axis="dp"),
            tiers={g: DeviceTier(local_train, GRADES[g], cohort_size=cohort,
                                 device=dev, mesh=mesh, data_axis="dp")
                   for g in ("High", "Low")},
            deviceflow=flow, wire=wire, error_feedback=True,
            recycle_buffers=recycle,
            payload_transform=None if transform is None else transform(),
            worker_pool=pool)
        params, losses, arrivals, walls, mem, kept = [], [], [], [], [], []
        stat_keys = ("requested_bytes", "allocated_bytes")
        for rnd in range(rounds):
            if dev.type == "cuda":
                # The caching allocator's bytes asked for and handed out
                # (whole cached blocks) in the round, and its peak: what
                # recycled buffers should cut.
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                stats = torch.cuda.memory_stats(dev)
                before = {k: stats[f"{k}.all.allocated"] for k in stat_keys}
            if on_round is not None:
                on_round(sim, rnd)
            with (profiler.round(wire, rnd) if profiler is not None
                  else contextlib.nullcontext()):
                t = time.perf_counter()
                outcome = sim.run_plan_round(
                    task_id=0, round_idx=rnd,
                    global_params=svc.global_params, plan=plan,
                    grade_batches=batches, grade_num_samples=counts,
                    rng=torch.Generator().manual_seed(rnd), calibrator=cal)
                if wire == "int8":
                    flow.run(1e12)
                    svc.tick(flow.clock.now)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
            if dev.type == "cuda":
                stats = torch.cuda.memory_stats(dev)
                mem.append({
                    **{k: stats[f"{k}.all.allocated"] - before[k]
                       for k in stat_keys},
                    "peak_bytes": torch.cuda.max_memory_allocated(dev)})
            if recycle:  # the storage of the buffers kept for next round
                kept.append(sorted(leaf.data_ptr()
                                   for bufs in sim._retired.values()
                                   for b in bufs for leaf in b.leaves2d))
            acc = float(ctr.accuracy(svc.global_params, test_x, test_y))
            loss = float(ctr.bce_loss(svc.global_params, test_x, test_y))
            p = ctr.params_to_numpy(svc.global_params)
            for k, v in p.items():
                if not np.all(np.isfinite(v)):
                    raise AssertionError(f"[{wire}] params[{k!r}] not finite")
            if p["w"].shape != (dim,) or p["b"].shape != ():
                raise AssertionError(f"[{wire}] params have the wrong shapes")
            per_grade = " ".join(f"{g}={b.makespan_s:.0f}s"
                                 for g, b in outcome.per_grade.items())
            if verbose:
                log(f"round {rnd}: aggregations={len(svc.history)} "
                    f"test_acc={acc:.4f} test_loss={loss:.6f} "
                    f"makespan[{per_grade}] wall_ms={wall_ms:.1f} "
                    f"wire={wire} |w|={float(np.linalg.norm(p['w'])):.6f}")
            params.append(p)
            losses.append(loss)
            walls.append(wall_ms)
            arrivals.append(outcome.arrival_times.copy())
        shelf = flow.shelf(0)
        if not flow.conservation_ok(0):
            raise AssertionError(f"[{wire}] DeviceFlow lost messages")
        out["wires"][wire] = {
            "params": params, "test_loss": losses,
            "aggregations": len(svc.history), "arrivals": arrivals,
            "bytes": shelf.total_bytes_dispatched,
            "bytes_received": shelf.total_bytes_received,
            "dispatched": shelf.total_dispatched, "audit": audit,
            "wall_ms": walls, "memory": mem, "kept": kept, "svc": svc,
            "outcome": outcome}
        if verbose:
            log(f"[{wire}] deviceflow traffic: "
                f"{shelf.total_bytes_dispatched / 2**20:.1f} MiB dispatched "
                f"across {shelf.total_dispatched} update messages; "
                f"fed_reduce launches expected {audit.expected} "
                f"({audit.per_aggregation} per aggregation)")
        if profiler is not None:
            profiler.report(wire, walls)
    return out


def slice_phase(dev, n_devices: int, rounds: int, checked: set,
                bench: int) -> dict:
    from repro_torch.configs.avazu_lr import CONFIG
    from repro_torch.kernels.fed_reduce.ops import fed_reduce

    fed_reduce.launches = 0  # zeroed just before the main path ...
    res = run_slice(dev, n_devices, dim=CONFIG.dim, cohort=COHORT,
                    rounds=rounds, bench=bench)
    launches = fed_reduce.launches  # ... and read just after it
    expected = sum(w["audit"].expected for w in res["wires"].values())
    log(f"fed_reduce launches on the main path: {launches} "
        f"(expected {expected})")
    if launches <= 0 or launches != expected:
        raise AssertionError(
            f"fed_reduce launched {launches} times on the main path, "
            f"expected {expected} (> 0)")
    reduced = set().union(*(w["audit"].shapes
                            for w in res["wires"].values()))
    if not reduced <= checked:
        raise AssertionError(
            f"the main path reduced shapes the kernel phase did not check: "
            f"{sorted(reduced - checked)}")
    log(f"main-path shapes {sorted(reduced)} all checked in the kernel phase")
    for wire, w in res["wires"].items():
        # From zero params the test loss starts at ln 2 and FedAvg of local
        # SGD must lower it every round.
        losses = [math.log(2.0)] + w["test_loss"]
        if not all(b < a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"[{wire}] test loss did not fall every "
                                 f"round: {losses}")
    res["launches"] = launches
    return res


def cross_check_phase(n_devices: int, rounds: int) -> dict:
    import numpy as np

    from repro_torch.configs.avazu_lr import CONFIG

    def flat(p):
        return np.concatenate([p[k].reshape(-1) for k in sorted(p)])

    kw = dict(dim=CONFIG.dim, cohort=512, rounds=rounds, verbose=False)
    gpu = run_slice("cuda", n_devices, **kw)
    cpu = run_slice("cpu", n_devices, **kw)
    report = {}
    for wire in gpu["wires"]:
        g, c = gpu["wires"][wire], cpu["wires"][wire]
        diff = rel = 0.0
        prev_g = prev_c = np.zeros_like(flat(c["params"][0]))
        for pg, pc in zip(g["params"], c["params"]):
            fg, fc = flat(pg), flat(pc)
            diff = max(diff, float(np.abs(fg - fc).max()))
            rel = max(rel, float(np.linalg.norm((fg - prev_g) - (fc - prev_c))
                                 / np.linalg.norm(fc - prev_c)))
            prev_g, prev_c = fg, fc
        same_host = (g["aggregations"] == c["aggregations"]
                     and g["bytes"] == c["bytes"]
                     and g["dispatched"] == c["dispatched"]
                     and all(np.array_equal(a, b) for a, b in
                             zip(g["arrivals"], c["arrivals"])))
        report[wire] = {"max_param_diff": diff, "max_update_rel_err": rel,
                        "host_state_equal": same_host,
                        "aggregations": g["aggregations"]}
        log(f"cross-check [{wire}] {n_devices} devices: card vs cpu max "
            f"param diff {diff:.3e} (tol 1e-6), max relative update error "
            f"{rel:.3e} (tol 1e-3), host state equal {same_host}")
        if not (diff <= 1e-6 and rel <= 1e-3) or not same_host:
            raise AssertionError(f"cross-check [{wire}] failed: {report}")
    return report


# --------------------------------------------------------------------------
# phase 4: the attention kernels against their plain versions

SERVE_ARCH = "llama3_2_3b"
SERVE_SLOTS = 16
SERVE_REQUESTS = 64
SERVE_PROMPT = 512
SERVE_DECODE = 64
SERVE_MAX_LEN = SERVE_PROMPT + SERVE_DECODE + 1
SERVE_SEED = 0
# (b, s, h, kv, d) and (b, sq, sk, h, kv, d, causal, q_offset): the serving
# run's shapes first, then tests/test_kernels.py's DECODE_CASES (l.65) and
# FLASH_CASES (l.27).
DECODE_SERVE = (SERVE_SLOTS, SERVE_MAX_LEN, 24, 8, 128)
FLASH_SERVE = (SERVE_SLOTS, SERVE_PROMPT, SERVE_PROMPT, 24, 8, 128, True, 0)
# zamba2-1.2b's shared attention block at the SSM serving run's shapes: 32
# heads of 64, one query head per KV head.
DECODE_ZAMBA = (SERVE_SLOTS, SERVE_MAX_LEN, 32, 32, 64)
FLASH_ZAMBA = (SERVE_SLOTS, SERVE_PROMPT, SERVE_PROMPT, 32, 32, 64, True, 0)
# granite-moe-3b (24 query / 8 KV heads of 64, g = 3) on the llama trace.
MOE_ARCH = "granite_moe_3b_a800m"
# Phase 10 serves granite-moe-3b at its published width and 8 of its 32
# layers: its host-bound decode grows with depth (~255 s of the smoke at
# 32 layers), and the smoke's phases must fit its time limit.
MOE_LAYERS = 8
DECODE_GRANITE = (SERVE_SLOTS, SERVE_MAX_LEN, 24, 8, 64)
FLASH_GRANITE = (SERVE_SLOTS, SERVE_PROMPT, SERVE_PROMPT, 24, 8, 64, True, 0)
# seamless-m4t-medium (16/16 heads of 64): 16 sequences of 256 stub source
# frames, decoder prompts of 64 and 64 greedy tokens.
ENCDEC_ARCH = "seamless_m4t_medium"
ENCDEC_PROMPT = 64
ENCDEC_DECODE = 64
ENCDEC_MAX_LEN = ENCDEC_PROMPT + ENCDEC_DECODE + 1
ENCDEC_FRAMES = 256  # cfg.frontend_tokens
DECODE_SEAMLESS = (SERVE_SLOTS, ENCDEC_MAX_LEN, 16, 16, 64)  # self
DECODE_SEAMLESS_X = (SERVE_SLOTS, ENCDEC_FRAMES, 16, 16, 64)  # cross
FLASH_SEAMLESS_ENC = (SERVE_SLOTS, ENCDEC_FRAMES, ENCDEC_FRAMES, 16, 16, 64,
                      False, 0)
FLASH_SEAMLESS_SELF = (SERVE_SLOTS, ENCDEC_PROMPT, ENCDEC_PROMPT, 16, 16, 64,
                       True, 0)
FLASH_SEAMLESS_X = (SERVE_SLOTS, ENCDEC_PROMPT, ENCDEC_FRAMES, 16, 16, 64,
                    False, 0)
# Cross-attention decode reads every source frame: timed at full lengths.
FULL_LENGTHS = (DECODE_SEAMLESS_X,)
TIMED_DECODE = (DECODE_SERVE, DECODE_ZAMBA, DECODE_GRANITE, DECODE_SEAMLESS,
                DECODE_SEAMLESS_X)
TIMED_FLASH = (FLASH_SERVE, FLASH_ZAMBA, FLASH_GRANITE, FLASH_SEAMLESS_ENC,
               FLASH_SEAMLESS_SELF, FLASH_SEAMLESS_X)
DECODE_NEW = [DECODE_GRANITE, DECODE_SEAMLESS, DECODE_SEAMLESS_X]
FLASH_NEW = [FLASH_GRANITE, FLASH_SEAMLESS_ENC, FLASH_SEAMLESS_SELF,
             FLASH_SEAMLESS_X]
DECODE_CASES = [DECODE_SERVE, DECODE_ZAMBA, *DECODE_NEW, (2, 256, 8, 2, 64),
                (1, 512, 4, 4, 128), (3, 300, 6, 1, 64), (2, 64, 16, 16, 32)]
FLASH_CASES = [FLASH_SERVE, FLASH_ZAMBA, *FLASH_NEW,
               (2, 256, 256, 4, 2, 64, True, 0),
               (1, 128, 384, 8, 8, 128, False, 0),
               (2, 96, 200, 6, 2, 64, True, 104),
               (1, 1, 256, 4, 1, 64, True, 255),
               (1, 512, 512, 2, 1, 32, True, 0),
               (2, 200, 200, 12, 4, 128, True, 0)]
DECODE_SOURCE = "src/repro_torch/csrc/decode_attention.cu"
DECODE_REPLACES = "src/repro/kernels/decode_attention/decode_attention.py:31"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:33"
FLASH_KERNEL = "flash_fwd_wgmma_kernel"  # bf16 at d = 64, 128: tensor cores
DECODE_KERNEL = "decode_kernel (mma stream)"  # bf16 at d = 64, 128: mma.sync


def _attn_tol(dtype) -> float:
    import torch

    return 3e-5 if dtype == torch.float32 else 2e-2


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _check_close(name: str, out, plain, dtype) -> float:
    """Max |out - plain|; raises unless |out - plain| <= tol (1 + |plain|)
    everywhere (the reference tests' atol = rtol = tol)."""
    tol = _attn_tol(dtype)
    err = (out.float() - plain.float()).abs()
    if not bool((err <= tol * (1.0 + plain.float().abs())).all()):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max abs error {float(err.max()):.3e} "
                             f"(tol {tol})")
    return float(err.max())


def _copies(nbytes: int) -> int:
    """Copies to cycle through so the timed calls find their inputs cold in
    the 50 MB L2, as the serving path does layer after layer."""
    return max(1, min(16, math.ceil(3 * L2_BYTES / nbytes)))


def _timed_entry(name, source, replaces, errs, serve_row) -> dict:
    """A kernel's JSON entry: its numbers at the main path's shape (None
    where that shape was not run, as under ``--ssm-only``)."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": max(errs),
            **{k: (serve_row or {}).get(k) for k in keys}}


def decode_cases(dev, cases=DECODE_CASES) -> tuple[dict, set]:
    import torch

    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, scatter_prefill_rows)

    gen = torch.Generator().manual_seed(1)
    checked, errs, serve_row, calls = set(), [], None, []
    for case in cases:
        b, s, h, kv, d = case
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, h, d), generator=gen).to(dtype).to(dev)
            kc = torch.randn((b, s, kv, d), generator=gen).to(dtype).to(dev)
            vc = torch.randn((b, s, kv, d), generator=gen).to(dtype).to(dev)
            lens = torch.randint(1, s + 1, (b,), generator=gen,
                                 dtype=torch.int32)
            lens[0], lens[-1] = 0, s  # an empty slot and a full one
            lens = lens.to(dev)
            name = f"decode_attention{case} {_dtype_name(dtype)}"
            out = decode_attention(q, kc, vc, lens, impl="cuda")
            out2 = decode_attention(q, kc, vc, lens, impl="cuda")
            plain = decode_attention(q, kc, vc, lens, impl="ref")
            torch.cuda.synchronize()
            err = _check_close(name, out, plain, dtype)
            if not torch.equal(out, out2):
                raise AssertionError(f"{name} is not repeatable")
            if not bool((out[lens == 0] == 0).all()):
                raise AssertionError(f"{name}: an empty slot is not zeros")
            # A reused slot: rows past its new length hold the previous
            # occupant's K/V, and attention must not see them.
            new_len = max(1, s // 3)
            sid = torch.tensor([b - 1], dtype=torch.int32, device=dev)
            dk = scatter_prefill_rows(kc.clone(), kc[:1, :new_len], sid)
            dv = scatter_prefill_rows(vc.clone(), vc[:1, :new_len], sid)
            ck, cv = dk.clone(), dv.clone()
            ck[b - 1, new_len:] = 0
            cv[b - 1, new_len:] = 0
            lens2 = lens.clone()
            lens2[-1] = new_len
            stale = float((decode_attention(q, dk, dv, lens2, impl="cuda")
                           .float() - decode_attention(
                               q, ck, cv, lens2, impl="cuda").float())
                          .abs().max())
            if not stale <= 1e-6:
                raise AssertionError(f"{name} reads stale KV: {stale:.3e}")
            errs.append(err)
            calls.append((q, kc, vc, lens))
            checked.add(("decode", case, _dtype_name(dtype)))
            row = {"case": list(case), "dtype": _dtype_name(dtype),
                   "max_abs_err": err, "stale_kv_diff": stale,
                   "bitwise_repeatable": True, "empty_slots_zero": True}
            if case in TIMED_DECODE and dtype == torch.bfloat16:
                tl = (torch.full_like(lens, s) if case in FULL_LENGTHS
                      else lens)
                row.update(decode_timing(q, kc, vc, tl, case))
                row["lengths"] = "full" if case in FULL_LENGTHS else "ragged"
                if case == DECODE_SERVE:
                    # The continuous engine's decode steps: 3 busy slots of
                    # 16 (lengths 512-577), the rest empty.
                    busy = torch.zeros(b, dtype=torch.int32)
                    busy[-3:] = torch.tensor([512, 545, 577],
                                             dtype=torch.int32)
                    occ = decode_timing(q, kc, vc, busy.to(dev), case)
                    row["main_occupancy"] = {
                        "lengths": busy.tolist(),
                        **{k: occ[k] for k in ("ms", "plain_ms",
                                               "library_ms", "bound_ms",
                                               "bound_by")}}
                    serve_row = row
            log(json.dumps({"decode_attention_case": row}))
    # One kernel per call, the splits' fold included: each call once more
    # to warm it, then twice per case in a profiled window.
    calls = calls[1::2][:2] + calls[-2:]  # both bf16 serving shapes first

    def window():
        for _ in range(2):
            for c in calls:
                decode_attention(*c, impl="cuda")
    for c in calls:
        decode_attention(*c, impl="cuda")
    launched = device_kernels(window)
    n_launched = sum(n for _, _, n in launched)
    if n_launched != 2 * len(calls) or any("decode_kernel" not in k
                                           for k, _, _ in launched):
        raise AssertionError(f"{2 * len(calls)} decode_attention calls "
                             f"launched {launched}, not one decode_kernel "
                             f"each")
    log(f"decode_attention: {2 * len(calls)} calls, {n_launched} kernel "
        f"launches ({', '.join(sorted({k for k, _, _ in launched}))[:200]})")
    entry = _timed_entry("decode_attention", DECODE_SOURCE, DECODE_REPLACES,
                         errs, serve_row)
    entry["kernel"] = DECODE_KERNEL  # the main path's: bf16 at d = 64, 128
    return entry, checked


def decode_timing(q, kc, vc, lens, case) -> dict:
    """A bf16 serving shape's times at these lengths: the kernel, the plain
    version, SDPA (GQA, a boolean length mask) and the bound (the K/V rows
    these lengths need, read once)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.roofline import op_analysis as oa

    b, s, h, kv, d = case
    n = _copies(2 * kc.numel() * kc.element_size())
    ks = [kc.clone() for _ in range(n)]
    vs = [vc.clone() for _ in range(n)]
    kts = [k.transpose(1, 2).contiguous() for k in ks]
    vts = [v.transpose(1, 2).contiguous() for v in vs]
    q4 = q[:, :, None, :]
    mask = (torch.arange(s, device=q.device)[None] < lens[:, None])[
        :, None, None, :]
    row = {"kernel": DECODE_KERNEL}
    row["ms"] = time_ms(lambda i: decode_attention(
        q, ks[i % n], vs[i % n], lens, impl="cuda"), iters=100)
    row["plain_ms"] = time_ms(lambda i: decode_attention(
        q, ks[i % n], vs[i % n], lens, impl="ref"), iters=10)
    row["library_ms"] = time_ms(
        lambda i: F.scaled_dot_product_attention(
            q4, kts[i % n], vts[i % n], attn_mask=mask, enable_gqa=True),
        iters=100)
    row.update(oa.bound(oa.decode_attention_work(
        b, h, kv, d, kc.element_size(), oa.decode_rows(lens, s)),
        BF16_FLOPS))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


def flash_cases(dev, cases=FLASH_CASES) -> tuple[dict, set]:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention

    gen = torch.Generator().manual_seed(2)
    checked, errs, serve_row = set(), [], None
    for case in cases:
        b, sq, sk, h, kv, d, causal, off = case
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, sq, h, d), generator=gen).to(dtype).to(dev)
            k = torch.randn((b, sk, kv, d), generator=gen).to(dtype).to(dev)
            v = torch.randn((b, sk, kv, d), generator=gen).to(dtype).to(dev)
            kw = dict(causal=causal, q_offset=off)
            name = f"flash_attention{case} {_dtype_name(dtype)}"
            out = flash_attention(q, k, v, impl="cuda", **kw)
            out2 = flash_attention(q, k, v, impl="cuda", **kw)
            plain = flash_attention(q, k, v, impl="ref", **kw)
            torch.cuda.synchronize()
            err = _check_close(name, out, plain, dtype)
            if not torch.equal(out, out2):
                raise AssertionError(f"{name} is not repeatable")
            errs.append(err)
            checked.add(("flash", case, _dtype_name(dtype)))
            row = {"case": list(case), "dtype": _dtype_name(dtype),
                   "max_abs_err": err, "bitwise_repeatable": True}
            if case in TIMED_FLASH and dtype == torch.bfloat16:
                row.update(flash_timing(q, k, v, case))
                if case == FLASH_SERVE:
                    serve_row = row
            log(json.dumps({"flash_attention_case": row}))
    entry = _timed_entry("flash_attention", FLASH_SOURCE, FLASH_REPLACES,
                         errs, serve_row)
    entry["kernel"] = FLASH_KERNEL  # the main path's: bf16 at d = 64, 128
    return entry, checked


def flash_timing(q, k, v, case) -> dict:
    """A bf16 serving shape's times: the tensor-core kernel, the plain-FMA
    kernel on the same inputs (the previous design, for comparison in this
    call), the plain version, SDPA (GQA, causal) and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.roofline import op_analysis as oa

    b, sq, sk, h, kv, d, causal, off = case
    kw = dict(causal=causal, q_offset=off)
    scale = d ** -0.5
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    row = {"kernel": FLASH_KERNEL}
    row["ms"] = time_ms(lambda i: ops.flash_attention(
        q, k, v, impl="cuda", **kw), iters=40)
    row["simt_ms"] = time_ms(lambda i: ops._flash_attention_cuda(
        q, k, v, causal, off, scale, kernel="simt"), iters=20)
    row["plain_ms"] = time_ms(lambda i: ops.flash_attention(
        q, k, v, impl="ref", **kw), iters=5)
    row["library_ms"] = time_ms(
        lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), iters=40)
    row.update(oa.bound(oa.flash_attention_work(
        b, sq, sk, h, kv, d, q.element_size(), causal, off), BF16_FLOPS))
    row["tflops"] = row["flops"] / (row["ms"] * 1e9)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


# --------------------------------------------------------------------------
# phase 5/6: continuous-batching serving at llama3.2-3b width

class WallTimer:
    """Host wall ms of each call of a wrapped function, the card drained
    before and after (so a call's time is its own)."""

    def __init__(self):
        self.ms: dict[str, list[float]] = {}

    def wrap(self, name: str, fn):
        import torch

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.ms.setdefault(name, []).append(
                (time.perf_counter() - t) * 1e3)
            return out
        return timed


@contextlib.contextmanager
def timed_arena_ops(timer: WallTimer):
    """The continuous engine's arena_prefill/arena_decode, wall-timed."""
    from repro_torch.core import serving

    saved = serving.arena_prefill, serving.arena_decode
    serving.arena_prefill = timer.wrap("prefill", saved[0])
    serving.arena_decode = timer.wrap("decode", saved[1])
    try:
        yield
    finally:
        serving.arena_prefill, serving.arena_decode = saved


def _trace_kw(cfg) -> dict:
    from repro_torch.core.traffic_curves import diurnal

    return dict(requests=SERVE_REQUESTS, prompt_len=SERVE_PROMPT,
                vocab_size=cfg.vocab_size, curve=diurnal(), interval=60.0,
                seed=SERVE_SEED)


def cpu_reports(arch: str) -> dict:
    """The same trace on the CPU: the virtual-time reports depend on the
    arrivals and the cost model only, so the continuous engine runs without
    a model and the fixed batches with ``arch``'s smoke-size model."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.deviceflow import VirtualClock
    from repro_torch.core.serving import (ContinuousBatchingEngine,
                                          ContinuousServer)
    from repro_torch.launch import serve

    cfg = get_config(arch, smoke=True)
    eng = ContinuousBatchingEngine(slots=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
                                   decode_tokens=SERVE_DECODE,
                                   max_len=SERVE_MAX_LEN, simulate_only=True)
    clock = VirtualClock()
    serve.run_trace(ContinuousServer(eng, clock), clock=clock,
                    **_trace_kw(cfg))
    return {"continuous": eng.report(), "fixed": fixed_cpu_report(arch)}


def fixed_cpu_report(arch: str):
    """The trace's fixed-batch run on the CPU with ``arch``'s smoke-size
    model."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve

    cfg = get_config(arch, smoke=True)
    fixed = serve.BatchedServer(cfg, batch_size=SERVE_SLOTS,
                                prompt_len=SERVE_PROMPT,
                                decode_tokens=SERVE_DECODE,
                                max_len=SERVE_MAX_LEN, device="cpu")
    serve.run_trace(fixed, **_trace_kw(cfg))
    return fixed.report()


def cuda_events(prof) -> list:
    """The device kernel records of a ``torch.profiler`` window."""
    from torch.autograd import DeviceType

    return [e for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def kernel_time(kern: list) -> tuple[float, int, list]:
    """Device busy time of kernel records (the union of their intervals,
    ms), their count, and ``[name, ms, calls]`` per kernel name (first 90
    characters), most device time first."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    by_name: dict[str, list] = {}
    for e in kern:
        rec = by_name.setdefault(e.name[:90], [0.0, 0])
        rec[0] += (e.time_range.end - e.time_range.start) / 1e3
        rec[1] += 1
    rows = sorted(([k, *v] for k, v in by_name.items()), key=lambda r: -r[1])
    return busy / 1e3, len(kern), rows


SENTINEL = "spin_kernel"  # torch.cuda._sleep's kernel, launched nowhere else


def profiled(fn) -> tuple[list, float]:
    """``fn()`` under ``torch.profiler`` (CUDA activity only): the kernel
    records it ran and its host wall (ms).

    The tracer can drop a window's first records, more of them the more
    windows and kernels ran before (never adding any).  So the window is
    bracketed by ``pad`` sentinel kernels on each side, and its records
    count only when the first and the last record are sentinels: then
    every record of ``fn`` in between was kept.  Otherwise the window
    runs again with a longer pad, and after the last try this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for pad in (1024, 8192, 32768):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)  # let the tracer settle before the first launch
            for _ in range(pad):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e3
            for _ in range(pad):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        kern = sorted(cuda_events(prof), key=lambda e: e.time_range.start)
        work = [i for i, e in enumerate(kern) if SENTINEL not in e.name]
        lead = work[0] if work else len(kern)
        trail = len(kern) - 1 - work[-1] if work else len(kern)
        if lead and trail:
            return [kern[i] for i in work], wall
        log(f"profiler window with a pad of {pad} kept {lead} leading and "
            f"{trail} trailing sentinels of {pad} each; again with a longer "
            f"pad")
    raise AssertionError("the profiler lost records at the edge of every "
                         "window, so no kernel count can be trusted")


def device_kernels(fn) -> list:
    """``[name, ms, launches]`` of each device kernel one call of ``fn``
    runs (:func:`profiled`)."""
    return kernel_time(profiled(fn)[0])[2]


def profile_window(fn, steps: int, match=()) -> dict:
    """``fn()`` under :func:`profiled`: its host wall, the device's busy
    time and idle share, the kernels that took it, and how many kernels'
    names contain each string of ``match`` and their device ms."""
    kern, wall = profiled(fn)
    busy, n, by_name = kernel_time(kern)
    return {"steps": steps, "wall_ms": wall, "device_busy_ms": busy,
            "kernels": n, "device_idle_share": 1.0 - busy / wall,
            "top_kernels_ms": by_name[:8],
            "matched": {m: sum(m in e.name for e in kern) for m in match},
            "matched_ms": {m: sum((e.time_range.end - e.time_range.start)
                                  / 1e3 for e in kern if m in e.name)
                           for m in match}}


def serving_profile(cfg, params, prompts, card: str) -> dict:
    """Device idle share of the continuous engine: one step admitting three
    requests (the trace's usual occupancy: prefill + decode), then 20
    decode-only steps, each window under ``torch.profiler`` (CUDA activity
    only) with its host wall."""
    from repro_torch.core.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(cfg, slots=SERVE_SLOTS,
                                   prompt_len=SERVE_PROMPT,
                                   decode_tokens=SERVE_DECODE,
                                   max_len=SERVE_MAX_LEN, params=params,
                                   device=params["ln_f"].device)
    for i in range(3):
        eng.submit(i, prompts[i], 0.0)
    out, clock = {}, [0.0]

    def steps(k):
        for _ in range(k):
            clock[0] += eng.step(clock[0])
    for window, k in (("prefill_step", 1), ("decode_steps", 20)):
        out[window] = profile_window(lambda: steps(k), k)
    log(json.dumps({"serving_profile": out, "card": card}))
    del eng
    return out


def serving_phase(dev, checked: set, card: str,
                  arch: str = SERVE_ARCH, layers: "int | None" = None
                  ) -> dict:
    """Phase 5 (llama3.2-3b) and phase 10 (granite-moe-3b): ``arch`` at
    full width on the trace, continuous then fixed, at ``layers`` of its
    layers (all by default)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.deviceflow import VirtualClock
    from repro_torch.core.serving import (ContinuousBatchingEngine,
                                          ContinuousServer)
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    params = transformer.init(
        torch.Generator(device=dev).manual_seed(SERVE_SEED), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name}: {n_params} params ({n_params * 2 / 1e9:.2f} GB bf16) "
        f"at {cfg.num_layers} layers, initialized on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    L = cfg.num_layers

    def flash_shape(b):  # what a prefill of b prompts gives the kernel
        return (b, SERVE_PROMPT, SERVE_PROMPT, cfg.num_heads,
                cfg.num_kv_heads, cfg.head_dim, True, 0)

    def decode_shape(b):  # what a decode step over b rows gives it
        return (b, SERVE_MAX_LEN, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim)

    cpu = cpu_reports(arch)
    reports, results = {}, {}
    for mode in ("continuous", "fixed"):
        timer = WallTimer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        decode_attention.launches = 0  # zeroed just before the main path ...
        flash_attention.launches = flash_attention.wgmma_launches = 0
        w0 = time.perf_counter()
        if mode == "continuous":
            engine = ContinuousBatchingEngine(
                cfg, slots=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
                decode_tokens=SERVE_DECODE, max_len=SERVE_MAX_LEN,
                params=params, device=dev)
            clock = VirtualClock()
            with timed_arena_ops(timer):
                serve.run_trace(ContinuousServer(engine, clock), clock=clock,
                                **_trace_kw(cfg))
            rep = engine.report()
            n_prefill = sum(1 for it in engine.iterations if it.admitted)
            n_decode = sum(1 for it in engine.iterations if it.n_active)
            tokens = sum(it.n_active for it in engine.iterations)
            shapes = {("flash", flash_shape(SERVE_SLOTS), "bfloat16"),
                      ("decode", decode_shape(SERVE_SLOTS), "bfloat16")}
            occupancy = max(it.n_active for it in engine.iterations)
        else:
            server = serve.BatchedServer(
                cfg, batch_size=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
                decode_tokens=SERVE_DECODE, max_len=SERVE_MAX_LEN,
                params=params, device=dev)
            server.api = dataclasses.replace(
                server.api, prefill=timer.wrap("prefill", server.api.prefill),
                decode_step=timer.wrap("decode", server.api.decode_step))
            serve.run_trace(server, **_trace_kw(cfg))
            rep = server.report()
            n_prefill = len(server.metrics)
            n_decode = n_prefill * SERVE_DECODE
            tokens = sum(m.tokens_decoded for m in server.metrics)
            shapes = set()
            for m in server.metrics:
                shapes.add(("flash", flash_shape(m.batch_size), "bfloat16"))
                shapes.add(("decode", decode_shape(m.batch_size), "bfloat16"))
            occupancy = max(m.batch_size for m in server.metrics)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - w0
        launches = {"decode_attention": decode_attention.launches,
                    "flash_attention": flash_attention.launches,
                    "flash_attention_wgmma":
                        flash_attention.wgmma_launches}  # ... read
        # Every prefill's attention runs on the tensor-core kernel.
        expected = {"decode_attention": L * n_decode,
                    "flash_attention": L * n_prefill,
                    "flash_attention_wgmma": L * n_prefill}
        peak = torch.cuda.max_memory_allocated()
        s = rep.summary(30.0)
        if s != cpu[mode].summary(30.0):
            raise AssertionError(f"[{mode}] the card's virtual-time report "
                                 f"{s} differs from the CPU run's "
                                 f"{cpu[mode].summary(30.0)}")
        if launches != expected or min(launches.values()) <= 0:
            raise AssertionError(f"[{mode}] launches {launches}, expected "
                                 f"{expected}")
        if not shapes <= checked:
            raise AssertionError(f"[{mode}] launched shapes the kernel phase "
                                 f"did not check: {sorted(shapes - checked)}")
        toks = {r.request_id: r.tokens for r in rep.records}
        if len(rep.finished()) != SERVE_REQUESTS or any(
                len(t) != SERVE_DECODE + 1 for t in toks.values()):
            raise AssertionError(f"[{mode}] not every request finished")
        pre, dec = timer.ms["prefill"], timer.ms["decode"]
        res = {"arch": cfg.name, "mode": mode, "report": s,
               "prefill_calls": n_prefill,
               "decode_iterations": n_decode,
               "wall_ms_per_prefill": sum(pre) / len(pre),
               "wall_ms_per_decode_iteration": sum(dec) / len(dec),
               "decode_tokens_per_s": tokens / (sum(dec) / 1e3),
               "peak_memory_gb": peak / 1e9, "wall_s": wall_s,
               "launches": launches, "expected_launches": expected,
               "peak_occupancy": occupancy, "card": card}
        log(json.dumps({"serving": res}))
        log(f"  {mode:10s} p50={s['p50_latency_s'] * 1e3:.1f}ms "
            f"p99={s['p99_latency_s'] * 1e3:.1f}ms "
            f"ttft_p99={s['p99_ttft_s'] * 1e3:.1f}ms "
            f"goodput={s['goodput_rps']:.4f} req/s (= CPU run) | "
            f"{res['wall_ms_per_prefill']:.1f} ms/prefill, "
            f"{res['wall_ms_per_decode_iteration']:.2f} ms/decode "
            f"iteration, {res['decode_tokens_per_s']:.0f} decode tok/s, "
            f"peak {peak / 1e9:.2f} GB; launches {launches} = expected")
        reports[mode], results[mode] = rep, res
        results[mode]["tokens"] = toks
    c, f = reports["continuous"], reports["fixed"]
    cut = f.p99_latency_s / c.p99_latency_s
    log(f"p99 latency cut: {cut:.2f}x (>= 2 required)")
    if not cut >= 2.0:
        raise AssertionError(f"continuous p99 cut {cut:.2f}x < 2x")
    tc, tf = results["continuous"].pop("tokens"), results["fixed"].pop(
        "tokens")
    same = sum(tc[i] == tf[i] for i in tc)
    log(f"continuous vs fixed tokens: {same}/{len(tc)} requests identical "
        "(bf16; not gated)")
    prompts = np.random.default_rng(SERVE_SEED).integers(
        1, cfg.vocab_size, size=(SERVE_REQUESTS, SERVE_PROMPT))
    profile = serving_profile(cfg, params, prompts, card)
    return {"params": params, "cfg": cfg, "prompts": prompts,
            "results": results, "p99_cut": cut, "profile": profile,
            "launches": {k: sum(r["launches"][k] for r in results.values())
                         for k in ("decode_attention", "flash_attention",
                                   "flash_attention_wgmma")}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def compare_paths(name: str, kernel, plain, vocab: int, dtype: str,
                  tol: float, steps: int = 16,
                  gate_tokens: bool = True) -> dict:
    """Teacher-forced comparison of two serving paths at full width and 2
    layers.  ``kernel`` and ``plain`` are ``(prefill() -> (logits, cache),
    decode(token, cache) -> (logits, cache))``; both paths get the plain
    path's greedy token.  Last-position logits must agree within ``tol``
    relative, and in f32 every greedy token must be equal."""
    import torch

    lk, ck = kernel[0]()
    lp, cp = plain[0]()
    worst, agree, total = 0.0, 0, 0
    for step in range(steps + 1):
        worst = max(worst, float((lk - lp).abs().max() / lp.abs().max()))
        gk, gp = lk[:, :vocab].argmax(-1), lp[:, :vocab].argmax(-1)
        agree += int((gk == gp).sum())
        total += gk.numel()
        if step == steps:
            break
        nxt = gp.to(torch.int32)
        lk, ck = kernel[1](nxt, ck)
        lp, cp = plain[1](nxt, cp)
    rate = agree / total
    log(f"{name} 2 layers at full width: kernel vs plain max relative "
        f"logit diff {worst:.3e} (tol {tol}), greedy tokens agree "
        f"{agree}/{total} ({rate:.4f})")
    if not worst <= tol:
        raise AssertionError(f"{name} failed")
    if gate_tokens and dtype == "float32" and agree != total:
        raise AssertionError(f"{name}: greedy tokens differ")
    return {"max_rel_logit_diff": worst, "tol": tol,
            "greedy_agreement": rate, "steps": steps}


def _float_tree(tree):
    if isinstance(tree, dict):
        return {k: _float_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_float_tree(v) for v in tree]
    return tree.float()


CROSS_DTYPES = (("bfloat16", 2e-2), ("float32", 1e-4))


class ForcedRouting:
    """Teacher-forces an MoE model's discrete choices across two paths, as
    ``compare_paths`` teacher-forces tokens: the kernel path's calls record
    each layer's routing (experts and capacity slots), the plain path's
    calls replay it with their own gate values at those experts.  Without
    it one near-tie in the router (an 8th and 9th expert a bf16 rounding
    apart) swaps an expert and, through the capacity ranks, can drop or
    keep other tokens: the logits then measure that discrete choice, not
    the kernels.  ``flips`` counts the pairs whose own choice differed."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.real = moe, moe.route
        self.record, self.log, self.i = True, [], 0
        self.flips = self.pairs = 0

    def __call__(self, router, xt, cfg):
        import torch

        r = self.real(router, xt, cfg)
        if self.record:
            self.log.append(r)
            return r
        f = self.log[self.i]
        self.i += 1
        self.flips += int((f.expert != r.expert).sum())
        self.pairs += f.expert.numel()
        with self.moe._full_f32_matmul():
            probs = torch.softmax(xt.float() @ router, dim=-1)
        g = probs.gather(1, f.expert.view(-1, cfg.experts_per_token))
        g = g / torch.clamp_min(g.sum(-1, keepdim=True), 1e-9)
        g = g.reshape(-1) * (f.slot < f.capacity).float()
        return self.moe.Routing(f.expert, f.slot, g, f.capacity, r.aux_loss)

    def path(self, fn, record: bool):
        def call(*a):
            self.record = record
            if record:
                self.log = []
            self.i = 0
            return fn(*a)
        return call

    @contextlib.contextmanager
    def installed(self):
        self.moe.route = self
        try:
            yield self
        finally:
            self.moe.route = self.real


def serving_cross_check(params, cfg, prompts) -> dict:
    """The kernel path against the plain path (``attention_impl="einsum"``)
    at full width and 2 layers.  An MoE model is compared twice: as is
    (gated in f32, reported in bf16) and with the plain path replaying the
    kernel path's routing (gated; :class:`ForcedRouting`)."""
    import dataclasses

    import torch

    from repro_torch.models import transformer

    two = {**params, "layers": params["layers"][:2]}
    toks = torch.as_tensor(prompts[:SERVE_SLOTS], dtype=torch.int32,
                           device=params["ln_f"].device)
    out = {}
    for dtype, tol in CROSS_DTYPES:
        p = two if dtype == "bfloat16" else _float_tree(two)
        paths = []
        for impl in ("auto", "einsum"):
            c = dataclasses.replace(cfg, num_layers=2, dtype=dtype,
                                    attention_impl=impl)
            paths.append((
                lambda c=c: transformer.prefill(p, toks, c, SERVE_MAX_LEN),
                lambda t, cache, c=c: transformer.decode_step(p, t, c,
                                                              cache)))
        if not cfg.num_experts:
            out[dtype] = compare_paths(f"serving cross-check [{dtype}]",
                                       *paths, cfg.vocab_size, dtype, tol)
            continue
        # Each path's own routing: gated in f32 (1e-4, equal tokens); in
        # bf16 reported only, since near-ties in the router flip experts
        # between any two attention paths (the reference's own included:
        # tests/test_torch_moe.py) and the gate is the forced run below.
        gated = dtype == "float32"
        free = compare_paths(
            f"moe cross-check [{dtype}], own routing"
            + ("" if gated else " (not gated)"), *paths, cfg.vocab_size,
            dtype, tol if gated else float("inf"), gate_tokens=gated)
        with ForcedRouting().installed() as fr:
            forced = compare_paths(
                f"moe cross-check [{dtype}], kernel path's routing",
                *[(fr.path(a, rec), fr.path(b, rec))
                  for (a, b), rec in zip(paths, (True, False))],
                cfg.vocab_size, dtype, tol)
        log(f"moe cross-check [{dtype}]: the plain path's own routing "
            f"differed in {fr.flips} of {fr.pairs} (token, expert) pairs")
        out[dtype] = {"forced": forced, "own_routing": free,
                      "flipped_pairs": fr.flips, "pairs": fr.pairs}
    return out


# --------------------------------------------------------------------------
# phase 3b: the rest of the federated main path (recycled buffers, top-k
# compression, the checkpointer, the quickstart example)

class TopKTransform:
    """``--compress`` on the columnar plane: each cohort chunk's buffer is
    top-k compressed (30 %) with its error-feedback memory kept per chunk;
    a row ships its nonzeros as (value, index) pairs.  Every chunk is also
    compressed on the CPU from the same rows with a CPU memory: kept
    values, residuals and nonzero counts must be the card's bit for bit,
    and ``cpu_bytes`` sums the wire bytes the CPU gives."""

    def __init__(self, fraction: float = 0.3):
        self.fraction = fraction
        self.memory: dict = {}
        self.cpu_memory: dict = {}
        self.cpu_bytes = 0

    def __call__(self, e):
        import numpy as np
        import torch

        from repro_torch.core import ArrivalBatch, UpdateBuffer
        from repro_torch.optim.compression import topk_compress_rows

        if not (isinstance(e, ArrivalBatch) and e.buffer is not None):
            return e
        leaves = e.buffer.leaves2d
        rows = torch.as_tensor(e.rows, device=leaves[0].device)
        stacked = {k: leaf.index_select(0, rows).reshape((e.n,) + shape)
                   for k, leaf, shape in zip(e.buffer.keys, leaves,
                                             e.buffer.shapes)}
        key = int(e.device_ids[0])
        kept, self.memory[key], nnz = topk_compress_rows(
            stacked, self.memory.get(key), fraction=self.fraction)
        cpu_kept, self.cpu_memory[key], cpu_nnz = topk_compress_rows(
            {k: v.cpu() for k, v in stacked.items()},
            self.cpu_memory.get(key), fraction=self.fraction)
        if not (np.array_equal(nnz, cpu_nnz)
                and all(torch.equal(kept[k].cpu(), cpu_kept[k])
                        for k in kept)
                and all(torch.equal(a.cpu(), b) for a, b in
                        zip(self.memory[key], self.cpu_memory[key]))):
            raise AssertionError(f"top-k of chunk {key} differs between "
                                 "the card and the CPU")
        self.cpu_bytes += int(np.maximum(cpu_nnz, 1).sum()) * 8
        return ArrivalBatch(e.task_id, e.round_idx, rows=np.arange(e.n),
                            created_t=e.created_t,
                            nbytes=np.maximum(nnz, 1) * 8,
                            num_samples=e.num_samples,
                            device_ids=e.device_ids,
                            buffer=UpdateBuffer.from_stacked(kept))


def _masked(line: str) -> str:
    """A quickstart line with its accuracies masked (compared apart) and
    its task ids (a process-wide counter, so the CPU run's differ)."""
    import re

    line = re.sub(r"^task [0-9]+:", "task #:", line)
    return re.sub(r"(test_acc=|run above: )[0-9.]+", r"\1#", line)


def start_audit() -> None:
    """Zeroes every launch count of the federated paths' kernels and starts
    each wrapper's record of the shapes it launches at: called just before
    a path runs."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.fed_reduce.ops import fed_reduce
    from repro_torch.kernels.flash_attention.ops import flash_attention

    fed_reduce.launches = decode_attention.launches = 0
    flash_attention.launches = flash_attention.wgmma_launches = 0
    for w in (fed_reduce, decode_attention, flash_attention):
        w.shapes = set()


def read_audit() -> dict:
    """The counts and shapes since :func:`start_audit`, read just after the
    path ran; the shape records stop."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.fed_reduce.ops import fed_reduce
    from repro_torch.kernels.flash_attention.ops import flash_attention

    out = {"fed_reduce": fed_reduce.launches,
           "decode_attention": decode_attention.launches,
           "flash_attention": flash_attention.launches,
           "flash_attention_wgmma": flash_attention.wgmma_launches,
           "shapes": {w.__name__: w.shapes for w in (
               fed_reduce, decode_attention, flash_attention)}}
    for w in (fed_reduce, decode_attention, flash_attention):
        w.shapes = None
    return out


def check_launched_shapes(dev, shapes: dict, checked: set) -> dict:
    """Holds each kernel against its plain version at every shape a path
    launched it at that no earlier case checked (seeded inputs, the checks
    of :func:`fed_reduce_case`, :func:`decode_cases` and
    :func:`flash_cases`), and adds those shapes to ``checked``.  These
    launches come after the path's counts were read.  Returns each
    kernel's max abs error over the new cases (0.0 where none was new)."""
    import torch

    errs = dict.fromkeys(("fed_reduce", "decode_attention",
                          "flash_attention"), 0.0)
    gen = torch.Generator().manual_seed(3)
    for n, d, dt in sorted(shapes["fed_reduce"] - checked):
        row, _ = fed_reduce_case(dev, gen, n, d, getattr(torch, dt))
        checked.add((n, d, dt))
        errs["fed_reduce"] = max(errs["fed_reduce"], row["max_abs_err"])
        log(json.dumps({"fed_reduce_case": row, "launched_by": "path"}))
    keys = {"decode_attention": {("decode", x[:5], x[5])
                                 for x in shapes["decode_attention"]},
            "flash_attention": {("flash", x[:8], x[8])
                                for x in shapes["flash_attention"]}}
    for name, run in (("decode_attention", decode_cases),
                      ("flash_attention", flash_cases)):
        new = sorted({case for _, case, _ in keys[name] - checked})
        if new:
            entry, got = run(dev, new)
            checked |= got
            errs[name] = entry["max_abs_err"]
    left = (shapes["fed_reduce"] | keys["decode_attention"]
            | keys["flash_attention"]) - checked
    if left:
        raise AssertionError(f"launched shapes left unchecked: {left}")
    return errs


def main_path_phase(dev, n_devices: int, rounds: int, checked: set,
                    slice_res: dict, cross_devices: int, card: str) -> dict:
    """Recycled rounds, a top-k compressed round, a checkpoint round trip
    and the quickstart example on the card.  Returns the launches of each
    path, each read just after it ran, and the max abs errors of the
    kernels at the shapes these paths launched them at."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.avazu_lr import CONFIG
    from repro_torch.examples import quickstart

    launches, errs = {}, {}

    def audited(name: str, run):
        start_audit()  # counts zeroed just before the path ...
        result = run()
        launches[name] = read_audit()  # ... and read just after
        for k, e in check_launched_shapes(
                dev, launches[name].pop("shapes"), checked).items():
            errs[k] = max(errs.get(k, 0.0), e)
        return result

    # Recycled update buffers: the f32 rounds of phase 2 again, each
    # device-tier chunk's cast back to f32 written into the previous
    # round's buffer of its (tier, rows) key.  The params must equal phase
    # 2's bitwise, every round must keep the same storage, and every round
    # after the first must ask the allocator for at least those buffers'
    # bytes fewer than phase 2's.  Phase 2's last outputs are dropped
    # first, so that both runs' peaks see the same live memory.
    for w in slice_res["wires"].values():
        for k in ("outcome", "svc", "audit"):
            w.pop(k, None)
    rec = audited("recycled", lambda: run_slice(
        dev, n_devices, dim=CONFIG.dim, cohort=COHORT, rounds=rounds,
        wires=("f32",), verbose=False, recycle=True))
    got, want = rec["wires"]["f32"], slice_res["wires"]["f32"]
    audit = got["audit"]
    same = (all(np.array_equal(a[k], b[k]) for a, b in
                zip(got["params"], want["params"]) for k in a)
            and all(np.array_equal(a, b) for a, b in
                    zip(got["arrivals"], want["arrivals"]))
            and (got["aggregations"], got["bytes"]) == (
                want["aggregations"], want["bytes"]))
    n_fed = launches["recycled"]["fed_reduce"]
    log(f"recycled rounds [f32] {n_devices} devices x {rounds}: params, "
        f"arrivals and bytes bitwise equal to phase 2's {same}; fed_reduce "
        f"launches {n_fed} (expected {audit.expected})")
    if not same:
        raise AssertionError("recycled rounds differ from fresh rounds")
    if n_fed != audit.expected or audit.expected <= 0:
        raise AssertionError("recycled rounds' fed_reduce launches")
    if not audit.shapes <= checked:
        raise AssertionError(f"recycled rounds reduced unchecked shapes "
                             f"{sorted(audit.shapes - checked)}")
    device_rows = [e.num_physical + e.num_benchmarking
                   for e in rec["plan"].entries]
    chunks = sum(math.ceil(n / COHORT) for n in device_rows)
    buffers = sum(device_rows) * (CONFIG.dim + 1) * 4
    memory = [{"round": r, "fresh": f, "recycled": g,
               "saved_requested_bytes": (f["requested_bytes"]
                                         - g["requested_bytes"])}
              for r, (f, g) in enumerate(zip(want["memory"], got["memory"]))]
    kept = got["kept"]
    log(json.dumps({"recycled_memory": {
        "device_tier_buffer_bytes": buffers, "rounds": memory,
        "same_storage_every_round": all(k == kept[0] for k in kept),
        "kept_leaves": len(kept[0]), "card": card}}))
    if not (len(kept[0]) == 2 * chunks and all(k == kept[0] for k in kept)):
        raise AssertionError(f"recycled rounds kept {len(kept[0])} leaves "
                             f"(expected {2 * chunks}) or moved them")
    if not all(m["saved_requested_bytes"] >= buffers for m in memory[1:]):
        raise AssertionError(f"recycled rounds did not write into the "
                             f"retired buffers ({buffers} bytes a round)")

    # Checkpointer: the recycled run's global params and a live update
    # buffer, saved and restored on the card, bitwise.
    ck_dir = os.path.join(ROOT, "build", "smoke_checkpoint")
    shutil.rmtree(ck_dir, ignore_errors=True)
    try:
        ck = Checkpointer(ck_dir, keep=2)
        buf = next(b.buffer for b in got["outcome"].batches
                   if b.buffer is not None)
        state = {"params": got["svc"].global_params, "buffer": buf}
        ck.save(1, state, extra={"round": rounds})
        ck.save_async(2, state)
        ck.wait()
        want_buf = buf.materialize()
        like = {"params": {k: torch.empty_like(v) for k, v in
                           got["svc"].global_params.items()},
                "buffer": {k: torch.empty_like(v, device=dev)
                           for k, v in want_buf.items()}}
        restored, extra = ck.restore(like)
        ok = (ck.latest_step() == 2 and extra == {}
              and all(torch.equal(restored["params"][k], v)
                      for k, v in got["svc"].global_params.items())
              and all(restored["buffer"][k].device.type == dev.type
                      and torch.equal(restored["buffer"][k].cpu(), v)
                      for k, v in want_buf.items())
              and ck.restore(like, step=1)[1] == {"round": rounds})
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    log(f"checkpoint: global params and a live {buf} saved, restored on "
        f"the card bitwise {ok}")
    if not ok:
        raise AssertionError("checkpoint round trip is not bitwise")

    # Top-k compression as the payload transform: every chunk's top-k on
    # the card against the CPU's on the same rows (bitwise), and the round's
    # wire bytes against the CPU's.  (A whole CPU round would not do: its
    # training arithmetic differs in the last bits, and magnitudes that tie
    # or nearly tie at the threshold then keep other entries.)
    transforms = []

    def make():
        transforms.append(TopKTransform())
        return transforms[-1]
    run = audited("topk", lambda: run_slice(
        dev, cross_devices, dim=CONFIG.dim, cohort=512, rounds=2,
        wires=("f32",), verbose=False, bench=0,
        transform=make))["wires"]["f32"]
    n_fed = launches["topk"]["fed_reduce"]
    tk = transforms[0]
    dense = cross_devices * 2 * (CONFIG.dim + 1) * 4
    log(f"top-k payload transform [{cross_devices} devices x 2]: wire "
        f"bytes {run['bytes']} = CPU's {tk.cpu_bytes} (dense {dense}), "
        f"every chunk's kept values, residuals and counts equal to the "
        f"CPU's; {run['dispatched']} messages, {run['aggregations']} "
        f"aggregations; fed_reduce launches {n_fed} (expected "
        f"{run['audit'].expected}) at shapes {sorted(run['audit'].shapes)}")
    if run["bytes"] != tk.cpu_bytes or not 0 < run["bytes"] < dense:
        raise AssertionError(f"top-k round: wire bytes {run['bytes']}, "
                             f"CPU's {tk.cpu_bytes}")
    if n_fed != run["audit"].expected:
        raise AssertionError("top-k round's fed_reduce launches")
    if not run["audit"].shapes <= checked:
        raise AssertionError(f"top-k rounds reduced unchecked shapes "
                             f"{sorted(run['audit'].shapes - checked)}")

    # The quickstart example (sections 1-5, 8, 9, 10) on the card against
    # its CPU run.
    def timed_quickstart():
        t0 = time.perf_counter()
        out = quickstart.run(dev)
        return out, time.perf_counter() - t0
    card_run, wall = audited("quickstart", timed_quickstart)
    qs = launches["quickstart"]
    with contextlib.redirect_stdout(io.StringIO()):  # its lines: above
        cpu_run = quickstart.run("cpu")
    same_lines = ([_masked(x) for x in card_run["lines"]]
                  == [_masked(x) for x in cpu_run["lines"]])
    acc_diff = max(abs(a - b) for a, b in zip(
        card_run["test_acc"] + [card_run["test_acc_int8"]],
        cpu_run["test_acc"] + [cpu_run["test_acc_int8"]]))
    log(f"quickstart on the card in {wall:.1f}s: allocation and "
        f"virtual-time lines equal to the CPU run's {same_lines}, test_acc "
        f"within {acc_diff:.2e} (tol 1e-4), tokens identical "
        f"{card_run['token_identical']}; launches fed_reduce "
        f"{qs['fed_reduce']}, decode_attention {qs['decode_attention']}, "
        f"flash_attention {qs['flash_attention']}")
    if not (same_lines and acc_diff <= 1e-4 and card_run["token_identical"]
            and min(qs["fed_reduce"], qs["decode_attention"],
                    qs["flash_attention"]) > 0):
        raise AssertionError("the quickstart on the card differs from its "
                             "CPU run")
    log(json.dumps({"main_path": {"launches": launches,
                                  "max_abs_err_at_launched_shapes": errs,
                                  "card": card}}))
    return {"launches": launches, "max_abs_err": errs}


# --------------------------------------------------------------------------
# phase 13: scheduled rounds (TaskEngine over real rounds, snapshot, resume)

TASKS_13 = ((0, 0), (1, 0), (2, 5))  # (task_id, priority)
ROUNDS_13 = 2
ARRIVAL_13 = 1.0  # the priority-5 task arrives inside round 0


class LossRecorder:
    """Delivery sink behind a task's ``LaunchAudit``: the test loss after
    each of the task's aggregations."""

    def __init__(self, audit, test_x, test_y):
        self.audit, self.test_x, self.test_y = audit, test_x, test_y
        self.losses: list[float] = []

    def __call__(self, d):
        from repro_torch.models import ctr

        svc = self.audit.svc
        before = len(svc.history)
        self.audit(d)
        if len(svc.history) > before:
            self.losses.append(float(ctr.bce_loss(
                svc.global_params, self.test_x, self.test_y)))


class ScheduledWorld:
    """Three federated tasks over the slice's plan contending for one pool:
    a preemptive, elastic ``TaskEngine`` on DeviceFlow's clock drives real
    ``run_plan_round`` calls of one streaming ``HybridSimulation``; each
    task aggregates in its own streaming ``AggregationService`` behind a
    task router (the reference's ``launch/train.py --tasks``).  The two
    priority-0 tasks together freeze the whole pool; the priority-5 task
    arrives inside round 0 and preempts one of them."""

    def __init__(self, device, n_devices: int, *, dim: int, cohort: int,
                 bench: int, data=None):
        import torch

        from repro_torch.configs.avazu_lr import CONFIG
        from repro_torch.core import (AccumulatedStrategy, AggregationService,
                                      ClientCountTrigger, DeviceFlow,
                                      ResourceManager, ResourcePool,
                                      TaskEngine)
        from repro_torch.core.devicemodel import GRADES
        from repro_torch.core.simulation import (DeviceTier, HybridSimulation,
                                                 LogicalTier)
        from repro_torch.core.task import OperatorFlow, Task
        from repro_torch.data.synthetic_ctr import make_federated_ctr
        from repro_torch.models import ctr

        self.dev = torch.device(device)
        self.n_devices = n_devices
        self.specs = grade_specs(n_devices, bench)
        self.cal, _, _ = calibrated_plan(self.specs)
        self.data = data or grade_data(self.specs, dim, self.dev)
        test = make_federated_ctr(num_devices=64, dim=dim, seed=9)
        test_x = torch.from_numpy(test.features).to(self.dev)
        test_y = torch.from_numpy(test.labels).to(self.dev)
        self.tasks = [Task(OperatorFlow(("train",)), tuple(self.specs),
                           rounds=ROUNDS_13, priority=prio, task_id=tid)
                      for tid, prio in TASKS_13]
        self.svcs, self.audits, self.sinks = {}, {}, {}
        for t in self.tasks:
            svc = AggregationService(ctr.lr_init(dim, device=self.dev),
                                     trigger=ClientCountTrigger(n_devices),
                                     streaming=True)
            self.svcs[t.task_id] = svc
            self.audits[t.task_id] = LaunchAudit(svc, n_leaves=2)
            self.sinks[t.task_id] = LossRecorder(self.audits[t.task_id],
                                                 test_x, test_y)
        self.flow = DeviceFlow(lambda d: self.sinks[d.task_id](d))
        for t in self.tasks:
            self.flow.register_task(t.task_id,
                                    AccumulatedStrategy(thresholds=(1,)))
        local = ctr.make_local_train_fn(lr=CONFIG.lr,
                                        epochs=CONFIG.local_epochs)
        self.sim = HybridSimulation(
            LogicalTier(local, cohort_size=cohort, device=self.dev),
            tiers={g: DeviceTier(local, GRADES[g], cohort_size=cohort,
                                 device=self.dev) for g in ("High", "Low")},
            deviceflow=self.flow, stream_chunks=True)
        demand = self.tasks[0].demand()
        self.rm = ResourceManager(ResourcePool(
            {g: 2 * b for g, (b, _) in demand.items()},
            {g: 2 * p for g, (_, p) in demand.items()}))
        self.engine = TaskEngine(self.rm, self.cal,
                                 round_runner=self.round_runner,
                                 clock=self.flow.clock, elastic=True,
                                 preemptive=True)
        self.walls: list[float] = []
        self.measured_s = 0.0  # sum of round durations: the serial estimate

    def round_runner(self, task, round_idx, allocation, now):
        import torch

        from repro_torch.core import RoundPlan

        svc = self.svcs[task.task_id]
        batches, counts = self.data
        t0 = time.perf_counter()
        out = self.sim.run_plan_round(
            task.task_id, round_idx, svc.global_params,
            RoundPlan.from_allocation(allocation, task.grades), batches,
            counts, torch.Generator().manual_seed(1000 * task.task_id
                                                  + round_idx),
            calibrator=self.cal)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.walls.append(time.perf_counter() - t0)
        self.measured_s += out.makespan_s
        return out.makespan_s

    def submit(self) -> None:
        for t in self.tasks:
            self.engine.submit(t, at=ARRIVAL_13 if t.priority else None)

    def mid_preemption(self) -> bool:
        ex = self.engine.executions
        hi = ex.get(TASKS_13[-1][0])
        return (hi is not None and hi.state.value == "running"
                and any(e.state.value == "paused" for e in ex.values()))

    def timeline(self) -> dict:
        return {"tasks": {tid: {
            "started_t": ex.started_t, "finished_t": ex.finished_t,
            "rounds_done": ex.rounds_done, "preemptions": ex.preemptions,
            "reallocations": ex.reallocations,
            "preemption_decisions": [dict(d)
                                     for d in ex.preemption_decisions],
            "queueing_delay_s": ex.queueing_delay_s}
            for tid, ex in sorted(self.engine.executions.items())},
            "makespan": self.engine.makespan}

    def params(self) -> dict:
        return {tid: {k: v.detach().clone() for k, v in
                      svc.global_params.items()}
                for tid, svc in self.svcs.items()}

    def snapshot(self, ck) -> None:
        state = self.engine.state_dict(deviceflow=self.flow,
                                       fleets=self.sim.fleets,
                                       services=self.svcs)
        ck.save(1, {"params": {str(t): svc.global_params
                               for t, svc in self.svcs.items()}},
                runtime_state=state,
                extra={"calibrator": self.cal.state_dict()})

    def restore(self, ck) -> None:
        tree, extra = ck.restore({"params": {
            str(t): svc.global_params for t, svc in self.svcs.items()}})
        for t, svc in self.svcs.items():
            svc.global_params = tree["params"][str(t)]
        self.cal.load_state_dict(extra["calibrator"])
        self.engine.load_state_dict(
            ck.restore_runtime_state(), tasks=self.tasks,
            deviceflow=self.flow, fleets=self.sim.fleets,
            services=self.svcs)


def scheduled_phase(dev, n_devices: int, cross_devices: int, checked: set,
                    bench: int, card: str) -> dict:
    """Phase 13: the scheduled world uninterrupted, then snapshotted
    mid-preemption through the checkpointer and resumed in a fresh world;
    then the same schedule at ``cross_devices`` on the card and the CPU.
    Returns the main path's ``fed_reduce`` launches and the max abs error
    at the shapes it launched at."""
    import shutil

    import torch

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.avazu_lr import CONFIG

    kw = dict(dim=CONFIG.dim, cohort=COHORT, bench=bench)
    t_phase = time.perf_counter()
    start_audit()  # counts zeroed just before the main path ...
    world = ScheduledWorld(dev, n_devices, **kw)
    world.submit()
    result = world.engine.drain()
    audit = read_audit()  # ... and read just after it
    launches = audit["fed_reduce"]
    expected = sum(a.expected for a in world.audits.values())
    errs = check_launched_shapes(dev, audit["shapes"], checked)
    tl = world.timeline()
    params = world.params()
    reduced = set().union(*(a.shapes for a in world.audits.values()))
    log(f"scheduled rounds [{n_devices} devices, {len(world.tasks)} tasks x "
        f"{ROUNDS_13}]: {len(world.walls)} rounds, wall s per round "
        f"{[round(w, 3) for w in world.walls]}; fed_reduce launches "
        f"{launches} (expected {expected}) at shapes {sorted(reduced)}")
    if len(result) != len(world.tasks) or result.stranded:
        raise AssertionError(f"the schedule stranded tasks: {result}")
    if launches <= 0 or launches != expected:
        raise AssertionError(f"scheduled rounds launched fed_reduce "
                             f"{launches} times, expected {expected}")
    victims = [t for t, v in tl["tasks"].items() if v["preemptions"] >= 1]
    if not victims:
        raise AssertionError(f"no task was preempted: {tl}")
    for tid, sink in world.sinks.items():
        losses = [math.log(2.0)] + sink.losses
        if len(sink.losses) != ROUNDS_13 or not all(
                b < a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"task {tid}'s test loss did not fall "
                                 f"every aggregation: {losses}")
    hi = tl["tasks"][TASKS_13[-1][0]]
    log(json.dumps({"scheduled_timeline": tl, "card": card}))
    log(f"interleaved makespan {tl['makespan']:.1f}s against the serial "
        f"estimate {world.measured_s:.1f}s; the priority-5 task queued "
        f"{hi['queueing_delay_s']:.1f}s; victims {victims}")
    walls, serial_s = list(world.walls), world.measured_s
    data = world.data
    del world, result

    # Snapshot mid-preemption (victim paused, preemptor admitted) through
    # the checkpointer, restore into a fresh world and run to the end.
    ck_dir = os.path.join(ROOT, "build", "smoke_schedule")
    shutil.rmtree(ck_dir, ignore_errors=True)
    try:
        first = ScheduledWorld(dev, n_devices, data=data, **kw)
        first.submit()
        while not first.mid_preemption():
            if not first.engine.clock.run_one():
                raise AssertionError("the schedule never preempted")
        ck = Checkpointer(ck_dir)
        first.snapshot(ck)
        rounds_before = len(first.walls)
        del first
        second = ScheduledWorld(dev, n_devices, data=data, **kw)
        second.restore(ck)
        second.engine.run_until()
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    same_tl = second.timeline() == tl
    got = second.params()
    same_params = all(torch.equal(got[t][k], params[t][k])
                      for t in params for k in params[t])
    log(f"schedule snapshotted mid-preemption after {rounds_before} rounds "
        f"and resumed for {len(second.walls)}: timeline equal to the "
        f"uninterrupted run's {same_tl}, every task's params bitwise equal "
        f"{same_params}")
    if not (same_tl and same_params):
        raise AssertionError(f"the resumed schedule differs: "
                             f"{second.timeline()} vs {tl}")
    del second, data
    torch.cuda.empty_cache()

    # The same schedule at cross_devices on the card and on the CPU.
    small = {}
    for d in (dev, torch.device("cpu")):
        w = ScheduledWorld(d, cross_devices, dim=CONFIG.dim, cohort=512,
                           bench=bench)
        w.submit()
        w.engine.drain()
        small[d.type] = (w.timeline(), {
            t: {k: v.cpu() for k, v in p.items()}
            for t, p in w.params().items()})
    (g_tl, g_p), (c_tl, c_p) = small["cuda"], small["cpu"]
    diff = max(float((g_p[t][k] - c_p[t][k]).abs().max())
               for t in g_p for k in g_p[t])
    log(f"scheduled rounds [{cross_devices} devices]: card vs CPU timeline "
        f"equal {g_tl == c_tl}, max param diff {diff:.3e} (tol 1e-6)")
    if g_tl != c_tl or not diff <= 1e-6:
        raise AssertionError(f"the scheduled rounds on the card differ from "
                             f"the CPU's: {g_tl} vs {c_tl}, {diff}")
    seconds = time.perf_counter() - t_phase
    log(json.dumps({"scheduled": {
        "devices": n_devices, "rounds": len(walls),
        "wall_s_per_round": walls, "makespan_s": tl["makespan"],
        "serial_estimate_s": serial_s,
        "priority5_queueing_delay_s": hi["queueing_delay_s"],
        "fed_reduce_launches": launches, "phase_s": seconds,
        "card": card}}))
    return {"launches": launches, "max_abs_err": errs["fed_reduce"]}


# --------------------------------------------------------------------------
# phase 14: pooled rounds (cohort chunks in worker processes on the card)

def smoke_tiers(device: str, cohort: int):
    """The slice's tiers, rebuilt inside each worker process (module level,
    so a spawned worker unpickles it by reference)."""
    from repro_torch.configs.avazu_lr import CONFIG
    from repro_torch.core.devicemodel import GRADES
    from repro_torch.core.simulation import DeviceTier, LogicalTier
    from repro_torch.models import ctr

    local = ctr.make_local_train_fn(lr=CONFIG.lr, epochs=CONFIG.local_epochs)
    return (LogicalTier(local, cohort_size=cohort, device=device),
            {g: DeviceTier(local, GRADES[g], cohort_size=cohort,
                           device=device) for g in ("High", "Low")})


def _shm_segments() -> set:
    return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}


def _same_rounds(got: dict, want: dict) -> dict:
    """Per-wire bitwise comparison of two ``run_slice`` results."""
    import numpy as np

    out = {}
    for wire, w in want.items():
        g = got[wire]
        out[wire] = {
            "params": all(np.array_equal(a[k], b[k]) for a, b in
                          zip(g["params"], w["params"]) for k in a),
            "groups": g["groups"] == w["groups"],
            "bytes": (g["bytes_received"], g["bytes"]) == (
                w["bytes_received"], w["bytes"]),
            "aggregations": g["aggregations"] == w["aggregations"],
            "arrivals": all(np.array_equal(a, b) for a, b in
                            zip(g["arrivals"], w["arrivals"]))}
    return out


def _slice_summary(res: dict) -> dict:
    """What phase 14 holds pooled rounds against, kept from a run."""
    return {wire: {"params": w["params"], "groups": w["audit"].groups,
                   "bytes_received": w["bytes_received"],
                   "bytes": w["bytes"], "aggregations": w["aggregations"],
                   "arrivals": w["arrivals"], "wall_ms": w["wall_ms"]}
            for wire, w in res["wires"].items()}


def pooled_phase(dev, n_devices: int, rounds: int, cross_devices: int,
                 bench: int, inline: dict, inline_launches: int,
                 card: str) -> dict:
    """Phase 14: phase 2's f32 and int8 rounds with the cohort chunks in two
    worker processes on the card, bitwise against phase 2's inline rounds;
    then a worker killed mid-round at ``cross_devices`` with three workers.
    Returns the main path's ``fed_reduce`` launches."""
    import shutil

    from repro_torch.configs.avazu_lr import CONFIG
    from repro_torch.kernels.fed_reduce.ops import fed_reduce
    from repro_torch.runtime.workers import FleetWorkerPool, WorkerSpec

    t_phase = time.perf_counter()
    df = subprocess.run(["df", "-h", "/dev/shm"], capture_output=True,
                        text=True).stdout.strip()
    log(f"/dev/shm:\n{df}")
    # The largest per-call input segment: one grade's params and batches
    # (x, y, mask), plus a round's result segments.
    specs = grade_specs(n_devices, bench)
    need = max(s.num_devices for s in specs) * RECORDS * (CONFIG.dim + 2) * 4
    need += n_devices * (CONFIG.dim + 1) * 4 * 2
    free = shutil.disk_usage("/dev/shm").free
    n_pool = n_devices
    if free < need:
        n_pool = int(n_devices * free / need * 0.8) // 1000 * 1000
        log(f"pooled rounds cut to {n_pool} devices: /dev/shm has {free} "
            f"bytes free, {n_devices} devices need {need}")
        if n_pool < cross_devices:
            raise AssertionError(f"/dev/shm holds too little ({free} bytes) "
                                 f"for pooled rounds")
        fed_reduce.launches = 0
        ref = run_slice(dev, n_pool, dim=CONFIG.dim, cohort=COHORT,
                        rounds=rounds, verbose=False, bench=bench)
        inline_launches = fed_reduce.launches
        inline = _slice_summary(ref)
        del ref
    shm_before = _shm_segments()
    spec = WorkerSpec(smoke_tiers, {"device": str(dev), "cohort": COHORT})
    pool = FleetWorkerPool(spec, 2, device=dev)
    # Host seconds the coordinator spends copying each call's params and
    # batches off the card into the input segment, and each result segment
    # back onto the card (the rest of a round is the workers' time).
    copy_s = {"input": 0.0, "results": 0.0}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                copy_s[name] += time.perf_counter() - t
        return run
    pool._write_input = timed("input", pool._write_input)
    pool._wrap_result = timed("results", pool._wrap_result)
    try:
        t0 = time.perf_counter()
        pool.start()
        spawn_s = time.perf_counter() - t0
        fed_reduce.launches = 0  # zeroed just before the main path ...
        res = run_slice(dev, n_pool, dim=CONFIG.dim, cohort=COHORT,
                        rounds=rounds, verbose=False, bench=bench, pool=pool)
        launches = fed_reduce.launches  # ... and read just after it
        stats = dict(pool.stats)
        workers = pool.worker_stats()
    finally:
        pool.close()
    got = _slice_summary(res)
    same = _same_rounds(got, inline)
    calls = stats["calls"]
    log(f"pooled rounds [{n_pool} devices, 2 workers, f32 and int8 x "
        f"{rounds}]: bitwise equal to the inline rounds {same}; fed_reduce "
        f"launches {launches} (inline {inline_launches}); spawn "
        f"{spawn_s:.1f}s; wall s per round "
        f"{ {w: [round(x / 1e3, 3) for x in v['wall_ms']] for w, v in got.items()} } "
        f"vs inline { {w: [round(x / 1e3, 3) for x in v['wall_ms']] for w, v in inline.items()} }")
    if not all(all(v.values()) for v in same.values()):
        raise AssertionError(f"pooled rounds differ from inline: {same}")
    if launches != inline_launches or launches <= 0:
        raise AssertionError(f"pooled rounds launched fed_reduce {launches} "
                             f"times, inline {inline_launches}")
    if not (stats["segment_reuses"] > 0
            and stats["segments_created"] <= stats["chunks"]):
        raise AssertionError(f"the segment ring did not recycle: {stats}")
    if not all(w["device"] == str(dev) for w in workers.values()):
        raise AssertionError(f"a worker computed off the card: {workers}")
    leaked = _shm_segments() - shm_before
    log(f"pool closed: {len(leaked)} shared-memory segments left behind")
    if leaked:
        raise AssertionError(f"segments left in /dev/shm: {sorted(leaked)}")

    # Worker death: three workers at cross_devices, worker 1 poisoned to
    # die after one chunk of round 1; the round completes bitwise.
    small_ref = _slice_summary(run_slice(
        dev, cross_devices, dim=CONFIG.dim, cohort=512, rounds=2,
        wires=("f32",), verbose=False, bench=bench))
    pool3 = FleetWorkerPool(WorkerSpec(smoke_tiers, {"device": str(dev),
                                                     "cohort": 512}), 3,
                            device=dev)

    def poison(sim, rnd):
        if rnd == 1:
            sim.pool.poison_worker(1, fail_after_chunks=1)
    try:
        died = _slice_summary(run_slice(
            dev, cross_devices, dim=CONFIG.dim, cohort=512, rounds=2,
            wires=("f32",), verbose=False, bench=bench, pool=pool3,
            on_round=poison))
        failures, alive = list(pool3.failures), pool3.alive_workers
        stats3 = dict(pool3.stats)
    finally:
        pool3.close()
    same3 = _same_rounds(died, small_ref)
    f = failures[0] if len(failures) == 1 else None
    log(f"worker death [{cross_devices} devices, 3 workers]: worker 1 died "
        f"in round 1; failures {failures}; survivors {alive}; round "
        f"bitwise equal to the inline run {same3}")
    if not (f is not None and f.worker_id == 1 and f.chunks
            and set(f.survivors) == set(alive) == {0, 2}
            and stats3["redispatched_chunks"] == len(f.chunks)
            and all(v for d in same3.values() for v in d.values())):
        raise AssertionError(f"worker death was not absorbed: {failures}, "
                             f"{same3}")
    leaked = _shm_segments() - shm_before
    if leaked:
        raise AssertionError(f"segments left in /dev/shm: {sorted(leaked)}")
    seconds = time.perf_counter() - t_phase
    log(json.dumps({"pooled": {
        "devices": n_pool, "workers": 2, "spawn_s": spawn_s,
        "wall_ms_per_round": {w: v["wall_ms"] for w, v in got.items()},
        "inline_wall_ms_per_round": {w: v["wall_ms"]
                                     for w, v in inline.items()},
        "bytes_shipped_per_round": stats["bytes_shipped"] / (2 * rounds),
        "input_bytes_per_round": stats["input_bytes"] / (2 * rounds),
        "coordinator_copy_s_per_round": {
            k: v / (2 * rounds) for k, v in copy_s.items()},
        "calls": calls, "chunks": stats["chunks"],
        "segments_created": stats["segments_created"],
        "segment_reuses": stats["segment_reuses"],
        "workers_stats": workers, "fed_reduce_launches": launches,
        "phase_s": seconds, "card": card}}))
    return {"launches": launches}


# --------------------------------------------------------------------------
# phase 11: the encoder-decoder model at seamless-m4t-medium width

def encdec_inputs(cfg, dev):
    """Seeded stub source frames ``(16, 256, d)`` (bf16) and decoder
    prompts ``(16, 64)``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SERVE_SEED)
    src = torch.from_numpy((rng.standard_normal(
        (SERVE_SLOTS, ENCDEC_FRAMES, cfg.d_model)) * 0.01).astype(
            np.float32)).to(torch.bfloat16).to(dev)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab_size,
                                        (SERVE_SLOTS, ENCDEC_PROMPT)),
                           dtype=torch.int32, device=dev)
    return src, toks


def encdec_phase(dev, checked: set, card: str) -> dict:
    """seamless-m4t-medium at full width: ``prefill`` (encoder, decoder
    prompt, cross K/V) then 64 greedy ``decode_step``s over 16 sequences."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import encdec

    cfg = get_config(ENCDEC_ARCH)
    if cfg.frontend_tokens != ENCDEC_FRAMES:
        raise AssertionError(f"{cfg.name} has {cfg.frontend_tokens} frames")
    t0 = time.perf_counter()
    params = encdec.init(torch.Generator(device=dev).manual_seed(SERVE_SEED),
                         cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name}: {n_params} params ({n_params * 2 / 1e9:.2f} GB bf16) "
        f"initialized on the card in {time.perf_counter() - t0:.1f}s")
    src, toks = encdec_inputs(cfg, dev)
    timer = WallTimer()
    prefill = timer.wrap("prefill", encdec.prefill)
    step = timer.wrap("decode", encdec.decode_step)

    def generate():
        logits, cache = prefill(params, src, toks, cfg, ENCDEC_MAX_LEN)
        out = [logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)]
        for _ in range(ENCDEC_DECODE):
            logits, cache = step(params, out[-1], cfg, cache)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError("seamless decode logits not finite")
            out.append(logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32))
        return torch.stack(out, dim=1)

    generate()  # warm-up: the timed run below is the main path
    timer.ms.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode_attention.launches = 0  # zeroed just before the main path ...
    flash_attention.launches = flash_attention.wgmma_launches = 0
    tokens = generate()
    torch.cuda.synchronize()
    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches,
                "flash_attention_wgmma":
                    flash_attention.wgmma_launches}  # ... read just after
    L, E = cfg.num_layers, cfg.num_encoder_layers
    # Per prefill: E encoder + L self + L cross flash calls; per decode
    # step: L self + L cross decode calls.
    expected = {"decode_attention": 2 * L * ENCDEC_DECODE,
                "flash_attention": E + 2 * L,
                "flash_attention_wgmma": E + 2 * L}
    if launches != expected:
        raise AssertionError(f"[{cfg.name}] launches {launches}, expected "
                             f"{expected}")
    # What the path gives the kernels: the encoder (bidirectional), the
    # decoder's self-attention (causal) and cross-attention (sq != sk) in
    # prefill; self and cross decode (every length = the frame count).
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    b, f, sp = SERVE_SLOTS, ENCDEC_FRAMES, ENCDEC_PROMPT
    shapes = {("flash", (b, f, f, *heads, False, 0), "bfloat16"),
              ("flash", (b, sp, sp, *heads, True, 0), "bfloat16"),
              ("flash", (b, sp, f, *heads, False, 0), "bfloat16"),
              ("decode", (b, ENCDEC_MAX_LEN, *heads), "bfloat16"),
              ("decode", (b, f, *heads), "bfloat16")}
    if not shapes <= checked:
        raise AssertionError(f"unchecked shapes {sorted(shapes - checked)}")
    if tokens.shape != (SERVE_SLOTS, ENCDEC_DECODE + 1) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError("seamless tokens out of range")
    peak = torch.cuda.max_memory_allocated()
    pre, dec = timer.ms["prefill"], timer.ms["decode"]
    res = {"arch": cfg.name, "sequences": SERVE_SLOTS,
           "source_frames": ENCDEC_FRAMES, "prompt": ENCDEC_PROMPT,
           "decode_steps": len(dec), "wall_ms_per_prefill": sum(pre) / len(pre),
           "wall_ms_per_decode_step": sum(dec) / len(dec),
           "decode_tokens_per_s": SERVE_SLOTS * len(dec) / (sum(dec) / 1e3),
           "peak_memory_gb": peak / 1e9, "launches": launches,
           "expected_launches": expected, "card": card}
    log(json.dumps({"encdec": res}))
    log(f"  {cfg.name}: {res['wall_ms_per_prefill']:.1f} ms/prefill, "
        f"{res['wall_ms_per_decode_step']:.2f} ms/decode step, "
        f"{res['decode_tokens_per_s']:.0f} decode tok/s, peak "
        f"{peak / 1e9:.2f} GB; launches {launches} = expected")
    cache = [None]

    def one_prefill():
        cache[0] = encdec.prefill(params, src, toks, cfg, ENCDEC_MAX_LEN)[1]

    def decode_steps(k=20):
        tok = toks[:, -1]
        c = cache[0]
        for _ in range(k):
            logits, c = encdec.decode_step(params, tok, cfg, c)
            tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    prof = {"prefill": profile_window(one_prefill, 1,
                                      match=("flash_fwd_wgmma",)),
            "decode_steps": profile_window(decode_steps, 20,
                                           match=("decode_kernel",))}
    log(json.dumps({"encdec_profile": prof, "card": card}))
    return {"params": params, "cfg": cfg, "launches": launches,
            "result": res, "profile": prof}


def encdec_cross_check(params, cfg) -> dict:
    """Phase 12: the kernel path against the plain path at full width with
    2 encoder and 2 decoder layers (bf16 2e-2, f32 1e-4 with equal
    tokens)."""
    import dataclasses

    from repro_torch.models import encdec

    two = {**params, "encoder": params["encoder"][:2],
           "decoder": params["decoder"][:2]}
    src, toks = encdec_inputs(cfg, params["ln_f"].device)
    out = {}
    for dtype, tol in CROSS_DTYPES:
        p = two if dtype == "bfloat16" else _float_tree(two)
        paths = []
        for impl in ("auto", "einsum"):
            c = dataclasses.replace(cfg, num_layers=2, num_encoder_layers=2,
                                    dtype=dtype, attention_impl=impl)
            paths.append((
                lambda c=c: encdec.prefill(p, src, toks, c, ENCDEC_MAX_LEN),
                lambda t, cache, c=c: encdec.decode_step(p, t, c, cache)))
        out[dtype] = compare_paths(f"encdec cross-check [{dtype}]", *paths,
                                   cfg.vocab_size, dtype, tol)
    return out


# --------------------------------------------------------------------------
# phase 7: the SSD scan kernel against its plain versions

SSM_ARCHS = ("mamba2_1_3b", "zamba2_1_2b")
# Phase 8 serves both at their published widths and 8 layers (of 48 and
# 38; zamba2 keeps two shared-block applications, at layers 0 and 6):
# their host-bound decode grows with depth, and the smoke's phases must
# fit its time limit on the slower hosts too.
SSM_SERVE_LAYERS = 8
# (b, l, h, p, g, n, chunk): tests/test_kernels.py's SSD_CASES (l.186), both
# serving shapes (16 prompts of 512 at mamba2-1.3b's and zamba2-1.2b's
# widths), a length that pads to the chunk, and decays that overflow above
# the diagonal (A = -64, dt = 0.1).
SSD_CASES = [(2, 128, 4, 32, 1, 16, 32), (1, 256, 8, 64, 2, 64, 64),
             (2, 64, 2, 16, 2, 8, 16), (1, 128, 4, 64, 1, 128, 128)]
SSD_MAMBA = (SERVE_SLOTS, SERVE_PROMPT, 64, 64, 1, 128, 128)
SSD_ZAMBA = (SERVE_SLOTS, SERVE_PROMPT, 64, 64, 1, 64, 128)
SSD_RAGGED = (2, 500, 64, 64, 1, 128, 128)
SSD_OVERFLOW = (2, 256, 8, 64, 1, 128, 128)
SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/ssd_scan.py:30"
SSD_KERNELS = {"tc": "ssd_scan_tc_kernel", "simt": "ssd_scan_kernel"}


def ssd_inputs(gen, case, dtype, dev, *, overflow: bool = False):
    """x, dt, A, B, C drawn as the reference's tests draw them (x, B and C
    in ``dtype``; dt and A f32, as the model passes them)."""
    import torch

    b, l, h, p, g, n, _ = case
    x = (torch.randn((b, l, h, p), generator=gen) * 0.5).to(dtype)
    if overflow:
        dt, A = torch.full((b, l, h), 0.1), torch.full((h,), -64.0)
    else:
        dt = torch.randn((b, l, h), generator=gen).abs() * 0.1 + 0.01
        A = -torch.randn(h, generator=gen).abs() - 0.1
    B = (torch.randn((b, l, g, n), generator=gen) * 0.3).to(dtype)
    C = (torch.randn((b, l, g, n), generator=gen) * 0.3).to(dtype)
    return [t.to(dev) for t in (x, dt, A, B, C)]


def ssd_cases(dev) -> tuple[dict, set]:
    """``ssd_scan`` on the card against its chunked plain version and the
    sequential oracle on the card: y and the state within 3e-4 absolute in
    f32 (tests/test_kernels.py:207), y within 2e-2 relative in bf16, no
    NaN, two launches bitwise equal.  The serving shapes are timed."""
    import torch

    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ops import kernel_for, ssd_scan
    from repro_torch.roofline import op_analysis as oa

    gen = torch.Generator().manual_seed(3)
    cases = [(c, False) for c in SSD_CASES + [SSD_MAMBA, SSD_ZAMBA,
                                               SSD_RAGGED]]
    cases.append((SSD_OVERFLOW, True))
    checked, errs, main_row = set(), [], None
    for case, overflow in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = ssd_inputs(gen, case, dtype, dev, overflow=overflow)
            q = case[-1]
            tc0 = ssd_scan.tc_launches
            y, s = ssd_scan(*args, chunk=q, impl="cuda")
            y2, s2 = ssd_scan(*args, chunk=q, impl="cuda")
            name = (f"ssd_scan{case}{' overflow' if overflow else ''} "
                    f"{_dtype_name(dtype)}")
            finite = bool(torch.isfinite(y.float()).all()
                          and torch.isfinite(s).all())
            if not finite:
                raise AssertionError(f"{name} gave a non-finite value")
            bitwise = bool(torch.equal(y, y2) and torch.equal(s, s2))
            if not bitwise:
                raise AssertionError(f"{name} is not repeatable")
            route = kernel_for(dtype, case[3], case[5], min(q, case[1]))
            if ssd_scan.tc_launches - tc0 != (2 if route == "tc" else 0):
                raise AssertionError(f"{name} should run on the {route} "
                                     f"kernel")
            row = {"case": list(case), "dtype": _dtype_name(dtype),
                   "kernel": SSD_KERNELS[route],
                   "overflow": overflow, "bitwise_repeatable": bitwise,
                   "finite": finite}
            for plain in ("chunked", "ref"):
                py, ps = ssd_scan(*args, chunk=q, impl=plain)
                torch.cuda.synchronize()
                ey = (y.float() - py.float()).abs()
                es = float((s - ps).abs().max())
                if dtype == torch.float32:
                    ok = float(ey.max()) <= 3e-4 and es <= 3e-4
                else:
                    ok = bool((ey <= 2e-2 * (1 + py.float().abs())).all()
                              and es <= 3e-4)
                if not ok:
                    raise AssertionError(
                        f"{name} disagrees with its {plain} version: y "
                        f"{float(ey.max()):.3e}, state {es:.3e}")
                row[f"max_abs_err_y_{plain}"] = float(ey.max())
                row[f"max_abs_err_state_{plain}"] = es
                errs += [float(ey.max()), es]
            checked.add(("ssd", case, _dtype_name(dtype)))
            if case in (SSD_MAMBA, SSD_ZAMBA) and dtype == torch.bfloat16:
                nbytes = sum(t.numel() * t.element_size() for t in args)
                n = _copies(nbytes)
                sets = [[t.clone() for t in args] for _ in range(n)]
                row["ms"] = time_ms(lambda i: ssd_scan(
                    *sets[i % n], chunk=q, impl="cuda"), iters=40)
                # The plain-FMA kernel (the previous design) on the same
                # inputs, for comparison in this call.
                row["simt_ms"] = time_ms(lambda i: ops._ssd_scan_cuda(
                    *sets[i % n], q, kernel="simt"), iters=10)
                row["plain_ms"] = time_ms(lambda i: ssd_scan(
                    *sets[i % n], chunk=q, impl="chunked"), iters=5)
                row["library_ms"] = None  # no PyTorch op computes the scan
                row.update(oa.bound(oa.ssd_scan_work(*case, 2), BF16_FLOPS))
                row["bound_share"] = row["bound_ms"] / row["ms"]
                if case == SSD_MAMBA:
                    main_row = row
                del sets
            log(json.dumps({"ssd_scan_case": row}))
    entry = _timed_entry("ssd_scan", SSD_SOURCE, SSD_REPLACES, errs,
                         main_row)
    entry["kernel"] = SSD_KERNELS["tc"]  # the main path's: bf16 serving
    return entry, checked


# --------------------------------------------------------------------------
# phase 8/9: fixed-batch serving of the SSM and hybrid models

def _ssm_shapes(cfg, batch: int) -> set:
    """(kernel, shape, dtype) of every launch a prefill of ``batch`` prompts
    and its decode steps give the kernels."""
    from repro_torch.models import hybrid

    q = min(cfg.ssm_chunk, SERVE_PROMPT)
    out = {("ssd", (batch, SERVE_PROMPT, cfg.ssm_heads, cfg.ssm_head_dim,
                    cfg.ssm_groups, cfg.ssm_state, q), cfg.dtype)}
    if cfg.family == "hybrid" and hybrid._attn_positions(cfg):
        out.add(("flash", (batch, SERVE_PROMPT, SERVE_PROMPT, cfg.num_heads,
                           cfg.num_kv_heads, cfg.head_dim, True, 0),
                 cfg.dtype))
        out.add(("decode", (batch, SERVE_MAX_LEN, cfg.num_heads,
                            cfg.num_kv_heads, cfg.head_dim), cfg.dtype))
    return out


def ssm_profile(api, cfg, params, prompts, card: str) -> dict:
    """Device idle share of fixed-batch serving: one prefill of 16 prompts,
    then 20 greedy decode steps, each window profiled; in those windows
    every counted ``ssd_scan`` tensor-core launch and ``decode_attention``
    call must be one kernel of its name."""
    import torch

    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    toks = torch.as_tensor(prompts[:SERVE_SLOTS], dtype=torch.int32,
                           device=params["ln_f"].device)
    state = {}

    def greedy(logits):
        return logits[:, : cfg.vocab_size].argmax(-1).to(torch.int32)

    # A window that lost records runs again (``profiled``), so each call
    # keeps its own launch count and decodes from the prefill's cache.
    def prefill():
        tc0 = ssd_scan.tc_launches
        logits, state["cache"] = api.prefill(params, toks, cfg,
                                             SERVE_MAX_LEN)
        state["tok"] = greedy(logits)
        state["tc"] = ssd_scan.tc_launches - tc0

    def decode():
        d0 = decode_attention.launches
        tok, cache = state["tok"], state["cache"]
        for _ in range(20):
            logits, cache = api.decode_step(params, tok, cfg, cache)
            tok = greedy(logits)
        state["dec"] = decode_attention.launches - d0
    # Each counted launch is one kernel of its name: the bf16 scans on the
    # tensor-core kernel, each decode_attention call one decode_kernel.
    out = {"prefill": profile_window(prefill, 1, ("ssd_scan_tc_kernel",)),
           "decode_steps": profile_window(decode, 20, ("decode_kernel",))}
    seen = {"ssd_scan_tc_kernel": (out["prefill"]["matched"][
                "ssd_scan_tc_kernel"], state["tc"]),
            "decode_kernel": (out["decode_steps"]["matched"][
                "decode_kernel"], state["dec"])}
    if any(k != c for k, c in seen.values()) or seen[
            "ssd_scan_tc_kernel"][1] != cfg.num_layers:
        raise AssertionError(f"[{cfg.name}] profiled kernels vs counted "
                             f"launches: {seen}")
    out["kernels_vs_launches"] = seen
    log(json.dumps({"ssm_serving_profile": out, "arch": cfg.name,
                    "card": card}))
    return out


def ssm_serving_phase(dev, arch: str, checked: set, card: str) -> dict:
    """``arch`` at full width and ``SSM_SERVE_LAYERS`` layers in bf16
    through ``BatchedServer(16)`` on the serving trace: the report equals
    the CPU run's, the launch counters
    read one ``ssd_scan`` per layer per prefill (and, for the hybrid, one
    ``flash_attention`` per shared-block application per prefill and one
    ``decode_attention`` per application per decode step) at shapes phases
    4 and 7 checked."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.causal_conv.ops import causal_conv
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models import hybrid
    from repro_torch.models.registry import get_model

    cfg = dataclasses.replace(get_config(arch), num_layers=SSM_SERVE_LAYERS)
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=dev).manual_seed(SERVE_SEED),
                      cfg, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"{cfg.name}: {n_params} params ({n_params * 2 / 1e9:.2f} GB bf16) "
        f"at {cfg.num_layers} layers, initialized on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    apps = len(hybrid._attn_positions(cfg)) if cfg.family == "hybrid" else 0
    cpu = fixed_cpu_report(arch).summary(30.0)
    timer = WallTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_scan.launches = ssd_scan.tc_launches = 0  # zeroed just before the
    decode_attention.launches = flash_attention.launches = 0  # main path ...
    flash_attention.wgmma_launches = causal_conv.launches = 0
    w0 = time.perf_counter()
    server = serve.BatchedServer(
        cfg, batch_size=SERVE_SLOTS, prompt_len=SERVE_PROMPT,
        decode_tokens=SERVE_DECODE, max_len=SERVE_MAX_LEN, params=params,
        device=dev)
    server.api = dataclasses.replace(
        server.api, prefill=timer.wrap("prefill", server.api.prefill),
        decode_step=timer.wrap("decode", server.api.decode_step))
    serve.run_trace(server, **_trace_kw(cfg))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - w0
    launches = {"ssd_scan": ssd_scan.launches,
                "ssd_scan_tc": ssd_scan.tc_launches,
                "flash_attention": flash_attention.launches,
                "flash_attention_wgmma": flash_attention.wgmma_launches,
                "decode_attention": decode_attention.launches,
                "causal_conv": causal_conv.launches}  # ... read
    rep = server.report()
    n_prefill = len(server.metrics)
    n_decode = n_prefill * SERVE_DECODE
    # Every bf16 prefill's scan runs on the tensor-core kernel, and each
    # layer's two convs on the conv kernel (decode keeps its own one-token
    # conv).
    expected = {"ssd_scan": cfg.num_layers * n_prefill,
                "ssd_scan_tc": cfg.num_layers * n_prefill,
                "flash_attention": apps * n_prefill,
                "flash_attention_wgmma": apps * n_prefill,
                "decode_attention": apps * n_decode,
                "causal_conv": 2 * cfg.num_layers * n_prefill}
    peak = torch.cuda.max_memory_allocated()
    s = rep.summary(30.0)
    if s != cpu:
        raise AssertionError(f"[{arch}] the card's virtual-time report {s} "
                             f"differs from the CPU run's {cpu}")
    if launches != expected or launches["ssd_scan"] <= 0:
        raise AssertionError(f"[{arch}] launches {launches}, expected "
                             f"{expected}")
    shapes = set().union(*(_ssm_shapes(cfg, m.batch_size)
                           for m in server.metrics))
    if not shapes <= checked:
        raise AssertionError(f"[{arch}] launched shapes the kernel phases "
                             f"did not check: {sorted(shapes - checked)}")
    toks = {r.request_id: r.tokens for r in rep.records}
    if len(rep.finished()) != SERVE_REQUESTS or any(
            len(t) != SERVE_DECODE + 1 for t in toks.values()):
        raise AssertionError(f"[{arch}] not every request finished")
    pre, dec = timer.ms["prefill"], timer.ms["decode"]
    tokens = sum(m.tokens_decoded for m in server.metrics)
    res = {"arch": cfg.name, "mode": "fixed", "report": s,
           "prefill_calls": n_prefill, "decode_iterations": n_decode,
           "wall_ms_per_prefill": sum(pre) / len(pre),
           "wall_ms_per_decode_iteration": sum(dec) / len(dec),
           "decode_tokens_per_s": tokens / (sum(dec) / 1e3),
           "peak_memory_gb": peak / 1e9, "wall_s": wall_s,
           "launches": launches, "expected_launches": expected,
           "params": n_params, "card": card}
    log(json.dumps({"ssm_serving": res}))
    log(f"  {cfg.name:12s} fixed p50={s['p50_latency_s'] * 1e3:.1f}ms "
        f"p99={s['p99_latency_s'] * 1e3:.1f}ms "
        f"goodput={s['goodput_rps']:.4f} req/s (= CPU run) | "
        f"{res['wall_ms_per_prefill']:.1f} ms/prefill, "
        f"{res['wall_ms_per_decode_iteration']:.2f} ms/decode iteration, "
        f"{res['decode_tokens_per_s']:.0f} decode tok/s, peak "
        f"{peak / 1e9:.2f} GB; launches {launches} = expected")
    prompts = np.random.default_rng(SERVE_SEED).integers(
        1, cfg.vocab_size, size=(SERVE_REQUESTS, SERVE_PROMPT))
    res["profile"] = ssm_profile(api, cfg, params, prompts, card)
    return {"params": params, "cfg": cfg, "prompts": prompts,
            "results": res, "launches": launches}


def ssm_plain_prefill(p, toks, cfg):
    """The plain path of a prefill, layer by layer: the model's own blocks
    with the chunked scan (``block_prefill(impl="chunked")``) and, for the
    hybrid, the shared block's plain attention (``cfg.attention_impl``)."""
    from repro_torch.models import hybrid, mamba2
    from repro_torch.models.layers import embed_apply, rmsnorm, unembed_apply

    x = embed_apply(p["embed"], toks)
    if cfg.family == "ssm":
        caches = []
        for lp in p["layers"]:
            x, c = mamba2.block_prefill(lp, x, cfg, impl="chunked")
            caches.append(c)
    else:
        positions = hybrid._positions(x)
        attn_at = set(hybrid._attn_positions(cfg))
        caches = {"mamba": [], "attn": []}
        for i, lp in enumerate(p["mamba_layers"]):
            if i in attn_at:
                x, ac = hybrid.attention_prefill(p["shared_attn"], x, cfg,
                                                 positions, SERVE_MAX_LEN)
                caches["attn"].append(ac)
            x, mc = mamba2.block_prefill(lp, x, cfg, impl="chunked")
            caches["mamba"].append(mc)
    x = rmsnorm(x, p["ln_f"], cfg.norm_eps)
    return unembed_apply(p["embed"], x[:, -1]), caches


def ssm_cross_check(params, cfg, prompts) -> dict:
    """The kernel path against the plain path at full width and 2 layers
    (zamba2: its shared block applied at layer 0).  The kernel path's
    prefill must launch one ``ssd_scan`` per layer, the plain path's
    none."""
    import dataclasses

    import torch

    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.models.registry import get_model

    api = get_model(cfg)
    layers = "layers" if cfg.family == "ssm" else "mamba_layers"
    two = {**params, layers: params[layers][:2]}
    toks = torch.as_tensor(prompts[:SERVE_SLOTS], dtype=torch.int32,
                           device=params["ln_f"].device)
    out, launched = {}, []

    def kernel_prefill(p, c):
        before = ssd_scan.launches
        res = api.prefill(p, toks, c, SERVE_MAX_LEN)
        launched.append(ssd_scan.launches - before)
        return res

    def plain_prefill(p, c):
        before = ssd_scan.launches
        res = ssm_plain_prefill(p, toks, c)
        launched.append(ssd_scan.launches - before)
        return res
    for dtype, tol in CROSS_DTYPES:
        p = two if dtype == "bfloat16" else _float_tree(two)
        cfg2 = dataclasses.replace(cfg, num_layers=2, dtype=dtype)
        cfg_plain = dataclasses.replace(cfg2, attention_impl="einsum")
        out[dtype] = compare_paths(
            f"ssm cross-check [{cfg.name} {dtype}]",
            (lambda: kernel_prefill(p, cfg2),
             lambda t, cache: api.decode_step(p, t, cfg2, cache)),
            (lambda: plain_prefill(p, cfg_plain),
             lambda t, cache: api.decode_step(p, t, cfg_plain, cache)),
            cfg.vocab_size, dtype, tol)
        if launched[-2:] != [2, 0]:
            raise AssertionError(f"[{cfg.name}] ssd_scan launches in the "
                                 f"kernel and plain prefills: {launched}")
    return out


def ssm_phases(dev, checked: set, card: str) -> dict:
    """Phases 8 and 9 for each SSM architecture; returns the launches read
    on each model's main path."""
    import torch

    out = {}
    for arch in SSM_ARCHS:
        t0 = time.perf_counter()
        srv = ssm_serving_phase(dev, arch, checked, card)
        passed(f"ssm serving phase [{arch}]", t0)
        t0 = time.perf_counter()
        ssm_cross_check(srv["params"], srv["cfg"], srv["prompts"])
        passed(f"ssm cross-check [{arch}]", t0)
        out[arch] = srv["launches"]
        del srv
        torch.cuda.empty_cache()
    return out


def family_phases(dev, checked: set, card: str) -> dict:
    """Phases 10-12: granite-moe-3b served on the trace and its cross-check,
    then seamless-m4t-medium and its cross-check; returns the launches read
    on each model's main path."""
    import torch

    t0 = time.perf_counter()
    srv = serving_phase(dev, checked, card, arch=MOE_ARCH, layers=MOE_LAYERS)
    passed("moe serving phase", t0)
    t0 = time.perf_counter()
    serving_cross_check(srv["params"], srv["cfg"], srv["prompts"])
    passed("moe cross-check", t0)
    out = {MOE_ARCH: srv["launches"]}
    del srv
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ed = encdec_phase(dev, checked, card)
    passed("encdec phase", t0)
    t0 = time.perf_counter()
    encdec_cross_check(ed["params"], ed["cfg"])
    passed("encdec cross-check", t0)
    out[ENCDEC_ARCH] = ed["launches"]
    del ed
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# phase 15: the flash backward against its plain version

TRAIN_ARCH = "llama3_2_3b"
SSM_TRAIN_ARCH = "mamba2_1_3b"  # phase 19
TRAIN_SEQ = 4096  # the reference's train_4k sequence
TRAIN_MICRO = 8  # one sequence per microbatch, 32 768 tokens a step
TRAIN_STEPS = 3  # timed, after one warm-up step
# (b, sq, sk, h, kv, d, causal, q_offset) and the dtypes it is checked in:
# llama's training shape, the same at 2 KV heads in f32, granite's and
# seamless's shapes, the smoke width (a federated chunk of 8 clients and a
# pretraining microbatch), a ragged key length and a query offset.
BWD_LLAMA = (1, TRAIN_SEQ, TRAIN_SEQ, 24, 8, 128, True, 0)
BWD_SMOKE = (8, 64, 64, 6, 2, 16, True, 0)
BWD_CASES = [
    (BWD_LLAMA, ("bfloat16",)),
    ((1, TRAIN_SEQ, TRAIN_SEQ, 6, 2, 128, True, 0), ("float32",)),
    (FLASH_GRANITE, ("bfloat16", "float32")),
    (FLASH_SEAMLESS_ENC, ("bfloat16", "float32")),
    (FLASH_SEAMLESS_X, ("bfloat16", "float32")),
    (BWD_SMOKE, ("float32", "bfloat16")),
    ((4, 128, 128, 6, 2, 16, True, 0), ("float32", "bfloat16")),
    ((1, 4000, 4000, 24, 8, 128, True, 0), ("bfloat16",)),
    ((2, 96, 200, 6, 2, 64, True, 104), ("float32", "bfloat16")),
]
TIMED_BWD = (BWD_LLAMA, BWD_SMOKE)
BWD_REPLACES = "src/repro/kernels/flash_attention/ref.py:49"


def _randn(gen, shape, dtype, dev):
    import torch

    return torch.randn(shape, generator=gen).to(getattr(torch, dtype)).to(dev)


def bwd_case(dev, gen, case, dtype: str) -> tuple[dict, tuple]:
    """The forward kernel with its log-sum-exp at ``case`` against
    ``attention_fwd_lse``, then the backward kernels against
    ``attention_bwd_ref`` on the card, from the forward kernel's own o and
    log-sum-exp; two backward calls must give the same bits."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    b, sq, sk, h, kv, d, causal, off = case
    q, do = (_randn(gen, (b, sq, h, d), dtype, dev) for _ in range(2))
    k, v = (_randn(gen, (b, sk, kv, d), dtype, dev) for _ in range(2))
    scale = d ** -0.5
    o, lse = ops._flash_attention_cuda(q, k, v, causal, off, scale,
                                       with_lse=True)
    route = ops.kernel_for_bwd(q.dtype, d)
    runs = {route: [ops._flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal, off, scale) for _ in range(2)]}
    plain = ops.attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                  q_offset=off)
    plain_o, plain_lse = ops.attention_fwd_lse(q, k, v, causal=causal,
                                               q_offset=off)
    torch.cuda.synchronize()
    fwd_err = _check_close(f"flash_attention{case} {dtype} o (with lse)", o,
                           plain_o, q.dtype)
    name = f"flash_attention_bwd{case} {dtype}"
    lse_err = float((lse - plain_lse).abs().max())
    if lse_err > 1e-3:
        raise AssertionError(f"{name}: lse off by {lse_err:.3e}")
    errs = {}
    for kern, (got, again) in runs.items():
        errs[kern] = max(_check_close(f"{name} {kern} {g}", a, p, q.dtype)
                         for g, a, p in zip(("dq", "dk", "dv"), got, plain))
        if not all(torch.equal(a, a2) for a, a2 in zip(got, again)):
            raise AssertionError(f"{name} {kern} is not bitwise repeatable")
    row = {"case": list(case), "dtype": dtype, "max_abs_err": errs[route],
           "fwd_max_abs_err": fwd_err, "lse_max_abs_err": lse_err,
           "bitwise_repeatable": True, "kernel": route}
    return row, (q, k, v, o, lse, do)


def bwd_timing(tensors, case) -> dict:
    """Times at a timed shape: the backward kernels of the route and the
    plain-FMA kernels on the same inputs, the plain version, the autograd backward of
    ``F.scaled_dot_product_attention`` (GQA) as the library yardstick, the
    forward kernel with its log-sum-exp and SDPA's forward, and the
    bounds."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.roofline import op_analysis as oa

    q, k, v, o, lse, do = tensors
    b, sq, sk, h, kv, d, causal, off = case
    scale = d ** -0.5
    big = q.numel() >= 2**24
    row = {"kernel": ops.kernel_for_bwd(q.dtype, d)}
    row["ms"] = time_ms(lambda i: ops._flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal, off, scale), iters=10 if big else 40)
    if row["kernel"] != "simt":  # the plain-FMA kernels on the same inputs
        row["simt_ms"] = time_ms(lambda i: ops._flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal, off, scale, kernel="simt"),
            iters=3 if big else 20)
    row["plain_ms"] = time_ms(lambda i: ops.attention_bwd_ref(
        q, k, v, o, lse, do, causal=causal, q_offset=off), iters=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                         enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    row["library_ms"] = time_ms(lambda i: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), iters=10 if big else 40)
    row["fwd_ms"] = time_ms(lambda i: ops._flash_attention_cuda(
        q, k, v, causal, off, scale, with_lse=True), iters=10 if big else 40)
    with torch.no_grad():
        row["fwd_library_ms"] = time_ms(
            lambda i: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True),
            iters=10 if big else 40)
    del out
    size = q.element_size()
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    row.update(oa.bound(oa.flash_attention_bwd_work(
        b, sq, sk, h, kv, d, size, causal, off), peak))
    row["fwd_bound_ms"] = oa.bound(oa.flash_attention_work(
        b, sq, sk, h, kv, d, size, causal, off, lse=True), peak)["bound_ms"]
    row["tflops"] = row["flops"] / (row["ms"] * 1e9)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


def vmap_grad_check(dev) -> float:
    """``FlashAttention`` under ``torch.func.vmap(grad(...))`` on the card
    (the federated clients' path) equals a loop of per-sample grads."""
    import torch
    from torch.func import grad, vmap

    from repro_torch.kernels.flash_attention.ops import FlashAttention

    gen = torch.Generator().manual_seed(15)
    n, (b, s, _, h, kv, d, causal, off) = 4, BWD_SMOKE
    q = _randn(gen, (n, 1, s, h, d), "float32", dev)
    k, v = (_randn(gen, (n, 1, s, kv, d), "float32", dev) for _ in range(2))

    def loss(q, k, v):
        return (FlashAttention.apply(q, k, v, causal, off, d ** -0.5)[0]
                ** 2).sum()

    batched = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
    err = 0.0
    for i in range(n):
        for a, w in zip(batched, grad(loss, argnums=(0, 1, 2))(q[i], k[i],
                                                               v[i])):
            err = max(err, float((a[i] - w).abs().max()))
    torch.cuda.synchronize()
    if err > 1e-6:
        raise AssertionError(f"vmap(grad) through FlashAttention differs "
                             f"from the per-sample loop by {err:.3e}")
    return err


def bwd_phase(dev) -> tuple[dict, set, float]:
    """Phase 15: every case of ``BWD_CASES``, the timed shapes, the
    ``vmap(grad)`` check; returns the kernel's JSON entry, the checked
    (case, dtype) pairs and the forward's max abs error over them."""
    import torch

    gen = torch.Generator().manual_seed(15)
    checked, errs, fwd_errs, main_row = set(), [], [], None
    for case, dtypes in BWD_CASES:
        for dtype in dtypes:
            row, tensors = bwd_case(dev, gen, case, dtype)
            if case in TIMED_BWD and dtype == "bfloat16":
                row.update(bwd_timing(tensors, case))
                if case == BWD_LLAMA:
                    main_row = row
            del tensors
            errs.append(row["max_abs_err"])
            fwd_errs.append(row["fwd_max_abs_err"])
            checked.add((case, dtype))
            log(json.dumps({"flash_attention_bwd_case": row}))
    err = vmap_grad_check(dev)
    log(f"vmap(grad) through FlashAttention on the card equals the "
        f"per-sample loop (max abs difference {err:.3e})")
    entry = _timed_entry("flash_attention_bwd", FLASH_SOURCE, BWD_REPLACES,
                         errs, main_row)
    entry["kernel"] = main_row["kernel"] if main_row else None
    torch.cuda.empty_cache()
    return entry, checked, max(fwd_errs)


def start_training_audit() -> None:
    """Starts the flash wrappers' records of the shapes the training
    paths launch the forward (with its log-sum-exp) and the backward at."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    flash_attention.shapes = set()
    flash_attention.bwd_shapes = set()


def check_training_shapes(dev, checked: set) -> tuple[float, float]:
    """Stops the records of :func:`start_training_audit` and runs
    :func:`bwd_case` (forward and backward against their plain versions) at
    every forward or backward shape launched since that phase 15 did not
    check; returns the forward's and the backward's max abs errors over
    those cases (0.0 where none was new)."""
    import torch

    from repro_torch.kernels.flash_attention.ops import flash_attention

    launched = flash_attention.shapes | flash_attention.bwd_shapes
    flash_attention.shapes = flash_attention.bwd_shapes = None
    gen = torch.Generator().manual_seed(17)
    new = sorted(s for s in launched if (s[:8], s[8]) not in checked)
    fwd_err = bwd_err = 0.0
    for s in new:
        row, _ = bwd_case(dev, gen, s[:8], s[8])
        checked.add((s[:8], s[8]))
        log(json.dumps({"flash_attention_bwd_case": row,
                        "launched_by": "path"}))
        fwd_err = max(fwd_err, row["fwd_max_abs_err"])
        bwd_err = max(bwd_err, row["max_abs_err"])
    log(f"forward and backward shapes launched by phases 16, 17 and 19: "
        f"{len(launched)}, {len(new)} checked here")
    return fwd_err, bwd_err


# --------------------------------------------------------------------------
# phases 16 and 19: cloud training at llama3.2-3b's and mamba2-1.3b's
# published widths and depths

def _zero_flash_counters():
    from repro_torch.kernels.flash_attention.ops import flash_attention

    flash_attention.launches = 0
    flash_attention.wgmma_launches = 0
    flash_attention.bwd_launches = 0
    flash_attention.wgmma_bwd_launches = 0


def _flash_counters() -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_attention

    return {"flash_attention": flash_attention.launches,
            "flash_attention_wgmma": flash_attention.wgmma_launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "flash_attention_bwd_wgmma": flash_attention.wgmma_bwd_launches}


def _zero_ssd_counters():
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    ssd_scan.launches = ssd_scan.tc_launches = ssd_scan.bwd_launches = 0
    ssd_scan.tc_bwd_launches = 0


def _ssd_counters() -> dict:
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    return {"ssd_scan": ssd_scan.launches,
            "ssd_scan_tc": ssd_scan.tc_launches,
            "ssd_scan_bwd": ssd_scan.bwd_launches,
            "ssd_scan_bwd_tc": ssd_scan.tc_bwd_launches}


def _zero_conv_counters():
    from repro_torch.kernels.causal_conv.ops import causal_conv

    causal_conv.launches = causal_conv.bwd_launches = 0


def _conv_counters() -> dict:
    from repro_torch.kernels.causal_conv.ops import causal_conv

    return {"causal_conv": causal_conv.launches,
            "causal_conv_bwd": causal_conv.bwd_launches}


def _zero_counters():
    _zero_flash_counters()
    _zero_ssd_counters()
    _zero_conv_counters()


def _counters() -> dict:
    return {**_flash_counters(), **_ssd_counters(), **_conv_counters()}


def _audit(cfg) -> tuple[dict, tuple, dict]:
    """What one training step of ``cfg`` (8 microbatches, remat) must
    launch: the counters' expected values, the kernels a profiled step
    must show and their expected counts.  Each layer launches its forward
    kernel twice (the forward and the recompute) and its backward once:
    flash attention for llama, the scan (on the tensor cores, forward and
    backward) for mamba2, and for mamba2 each of a block's two causal
    convs likewise (one forward kernel a call, two backward)."""
    L, n = cfg.num_layers, TRAIN_MICRO
    if cfg.family == "ssm":
        expected = {"ssd_scan": 2 * L * n, "ssd_scan_tc": 2 * L * n,
                    "ssd_scan_bwd": L * n, "ssd_scan_bwd_tc": L * n,
                    "causal_conv": 2 * 2 * L * n,
                    "causal_conv_bwd": 2 * L * n}
        match = ("ssd_scan_tc_kernel", *SSD_BWD_KERNELS["tc"])
    else:
        expected = {"flash_attention": 2 * L * n,
                    "flash_attention_wgmma": 2 * L * n,
                    "flash_attention_bwd": L * n,
                    "flash_attention_bwd_wgmma": L * n,
                    "ssd_scan": 0, "ssd_scan_tc": 0, "ssd_scan_bwd": 0,
                    "ssd_scan_bwd_tc": 0, "causal_conv": 0,
                    "causal_conv_bwd": 0}
        match = ("flash_fwd_wgmma_kernel", "flash_bwd_prep_kernel",
                 "flash_bwd_fused_wgmma_kernel",
                 "flash_bwd_dq_convert_kernel")
    want = {m: 2 * L * n if i == 0 else L * n for i, m in enumerate(match)}
    if cfg.family == "ssm":
        match += CONV_KERNELS
        want.update({CONV_KERNELS[0]: 2 * 2 * L * n,
                     CONV_KERNELS[1]: 2 * L * n, CONV_KERNELS[2]: 2 * L * n})
    return expected, match, want


def training_phase(dev, card: str, arch: str = TRAIN_ARCH,
                   analyze_step: bool = False) -> dict:
    """Phase 16 (llama3.2-3b) and phase 19 (mamba2-1.3b):
    ``cloud_training``'s own step function (``make_cloud_step``) on
    ``arch`` at full width and depth, seeded random bf16 weights, one
    warm-up step then ``TRAIN_STEPS`` timed ones, then one profiled step;
    the launch counts per step must equal the audit's (:func:`_audit`).
    With ``analyze_step`` one more step runs under the analyzer (phase 21a,
    :func:`card_step_analysis`), its seconds kept apart."""
    import math

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distribution.steps import init_train_state
    from repro_torch.launch.train import make_cloud_step
    from repro_torch.optim.optimizers import tree_leaves

    cfg = get_config(arch)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_MICRO, "train",
                        microbatches=TRAIN_MICRO)
    free_cycles()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    log(f"{cfg.name} training state: {n_params} params, bf16 params + f32 "
        f"master, m, v in {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
        f"initialized in {time.perf_counter() - t0:.1f}s")
    pipe = TokenPipeline(cfg.vocab_size, TRAIN_SEQ, TRAIN_MICRO, seed=0)
    step = make_cloud_step(cfg, shape, pipe, device=dev)
    tokens = TRAIN_SEQ * TRAIN_MICRO
    expected, match, want = _audit(cfg)
    rows = []
    for i in range(1 + TRAIN_STEPS):
        _zero_counters()
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        state, m = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        launches = {k: v for k, v in _counters().items() if k in expected}
        loss, lr, gn = (float(m[k]) for k in ("loss", "lr", "grad_norm"))
        if not all(math.isfinite(x) for x in (loss, lr, gn)):
            raise AssertionError(f"{arch} training step {i}: loss {loss}, "
                                 f"lr {lr}, grad_norm {gn}")
        if launches != expected:
            raise AssertionError(f"{arch} training step {i}: launches "
                                 f"{launches}, expected {expected}")
        row = {"step": i, "warm_up": i == 0, "loss": loss, "lr": lr,
               "grad_norm": gn, "wall_s": wall, "tokens_per_s": tokens / wall,
               "peak_share": 6 * n_params * tokens / wall / BF16_FLOPS}
        rows.append(row)
        log(f"train step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{loss:.4f} lr {lr:.3e} grad_norm {gn:.4f} | {wall:.3f} s, "
            f"{row['tokens_per_s']:.0f} tok/s, 6N share of 989 TFLOP/s "
            f"{row['peak_share']:.3f}; launches {launches}")
    peak = torch.cuda.max_memory_allocated()
    def profiled_step():
        # A window that lost records runs again (``profiled``): each try
        # counts its own launches.
        _zero_counters()
        step(state)

    prof = profile_window(profiled_step, 1, match=match)
    launches = {k: v for k, v in _counters().items() if k in expected}
    if launches != expected:
        raise AssertionError(f"profiled {arch} training step: launches "
                             f"{launches}, expected {expected}")
    if prof["matched"] != want:
        raise AssertionError(f"profiled {arch} training step ran "
                             f"{prof['matched']} kernels, the audit "
                             f"expects {want}")
    timed = rows[1:]
    res = {"arch": cfg.name, "params": n_params, "seq_len": TRAIN_SEQ,
           "microbatches": TRAIN_MICRO, "tokens_per_step": tokens,
           "steps": rows,
           "wall_s_per_step": sum(r["wall_s"] for r in timed) / len(timed),
           "peak_memory_gib": peak / 2**30,
           "launches_per_step": expected,
           "profiled_step": {k: prof[k] for k in (
               "wall_ms", "device_busy_ms", "kernels", "device_idle_share",
               "top_kernels_ms", "matched", "matched_ms")},
           "card": card}
    res["tokens_per_s"] = tokens / res["wall_s_per_step"]
    res["peak_share"] = 6 * n_params * tokens / res["wall_s_per_step"] \
        / BF16_FLOPS
    card_step = (card_step_analysis(step, state, expected) if analyze_step
                 else None)
    log(json.dumps({"training": res}))
    log(f"{cfg.name} training: {res['wall_s_per_step']:.3f} s/step, "
        f"{res['tokens_per_s']:.0f} tok/s, 6N share {res['peak_share']:.3f}, "
        f"peak {res['peak_memory_gib']:.2f} GiB; profiled step "
        f"{prof['device_idle_share']:.3f} idle, kernels {prof['matched']} "
        f"= audit, device ms {prof['matched_ms']}")
    steps = 2 + TRAIN_STEPS + (card_step is not None)
    total = {k: v * steps for k, v in expected.items()}
    del state, step
    free_cycles()
    return {"launches": total, "summary": res, "card_step": card_step}


def free_cycles() -> None:
    """Frees what only reference cycles keep alive, then the allocator's
    cache: a train step function holds its f32 accumulator (a whole
    model's gradients) in a cycle through its own closure, which
    reference counting alone never frees."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _leaf_names(tree, prefix: str = "") -> list:
    """Each leaf's path in ``tree_leaves``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{prefix}{i}/")]
    return [] if tree is None else [prefix.rstrip("/")]


def _leaf_rel_errs(got: list, want: list) -> list:
    """Each leaf's ``|got - want| / |want|`` (Frobenius norms)."""
    return [float((a - b).norm() / b.norm().clamp_min(1e-30))
            for a, b in zip(got, want)]


def training_cross_check(dev, arch: str = TRAIN_ARCH) -> dict:
    """Phase 16's cross-check (and phase 19's, for mamba2-1.3b and
    zamba2-1.2b): ``arch`` at full width and 2 layers, 2 steps of 2
    microbatches of 4096 tokens, the kernel path against the plain path
    (``attention_impl="einsum"``: the plain attention and, in the SSM
    blocks, the plain scan and its written-out backward), both on the card,
    within 2e-2 relative in bf16 and 1e-4 in f32 (TF32 off):
    each step's loss and grad norm, each updated leaf, and each leaf's
    first-step gradient, read as AdamW's first moment after one step
    (``(1 - b1)`` times the clipped mean of the microbatches' f32
    gradients).  Two steps move a weight by ~3 % of its size, so the
    updated leaves alone would hide an error in the gradients; Adam's
    near-sign steps hide their magnitude too, so the gradients are held
    directly.  Each leaf's change in its f32 master over the 2 steps is
    logged, not held: Adam's first steps turn bf16 rounding in gradients
    near 0 into sign flips.  A leaf that starts at 0 (the SSM blocks' conv
    biases) is its change after 2 steps, so its updated value is logged
    with the changes and not held either; its gradient is held as every
    leaf's is.  Every reading is logged before any limit is applied."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.distribution.steps import init_train_state
    from repro_torch.launch.train import make_cloud_step
    from repro_torch.optim.optimizers import AdamWConfig, tree_leaves

    shape = ShapeConfig("train_4k_x", TRAIN_SEQ, 2, "train", microbatches=2)
    opt = AdamWConfig(warmup_steps=1)  # the peak lr from the first step
    # The kernel path's backward launches over 2 steps of 2 microbatches:
    # one per layer (attention or scan) and, for zamba2, one per
    # application of the shared block (at layer 0 of 2).
    family = get_config(arch).family
    want = {"flash_attention_bwd": 0 if family == "ssm" else (
        2 * 2 * (1 if family == "hybrid" else 2)),
        "ssd_scan_bwd": 2 * 2 * 2 if family in ("ssm", "hybrid") else 0,
        "causal_conv_bwd": 2 * 2 * 2 * 2 if family in ("ssm", "hybrid")
        else 0}
    out = {}
    for dtype, tol in (("bfloat16", 2e-2), ("float32", 1e-4)):
        cfg = dataclasses.replace(get_config(arch), num_layers=2,
                                  dtype=dtype)
        runs = {}
        for path, c in (("kernel", cfg), ("plain", dataclasses.replace(
                cfg, attention_impl="einsum"))):
            _zero_counters()
            state = init_train_state(c, seed=0, device=dev)
            start = [t.clone() for t in tree_leaves(state["opt"]["master"])]
            names = _leaf_names(state["opt"]["master"])
            zero = [bool(t.eq(0).all()) for t in start]
            step = make_cloud_step(
                c, shape, TokenPipeline(c.vocab_size, TRAIN_SEQ, 2, seed=0),
                opt_cfg=opt, device=dev)
            metrics, grads = [], None
            for i in range(2):
                state, m = step(state)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                if i == 0:
                    grads = [t.cpu() for t in tree_leaves(state["opt"]["m"])]
            moved = [(t - s0).cpu() for t, s0 in zip(
                tree_leaves(state["opt"]["master"]), start)]
            params = [t.float().cpu() for t in tree_leaves(state["params"])]
            runs[path] = (metrics, params, grads, moved, _counters(), zero)
            del state, step, start
            free_cycles()
        (mk, pk, gk, dk, lk, zero), (mp, pp, gp, dp, lp, _) = (
            runs["kernel"], runs["plain"])
        metric_err = max(abs(a - b) / abs(b) for x, y in zip(mk, mp)
                         for a, b in zip(x, y))
        grad_errs, delta_errs = _leaf_rel_errs(gk, gp), _leaf_rel_errs(dk, dp)
        leaf_errs = _leaf_rel_errs(pk, pp)
        held = [e for e, z in zip(leaf_errs, zero) if not z]
        res = {"arch": cfg.name, "dtype": dtype, "limit": tol,
               "metrics_kernel": mk,
               "metrics_plain": mp, "max_metric_rel_err": metric_err,
               "max_leaf_rel_err": max(held),
               "zero_init_leaves": {n: e for n, e, z in zip(
                   names, leaf_errs, zero) if z},
               "worst_grad_leaf": names[grad_errs.index(max(grad_errs))],
               "max_grad_rel_err": max(grad_errs),
               "max_change_rel_err": max(delta_errs),
               "median_change_rel_err": sorted(delta_errs)[
                   len(delta_errs) // 2],
               "leaves": len(gk), "launches_kernel": lk,
               "launches_plain": lp}
        log(json.dumps({"training_cross_check": res}))
        log(f"training cross-check [{cfg.name} {dtype}]: loss/grad_norm per "
            f"step kernel {mk} vs plain {mp}, worst relative "
            f"{metric_err:.3e}; "
            f"{len(gk)} leaves: updated worst relative "
            f"{res['max_leaf_rel_err']:.3e}, first-step gradient worst "
            f"relative {max(grad_errs):.3e} (limit {tol}); change over 2 "
            f"steps worst relative {max(delta_errs):.3e} (not held"
            + (f"; with it {sum(zero)} leaves that start at 0, updated "
               f"worst relative {max(res['zero_init_leaves'].values()):.3e}"
               if any(zero) else "") + ")")
        out[dtype] = res
        del runs, pk, pp, gk, gp, dk, dp
    for dtype, res in out.items():
        tol = res["limit"]
        lk, lp = res["launches_kernel"], res["launches_plain"]
        # bf16 takes the scan's tensor-core backward, f32 the plain-FMA one.
        want_tc = want["ssd_scan_bwd"] if dtype == "bfloat16" else 0
        if any(lk[k] != v or lp[k] != 0 for k, v in want.items()) or (
                lk["ssd_scan_bwd_tc"] != want_tc):
            raise AssertionError(f"[{arch} {dtype}] the kernel path launched "
                                 f"{lk}, the plain path {lp}; expected "
                                 f"{want} ({want_tc} on the tensor cores) "
                                 f"and none")
        if not (res["max_metric_rel_err"] <= tol
                and res["max_leaf_rel_err"] <= tol
                and res["max_grad_rel_err"] <= tol):
            raise AssertionError(f"training cross-check [{arch} {dtype}] "
                                 f"over its limits: {res}")
    return out


# --------------------------------------------------------------------------
# phase 17: the LM examples and the federated LM loop

def _run_captured(argv, **init) -> tuple[str, dict]:
    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = train.run(argv, **init)
    return buf.getvalue(), res


def _cpu_init(cfg, seed, device):
    """The seeded smoke params drawn on the CPU and moved to ``device``, so
    the card's and the CPU's runs start from the same numbers."""
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizers import tree_map

    return tree_map(lambda t: t.to(device),
                    get_model(cfg).init(seed, cfg, device="cpu"))


def _virtual_lines(text: str) -> list:
    """The run's virtual-time lines: rounds without the client loss, task
    lines without the task id (each package counts its own), the makespan
    line without the host wall."""
    import re

    out = []
    for line in text.splitlines():
        if line.startswith("round"):
            out.append(re.sub(r"client-loss \S+ ", "", line))
        elif line.startswith("task"):
            out.append(re.sub(r"^task \d+:", "task:", line))
        elif line.startswith("interleaved"):
            out.append(re.sub(r"; wall \S+", "", line))
    return out


def pretrain_resume_check(dev) -> dict:
    """``examples/lm_pretrain.py`` on the card, 200 steps with checkpoints
    every 50: once straight through, once in a process killed after its
    step-100 save and resumed through ``TrainingSupervisor``; the resumed
    steps' losses must equal the uninterrupted run's bit for bit.  The
    checkpoints live in a temporary directory, removed at the end."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="lm_pretrain_") as root:
        return _pretrain_resume(root)


def _pretrain_resume(root: str) -> dict:
    import signal

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.examples import lm_pretrain

    whole_dir, killed_dir = (os.path.join(root, x) for x in ("a", "b"))
    _zero_flash_counters()
    t0 = time.perf_counter()
    _, res = _run_captured(lm_pretrain.argv(
        ["--device", "cuda", "--checkpoint-dir", whole_dir]))
    wall = time.perf_counter() - t0
    launches = _flash_counters()
    whole = res["losses"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.lm_pretrain",
         "--device", "cuda", "--checkpoint-dir", killed_dir], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    marker = os.path.join(killed_dir, f"step_{100:010d}", "manifest.json")
    deadline = time.time() + 300
    while not os.path.exists(marker):
        if proc.poll() is not None or time.time() > deadline:
            proc.kill()
            raise AssertionError(f"the pretraining process ended or stalled "
                                 f"before its step-100 save: "
                                 f"{proc.stderr.read().decode()[-2000:]}")
        time.sleep(0.02)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    latest = Checkpointer(killed_dir).latest_step()
    _, rest = _run_captured(lm_pretrain.argv(
        ["--device", "cuda", "--checkpoint-dir", killed_dir]))
    rest = rest["losses"]
    same = len(rest) == 200 - latest and rest == whole[latest:]
    out = {"steps": len(whole), "wall_s": wall, "killed_after_step": latest,
           "resumed_steps": len(rest), "bitwise_equal": same,
           "first_loss": whole[0], "final_loss": whole[-1],
           "launches": launches}
    log(f"lm_pretrain on the card: 200 steps in {wall:.1f}s, loss "
        f"{whole[0]:.4f} -> {whole[-1]:.4f}; killed after the step-{latest} "
        f"save and resumed: {len(rest)} losses bitwise equal to the "
        f"uninterrupted run's {same}; flash launches {launches}")
    if not same or launches["flash_attention_bwd"] <= 0:
        raise AssertionError(f"pretraining resume check failed: {out}")
    return out


def federation_check(dev, argv: list, name: str) -> dict:
    """``argv`` through the port's CLI on the card and on the CPU from the
    same params: every virtual-time line, the aggregation count and the
    wire bytes equal, client losses within 2e-2."""
    import re

    from repro_torch.kernels.fed_reduce.ops import fed_reduce

    _zero_flash_counters()
    fed_reduce.launches = 0
    t0 = time.perf_counter()
    card_text, card = _run_captured(argv + ["--device", "cuda"],
                                    init_params=_cpu_init)
    wall = time.perf_counter() - t0
    launches = {**_flash_counters(), "fed_reduce": fed_reduce.launches}
    cpu_text, cpu = _run_captured(argv + ["--device", "cpu"],
                                  init_params=_cpu_init)
    lines, cpu_lines = _virtual_lines(card_text), _virtual_lines(cpu_text)
    for line in lines:
        log(f"  {line}")
    same = lines == cpu_lines and len(lines) > 0
    res = {"name": name, "wall_s": wall, "virtual_lines_equal": same,
           "launches": launches}
    losses = [float(x) for x in re.findall(r"client-loss (\S+)", card_text)]
    cpu_losses = [float(x) for x in re.findall(r"client-loss (\S+)",
                                               cpu_text)]
    res["client_loss_max_rel_err"] = max(
        (abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)),
        default=0.0)
    ok = same and res["client_loss_max_rel_err"] <= 2e-2
    if "wire_bytes_received" in card:
        res.update(aggregations=card["aggregations"],
                   cpu_aggregations=cpu["aggregations"],
                   wire_bytes=card["wire_bytes_received"],
                   cpu_wire_bytes=cpu["wire_bytes_received"])
        ok = ok and card["aggregations"] == cpu["aggregations"] and \
            res["wire_bytes"] == res["cpu_wire_bytes"]
    log(json.dumps({"federated_lm": res}))
    log(f"{name} on the card in {wall:.1f}s: virtual-time lines equal to the "
        f"CPU run's {same}; launches {launches}")
    if not ok or launches["fed_reduce"] <= 0 or min(
            launches["flash_attention"], launches["flash_attention_bwd"]) <= 0:
        raise AssertionError(f"{name}: the card run differs from the CPU "
                             f"run or skipped a kernel: {res}")
    return res


def training_examples_phase(dev) -> dict:
    """Phase 17: the pretraining example with its kill-and-resume check,
    the federation example and ``--tasks 3 --preemptive`` on the card
    against the CPU."""
    from repro_torch.examples import lm_federation

    out = {"pretrain": pretrain_resume_check(dev)}
    fed_argv = lm_federation.argv([])[:-2]  # its flags, without --device
    out["federation"] = federation_check(dev, fed_argv, "lm_federation")
    out["tasks"] = federation_check(
        dev, ["--smoke", "--tasks", "3", "--preemptive"], "--tasks 3")
    out["launches"] = {k: sum(out[p]["launches"].get(k, 0) for p in
                              ("pretrain", "federation", "tasks"))
                       for k in ("flash_attention", "flash_attention_bwd",
                                 "fed_reduce")}
    return out


# --------------------------------------------------------------------------
# phase 18: the SSD scan's backward (K4b) against its plain version

# (b, l, h, p, g, n, chunk): the reference's forward cases (g < h among
# them), a length that pads to the chunk, decays that overflow above the
# diagonal (A = -64, dt = 0.1), and mamba2-1.3b's and zamba2-1.2b's
# training shapes (one sequence of 4096 per microbatch, chunk 128).  All
# but the training shapes carry a nonzero cotangent of the final state
# (the models drop the state, so theirs is zero).
SSD_TRAIN_MAMBA = (1, TRAIN_SEQ, 64, 64, 1, 128, 128)
SSD_TRAIN_ZAMBA = (1, TRAIN_SEQ, 64, 64, 1, 64, 128)
SSD_BWD_CASES = [
    *((c, ("float32", "bfloat16"), False, True) for c in SSD_CASES),
    (SSD_RAGGED, ("float32", "bfloat16"), False, True),
    (SSD_OVERFLOW, ("float32", "bfloat16"), True, True),
    (SSD_TRAIN_MAMBA, ("bfloat16", "float32"), False, False),
    (SSD_TRAIN_ZAMBA, ("bfloat16",), False, False),
]
SSD_BWD_REPLACES = "src/repro/kernels/ssd_scan/ref.py:60"
# Each route's kernels, one launch each per backward.
SSD_BWD_KERNELS = {
    "tc": ("ssd_bwd_tc_local_kernel", "ssd_bwd_tc_state_kernel",
           "ssd_bwd_tc_chunk_kernel", "ssd_bwd_tc_dbdc_kernel",
           "ssd_bwd_group_kernel", "ssd_bwd_da_kernel"),
    "simt": ("ssd_bwd_cb_kernel", "ssd_bwd_state_kernel",
             "ssd_bwd_chunk_kernel", "ssd_bwd_group_kernel",
             "ssd_bwd_da_kernel")}
GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _ssd_tol(dtype) -> float:
    import torch

    return 3e-4 if dtype == torch.float32 else 2e-2


def _rel_to_max(got, want) -> float:
    """max |got - want| / max |want|: the error relative to the tensor's
    largest entry."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def ssd_bwd_case(dev, gen, case, dtype: str, *, overflow=False,
                 dstate=True) -> tuple[dict, tuple]:
    """The forward kernel at ``case`` against ``ssd_chunked`` on the card
    (phase 7's limits), then the backward kernels against ``ssd_bwd_ref``
    on the card: each of dx, ddt, dA, dB, dC finite, two calls bitwise
    equal, and within 3e-4 (f32) or 2e-2 (bf16) of the plain version's
    largest entry."""
    import torch

    from repro_torch.kernels.ssd_scan import ops

    dt_ = getattr(torch, dtype)
    args = ssd_inputs(gen, case, dt_, dev, overflow=overflow)
    b, l, h, p, g, n, q = case
    dy = torch.randn((b, l, h, p), generator=gen).to(dt_).to(dev)
    ds = torch.randn((b, h, p, n), generator=gen).to(dev) if dstate else None
    name = (f"ssd_scan_bwd{case}{' overflow' if overflow else ''} {dtype}"
            f"{' with dstate' if dstate else ''}")
    y, s = ops._ssd_scan(*args, q, "cuda")
    py, ps = ops._ssd_scan(*args, q, "chunked")
    route = ops.kernel_for_bwd(dt_, p, n, q)
    tc0 = ops.ssd_scan.tc_bwd_launches
    got = ops._ssd_scan_bwd_cuda(*args, dy, ds, q)
    again = ops._ssd_scan_bwd_cuda(*args, dy, ds, q)
    plain = ops.ssd_bwd_ref(*args, dy, ds, chunk=q)
    torch.cuda.synchronize()
    if ops.ssd_scan.tc_bwd_launches - tc0 != (2 if route == "tc" else 0):
        raise AssertionError(f"{name} should run on the {route} route")
    ey = (y.float() - py.float()).abs()
    es = float((s - ps).abs().max())
    fwd_ok = (float(ey.max()) <= 3e-4 if dt_ == torch.float32 else bool(
        (ey <= 2e-2 * (1 + py.float().abs())).all())) and es <= 3e-4
    if not fwd_ok:
        raise AssertionError(f"{name}: the forward kernel disagrees with "
                             f"its plain version: y {float(ey.max()):.3e}, "
                             f"state {es:.3e}")
    tol = _ssd_tol(dt_)
    row = {"case": list(case), "dtype": dtype, "overflow": overflow,
           "dstate": dstate, "kernel": route,
           "kernels": "+".join(SSD_BWD_KERNELS[route]),
           "fwd_max_abs_err_y": float(ey.max()),
           "fwd_max_abs_err_state": es}
    for gname, a, a2, want in zip(GRAD_NAMES, got, again, plain):
        if not bool(torch.isfinite(a.float()).all()):
            raise AssertionError(f"{name}: {gname} is not finite")
        if not torch.equal(a, a2):
            raise AssertionError(f"{name}: {gname} is not bitwise "
                                 f"repeatable")
        if a.shape != want.shape or a.dtype != want.dtype:
            raise AssertionError(f"{name}: {gname} is {a.dtype} "
                                 f"{tuple(a.shape)}, the plain version "
                                 f"{want.dtype} {tuple(want.shape)}")
        row[f"{gname}_rel_err"] = _rel_to_max(a, want)
        row[f"{gname}_max_abs_err"] = float((a.float() - want.float()).abs()
                                            .max())
    row["max_rel_err"] = max(row[f"{g}_rel_err"] for g in GRAD_NAMES)
    row["max_abs_err"] = max(row[f"{g}_max_abs_err"] for g in GRAD_NAMES)
    row["limit"] = tol
    row["bitwise_repeatable"] = row["finite"] = True
    if row["max_rel_err"] > tol:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{row}")
    return row, (args, dy, ds)


def ssd_bwd_timing(tensors, case) -> dict:
    """Times at the timed shape, inputs cycled past the L2: the backward
    kernels on their route and (for the tensor-core route) the plain-FMA
    kernels on the same inputs, with each one's share of the bound and
    GFLOP/s, the plain version, autograd through the chunked plain forward
    (a reference point: no PyTorch call computes the scan or its
    backward), the forward kernel, and the bound."""
    import torch

    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.roofline import op_analysis as oa

    args, dy, ds = tensors
    q = case[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (*args, dy))
    n = _copies(nbytes)
    sets = [([t.clone() for t in args], dy.clone()) for _ in range(n)]
    route = ops.kernel_for_bwd(args[0].dtype, case[3], case[5], q)
    row = {"ms": time_ms(lambda i: ops._ssd_scan_bwd_cuda(
        *sets[i % n][0], sets[i % n][1], ds, q), iters=20 if route == "tc"
        else 10)}
    if route != "simt":  # the plain-FMA kernels on the same inputs
        row["simt_ms"] = time_ms(lambda i: ops._ssd_scan_bwd_cuda(
            *sets[i % n][0], sets[i % n][1], ds, q, kernel="simt"), iters=5)
    row["plain_ms"] = time_ms(lambda i: ops.ssd_bwd_ref(
        *sets[i % n][0], sets[i % n][1], ds, chunk=q), iters=3)
    leaves = [t.clone().requires_grad_(True) for t in args]
    y, _ = ops.ssd_chunked(*leaves, chunk=q)
    row["autograd_ms"] = time_ms(lambda i: torch.autograd.grad(
        y, leaves, dy, retain_graph=True), iters=3)
    del y, leaves
    row["library_ms"] = None  # no PyTorch call computes the scan backward
    row["fwd_ms"] = time_ms(lambda i: ops._ssd_scan(
        *sets[i % n][0], q, "cuda"), iters=20)
    row.update(oa.bound(
        oa.ssd_scan_bwd_work(*case, args[0].element_size(), ds is not None),
        BF16_FLOPS if args[0].dtype == torch.bfloat16 else F32_FLOPS))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["gflops_per_s"] = row["flops"] / (row["ms"] * 1e6)
    if "simt_ms" in row:
        row["simt_bound_share"] = row["bound_ms"] / row["simt_ms"]
        row["simt_gflops_per_s"] = row["flops"] / (row["simt_ms"] * 1e6)
        row["speedup_vs_simt"] = row["simt_ms"] / row["ms"]
    del sets
    return row


def ssd_vmap_grad_check(dev) -> float:
    """``SsdScan`` under ``torch.func.vmap(grad(...))`` on the card with A
    shared (the federated clients' path: params unbatched, data batched)
    equals a loop of per-sample grads."""
    import torch
    from torch.func import grad, vmap

    from repro_torch.kernels.ssd_scan.ops import SsdScan

    gen = torch.Generator().manual_seed(18)
    n, case = 4, (2, 100, 4, 16, 2, 16, 32)
    b, l, h, p, g, ns, q = case
    x, dt, A, B, C = ssd_inputs(gen, case, torch.float32, dev)
    xs, dts, Bs, Cs = (torch.stack([t * (1 + 0.1 * i) for i in range(n)])
                       for t in (x, dt, B, C))

    def loss(A, x, dt, B, C):
        y, s = SsdScan.apply(x, dt, A, B, C, q, "auto")
        return (y ** 2).sum() + s.sum()

    argnums = (0, 1, 2, 3, 4)
    batched = vmap(grad(loss, argnums=argnums),
                   in_dims=(None, 0, 0, 0, 0))(A, xs, dts, Bs, Cs)
    err = 0.0
    for i in range(n):
        for a, w in zip(batched, grad(loss, argnums=argnums)(
                A, xs[i], dts[i], Bs[i], Cs[i])):
            err = max(err, _rel_to_max(a[i], w))
    torch.cuda.synchronize()
    if err > 1e-6:
        raise AssertionError(f"vmap(grad) through SsdScan differs from the "
                             f"per-sample loop by {err:.3e}")
    return err


def tc_bwd_smem_check() -> dict:
    """The tensor-core backward's shared memory per kernel as the library
    reports it (``ssd_scan_bwd_tc_smem``) against its Python mirror
    (``ops.tc_bwd_smem_bytes``), at each shape the route takes; raises on
    a difference."""
    from repro_torch.kernels.ssd_scan import ops

    out = {}
    for q in ops.TC_CHUNKS:
        for n in ops.TC_STATES:
            mirror = ops.tc_bwd_smem_bytes(q, n)
            lib = {k: ops._library().ssd_scan_bwd_tc_smem(i, n, q)
                   for i, k in enumerate(("local", "chunk", "dbdc"))}
            if lib != mirror:
                raise AssertionError(f"tensor-core backward shared memory "
                                     f"at q {q}, n {n}: library {lib}, "
                                     f"mirror {mirror}")
            out[f"q{q} n{n}"] = lib
    return out


def ssd_bwd_phase(dev) -> tuple[dict, set]:
    """Phase 18: the tensor-core backward's shared memory against its
    mirror, every case of ``SSD_BWD_CASES``, the timed shape (mamba2's
    training shape in bf16), the ``vmap(grad)`` check; returns the
    kernel's JSON entry and the checked (case, dtype) pairs."""
    import torch

    log(json.dumps({"ssd_scan_bwd_tc_smem_bytes": tc_bwd_smem_check()}))
    gen = torch.Generator().manual_seed(18)
    checked, errs, rel_errs, main_row = set(), [], [], None
    for case, dtypes, overflow, dstate in SSD_BWD_CASES:
        for dtype in dtypes:
            row, tensors = ssd_bwd_case(dev, gen, case, dtype,
                                        overflow=overflow, dstate=dstate)
            if case == SSD_TRAIN_MAMBA and dtype == "bfloat16":
                row.update(ssd_bwd_timing(tensors, case))
                main_row = row
            del tensors
            errs.append(row["max_abs_err"])
            rel_errs.append(row["max_rel_err"])
            checked.add((case, dtype))
            log(json.dumps({"ssd_scan_bwd_case": row}))
    err = ssd_vmap_grad_check(dev)
    log(f"vmap(grad) through SsdScan on the card equals the per-sample loop "
        f"(max relative difference {err:.3e})")
    entry = _timed_entry("ssd_scan_bwd", SSD_SOURCE, SSD_BWD_REPLACES, errs,
                         main_row)
    entry["max_rel_err"] = max(rel_errs)  # to each gradient's largest entry
    entry["kernel"] = "+".join(SSD_BWD_KERNELS[main_row["kernel"]
                                               if main_row else "tc"])
    torch.cuda.empty_cache()
    return entry, checked


def start_ssd_audit() -> None:
    """Starts the scan wrapper's records of the shapes the training paths
    launch the forward and the backward at."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    ssd_scan.shapes = set()
    ssd_scan.bwd_shapes = set()


def check_ssd_shapes(dev, checked: set) -> tuple[float, float]:
    """Stops the records of :func:`start_ssd_audit` and runs
    :func:`ssd_bwd_case` at every forward or backward shape launched since
    that phase 18 did not check; returns the largest absolute and relative
    errors over those cases (0.0 where none was new)."""
    import torch

    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    launched = ssd_scan.shapes | ssd_scan.bwd_shapes
    ssd_scan.shapes = ssd_scan.bwd_shapes = None
    gen = torch.Generator().manual_seed(19)
    new = sorted(s for s in launched if (s[:7], s[7]) not in checked)
    err = rel = 0.0
    for s in new:
        row, _ = ssd_bwd_case(dev, gen, s[:7], s[7], dstate=False)
        checked.add((s[:7], s[7]))
        log(json.dumps({"ssd_scan_bwd_case": row, "launched_by": "path"}))
        err = max(err, row["max_abs_err"])
        rel = max(rel, row["max_rel_err"])
    log(f"scan forward and backward shapes launched by phase 19: "
        f"{len(launched)}, {len(new)} checked here")
    return err, rel


# --------------------------------------------------------------------------
# phase 18b: the causal conv + bias + SiLU kernel and its backward

# (batch, len, channels): mamba2-1.3b's x and B,C in a training microbatch
# and in a prefill batch of the benchmark's serving cell (8 x 4096).
CONV_CASES = ((1, 4096, 4096), (1, 4096, 256), (8, 4096, 4096),
              (8, 4096, 256))
CONV_SOURCE = "src/repro_torch/csrc/causal_conv.cu"
CONV_KERNELS = ("causal_conv_fwd_kernel", "causal_conv_bwd_kernel",
                "causal_conv_wsum_kernel")


def _conv_library(x, w, b):
    """``F.conv1d`` (cuDNN's depthwise conv, TF32 off) + SiLU: the library
    yardstick, timed only; the port never calls it."""
    import torch.nn.functional as F

    width = w.shape[0]
    out = F.conv1d(F.pad(x.transpose(1, 2), (width - 1, 0)),
                   w.t().unsqueeze(1), b, groups=x.shape[-1])
    return F.silu(out).transpose(1, 2)


def conv_case(dev, case) -> dict:
    """The kernel and its backward against the plain chain on the card at
    ``case`` in bf16 (y, dx, dw, db within 2e-2 of the plain version's
    largest entry, two calls bitwise equal, one forward and two backward
    kernels a call), then timed with inputs cycled past the L2: forward and
    backward kernels, the plain chain's forward and its autograd backward,
    ``F.conv1d`` + SiLU forward and backward, and the bounds."""
    import torch

    from repro_torch.kernels.causal_conv import ops
    from repro_torch.roofline import op_analysis as oa

    b, l, c = case
    gen = torch.Generator(device=dev).manual_seed(b * l + c)
    x = torch.randn((b, l, c), generator=gen, device=dev).bfloat16()
    w = (torch.randn((4, c), generator=gen, device=dev) * 0.125).bfloat16()
    bias = (torch.randn((c,), generator=gen, device=dev) * 0.1).bfloat16()
    dy = torch.randn((b, l, c), generator=gen, device=dev).bfloat16()
    got = [ops._fwd_cuda(x, w, bias), *ops._bwd_cuda(x, w, bias, dy)]
    again = [ops._fwd_cuda(x, w, bias), *ops._bwd_cuda(x, w, bias, dy)]
    leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    y = ops.causal_conv_ref(*leaves)
    want = [y.detach(), *torch.autograd.grad(y, leaves, dy)]
    errs = {n: float((g.float() - r.float()).abs().max()
                     / r.float().abs().max())
            for n, g, r in zip(("y", "dx", "dw", "db"), got, want)}
    kern = device_kernels(lambda: (ops._fwd_cuda(x, w, bias),
                                   ops._bwd_cuda(x, w, bias, dy)))
    names = {k: sum(r[2] for r in kern if k in r[0]) for k in CONV_KERNELS}
    row = {"shape": list(case), "dtype": "bfloat16", "max_rel_err": errs,
           "limit": 2e-2,
           "bitwise_equal": all(torch.equal(a, e) for a, e in zip(got,
                                                                  again)),
           "kernels": names,
           "plan_fwd": ops._plan(x, (x, w, bias), False)._asdict(),
           "plan_bwd": ops._plan(x, (x, w, bias, dy), True)._asdict()}
    del got, again, want, y
    nbytes = 2 * x.numel() * x.element_size()
    n = _copies(nbytes)
    sets = [(x.clone(), w, bias, dy.clone()) for _ in range(n)]
    row["ms"] = time_ms(lambda i: ops._fwd_cuda(*sets[i % n][:3]))
    row["bwd_ms"] = time_ms(lambda i: ops._bwd_cuda(*sets[i % n]))
    row["plain_ms"] = time_ms(lambda i: ops.causal_conv_ref(
        *sets[i % n][:3]), iters=10)
    row["library_ms"] = time_ms(lambda i: _conv_library(*sets[i % n][:3]),
                                iters=10)
    for key, fn in (("plain_bwd_ms", ops.causal_conv_ref),
                    ("library_bwd_ms", _conv_library)):
        graphs = []
        for xs, *_ in sets:
            lv = [xs.requires_grad_(True), w.clone().requires_grad_(True),
                  bias.clone().requires_grad_(True)]
            graphs.append((fn(*lv), lv))
        row[key] = time_ms(lambda i: torch.autograd.grad(
            graphs[i % n][0], graphs[i % n][1], sets[i % n][3],
            retain_graph=True), iters=10)
        del graphs
        for xs, *_ in sets:
            xs.requires_grad_(False)
    dims = (b, l, c, 4, x.element_size())
    fwd = oa.bound(oa.causal_conv_work(*dims), F32_FLOPS)
    bwd = oa.bound(oa.causal_conv_bwd_work(*dims), F32_FLOPS)
    row.update(bound_ms=fwd["bound_ms"], bound_by=fwd["bound_by"],
               bwd_bound_ms=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"])
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["bwd_bound_share"] = row["bwd_bound_ms"] / row["bwd_ms"]
    del sets
    if (max(errs.values()) > row["limit"] or not row["bitwise_equal"]
            or names != {CONV_KERNELS[0]: 1, CONV_KERNELS[1]: 1,
                         CONV_KERNELS[2]: 1}):
        raise AssertionError(f"causal_conv at {case}: {row}")
    return row


def conv_phase(dev) -> dict:
    """Phase 18b: :func:`conv_case` at each of ``CONV_CASES``; returns the
    kernel's entry for the kernels line (its numbers at the training x
    shape)."""
    rows = []
    for case in CONV_CASES:
        rows.append(conv_case(dev, case))
        log(json.dumps({"causal_conv_case": rows[-1]}))
    entry = _timed_entry("causal_conv", CONV_SOURCE, None,
                         [max(r["max_rel_err"].values()) for r in rows],
                         rows[0])
    entry["bwd_ms"] = rows[0]["bwd_ms"]
    entry["launches"] = None
    return entry


# --------------------------------------------------------------------------

# --compare-with DIR: the decode, scan and both backward kernels of this
# checkout and of the checkout at DIR (e.g. the parent commit), timed in
# turns (DIR, this, this, DIR) on one card, each in its own process with
# its own build.  The code runs against either package: it uses only the
# wrappers' public calls, with inputs drawn from fixed seeds.
AB_CODE = r"""
import json, math, sys
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan.ops import ssd_scan

def time_ms(fn, iters):
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters

def copies(nbytes):
    return max(1, min(16, math.ceil(3 * 50 * 2**20 / nbytes)))

dev = torch.device("cuda")
out = {"decode": {}, "ssd": {}}
for name, (b, s, h, kv, d), lens in (
        ("serve_ragged", (16, 577, 24, 8, 128), None),
        ("serve_main_occupancy", (16, 577, 24, 8, 128),
         [0] * 13 + [512, 545, 577]),
        ("serve_one_row", (16, 577, 24, 8, 128), [1] * 16),
        ("serve_full", (16, 577, 24, 8, 128), [577] * 16),
        ("zamba_ragged", (16, 577, 32, 32, 64), None)):
    g = torch.Generator().manual_seed(21)
    q = torch.randn((b, h, d), generator=g).bfloat16().to(dev)
    k = torch.randn((b, s, kv, d), generator=g).bfloat16()
    v = torch.randn((b, s, kv, d), generator=g).bfloat16()
    if lens is None:
        ln = torch.randint(1, s + 1, (b,), generator=g, dtype=torch.int32)
        ln[0], ln[-1] = 0, s
    else:
        ln = torch.tensor(lens, dtype=torch.int32)
    ln = ln.to(dev)
    n = copies(2 * k.numel() * 2)
    ks = [k.to(dev) for _ in range(n)]
    vs = [v.to(dev) for _ in range(n)]
    out["decode"][name] = time_ms(lambda i: decode_attention(
        q, ks[i % n], vs[i % n], ln, impl="cuda"), 100)
for name, n_state in (("mamba", 128), ("zamba", 64)):
    g = torch.Generator().manual_seed(22)
    b, l, h, p = 16, 512, 64, 64
    x = (torch.randn((b, l, h, p), generator=g) * 0.5).bfloat16()
    dt = torch.randn((b, l, h), generator=g).abs() * 0.1 + 0.01
    A = -torch.randn(h, generator=g).abs() - 0.1
    B = (torch.randn((b, l, 1, n_state), generator=g) * 0.3).bfloat16()
    C = (torch.randn((b, l, 1, n_state), generator=g) * 0.3).bfloat16()
    args = [t.to(dev) for t in (x, dt, A, B, C)]
    n = copies(sum(t.numel() * t.element_size() for t in args))
    sets = [[t.clone() for t in args] for _ in range(n)]
    out["ssd"][name] = time_ms(lambda i: ssd_scan(*sets[i % n], chunk=128,
                                                 impl="cuda"), 20)
# The flash backward at llama3.2-3b's training shape, on each checkout's
# own route (the key names it: "mma" before the wgmma kernels, "wgmma" after).
g = torch.Generator().manual_seed(23)
b, s, h, kv, d = 1, 4096, 24, 8, 128
q, do = (torch.randn((b, s, h, d), generator=g).bfloat16().to(dev)
         for _ in range(2))
k, v = (torch.randn((b, s, kv, d), generator=g).bfloat16().to(dev)
        for _ in range(2))
o, lse = flash_ops._flash_attention_cuda(q, k, v, True, 0, d ** -0.5,
                                         with_lse=True)
route = flash_ops.kernel_for_bwd(q.dtype, d)
out["flash_bwd"] = {"llama_train " + route: time_ms(
    lambda i: flash_ops._flash_attention_bwd_cuda(q, k, v, o, lse, do, True,
                                                  0, d ** -0.5), 10)}
# The scan backward (K4b) at mamba2-1.3b's training shape, keyed likewise by
# each checkout's route ("simt" before the tensor-core route, "tc" after).
from repro_torch.kernels.ssd_scan import ops as ssd_ops
g = torch.Generator().manual_seed(24)
b, l, h, p, n = 1, 4096, 64, 64, 128
sets = []
for _ in range(4):
    x = (torch.randn((b, l, h, p), generator=g) * 0.5).bfloat16()
    dt = torch.randn((b, l, h), generator=g).abs() * 0.1 + 0.01
    A = -torch.randn(h, generator=g).abs() - 0.1
    B = (torch.randn((b, l, 1, n), generator=g) * 0.3).bfloat16()
    C = (torch.randn((b, l, 1, n), generator=g) * 0.3).bfloat16()
    dy = torch.randn((b, l, h, p), generator=g).bfloat16()
    sets.append([t.to(dev) for t in (x, dt, A, B, C, dy)])
route = ssd_ops.kernel_for_bwd(torch.bfloat16, p, n, 128)
out["ssd_bwd"] = {"mamba_train " + route: time_ms(
    lambda i: ssd_ops._ssd_scan_bwd_cuda(*sets[i % 4], None, 128),
    20 if route == "tc" else 5)}
print(json.dumps(out))
"""


def compare_kernels(other: str) -> dict:
    """``--compare-with``: the kernel times of ``other`` and of this
    checkout, in turns (other, this, this, other), on one card."""
    runs = []
    for label, root in (("other", other), ("this", ROOT), ("this", ROOT),
                        ("other", other)):
        proc = subprocess.run([sys.executable, "-c", AB_CODE,
                               os.path.abspath(root)], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"kernel timing of {root} failed:\n"
                               f"{proc.stderr[-3000:]}")
        row = {"run": label, "root": root,
               **json.loads(proc.stdout.strip().splitlines()[-1])}
        log(json.dumps({"kernel_ab": row}))
        runs.append(row)
    return {"runs": runs}


# The new kernels' instantiations on the main paths, by mangled-name part.
PTXAS_KERNELS = {
    "decode_attention": {
        "d128 g<=4": "decode_kernelI13__nv_bfloat16Li128ELi4ELb1E",
        "d64 g<=4": "decode_kernelI13__nv_bfloat16Li64ELi4ELb1E"},
    "ssd_scan": {"n128 q128": "ssd_scan_tc_kernelILi128ELi128E",
                 "n64 q128": "ssd_scan_tc_kernelILi64ELi128E",
                 "bwd chunk bf16": "ssd_bwd_chunk_kernelI13__nv_bfloat16E",
                 "bwd state bf16": "ssd_bwd_state_kernelI13__nv_bfloat16E",
                 "bwd cb bf16": "ssd_bwd_cb_kernelI13__nv_bfloat16E",
                 "bwd tc local n128 q128": "ssd_bwd_tc_local_kernelILi128ELi128E",
                 "bwd tc chunk n128 q128": "ssd_bwd_tc_chunk_kernelILi128ELi128E",
                 "bwd tc dbdc n128 q128": "ssd_bwd_tc_dbdc_kernelILi128ELi128E",
                 "bwd tc local n64 q128": "ssd_bwd_tc_local_kernelILi64ELi128E",
                 "bwd tc chunk n64 q128": "ssd_bwd_tc_chunk_kernelILi64ELi128E",
                 "bwd tc dbdc n64 q128": "ssd_bwd_tc_dbdc_kernelILi64ELi128E",
                 "bwd tc state n128": "ssd_bwd_tc_state_kernelILi128E"},
    "flash_attention": {
        "bwd fused wgmma d128": "flash_bwd_fused_wgmma_kernelILi128E",
        "bwd fused wgmma d64": "flash_bwd_fused_wgmma_kernelILi64E",
        "bwd dkdv f32 d16": "flash_bwd_dkdv_kernelIfLi16E",
        "bwd dq f32 d16": "flash_bwd_dq_kernelIfLi16E"}}


def ptxas_summary(name: str) -> dict:
    """Registers and spill bytes ptxas reported for the main paths'
    instantiations of kernel ``name`` (from its build log)."""
    import re

    from repro_torch.kernels import _build

    lines = _build.BUILD_LOGS.get(name, "").splitlines()
    out = {}
    for label, needle in PTXAS_KERNELS.get(name, {}).items():
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and needle in line:
                text = " ".join(lines[i + 1:i + 4])
                regs = re.search(r"Used (\d+) registers", text)
                spill = re.search(r"(\d+) bytes spill stores", text)
                out[label] = {
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None}
                break
    return out


def tensor_core_sass(libs: dict) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in each built
    library's SASS (``cuobjdump -sass``), and per function for the
    backwards' tensor-core kernels (the flash backward's fused kernel, and
    the scan backward's kernels that run a product); raises unless
    flash_attention and ssd_scan hold HGMMA, decode_attention HMMA, and
    each of those backward kernels HGMMA."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    bwd = {"flash_attention": {
               label: needle for label, needle in
               PTXAS_KERNELS["flash_attention"].items() if "mma" in label},
           "ssd_scan": {
               label: needle for label, needle in
               PTXAS_KERNELS["ssd_scan"].items()
               if label.startswith("bwd tc") and "state" not in label}}
    out, per_kernel = {}, {}
    for name, path in libs.items():
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, check=True).stdout.splitlines()
        out[name] = {op: sum(op + "." in line or op + " " in line
                             for line in sass) for op in ("HGMMA", "HMMA")}
        label = None
        for line in sass:
            if "Function :" in line:
                label = next((k for k, v in bwd.get(name, {}).items()
                              if v in line), None)
                if label:
                    per_kernel[label] = {"HGMMA": 0, "HMMA": 0}
            elif label:
                for op in ("HGMMA", "HMMA"):
                    per_kernel[label][op] += (op + "." in line
                                              or op + " " in line)
    out["flash_attention_bwd"] = {k: v for k, v in per_kernel.items()
                                  if k in bwd["flash_attention"]}
    out["ssd_scan_bwd"] = {k: v for k, v in per_kernel.items()
                           if k in bwd["ssd_scan"]}
    want = {"flash_attention": "HGMMA", "ssd_scan": "HGMMA",
            "decode_attention": "HMMA"}
    need = [k for k in bwd["flash_attention"] if "wgmma" in k] + list(
        bwd["ssd_scan"])
    if any(out[name][op] == 0 for name, op in want.items()) or any(
            per_kernel.get(k, {}).get("HGMMA", 0) == 0 for k in need):
        raise AssertionError(f"tensor-core instructions missing: {out}")
    return out


# --------------------------------------------------------------------------
# phase 20: the sharded paths on one NCCL rank

SHARD_SERVE_BATCH = 16
SHARD_SERVE_PROMPT = 512
SHARD_DECODE_STEPS = 8
SHARD_TRAIN_LAYERS = 2
SHARD_TRAIN_SEQ = 4096
SHARD_FLEET_DEVICES = 2_000


def _rel(a, b) -> float:
    """``max |a - b| / max |b|`` (f32)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _one_rank_group():
    """A one-rank NCCL process group on an in-memory store."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)  # the rank's card, before any device mesh
    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"phase 20 needs NCCL, the group runs "
                             f"{dist.get_backend()}")


def _logical_mesh(cfg, dev):
    from repro_torch.configs.base import choose_mesh_plan
    from repro_torch.distribution.sharding import derive_logical_mesh
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1, device=dev)
    return derive_logical_mesh(mesh, choose_mesh_plan(cfg, model_axis=1))


def sharded_fed_reduce(dev, card: str) -> dict:
    """(a) ``fed_reduce(mesh=make_fleet_mesh(1))`` against the call with no
    mesh at 8192 x 256, f32 and int8 with scales: bitwise expected, held to
    1e-6 relative; each call's device ms with CUDA events."""
    import torch

    from repro_torch.distribution.sharding import make_fleet_mesh
    from repro_torch.kernels.fed_reduce.ops import fed_reduce

    fleet = make_fleet_mesh(1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(20)
    n, d = COHORT, LEAF_WIDTHS[0]
    w = torch.rand(n, generator=gen, device=dev)
    out, launches = {}, 0
    for name, stack, scales in (
            ("float32", torch.randn((n, d), generator=gen, device=dev), None),
            ("int8", torch.randint(-127, 128, (n, d), generator=gen,
                                   device=dev, dtype=torch.int8),
             torch.rand(n, generator=gen, device=dev) / 127)):
        plain = fed_reduce(stack, w, scales=scales)
        fed_reduce.launches = 0
        meshed = fed_reduce(stack, w, scales=scales, mesh=fleet)
        torch.cuda.synchronize()
        launches += fed_reduce.launches
        if fed_reduce.launches != 1:
            raise AssertionError(f"fed_reduce(mesh=) launched K1 "
                                 f"{fed_reduce.launches} times, expected 1")
        err = _rel(meshed, plain)
        row = {"dtype": name, "rows": n, "width": d,
               "bitwise_equal": bool(torch.equal(meshed, plain)),
               "max_rel_err": err, "limit": 1e-6,
               "ms_mesh": time_ms(lambda i: fed_reduce(stack, w,
                                                       scales=scales,
                                                       mesh=fleet)),
               "ms_no_mesh": time_ms(lambda i: fed_reduce(stack, w,
                                                          scales=scales)),
               "card": card}
        log(json.dumps({"sharded_fed_reduce": row}))
        if not err <= 1e-6:
            raise AssertionError(f"fed_reduce(mesh=) [{name}] off by {err}")
        out[name] = row
    return {"rows": out, "launches": launches}


def sharded_fleet_rounds(dev) -> dict:
    """(b) federated rounds at 2 000 devices with the service and both
    tiers on ``make_fleet_mesh(1)`` against the same rounds with no mesh:
    the virtual timeline and the params equal."""
    import numpy as np

    from repro_torch.configs.avazu_lr import CONFIG
    from repro_torch.distribution.sharding import make_fleet_mesh
    from repro_torch.kernels.fed_reduce.ops import fed_reduce

    kw = dict(dim=CONFIG.dim, cohort=512, rounds=2, verbose=False)
    plain = run_slice(dev, SHARD_FLEET_DEVICES, **kw)
    fed_reduce.launches = 0
    meshed = run_slice(dev, SHARD_FLEET_DEVICES,
                       mesh=make_fleet_mesh(1, device=dev), **kw)
    launches = fed_reduce.launches
    report = {}
    for wire, a in meshed["wires"].items():
        b = plain["wires"][wire]
        same = {
            "timeline": (a["aggregations"] == b["aggregations"]
                         and a["bytes"] == b["bytes"]
                         and a["dispatched"] == b["dispatched"]
                         and all(np.array_equal(x, y) for x, y in
                                 zip(a["arrivals"], b["arrivals"]))),
            "params": all(np.array_equal(pa[k], pb[k])
                          for pa, pb in zip(a["params"], b["params"])
                          for k in pa)}
        report[wire] = same
        log(f"fleet-sharded rounds [{wire}, {SHARD_FLEET_DEVICES} devices, "
            f"make_fleet_mesh(1)]: timeline equal {same['timeline']}, "
            f"params bitwise equal {same['params']}")
        if not all(same.values()):
            raise AssertionError(f"fleet-sharded rounds [{wire}]: {same}")
    want = sum(w["audit"].expected for w in meshed["wires"].values())
    log(f"fleet-sharded rounds: fed_reduce launches {launches} "
        f"(expected {want})")
    if launches != want or launches <= 0:
        raise AssertionError(f"fleet-sharded rounds launched K1 {launches} "
                             f"times, expected {want}")
    return {"wires": report, "launches": launches}


def sharded_serving(dev, card: str) -> dict:
    """(c) llama3.2-3b at full width and depth: one prefill of 16 x 512 and
    8 greedy decode steps through ``build_prefill_step`` and
    ``build_serve_step`` on a (1, 1) logical mesh, against ``prefill`` and
    ``decode_step`` from the same weights: logits within 2e-2 relative,
    greedy tokens equal."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distribution.steps import (build_prefill_step,
                                                build_serve_step,
                                                place_params)
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.models import transformer

    cfg = get_config(SERVE_ARCH)
    b, s, steps = SHARD_SERVE_BATCH, SHARD_SERVE_PROMPT, SHARD_DECODE_STEPS
    max_len = s + steps
    params = transformer.init(
        torch.Generator(device=dev).manual_seed(SERVE_SEED), cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device=dev, dtype=torch.int32)

    def greedy(logits):
        return logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)

    with torch.no_grad():
        logits, cache = transformer.prefill(params, prompts, cfg, max_len)
        plain_logits, plain_tokens = [logits.float().cpu()], []
        for _ in range(steps):
            tok = greedy(logits)
            plain_tokens.append(tok.cpu())
            logits, cache = transformer.decode_step(params, tok, cfg, cache)
            plain_logits.append(logits.float().cpu())
    del cache
    lmesh = _logical_mesh(cfg, dev)
    shape = ShapeConfig("serve", max_len, b, "decode")
    prefill_step = build_prefill_step(cfg, lmesh, shape)[0]
    serve_step = build_serve_step(cfg, lmesh, shape)[0]
    placed = place_params(params, cfg, lmesh)
    _zero_flash_counters()
    decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_step(placed, prompts)
    got_logits, got_tokens = [logits.full_tensor().float().cpu()], []
    for _ in range(steps):
        tok = greedy(logits.full_tensor())
        got_tokens.append(tok.cpu())
        logits, cache = serve_step(placed, cache, tok)
        got_logits.append(logits.full_tensor().float().cpu())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**_flash_counters(),
                "decode_attention": decode_attention.launches}
    err = max(_rel(a, b_) for a, b_ in zip(got_logits, plain_logits))
    same = all(torch.equal(a, b_) for a, b_ in zip(got_tokens, plain_tokens))
    row = {"arch": SERVE_ARCH, "layers": cfg.num_layers, "batch": b,
           "prompt": s, "decode_steps": steps, "max_rel_err": err,
           "limit": 2e-2, "tokens_equal": same, "launches": launches,
           "wall_s": wall, "card": card}
    log(json.dumps({"sharded_serving": row}))
    want = {"flash_attention_wgmma": cfg.num_layers,
            "decode_attention": cfg.num_layers * steps}
    if not (err <= 2e-2 and same):
        raise AssertionError(f"sharded serving off: {row}")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"sharded serving launched {launches}, "
                             f"expected {want}")
    del placed, params, cache
    free_cycles()
    return row


def _train_batch(cfg, shape, dev):
    import numpy as np
    import torch

    from repro_torch.data.tokens import TokenPipeline

    bt = next(TokenPipeline(cfg.vocab_size, shape.seq_len, shape.global_batch,
                            seed=0))
    n, mb = shape.microbatches, shape.global_batch // shape.microbatches
    return {k: torch.from_numpy(np.ascontiguousarray(
        getattr(bt, k).reshape(n, mb, -1))).to(dev)
        for k in ("tokens", "targets", "mask")}


def sharded_training(dev, arch: str, card: str, steps: int = 2) -> dict:
    """(d, e) ``arch`` at full width and 2 layers: ``steps`` steps through
    ``build_train_step(cfg, lmesh)`` on a (1, 1) mesh against
    ``build_train_step(cfg, None)`` from the same seed and batch: loss,
    grad norm and updated leaves within 2e-2 relative (bitwise expected);
    each path's wall s per step."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distribution.steps import (build_train_step, gather,
                                                init_train_state,
                                                place_train_state)
    from repro_torch.optim.optimizers import tree_leaves

    cfg = dataclasses.replace(get_config(arch), num_layers=SHARD_TRAIN_LAYERS)
    shape = ShapeConfig("train_4k_x", SHARD_TRAIN_SEQ, 2, "train",
                        microbatches=2)
    batch = _train_batch(cfg, shape, dev)
    runs = {}
    for path in ("plain", "sharded"):
        state = init_train_state(cfg, seed=0, device=dev)
        lmesh = _logical_mesh(cfg, dev) if path == "sharded" else None
        if lmesh is not None:
            state = place_train_state(state, cfg, lmesh)
        step = build_train_step(cfg, lmesh, shape)[0]
        _zero_counters()
        metrics, walls = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            walls.append(time.perf_counter() - t)
        params = [t.float().cpu() for t in tree_leaves(
            gather(state["params"]) if lmesh is not None
            else state["params"])]
        runs[path] = (metrics, walls, params, _counters())
        del state, step
        free_cycles()
    (mp, wp, pp, _), (ms, ws, ps, launches) = runs["plain"], runs["sharded"]
    metric_err = max(abs(a - b) / abs(b) for x, y in zip(ms, mp)
                     for a, b in zip(x, y))
    leaf_err = max(_rel(a, b) for a, b in zip(ps, pp))
    row = {"arch": arch, "layers": cfg.num_layers, "seq": SHARD_TRAIN_SEQ,
           "microbatches": shape.microbatches, "steps": steps,
           "loss_grad_norm": {"sharded": ms, "plain": mp},
           "metric_max_rel_err": metric_err, "leaf_max_rel_err": leaf_err,
           "limit": 2e-2,
           "bitwise_equal": metric_err == 0.0 and leaf_err == 0.0,
           "wall_s_per_step": {"sharded": ws, "plain": wp},
           "launches": launches, "card": card}
    log(json.dumps({"sharded_training": row}))
    if not (metric_err <= 2e-2 and leaf_err <= 2e-2):
        raise AssertionError(f"sharded training [{arch}] off: {row}")
    L, n = cfg.num_layers, shape.microbatches
    want = {"flash_attention_wgmma": 2 * L * n * steps,
            "flash_attention_bwd": L * n * steps}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"sharded training [{arch}] launched "
                             f"{launches}, expected {want}")
    return row


def sharded_moe_prefill(dev, card: str) -> dict:
    """(e) granite-moe at full width and 2 layers: a prefill of 4 x 512
    through ``build_prefill_step`` (the expert-parallel block of
    ``make_moe_sharded``) against ``prefill`` (``moe_apply``): logits within
    2e-2 relative."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distribution.steps import build_prefill_step, place_params
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              num_layers=SHARD_TRAIN_LAYERS)
    b, s = 4, SHARD_SERVE_PROMPT
    params = transformer.init(
        torch.Generator(device=dev).manual_seed(SERVE_SEED), cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(22), dtype=torch.int32)
    with torch.no_grad():
        plain, _ = transformer.prefill(params, prompts, cfg, s)
    lmesh = _logical_mesh(cfg, dev)
    step = build_prefill_step(cfg, lmesh, ShapeConfig("p", s, b, "prefill"))[0]
    _zero_flash_counters()
    got, _ = step(place_params(params, cfg, lmesh), prompts)
    got = got.full_tensor()
    err = _rel(got, plain)
    row = {"arch": MOE_ARCH, "layers": cfg.num_layers, "batch": b,
           "prompt": s, "max_rel_err": err, "limit": 2e-2,
           "bitwise_equal": bool(torch.equal(got, plain)),
           "launches": _flash_counters(), "card": card}
    log(json.dumps({"sharded_moe_prefill": row}))
    if not err <= 2e-2:
        raise AssertionError(f"sharded MoE prefill off: {row}")
    del params
    free_cycles()
    return row


# Phase 20's tensor-parallel checks: K2p (the decode kernel's partial output) on
# rank blocks of llama3.2-3b's decode cache, the scan kernels on the heads
# one tensor-parallel rank holds, the SSM, hybrid and audio families through
# the tensor-parallel steps, and a sequence-split decode across two ranks.
K2P_CASE = DECODE_SERVE  # 16 sequences x 24 heads of 128, 577 x 8 x 128
K2P_BLOCKS = (2, 4)
K2P_REPLACES = "src/repro/kernels/decode_attention/decode_attention.py:31"
# (b, l, h, p, g, n, chunk): mamba2-1.3b's and zamba2-1.2b's scans on the
# 4 and 2 of their 64 heads a rank holds at tp = 16 and 32.
SSD_TP_CASES = [(2, 512, h, 64, 1, n, 128) for n in (128, 64) for h in (4, 2)]
SHARD_FAMILIES = ("mamba2_1_3b", "zamba2_1_2b", "seamless_m4t_medium")
SHARD_FAMILY_BATCH = 4
SHARD_FAMILY_PROMPT = 256
SHARD_FAMILY_SEQ = 1024  # the 2 train steps' sequence
# The sequence-split decode: llama3.2-3b at full width and 2 layers, the
# cache's 576 rows split over sp = 2 ranks (two processes on the card, a
# gloo group: its collectives here are the combine's two all-reduces).  The
# prompt stops 4 rows short of rank 1's block, so its first 4 decode steps
# find that block empty.
SEQ_SPLIT_RANKS = 2
SEQ_SPLIT_LEN = 576
SEQ_SPLIT_PROMPT = SEQ_SPLIT_LEN // SEQ_SPLIT_RANKS - 4


def _blocks(s: int, n: int) -> list:
    """``(start, size)`` of n contiguous blocks covering s rows (the first
    ``s % n`` one row longer)."""
    base, extra = divmod(s, n)
    out, start = [], 0
    for r in range(n):
        size = base + (r < extra)
        out.append((start, size))
        start += size
    return out


def k2p_cases(dev, card: str) -> dict:
    """K2p against its plain version at llama3.2-3b's decode shape, f32 and
    bf16, the cache cut into 2 and 4 rank blocks: each block's o, m and l
    (rows with keys) within 3e-5 (f32) or 2e-2 (bf16) of the plain
    version's largest entry (o is an unnormalised sum: the kernel's bf16
    rounding of q * scale, which the plain partial leaves out, moves it by
    ~0.5 % of its scale, not of each entry), blocks past a sequence's
    length exactly (0, NEG_INF, 0), two launches bitwise equal, one launch
    counted per call; the blocks' states combined (``combine_partials``)
    against the whole-cache decode kernel (|err| <= tol (1 + |whole|)).  Timed at bf16 on one of 2 blocks against the
    whole-cache kernel, the plain version and SDPA on that block."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ref
    from repro_torch.kernels.decode_attention.ops import (
        combine_partials, decode_attention, decode_attention_partial)
    from repro_torch.roofline import op_analysis as oa

    b, s, h, kv, d = K2P_CASE
    gen = torch.Generator().manual_seed(24)
    errs, rows, timed = [], [], None
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((b, h, d), generator=gen).to(dtype).to(dev)
        kc = torch.randn((b, s, kv, d), generator=gen).to(dtype).to(dev)
        vc = torch.randn((b, s, kv, d), generator=gen).to(dtype).to(dev)
        lens = torch.randint(1, s + 1, (b,), generator=gen, dtype=torch.int32)
        lens[0], lens[1], lens[-1] = 0, 100, s  # empty, one block, full
        lens = lens.to(dev)
        whole = decode_attention(q, kc, vc, lens, impl="cuda")
        tol = _attn_tol(dtype)
        for n in K2P_BLOCKS:
            parts, empty_rows, block_rel = [], 0, 0.0
            for r, (start, size) in enumerate(_blocks(s, n)):
                kb = kc[:, start:start + size].contiguous()
                vb = vc[:, start:start + size].contiguous()
                lb = (lens - start).clamp(0, size).to(torch.int32)
                name = f"K2p{K2P_CASE} {_dtype_name(dtype)} block {r}/{n}"
                l0 = decode_attention_partial.launches
                got = decode_attention_partial(q, kb, vb, lb, impl="cuda")
                again = decode_attention_partial(q, kb, vb, lb, impl="cuda")
                plain = ref.decode_attention_partial(q, kb, vb, lb)
                torch.cuda.synchronize()
                if decode_attention_partial.launches - l0 != 2:
                    raise AssertionError(f"{name}: 2 calls counted "
                                         f"{decode_attention_partial.launches - l0}")
                if not all(torch.equal(a, c) for a, c in zip(got, again)):
                    raise AssertionError(f"{name} is not repeatable")
                full = lb > 0
                for part, a, w in zip("oml", got, plain):
                    rel = _rel_to_max(a[full], w[full])
                    if not rel <= tol:
                        raise AssertionError(f"{name} {part} disagrees with "
                                             f"its plain version: {rel:.3e} "
                                             f"of its largest entry")
                    block_rel = max(block_rel, rel)
                o, m, l = (t[~full] for t in got)
                empty_rows += int((~full).sum())
                if o.any() or l.any() or not bool((m == ref.NEG_INF).all()):
                    raise AssertionError(f"{name}: an empty block is not "
                                         f"(0, NEG_INF, 0)")
                parts.append(got)
            out = combine_partials(*(torch.stack(x) for x in zip(*parts)),
                                   out_dtype=dtype)
            err = _check_close(f"K2p combined over {n} blocks "
                               f"{_dtype_name(dtype)}", out, whole, dtype)
            errs.append(err)
            row = {"case": list(K2P_CASE), "dtype": _dtype_name(dtype),
                   "blocks": n, "combined_vs_whole_max_abs_err": err,
                   "block_max_rel_err": block_rel,
                   "limit": tol, "empty_block_rows": empty_rows,
                   "bitwise_repeatable": True, "card": card}
            if dtype == torch.bfloat16 and n == 2:
                start, size = _blocks(s, n)[0]
                kb = kc[:, start:start + size].contiguous()
                vb = vc[:, start:start + size].contiguous()
                lb = (lens - start).clamp(0, size).to(torch.int32)
                nc = _copies(2 * kb.numel() * kb.element_size())
                ks = [kb.clone() for _ in range(nc)]
                vs = [vb.clone() for _ in range(nc)]
                kts = [k.transpose(1, 2).contiguous() for k in ks]
                vts = [v.transpose(1, 2).contiguous() for v in vs]
                mask = (torch.arange(size, device=dev)[None] < lb[:, None])[
                    :, None, None, :]
                t = {"ms": time_ms(lambda i: decode_attention_partial(
                        q, ks[i % nc], vs[i % nc], lb, impl="cuda"), 100),
                     "whole_cache_ms": time_ms(lambda i: decode_attention(
                         q, kc, vc, lens, impl="cuda"), 100),
                     "plain_ms": time_ms(lambda i: ref.decode_attention_partial(
                         q, ks[i % nc], vs[i % nc], lb), 10),
                     # SDPA on the block: the same attention, normalised
                     # (no PyTorch call returns the (m, l) state).
                     "library_ms": time_ms(lambda i: F.scaled_dot_product_attention(
                         q[:, :, None], kts[i % nc], vts[i % nc],
                         attn_mask=mask, enable_gqa=True), 100)}
                t.update(oa.bound(oa.decode_attention_work(
                    b, h, kv, d, 2, oa.decode_rows(lb, size), partial=True),
                    BF16_FLOPS))
                t["bound_share"] = t["bound_ms"] / t["ms"]
                t["block_rows"] = size
                row.update(t)
                timed = row
                del ks, vs, kts, vts
            rows.append(row)
            log(json.dumps({"decode_attention_partial_case": row}))
    entry = _timed_entry("decode_attention_partial", DECODE_SOURCE,
                         K2P_REPLACES, errs, timed)
    entry["kernel"] = DECODE_KERNEL + ", partial output"
    return entry


def ssd_tp_cases(dev) -> float:
    """The forward scan kernel and K4b on the 4 and 2 SSM heads a
    tensor-parallel rank holds (mamba2-1.3b's and zamba2-1.2b's n), bf16
    and f32, each against its plain version (``ssd_bwd_case``: phase 7's
    and 18's limits); returns the largest relative error."""
    import torch

    gen = torch.Generator().manual_seed(25)
    worst = 0.0
    for case in SSD_TP_CASES:
        for dtype in ("bfloat16", "float32"):
            row, _ = ssd_bwd_case(dev, gen, case, dtype)
            row["tensor_parallel_heads"] = case[2]
            log(json.dumps({"ssd_scan_tp_case": row}))
            worst = max(worst, row["max_rel_err"])
    return worst


SEQ_SPLIT_CODE = r"""
import datetime, json, os, sys
root, rank, world, store, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
sys.path.insert(0, os.path.join(root, "src"))
import dataclasses
import torch
import torch.distributed as dist
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=300))
from repro_torch.configs.base import MeshPlan, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.distribution.sharding import derive_logical_mesh
from repro_torch.distribution.steps import build_serve_step, place, place_params
from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_partial
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer
arch, layers, seed, b, prompt, max_len, steps = json.loads(sys.argv[6])
dev = torch.device("cuda")
lmesh = derive_logical_mesh(make_host_mesh(1, world, device="cuda"),
                            MeshPlan(tp=1, sp=world))
res = {"rank": rank, "rows": {}, "launches": 0}
for dtype in ("bfloat16", "float32"):
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)
    params = transformer.init(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (b, prompt), device=dev, dtype=torch.int32,
                            generator=torch.Generator(device=dev).manual_seed(seed + 1))
    with torch.no_grad():
        logits, cache = transformer.prefill(params, prompts, cfg, max_len)
        placed_cache = place({"k": cache["k"].clone(), "v": cache["v"].clone(),
                              "pos": cache["pos"]},
                             build_serve_step(cfg, lmesh, ShapeConfig(
                                 "d", max_len, b, "decode"))[1][1])
        toks, want = [], []
        for _ in range(steps):
            tok = logits[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
            toks.append(tok)
            logits, cache = transformer.decode_step(params, tok, cfg, cache)
            want.append(logits.float())
    del cache
    step = build_serve_step(cfg, lmesh, ShapeConfig("d", max_len, b, "decode"))[0]
    placed = place_params(params, cfg, lmesh)
    decode_attention.launches = decode_attention_partial.launches = 0
    torch.cuda.synchronize()
    import time
    t0 = time.perf_counter()
    cache, got = placed_cache, []
    for tok in toks:  # the unsharded path's tokens, teacher-forced
        logits, cache = step(placed, cache, tok)
        got.append(logits.to_local().float())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
    same = [bool(torch.equal(g[:, :cfg.vocab_size].argmax(-1), w[:, :cfg.vocab_size].argmax(-1)))
            for g, w in zip(got, want)]
    res["rows"][dtype] = {"max_rel_err": err, "limit": 2e-2 if dtype == "bfloat16" else 1e-4,
                          "greedy_tokens_equal_per_step": same,
                          "k2p_launches": decode_attention_partial.launches,
                          "k2_launches": decode_attention.launches, "wall_s": wall}
    res["launches"] += decode_attention_partial.launches
    del params, placed, placed_cache, cache
    torch.cuda.empty_cache()
with open(out, "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def start_seq_split(tmp: str) -> list:
    """The sequence-split decode's ranks, one process each on the card,
    started together (each ~8 s to reach the card)."""
    store = os.path.join(tmp, "seq_split_store")
    spec = json.dumps([SERVE_ARCH, SHARD_TRAIN_LAYERS, SERVE_SEED,
                       SERVE_SLOTS, SEQ_SPLIT_PROMPT, SEQ_SPLIT_LEN,
                       SHARD_DECODE_STEPS])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return [subprocess.Popen(
        [sys.executable, "-c", SEQ_SPLIT_CODE, ROOT, str(r),
         str(SEQ_SPLIT_RANKS), store, os.path.join(tmp, f"seq_split_{r}.json"),
         spec], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(SEQ_SPLIT_RANKS)]


def finish_seq_split(procs: list, tmp: str, card: str) -> dict:
    """Waits for the ranks (killing them past 300 s); each rank's 8 decode
    steps through ``build_serve_step`` at sp = 2 must match the unsharded
    decode (teacher-forced with its tokens) within 2e-2 (bf16) and 1e-4
    (f32) relative, and launch K2p once per layer and step and K2 never."""
    texts = []
    for proc in procs:
        try:
            text, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            text, _ = proc.communicate()
        texts.append(text)
    ranks = []
    for r, (proc, text) in enumerate(zip(procs, texts)):
        path = os.path.join(tmp, f"seq_split_{r}.json")
        if proc.returncode != 0 or not os.path.exists(path):
            raise AssertionError(f"sequence-split decode rank {r} failed "
                                 f"(exit {proc.returncode}): {text[-3000:]}")
        with open(path) as f:
            ranks.append(json.load(f))
    want = SHARD_TRAIN_LAYERS * SHARD_DECODE_STEPS
    for res in ranks:
        for dtype, row in res["rows"].items():
            if not (row["max_rel_err"] <= row["limit"]
                    and row["k2p_launches"] == want
                    and row["k2_launches"] == 0):
                raise AssertionError(f"sequence-split decode rank "
                                     f"{res['rank']} [{dtype}] off: {row}")
    out = {"arch": SERVE_ARCH, "layers": SHARD_TRAIN_LAYERS,
           "ranks": SEQ_SPLIT_RANKS, "plan": "tp 1, sp 2 (gloo, one card)",
           "batch": SERVE_SLOTS, "cache_rows": SEQ_SPLIT_LEN,
           "prompt": SEQ_SPLIT_PROMPT, "decode_steps": SHARD_DECODE_STEPS,
           "per_rank": ranks, "launches": sum(r["launches"] for r in ranks),
           "card": card}
    log(json.dumps({"sequence_split_decode": out}))
    return out


def sharded_family(dev, arch: str, card: str) -> dict:
    """``arch`` at its published width and 2 layers (seamless: 2 encoder
    layers too) through the tensor-parallel steps on a (1, 1) mesh against
    the unsharded functions from the same weights and inputs: a prefill of
    4 x 256, 8 decode steps fed the unsharded path's greedy tokens, and 2
    train steps of 2 x 1024 tokens; logits, loss, grad norm and updated
    leaves must be bitwise equal."""
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distribution.steps import (
        build_prefill_step, build_serve_step, build_train_step, gather,
        init_train_state, place_params, place_train_state)
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizers import tree_leaves

    base = get_config(arch)
    cfg = dataclasses.replace(base, num_layers=SHARD_TRAIN_LAYERS, **(
        {"num_encoder_layers": SHARD_TRAIN_LAYERS}
        if base.family == "audio" else {}))
    api = get_model(cfg)
    b, s, steps = SHARD_FAMILY_BATCH, SHARD_FAMILY_PROMPT, SHARD_DECODE_STEPS
    max_len = s + steps
    gen = torch.Generator(device=dev).manual_seed(26)
    params = api.init(torch.Generator(device=dev).manual_seed(SERVE_SEED),
                      cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=dev, dtype=torch.int32)
    # The audio source fills its cross cache (max_len frames).
    args = ((torch.randn((b, max_len, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16), toks)
            if cfg.family == "audio" else (toks,))
    from repro_torch.kernels.decode_attention.ops import decode_attention

    def zero():
        _zero_counters()
        decode_attention.launches = 0

    def counters():
        return {**_counters(), "decode_attention": decode_attention.launches}

    lmesh = _logical_mesh(cfg, dev)
    zero()
    with torch.no_grad():
        logits, cache = api.prefill(params, *args, cfg, max_len)
        want, tokens = [logits], []
        for _ in range(steps):
            tokens.append(logits[:, :cfg.vocab_size].argmax(-1).to(
                torch.int32))
            logits, cache = api.decode_step(params, tokens[-1], cfg, cache)
            want.append(logits)
    plain_launches = counters()
    del cache
    shape = ShapeConfig("serve", max_len, b, "decode")
    placed = place_params(params, cfg, lmesh)
    zero()
    logits, cache = build_prefill_step(cfg, lmesh, shape)[0](placed, *args)
    got = [logits.full_tensor()]
    serve = build_serve_step(cfg, lmesh, shape)[0]
    for tok in tokens:
        logits, cache = serve(placed, cache, tok)
        got.append(logits.full_tensor())
    torch.cuda.synchronize()
    serve_launches = counters()
    serve_equal = all(torch.equal(a, c) for a, c in zip(got, want))
    serve_err = max(_rel(a, c) for a, c in zip(got, want))
    del placed, params, cache, got, want
    free_cycles()
    tshape = ShapeConfig("train_x", SHARD_FAMILY_SEQ, 2, "train",
                         microbatches=2)
    batch = _train_batch(cfg, tshape, dev)
    if cfg.family == "audio":
        batch["src_embeds"] = torch.randn(
            (2, 1, SHARD_FAMILY_SEQ, cfg.d_model), generator=gen,
            device=dev).to(torch.bfloat16)
    runs = {}
    for path in ("plain", "sharded"):
        state = init_train_state(cfg, seed=0, device=dev)
        lm = lmesh if path == "sharded" else None
        if lm is not None:
            state = place_train_state(state, cfg, lm)
        step = build_train_step(cfg, lm, tshape)[0]
        zero()
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        leaves = [t.float().cpu() for t in tree_leaves(
            gather(state["params"]) if lm is not None else state["params"])]
        runs[path] = (metrics, leaves, counters())
        del state, step
        free_cycles()
    (mp_, lp, _), (ms_, ls, train_launches) = runs["plain"], runs["sharded"]
    train_equal = mp_ == ms_ and all(torch.equal(a, c)
                                     for a, c in zip(ls, lp))
    row = {"arch": arch, "family": cfg.family, "layers": cfg.num_layers,
           "plan": str(lmesh.plan), "batch": b, "prompt": s,
           "decode_steps": steps, "serve_bitwise_equal": serve_equal,
           "serve_max_rel_err": serve_err, "train_seq": SHARD_FAMILY_SEQ,
           "loss_grad_norm": {"sharded": ms_, "plain": mp_},
           "train_bitwise_equal": train_equal,
           "launches": {"serve": serve_launches, "serve_plain": plain_launches,
                        "train": train_launches}, "card": card}
    log(json.dumps({"sharded_family": row}))
    if not (serve_equal and train_equal):
        raise AssertionError(f"sharded {arch} is not bitwise equal to "
                             f"unsharded: {row}")
    if serve_launches != plain_launches:
        raise AssertionError(f"sharded {arch} serving launched "
                             f"{serve_launches}, unsharded {plain_launches}")
    # Each SSM layer's two convs: once in the prefill; in training twice a
    # microbatch forward (the recomputation) and once backward, 2 steps.
    convs = 2 * cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    micro = 2 * tshape.microbatches
    want = {"serve": {"causal_conv": convs, "causal_conv_bwd": 0},
            "train": {"causal_conv": 2 * micro * convs,
                      "causal_conv_bwd": micro * convs}}
    got = {k: {c: row["launches"][k][c] for c in want[k]} for k in want}
    if got != want:
        raise AssertionError(f"sharded {arch}: causal_conv calls {got}, "
                             f"expected {want}")
    return row


def sharded_phase(dev, card: str) -> dict:
    """Phase 20: the sharded paths (fleet-sharded ``fed_reduce`` and
    rounds, DTensor-placed serving and training, the expert-parallel MoE,
    and the SSM, hybrid and audio families through the tensor-parallel
    steps) on a one-rank NCCL group, each against its unsharded path; K2p
    and the scan kernels at a tensor-parallel rank's shapes against their
    plain versions; and the sequence-split decode on two ranks, the only
    path here with communication between ranks (two processes sharing the
    card).  One rank shows the sharded paths equal to the unsharded ones
    and nothing more: no communication between cards, no sharded
    scaling."""
    import tempfile

    _one_rank_group()
    k2p = k2p_cases(dev, card)
    ssd_tp = ssd_tp_cases(dev)
    fed = sharded_fed_reduce(dev, card)
    fleet = sharded_fleet_rounds(dev)
    serve = sharded_serving(dev, card)
    train = sharded_training(dev, TRAIN_ARCH, card)
    moe_train = sharded_training(dev, MOE_ARCH, card)
    moe = sharded_moe_prefill(dev, card)
    free_cycles()
    tmp = tempfile.mkdtemp(prefix="seq_split_")
    # The two ranks run while the families' (untimed) checks do.
    procs = start_seq_split(tmp)
    try:
        fams = {arch: sharded_family(dev, arch, card)
                for arch in SHARD_FAMILIES}
    finally:
        split = finish_seq_split(procs, tmp, card)
    k2p["launches"] = split["launches"]
    fam_flash = sum(r["launches"][k]["flash_attention_wgmma"]
                    for r in fams.values() for k in ("serve", "train"))
    fam_dec = sum(r["launches"]["serve"]["decode_attention"]
                  for r in fams.values())
    fam_ssd = sum(r["launches"][k]["ssd_scan"] for r in fams.values()
                  for k in ("serve", "train"))
    launches = {
        "fed_reduce": fed["launches"] + fleet["launches"],
        "decode_attention": serve["launches"]["decode_attention"] + fam_dec,
        "decode_attention_partial": split["launches"],
        "flash_attention_wgmma": (serve["launches"]["flash_attention_wgmma"]
                                  + train["launches"]["flash_attention_wgmma"]
                                  + moe_train["launches"][
                                      "flash_attention_wgmma"]
                                  + moe["launches"]["flash_attention_wgmma"]
                                  + fam_flash),
        "flash_attention_bwd": (train["launches"]["flash_attention_bwd"]
                                + moe_train["launches"]["flash_attention_bwd"]
                                + sum(r["launches"]["train"][
                                    "flash_attention_bwd"]
                                    for r in fams.values())),
        "ssd_scan": fam_ssd,
        "ssd_scan_bwd": sum(r["launches"]["train"]["ssd_scan_bwd"]
                            for r in fams.values()),
        # kernel launches: one a forward call, two a backward call
        "causal_conv": sum(r["launches"][k]["causal_conv"]
                           + 2 * r["launches"][k]["causal_conv_bwd"]
                           for r in fams.values()
                           for k in ("serve", "train"))}
    log(json.dumps({"sharded": {"launches": launches,
                                "ssd_tp_max_rel_err": ssd_tp,
                                "card": card}}))
    return {"launches": launches, "k2p": k2p}


# --------------------------------------------------------------------------
# phase 21: the tooling on the card

DRYRUN_CELLS = (("llama3_2_3b", "train_4k"), ("llama3_2_3b", "decode_32k"))


def card_step_analysis(step, state, expected: dict) -> dict:
    """Phase 21a on the card, inside phase 16: one more step of phase 16's
    train step (``make_cloud_step``'s ``train_step`` on the pipeline's next
    batch) under ``op_analysis.analyze``, not timed.  Its launches are
    zeroed before and read after, and must equal the audit's."""
    import torch

    from repro_torch.roofline.op_analysis import analyze

    batch = step.next_batch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    t0 = time.perf_counter()
    _, an = analyze(step.train_step, state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in _counters().items() if k in expected}
    if launches != expected:
        raise AssertionError(f"analyzed training step: launches {launches}, "
                             f"expected {expected}")
    return {"analysis": an, "launches": launches, "seconds": seconds,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "batch": {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}}


def meta_step_analysis(batch_specs: dict) -> tuple[dict, int]:
    """The unsharded llama3.2-3b step of phase 16 on the meta device under
    the analyzer, once: its first call allocates the step's f32
    accumulator (as phase 16's warm-up did; the memory tracker sees it)
    and runs the same ops as every later call.  Returns the analysis and
    the bytes of the step's arguments.  Runs in a process of its own, on
    the host's CPU, beside the rest of phase 21."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distribution.steps import (build_train_step,
                                                init_train_state)
    from repro_torch.roofline.op_analysis import analyze

    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_MICRO, "train",
                        microbatches=TRAIN_MICRO)
    meta = torch.device("meta")
    train_step, _, _ = build_train_step(cfg, None, shape)
    state = init_train_state(cfg, seed=0, device=meta)
    batch = {k: torch.empty(sh, dtype=dt, device=meta)
             for k, (sh, dt) in batch_specs.items()}
    args = sum(t.numel() * t.element_size()
               for t in (*_leaves(state), *_leaves(batch))
               if isinstance(t, torch.Tensor))
    t0 = time.perf_counter()
    _, an = analyze(train_step, state, batch)
    an["seconds"] = time.perf_counter() - t0
    return an, args


def recycle_sanitizer_check(dev, n_devices: int) -> dict:
    """Phase 21b: phase 3b's recycled f32 rounds at ``n_devices`` with the
    use-after-recycle sanitizer armed, against the same rounds unarmed:
    params, arrivals and bytes bitwise equal; a handle of a round-0 buffer,
    taken before round 1 and read after it, must raise
    ``UseAfterRecycleError``.  Each run's launches are zeroed before it and
    read after it."""
    import numpy as np

    from repro_torch.analysis import sanitizers
    from repro_torch.configs.avazu_lr import CONFIG

    stale = {}

    def on_round(sim, rnd):
        if rnd == 1:  # round 0's buffers, about to be recycled
            buf = next(b for bufs in sim._retired.values() for b in bufs)
            stale["handle"] = buf.handle(0)
        if rnd == 2:
            try:
                stale["handle"].materialize()
                stale["raised"] = False
            except sanitizers.UseAfterRecycleError:
                stale["raised"] = True

    runs, launches = {}, {}
    for armed in (True, False):
        start_audit()
        with sanitizers.override(armed):
            runs[armed] = run_slice(
                dev, n_devices, dim=CONFIG.dim, cohort=COHORT, rounds=3,
                wires=("f32",), verbose=False, recycle=True,
                on_round=on_round if armed else None)["wires"]["f32"]
        launches[armed] = read_audit()["fed_reduce"]
    a, b = runs[True], runs[False]
    same = (all(np.array_equal(x[k], y[k]) for x, y in
                zip(a["params"], b["params"]) for k in x)
            and all(np.array_equal(x, y) for x, y in
                    zip(a["arrivals"], b["arrivals"]))
            and (a["aggregations"], a["bytes"]) == (b["aggregations"],
                                                    b["bytes"]))
    log(f"recycled rounds [f32, {n_devices} devices x 3] with the "
        f"use-after-recycle sanitizer armed: params, arrivals and bytes "
        f"bitwise equal to unarmed {same}; a round-0 handle read after "
        f"round 1 raises UseAfterRecycleError {stale.get('raised')}; "
        f"fed_reduce launches {launches[True]} armed, {launches[False]} "
        f"unarmed (expected {a['audit'].expected} each)")
    if not (same and stale.get("raised")):
        raise AssertionError("the recycle sanitizer changed the rounds or "
                             "let a stale handle read")
    if not launches[True] == launches[False] == a["audit"].expected > 0:
        raise AssertionError("recycled rounds' fed_reduce launches")
    return {"bitwise_equal": same, "stale_handle_raises": True,
            "fed_reduce_launches": launches[True] + launches[False]}


def _start_dryruns(out_dir: str) -> list:
    """Phase 21c's dry runs, one process per cell, all started at once on
    the host's CPU (no card: ``CUDA_VISIBLE_DEVICES`` empty)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    return [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--out", out_dir], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cell in DRYRUN_CELLS]


def _finish_dryruns(procs: list, out_dir: str) -> dict:
    out = {}
    for (arch, shape), proc in procs:
        try:
            text, _ = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        lines = [x for x in text.splitlines()
                 if x.startswith(("PASS", "FAIL", "SKIP"))]
        log("\n".join(lines) or text[-2000:])
        path = os.path.join(out_dir, f"{arch}__{shape}__16_16.json")
        if proc.returncode != 0 or not lines or not lines[-1].startswith(
                "PASS") or not os.path.exists(path):
            raise AssertionError(f"dry run of {arch} x {shape} failed "
                                 f"(exit {proc.returncode}): {text[-2000:]}")
        with open(path) as f:
            rec = json.load(f)
        out[f"{arch} x {shape}"] = {
            "plan": rec["plan"], "seconds": rec["seconds"],
            "memory": rec["memory"], "cost_analysis": rec["cost_analysis"],
            "collective_op_counts": rec["collective_op_counts"],
            "kernels": rec["kernels"]}
    return out


def tooling_phase(dev, card: str, train: dict) -> dict:
    """Phase 21: the card step's analysis (taken in phase 16) against the
    same step traced on the meta device (flops, bytes and per-kernel work
    exactly equal), its roofline terms against phase 16's wall, the meta
    tracker's memory against the card's peak; the recycle sanitizer on the
    card (21b); the dry run of two llama3.2-3b cells at 16x16 in
    subprocesses, started first (21c)."""
    import concurrent.futures
    import multiprocessing
    import tempfile

    from repro_torch.roofline import op_analysis as oa

    os.makedirs(PROFILE_DIR, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="dryrun_torch_", dir=PROFILE_DIR)
    summary, cs = train["summary"], train["card_step"]
    card_an = cs["analysis"]
    procs = _start_dryruns(out_dir)
    meta_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        meta_run = meta_pool.submit(meta_step_analysis, cs["batch"])
        recycled = recycle_sanitizer_check(dev, 2_000)
        meta_an, args = meta_run.result(timeout=300)
        meta_s = meta_an.pop("seconds")
        keys = ("flops", "bytes", "kernels", "collective_bytes",
                "collective_count")
        equal = {k: card_an[k] == meta_an[k] for k in keys}
        kern = card_an["kernels"]
        log(f"analyzed llama3.2-3b step: card {card_an['flops']} flops, "
            f"{card_an['bytes']} bytes, kernels {kern}; meta {meta_an['flops']}"
            f" flops, {meta_an['bytes']} bytes, kernels {meta_an['kernels']} "
            f"(traced in {meta_s:.1f}s); equal {equal}")
        if not all(equal.values()):
            raise AssertionError(f"card and meta counts differ: {equal}")
        calls = {k: v["calls"] for k, v in kern.items()}
        if calls != {"flash_attention": 448, "flash_attention_bwd": 224}:
            raise AssertionError(f"analyzed kernel calls {calls}")
        wall = summary["wall_s_per_step"]
        terms = oa.roofline_terms(card_an)
        roof = {"wall_s": wall, **terms,
                "dominant": oa.dominant_term(terms),
                "flops_share": card_an["flops"] / wall / oa.PEAK_FLOPS,
                "six_n_share": summary["peak_share"],
                "memory_share": terms["memory_s"] / wall}
        log(f"roofline of the llama3.2-3b step against phase 16's "
            f"{wall:.3f} s: counted flops {card_an['flops'] / 1e12:.1f} T = "
            f"{roof['flops_share']:.3f} of 989 TFLOP/s (6N share "
            f"{roof['six_n_share']:.3f}); compute term "
            f"{terms['compute_s']:.3f} s, memory term {terms['memory_s']:.3f}"
            f" s ({card_an['bytes'] / 1e12:.2f} TB at 3.35 TB/s), "
            f"collective {terms['collective_s']:.3f} s; dominant "
            f"{roof['dominant']}")
        mem = {"meta_argument_bytes": args, "meta_temp_bytes":
               meta_an["temp_bytes"], "meta_total_bytes": args
               + meta_an["temp_bytes"], "card_peak_bytes": cs["peak_bytes"]}
        log(f"memory of the step: meta tracker arguments {args / 2**30:.2f} "
            f"GiB + temp {meta_an['temp_bytes'] / 2**30:.2f} GiB = "
            f"{mem['meta_total_bytes'] / 2**30:.2f} GiB against the card's "
            f"max_memory_allocated {cs['peak_bytes'] / 2**30:.2f} GiB")
        dry = _finish_dryruns(procs, out_dir)
    finally:
        meta_pool.shutdown(cancel_futures=True)
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    res = {"card_step_s": cs["seconds"], "meta_trace_s": meta_s,
           "counts_equal": equal, "kernels": kern, "roofline": roof,
           "memory": mem, "recycle_sanitizer": recycled, "dryrun": dry,
           "card": card}
    log(json.dumps({"tooling": res}))
    return {"launches": {"fed_reduce": recycled["fed_reduce_launches"]}}


def _tooling(dev, card: str, train: dict) -> dict:
    """Runs phase 21; its seconds are the card step's, taken inside phase
    16 (and taken out of phase 16's), and the rest's."""
    step_s = train["card_step"]["seconds"]
    PHASE_S["training phase"] -= step_s
    t0 = time.perf_counter() - step_s
    res = tooling_phase(dev, card, train)
    passed("tooling phase", t0)
    if PHASE_S["tooling phase"] > 60:
        log(f"tooling phase took {PHASE_S['tooling phase']:.1f}s, more than "
            f"its 60 s")
    return res


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=100_000)
    p.add_argument("--rounds", type=int, default=3,
                   help="rounds per wire format")
    p.add_argument("--cross-devices", type=int, default=2_000)
    p.add_argument("--benchmarking-devices", type=int, default=1,
                   help="q_i per grade (the quickstart's 1; 0 runs every "
                        "aggregation on buffer rows alone)")
    p.add_argument("--kernel-only", action="store_true",
                   help="build and check the kernels, skip the round and "
                        "serving phases")
    p.add_argument("--serving-only", action="store_true",
                   help="skip the federated-round phases (1-3)")
    p.add_argument("--scheduling-only", action="store_true",
                   help="build, then run the kernel (1), slice (2), "
                        "scheduled (13) and pooled (14) phases only")
    p.add_argument("--training-only", action="store_true",
                   help="build, then run the kernel (1), attention kernel "
                        "(4) and training (15-19) phases only")
    p.add_argument("--ssm-only", action="store_true",
                   help="build, then run the SSD kernel phase (7), zamba2's "
                        "attention shapes and the SSM phases (8-9) only")
    p.add_argument("--sharded-only", action="store_true",
                   help="build, then run the sharded phase (20) only")
    p.add_argument("--tooling-only", action="store_true",
                   help="build, then run phase 16 with its analyzed step "
                        "and the tooling phase (21) only")
    p.add_argument("--conv-only", action="store_true",
                   help="build, then run the causal conv kernel phase (18b) "
                        "only")
    p.add_argument("--profile", action="store_true",
                   help="profile the federated slice's rounds 1 and 2 "
                        "instead")
    p.add_argument("--compare-with", metavar="DIR",
                   help="time the decode, scan and flash backward kernels "
                        "of the checkout at DIR against this one's, in "
                        "turns, instead")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from repro_torch.configs.avazu_lr import CONFIG
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    if args.compare_with:
        compare_kernels(args.compare_with)
        log(card)
        return 0
    t0 = time.perf_counter()
    libs = _build.build_all(KERNELS)
    PHASE_S["build"] = time.perf_counter() - t0
    log(f"built {', '.join(lib.name for lib in libs.values())} in "
        f"{PHASE_S['build']:.1f}s (one nvcc per source, in parallel)")
    for name in KERNELS:
        log(f"--- {name}: ptxas")
        log("\n".join(line for line in _build.BUILD_LOGS.get(name, "")
                      .splitlines() if "Used" in line or "spill" in line))
    ptxas = {name: ptxas_summary(name) for name in ("decode_attention",
                                                      "ssd_scan")}
    ptxas["flash_attention_bwd"] = ptxas_summary("flash_attention")
    ptxas["ssd_scan_bwd"] = {k: ptxas["ssd_scan"].pop(k)
                             for k in list(ptxas["ssd_scan"])
                             if k.startswith("bwd")}
    log(json.dumps({"ptxas": ptxas}))
    log(json.dumps({"tensor_core_sass": tensor_core_sass(libs)}))
    if args.profile:
        run_slice(dev, args.devices, dim=CONFIG.dim, cohort=COHORT,
                  rounds=max(3, args.rounds), bench=args.benchmarking_devices,
                  profiler=RoundProfiler(card))
        log(card)
        return 0

    if args.sharded_only or args.tooling_only or args.conv_only:
        t0 = time.perf_counter()
        if args.conv_only:
            entry = conv_phase(dev)
            passed("causal conv kernel phase", t0)
            log(json.dumps({"kernels": [entry]}))
        elif args.sharded_only:
            sharded_phase(dev, card)
            passed("sharded phase", t0)
        else:
            train = training_phase(dev, card, analyze_step=True)
            passed("training phase", t0)
            _tooling(dev, card, train)
        log(json.dumps({"phase_s": PHASE_S}))
        log(card)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    entries, main_path, scheduling = [], None, None
    fed_entry = flash_entry = ssd_entry = dec_entry = bwd_entry = None
    conv_entry, conv_launches = None, 0  # phase 18b; the paths' launches
    if args.ssm_only:
        t0 = time.perf_counter()
        ssd_entry, ssd_checked = ssd_cases(dev)
        _, dec_checked = decode_cases(dev, [DECODE_ZAMBA])
        _, flash_checked = flash_cases(dev, [FLASH_ZAMBA])
        passed("ssd and zamba2 attention kernel phases", t0)
        t0 = time.perf_counter()
        conv_entry = conv_phase(dev)
        passed("causal conv kernel phase", t0)
        ssd_entry["launches"] = None
        if not args.kernel_only:
            ssm = ssm_phases(dev, ssd_checked | dec_checked | flash_checked,
                             card)
            ssd_entry["launches"] = sum(v["ssd_scan"] for v in ssm.values())
            conv_launches += sum(v["causal_conv"] for v in ssm.values())
        entries.append(ssd_entry)
    if not (args.serving_only or args.ssm_only):
        _, _, plan = calibrated_plan(
            grade_specs(args.devices, args.benchmarking_devices))
        rows = chunk_rows(plan, COHORT)
        log(f"chunk rows of the round's update buffers: {rows}")
        t0 = time.perf_counter()
        entry, checked = kernel_phase(dev, rows)
        passed("kernel phase", t0)
        entry["launches"] = None
        fed_entry = entry
        if not (args.kernel_only or args.training_only):
            t0 = time.perf_counter()
            res = slice_phase(dev, args.devices, args.rounds, checked,
                              args.benchmarking_devices)
            entry["launches"] = slice_launches = res["launches"]
            inline = _slice_summary(res)  # what phase 14 is held against
            passed("slice phase", t0)
            if not args.scheduling_only:
                t0 = time.perf_counter()
                cross_check_phase(args.cross_devices, args.rounds)
                passed("cross-check phase", t0)
                t0 = time.perf_counter()
                main_path = main_path_phase(dev, args.devices, args.rounds,
                                            checked, res, args.cross_devices,
                                            card)
                entry["launches"] += sum(v["fed_reduce"] for v in
                                         main_path["launches"].values())
                entry["max_abs_err"] = max(
                    entry["max_abs_err"],
                    main_path["max_abs_err"]["fed_reduce"])
                passed("main-path phase", t0)
            del res
            torch.cuda.empty_cache()
            scheduling = (entry, checked, inline, slice_launches)
        entries.append(entry)
    if not (args.ssm_only or args.scheduling_only):
        t0 = time.perf_counter()
        dec_entry, dec_checked = decode_cases(dev)
        flash_entry, flash_checked = flash_cases(dev)
        passed("attention kernel phase", t0)
        t0 = time.perf_counter()
        ssd_entry = None
        if not args.training_only:
            ssd_entry, ssd_checked = ssd_cases(dev)
            passed("ssd kernel phase", t0)
        for e in (dec_entry, flash_entry, ssd_entry):
            if e is not None:
                e["launches"] = None
        if not (args.kernel_only or args.training_only):
            t0 = time.perf_counter()
            srv = serving_phase(dev, dec_checked | flash_checked, card)
            passed("serving phase", t0)
            t0 = time.perf_counter()
            serving_cross_check(srv["params"], srv["cfg"], srv["prompts"])
            passed("serving cross-check", t0)
            llama = srv["launches"]
            del srv
            torch.cuda.empty_cache()
            ssm = ssm_phases(dev, dec_checked | flash_checked | ssd_checked,
                             card)
            fam = family_phases(dev, dec_checked | flash_checked, card)
            # Each path's own count, read just after it ran, summed (the
            # main-path phase's paths too); the flash entry is the
            # tensor-core kernel's.
            paths = (*ssm.values(), *fam.values(),
                     *(main_path["launches"].values() if main_path else ()))
            for e, key in ((dec_entry, "decode_attention"),
                           (flash_entry, "flash_attention_wgmma")):
                e["launches"] = llama[key] + sum(v[key] for v in paths)
            ssd_entry["launches"] = sum(v["ssd_scan"] for v in ssm.values())
            conv_launches += sum(v["causal_conv"] for v in ssm.values())
        if main_path:
            # The main-path phase's checks at the shapes it launched at.
            for e in (dec_entry, flash_entry):
                e["max_abs_err"] = max(e["max_abs_err"],
                                       main_path["max_abs_err"][e["name"]])
        entries += [e for e in (dec_entry, flash_entry, ssd_entry)
                    if e is not None]
    if scheduling is not None:
        # Phases 13-14, after phase 12 as numbered.
        entry, checked, inline, slice_launches = scheduling
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sched = scheduled_phase(dev, args.devices, args.cross_devices,
                                checked, args.benchmarking_devices, card)
        entry["launches"] += sched["launches"]
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   sched["max_abs_err"])
        passed("scheduled phase", t0)
        t0 = time.perf_counter()
        pooled = pooled_phase(dev, args.devices, args.rounds,
                              args.cross_devices, args.benchmarking_devices,
                              inline, slice_launches, card)
        entry["launches"] += pooled["launches"]
        passed("pooled phase", t0)
    if not (args.ssm_only or args.scheduling_only or args.serving_only):
        # Phases 15-19, last as numbered.
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        bwd_entry, bwd_checked, fwd_err = bwd_phase(dev)
        bwd_entry["launches"] = None
        flash_entry["max_abs_err"] = max(flash_entry["max_abs_err"], fwd_err)
        passed("backward kernel phase", t0)
        if not args.kernel_only:
            start_training_audit()
            t0 = time.perf_counter()
            train = training_phase(dev, card, analyze_step=True)
            passed("training phase", t0)
            t0 = time.perf_counter()
            training_cross_check(dev)
            passed("training cross-check", t0)
            t0 = time.perf_counter()
            ex = training_examples_phase(dev)
            passed("training examples phase", t0)
        t0 = time.perf_counter()
        ssd_bwd_entry, ssd_bwd_checked = ssd_bwd_phase(dev)
        ssd_bwd_entry["launches"] = None
        passed("ssd backward kernel phase", t0)
        t0 = time.perf_counter()
        conv_entry = conv_phase(dev)
        passed("causal conv kernel phase", t0)
        if not args.kernel_only:
            start_ssd_audit()
            t0 = time.perf_counter()
            ssm_train = training_phase(dev, card, SSM_TRAIN_ARCH)
            passed("ssm training phase", t0)
            for arch in SSM_ARCHS:
                t0 = time.perf_counter()
                training_cross_check(dev, arch)
                passed(f"ssm training cross-check [{arch}]", t0)
            # Every shape phases 16, 17 and 19 launched that phases 15 and
            # 18 did not check, checked as they check their cases.
            fwd_err, bwd_err = check_training_shapes(dev, bwd_checked)
            ssd_err, ssd_rel = check_ssd_shapes(dev, ssd_bwd_checked)
            # Each path's own count, read just after it ran.
            bwd_entry["launches"] = (train["launches"]["flash_attention_bwd"]
                                     + ex["launches"]["flash_attention_bwd"])
            bwd_entry["max_abs_err"] = max(bwd_entry["max_abs_err"],
                                           bwd_err)
            flash_entry["max_abs_err"] = max(flash_entry["max_abs_err"],
                                             fwd_err)
            flash_entry["launches"] = ((flash_entry["launches"] or 0) + train[
                "launches"]["flash_attention_wgmma"])
            fed_entry["launches"] = ((fed_entry["launches"] or 0)
                                     + ex["launches"]["fed_reduce"])
            ssd_bwd_entry["launches"] = ssm_train["launches"]["ssd_scan_bwd"]
            ssd_bwd_entry["max_abs_err"] = max(ssd_bwd_entry["max_abs_err"],
                                               ssd_err)
            ssd_bwd_entry["max_rel_err"] = max(ssd_bwd_entry["max_rel_err"],
                                               ssd_rel)
            if ssd_entry is not None:
                ssd_entry["launches"] = ((ssd_entry["launches"] or 0)
                                         + ssm_train["launches"]["ssd_scan"])
            conv_launches += (ssm_train["launches"]["causal_conv"]
                              + 2 * ssm_train["launches"]["causal_conv_bwd"])
        entries += [bwd_entry, ssd_bwd_entry]
    if not (args.ssm_only or args.scheduling_only or args.serving_only
            or args.kernel_only):
        # Phase 20, last as numbered: its launches join each kernel's.
        free_cycles()
        t0 = time.perf_counter()
        sharded = sharded_phase(dev, card)
        passed("sharded phase", t0)
        for e, key in ((fed_entry, "fed_reduce"),
                       (dec_entry, "decode_attention"),
                       (flash_entry, "flash_attention_wgmma"),
                       (bwd_entry, "flash_attention_bwd"),
                       (ssd_entry, "ssd_scan"),
                       (ssd_bwd_entry, "ssd_scan_bwd")):
            if e is not None:
                e["launches"] = (e["launches"] or 0) + sharded["launches"][key]
        conv_launches += sharded["launches"]["causal_conv"]
        entries.append(sharded["k2p"])
        # Phase 21, last as numbered (its card step ran inside phase 16).
        tooling = _tooling(dev, card, train)
        fed_entry["launches"] = ((fed_entry["launches"] or 0)
                                 + tooling["launches"]["fed_reduce"])
    if conv_entry is not None:
        # Kernel launches on the main paths that ran: one a forward call,
        # two a backward call.
        conv_entry["launches"] = conv_launches or None
        entries.append(conv_entry)
    for e in entries:
        if ptxas.get(e["name"]):
            e["ptxas"] = ptxas[e["name"]]
    log(json.dumps({"phase_s": PHASE_S}))
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
