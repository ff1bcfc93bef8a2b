#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

1. builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
   and prints each kernel function's registers, shared memory and spill
   bytes from ptxas; a spill in the flash (bf16 and fp32), matmul (fp32
   and bf16), mamba_scan, causal_conv or wkv6 kernels fails the run;
   counts ``HGMMA``
   and ``UTMALDG`` in the bf16 matmul kernel's SASS (``cuobjdump -sass``)
   and fails if either is 0; then the recurrence kernels' registers per
   thread and resident warps per SM as the CUDA runtime reports them;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it and at the matmul kernels' slice and tile
   edges (fp32 ``MM_EDGES``, bf16 ``MM_BF16_EDGES``: padded and unpadded
   routes and a misaligned operand; the bf16 app blocks must reach the
   kernel unpadded and uncopied) (matmul fp32 rtol=atol=1e-4 and bf16
   2e-2, the JAX package's kernel tolerances; stencil fp32 1e-4;
   segment_rowmax float64 1e-12 and float32 1e-4), and times both, with
   one library call beside each as a yardstick where one PyTorch call
   computes the same function, and the achieved TFLOP/s and share of the
   bound (both matmuls at the apps' block shape beside ``torch.matmul``);
3. drives the execute path: all nine paper apps through ``repro_torch.apps``
   at the registry's own problem sizes and default processor counts, each
   checked against its single-device oracle on the card, with the kernels'
   launch counters set to 0 just before and read just after (after one
   uncounted pass at the small validation sizes, so that the per-app times
   are not first-call times); then the six matmul apps once more on bf16
   inputs (``make_inputs(dtype=bfloat16)`` at 4096^3), counters set to 0
   just before each and read just after, each held to an fp32
   ``torch.matmul`` of the same inputs within 2e-2 of its largest |entry|
   (``MM_BF16_APP_REL``), with each run's wall time; then the nine apps
   again with one process per mesh rank (``apps.run.run_worlds``): a gloo
   world of 4 processes (Cannon, SUMMA, PUMMA) and one of 8 (the others),
   every rank sharing card 0 (``--share-card``), each rank launching the
   kernels on its own blocks, values crossing the processes through
   ``torch.distributed`` (the all-gather staged through host memory,
   ``world.STAGED``), at the registry's sizes; each app in its oracle's
   tolerance on every rank, every rank's blocks within ``PG_VIRTUAL_REL``
   (circuit ``PG_CIRCUIT_REL``) of the virtual-rank output's largest
   |entry| on the same inputs, every block on ``cuda:0``, matmul and
   stencil launches > 0 summed over the ranks (counters set to 0 just
   before each app and read just after, in each rank); each app's wall
   (a run's: the largest over the ranks; the median of runs 2..5,
   ``PG_REPEATS``) beside its virtual-rank wall (the same median),
   the staged bytes and the collectives staged; then a one-rank NCCL
   world: the rank bound to card 0, each ``spmd`` collective and Cannon's
   ``shard_map`` (kernel on) on a 1 x 1 mesh against the virtual ranks;
   before it, ``apps.run --all --execute --world nccl`` and ``--world
   gloo`` without ``--share-card`` must exit 1 naming the card and the
   ranks; the phase must end within ``PG_BUDGET_S``;
4. sweeps the pricer: for each app, its most balanced grid at 4096
   processors and 256 seeded random placements, priced by the torch engine
   on the card with the segment_rowmax kernel, against the NumPy engine (8
   rows, 1e-6 relative) and the engine's plain reduction (all rows, 1e-12);
5. drives the tune path: the time-domain tuner over all nine apps at 4096
   processors through ``repro_torch.apps.run.tune``, once on the torch
   engine on the card (launch counters set to 0 just before, read just
   after) and once on the NumPy engine; the winners must be the same and
   the placed seconds agree within 1e-6 relative;
6. drives the fault remapper at 4096 processors: each app's stale plan
   (its torch winner from 5) remapped warm and cold under the two
   scenarios of ``benchmarks/resilience_bench.py`` (processor nprocs-1
   dead; port 0 of level 0 slowed by 2.0) on the torch engine on the card,
   each held to the same remap on the NumPy engine (sub-machine, winner,
   placed seconds within 1e-6, no work on a dead processor, no worse than
   the stale plan), with warm and cold wall times per engine;
7. drives the mapping service: 48 requests drawn as the service CLI's
   demo trace draws them over the nine apps at 1024 and 4096 processors,
   then two node-death remaps, through a torch-engine ``MappingService``
   on the card, held to a NumPy-engine service; a second service on the
   same directory answering every tune from the plan cache; two workers
   giving the one-worker plans; ``ServiceStats`` (hits, p50, p95); and
   ``python -m repro_torch.serving.serve --demo 20 --backend torch``;
8. drives the runner's ``--warm-start-from`` at 4096 processors on the
   torch engine from the service's plan cache: the tune phase's winners;
   phases 5-8 each with the launch counters set to 0 just before and read
   just after, failing on no segment_rowmax launch;
9. holds the LM kernels against their plain versions at the serving
   path's shapes and times them: flash_attention at the hymba-1.5b
   prefill (B=4, S=2048, 25 heads over 5 KV heads, d=64, window 1024),
   the smollm-135m prefill (9 over 3 heads, no window), the
   qwen2-moe-a2.7b prefill (16 heads of 128, no window) and a ragged
   length, in bf16 (rtol=atol=2e-2) and fp32 (1e-4), with
   ``F.scaled_dot_product_attention`` as the yardstick, then each flash
   kernel's tile edges (bf16 ``FLASH_EDGES``: S one short of, at and one
   past a 64-row tile, windows inside and on a key tile, not causal, d 16
   and 128, a misaligned operand the wrapper copies; fp32
   ``FLASH_F32_EDGES``: S at each query tile (128 rows at d <= 64, 64
   above) +- 1, d 16, 80 and 128, a window ending inside a tile, not
   causal, a misaligned operand); mamba_scan at the
   hymba prefill (B=4, T=2048, d_inner 3200, state 16), a ragged one and
   its tile edges (``MAMBA_EDGES``), fp32 (1e-4), timed beside the
   exponentials' MUFU floor; then Hymba's mixer kernels (the causal conv
   + SiLU and the gated scan) at that shape and the hymba-prefill-32k
   cell's (B=2, T=32768), on the mixer's layouts, bf16 (2e-2) and fp32
   (1e-4) against their plain twins in ``ops`` (the conv's tail and the
   scan's state too), timed in bf16 beside their twins, the operator
   chain each replaced and the fp32 plain scan (``MIXER_SHAPES``);
10. drives the LM serving path at hymba-1.5b's full width (at 8 of its
   32 layers, ``EARLIER_LM_LAYERS``; weights from a seeded generator on
   the card): the prefill step with the kernels (B=4, prompt 2048 > the
   1024 window), counters set to 0 just before and read just after (8
   launches of each kernel); in fp32 its
   last logits against the plain prefill (rtol 1e-2, atol 5e-2, the
   mixer tolerance of tests/test_kernels.py), beside it the bf16 kernel
   prefill's difference from the bf16 plain one (reported; gated only on
   finite logits), and the median prefill wall time with and without the
   kernels; a 256-token prompt teacher-forced through ``decode_step``
   against the kernel prefill's last logits (fp32, 2e-3); a 4-slot
   ``ContinuousBatcher`` answering 8 requests of prompts 16-128, then,
   with the weights freed, the serving CLI (batch 4, prompt 32, gen 16),
   which draws its own; then smollm-135m's prefill
   (no window) with the kernels against its plain prefill (fp32, 2e-3);
11. holds wkv6 against its plain version (fp32, rtol=atol=1e-4) at the
   rwkv6-3b prefill shape (B=4, T=2048, 40 heads of 64), at a ragged T,
   at head sizes 32 and 16 and at its tile edges (``WKV6_EDGES``), and
   times it at the prefill shape;
12. drives RWKV-6 serving at rwkv6-3b's full width (8 of its 32 layers,
   d_model 2560, d_ff 8960, vocabulary 65536; parameters drawn from a
   seed, fp32 on the card, after hymba's are freed): the prefill step with
   the wkv6 kernel (B=4, prompt 2048), counters set to 0 just before and
   read just after (8 launches); in fp32 its last logits against the
   plain prefill (the per-step scan) within a max |diff| of 1e-3, the bf16
   difference reported, and the median bf16 prefill wall time with and
   without the kernel; a 256-token prompt teacher-forced through
   ``decode_step`` (the scan from the carried state) against the kernel
   prefill's last logits (fp32, 2e-3); a 4-slot ``ContinuousBatcher``
   answering 8 requests, then the serving CLI (batch 4, prompt 32, gen 16);
13. drives MoE serving at qwen2-moe-a2.7b's full width and depth (24
   layers, 60 routed experts padded to 64, top-4, 4 shared; 15146928128
   parameters, 60.59 GB of fp32 weights drawn after rwkv6-3b's are
   freed): the same phases as 12, with flash_attention launched once a
   layer (24) and no other kernel; routing is discontinuous, so the fp32
   kernel prefill runs on the plain prefill's expert choices and is held
   within DECODE_TOL of it (the free-running difference reported), every
   replayed choice within ``FLIP_TOL`` of the run's own top-k, and the
   decode check likewise on the prefill's routing; the bf16 kernel
   prefill is run twice and the difference reported;
14. drives MLA serving at deepseek-v2-lite-16b's full width and depth (27
   layers, one dense, then 64 experts top-6 and 2 shared; MLA latent rank
   512; 15706484224 parameters, 62.83 GB): ``use_kernel=True`` must raise
   the MLA ``ValueError`` (the reference has no kernel route either); the
   plain prefill, counted with no kernel launched, is the served one; the
   decode check, batcher and CLI as in 12; phases 10, 12, 13 and 14 print
   their peak memory, and each frees its weights before the serving CLI
   draws its own (two copies of an MoE model do not fit on the card);
15. drives the dry run (``repro_torch.launch.dryrun``): counts on the
   meta device, at the shapes' global batch, hymba-1.5b and rwkv6-3b
   prefill_32k and smollm-135m decode_32k, each within 30 s of host time;
   runs them through ``run_cell(device="cuda")`` at full width and depth
   (the prefills at B=1 through their kernels, each launched once a
   layer, the decode at B=32 on its plain step), printing each cell's
   seconds, peak memory, share of the bf16 peak and the term that bounds
   it; holds the prefills' kernel route to their plain route at
   S = 32768 at 2 layers in fp32 (10's and 12's limits); the phase must
   end within 150 s;
16. drives the mesh layer on virtual ranks (``core/spmd.py``; every
   rank's block on the card, else the run fails): smollm-135m at full
   width and depth, fp32, B=4, S=2048 on a (data=2, model=4) mesh with
   sequence sharding, its prefill through ``sp_attention`` (30 calls),
   then 64 decode steps through ``sp_decode_attention`` (30 calls a
   step) from a 2048-entry seeded cache, every position's hidden states,
   the last logits and the decode's logits each held to the no-mesh run
   within 1e-4 of their largest |entry|; qwen2-moe-a2.7b at full
   width with capacity factor 16: layer 0's MoE block through
   ``_moe_shard_map`` against ``_moe_dense`` (routing compared first, no
   drops, 2e-3), then at 16 of its 24 layers the bf16 prefill through the
   flash kernel and the EP MoE on the mesh, counters set to 0 just before
   and read just after (flash once a layer), on the no-mesh kernel
   prefill's routing and held to it (2e-2), and its fp32 twin the same
   way (2e-3); the GPipe pipeline over pod=2 on smollm-135m's 30 blocks
   (4 microbatches of 1, S=1024) against the sequential stack, the
   blocks' output within 1e-4 of its largest |entry| and each leaf's
   token-loss gradient within 5e-4 of the leaf's largest entry; each
   path's wall with and without
   the mesh, the call counts and peak memory; the phase must end within
   150 s;
17. drives the dry run's production meshes (``run_mesh_cell``): smollm-135m
   train_4k and qwen2-moe-a2.7b prefill_32k on the 256-chip single mesh,
   each counted on the meta device on a fake process group of 256 ranks
   (rank (0, 0)'s per-device FLOPs and collective bytes by kind), then
   rank (0, 0)'s share run once on the card under that group, counters
   set to 0 just before and read just after (no launch: the plain route,
   as the reference's cells); fails unless every local block lies on the
   card, the arguments there equal the meta count's argument bytes, and
   the peak memory is at least the arguments and under 80 GB; prints the
   reference's figures beside the port's; the phase must end within
   120 s; then the production cells with values (``CELL_JOBS``,
   ``launch.dryrun.run_world_cells``): a gloo world of 4 processes
   sharing card 0 on a (data=2, model=2) mesh in a Mapple cyclic
   mapper's device order, fp32, each rank placing its blocks of whole
   values made on the card from one seed, running the step once and
   gathering the outputs (the all-gathers staged through host memory):
   smollm-135m train_4k at full width and depth, B=8, fsdp, from the
   optimizer state past warmup (``steps.SEEDED_STEP``, seeded moments),
   where the step moves every parameter past the limit (checked, so an
   unwritten one would fail);
   qwen2-moe-a2.7b prefill_32k at 4 of 24 layers, B=2, S=4096, tp with
   the EP all-to-all, capacity factor 16; smollm-135m decode_32k, B=8,
   a 4096-entry seeded cache; each rank's gathered outputs held to the
   same step in this one process on the card (``CELL_LEAF_REL`` of each
   leaf's largest |entry|, the loss ``CELL_LOSS_ABS``, the grad norm
   ``CELL_GRAD_NORM_REL``), every block on ``cuda:0``, no launch (the
   plain route); prints each cell's largest wall over the ranks beside
   the one-process wall, each rank's peak memory and the staged bytes
   by collective; the phase must end within 150 s;
18. drives the training path (no kernel: the plain path, as the reference
   trains): the loop's train step on the card against the same step on
   the CPU on reduced fp32 smollm-135m (three steps, each from the CPU's
   state: losses within 1e-4, new parameters within 1e-4 wherever the
   two devices' gradients agree within 1%); at smollm-135m's full width,
   the accumulated step at n_micro 2 against 1 on one 2 x 4096 batch
   (loss 1e-4, grad norm 1e-3 relative); the main run, smollm-135m at
   full width and depth, B=16, S=4096 (train_4k's sequence, the batch cut
   from 256 for one card), 8 steps through ``launch.steps``' accumulated
   step with ``choose_microbatches``' 8, counters set to 0 just before
   and read just after (0 launches), finite losses, step 0 within 0.5 of
   ln(49152), step time, tokens/s, peak memory and model-FLOP share; the
   training CLI at full width (12 steps, B=8, S=2048, checkpoints every
   4) with a failure at step 9: one restart, from step 8, its losses
   within 1e-6 of an uninterrupted run's; ``use_kernel=True`` under
   autograd raising for flash, mamba_scan and wkv6 with no launch; one
   step each of hymba-1.5b and rwkv6-3b at full width and 2 layers;
19. prints one JSON ``kernels`` line (matmul and stencil launches from the
   execute path and the process-group apps, summed over the ranks, by
   path; the bf16 matmul row's by app from the bf16 pass,
   segment_rowmax launches from the tune path and, by path,
   from phases 5-8, flash_attention launches summed over the hymba,
   smollm and qwen2-moe prefills, the dry run and the mesh phase's
   qwen2-moe prefill, and by path, mamba_scan
   launches from the hymba prefill and the dry run, wkv6 launches from
   the rwkv6-3b prefill and the dry run, each by path), the
   card's name and power limit, and last ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero before the last line. Without a CUDA card,
or without the rest of the repository beside it, it fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks: dense fp32 and fp64 on the CUDA cores, dense
# bf16 on the tensor cores, HBM3 bandwidth.
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# segment_rowmax: float64 is the pricer's default and sums at most a few
# values per segment (1e-12); float32 takes the repo's fp32 tolerance.
SR_TOL = {"float64": dict(rtol=1e-12, atol=1e-12),
          "float32": dict(rtol=1e-4, atol=1e-4)}
# The pricer's scale, its placements per app, and its parity limits: the
# NumPy engine (sim_eval's 1e-6 gate) and the engine's plain reduction.
PRICER_PROCS = 4096
PRICER_ROWS = 256
PRICER_NUMPY_ROWS = 8
PRICER_RTOL = 1e-6
KERNEL_VS_PLAIN_RTOL = 1e-12
SCATTER_APP = "summa"      # the largest schedule (516096 transfers)
# The fault remapper and the mapping service at the tuner's scale: the
# contended port's slowdown (benchmarks/resilience_bench.py's), the slack
# of "no worse than the stale plan" (its gate), float64 round-off below
# which two NumPy placed seconds tie, and the service's trace: requests,
# drawn as serve.demo_trace draws them over the nine apps at these scales.
REMAP_CONTENTION = 2.0
# The apps whose cold remaps are also run on the NumPy engine, to hold the
# torch engine's to them (every warm remap is held): all nine took 58 s on
# the host, 50 of it summa's and pumma's (PERF.md §6); these three, a 3-D
# space and two 2-D ones, took 4 s.
REMAP_NUMPY_COLD_APPS = ("johnson", "stencil", "pennant")
STEP_SLACK = 1e-9
WINNER_TIE_RTOL = 1e-12
SERVICE_REQUESTS = 48
SERVICE_PROCS = (1024, 4096)
KERNELS = {
    "matmul": {"source": "src/repro_torch/kernels/csrc/matmul.cu",
               "replaces": "src/repro/kernels/matmul.py:39"},
    "stencil": {"source": "src/repro_torch/kernels/csrc/stencil.cu",
                "replaces": "src/repro/kernels/stencil.py:36"},
    "segment_rowmax": {"source": "src/repro_torch/kernels/csrc/segment_reduce.cu",
                       "replaces": "src/repro/kernels/segment_reduce.py:52"},
    "flash_attention": {"source": "src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
                        "fp32_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "replaces": "src/repro/kernels/flash_attention.py:79"},
    "mamba_scan": {"source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
                   "replaces": "src/repro/kernels/mamba_scan.py:58"},
    "causal_conv": {"source": "src/repro_torch/kernels/csrc/causal_conv.cu",
                    "replaces": "src/repro/models/hymba.py:95 (XLA ops, no Pallas kernel)"},
    "wkv6": {"source": "src/repro_torch/kernels/csrc/wkv6.cu",
             "replaces": "src/repro/kernels/wkv6.py:59"},
}
# The fp32 matmul kernel's slice and tile edges (8-deep slices, 128 x 128
# tiles; K and N multiples of 4 take its float4 path), and the target of
# both matmul kernels against torch.matmul at the apps' block shape
# (reported, not gated).
MM_EDGES = [(2, 70, 4, 36), (2, 70, 5, 36), (1, 200, 20, 136), (1, 200, 13, 136),
            (1, 129, 64, 129), (2, 129, 64, 132)]
MM_TARGET = 1.5
# The bf16 matmul kernel's tile edges (128 x 256 tiles, 64-deep stages):
# (batch, M, K, N, misaligned a). M 127-129 and 200, N 255-257, K 63-65
# and 777, batch 1 and 3: K or N off a multiple of 8 takes the padded
# route, the others the unpadded one; the last case hands the wrapper an a
# whose data pointer is 8 bytes off 16, which it copies.
MM_BF16_EDGES = [(1, 127, 63, 255, False), (3, 128, 64, 256, False),
                 (1, 129, 65, 257, False), (3, 200, 777, 256, False),
                 (1, 128, 64, 257, False), (3, 129, 64, 255, False),
                 (1, 200, 63, 256, False), (3, 127, 65, 256, False),
                 (2, 200, 64, 256, True)]
# The six matmul apps once on bf16 inputs: max |diff| against an fp32
# torch.matmul of the same inputs at most this share of the largest
# |entry| (the JAX package's bf16 kernel tolerance, taken relative: the
# entries reach about 4 sqrt(K)).
MM_BF16_APP_REL = 2e-2
# The bf16 flash kernel's tile edges (64 queries, 64 keys a tile):
# (B, S, H, Kv, d, window, causal, misaligned k).
FLASH_EDGES = [(2, 63, 4, 2, 64, 0, True, False), (2, 64, 4, 2, 64, 0, True, False),
               (2, 65, 4, 2, 64, 0, True, False), (1, 129, 6, 2, 64, 0, True, False),
               (2, 300, 4, 2, 64, 37, True, False), (1, 512, 4, 1, 64, 128, True, False),
               (2, 257, 4, 2, 64, 64, False, False), (2, 256, 4, 2, 16, 0, True, False),
               (1, 320, 4, 2, 128, 100, True, False), (2, 200, 4, 2, 64, 50, True, True)]
# The fp32 flash kernel's tile edges (128 queries at d <= 64, 64 above;
# 64 keys a tile), as FLASH_EDGES: S one short of, at and one past each
# query tile, d 16, 80 and 128, a window ending inside a key tile, not
# causal, and a misaligned k (heads 2 floats into a padded row) that the
# wrapper copies.
FLASH_F32_EDGES = [(2, 127, 4, 2, 64, 0, True, False), (2, 128, 4, 2, 64, 0, True, False),
                   (2, 129, 4, 2, 64, 0, True, False), (2, 63, 4, 2, 128, 0, True, False),
                   (2, 64, 4, 2, 128, 0, True, False), (2, 65, 4, 2, 128, 0, True, False),
                   (1, 257, 4, 2, 16, 0, True, False), (1, 300, 6, 3, 80, 100, True, False),
                   (2, 300, 4, 2, 64, 37, True, False), (1, 320, 4, 2, 128, 100, True, False),
                   (2, 257, 4, 2, 64, 64, False, False), (1, 77, 2, 2, 16, 0, False, False),
                   (2, 200, 4, 2, 64, 50, True, True)]
# Sources whose kernel functions must not spill (ptxas -v), and the
# functions of each that the rule covers.
NO_SPILL = {"flash_attention_bf16.cu": ("flash_bf16_kernel",),
            "flash_attention.cu": ("flash_f32_kernel",),
            "matmul.cu": ("sgemm_kernel", "hgemm_kernel"),
            "mamba_scan.cu": ("mamba_scan_kernel",), "wkv6.cu": ("wkv6_kernel",),
            "causal_conv.cu": ("causal_conv_silu_kernel",)}
# The bf16 matmul kernel runs on the tensor cores and through TMA: its
# SASS must hold these instructions (cuobjdump -sass of the built library).
HGEMM_FUNCTION = "hgemm_kernel"
HGEMM_SASS = ("HGMMA", "UTMALDG")
# The recurrence kernels' tile edges: mamba_scan (B, T, di, n) with a ragged
# last 32-channel block, T off the 32-step chunk, n = 4 and 32, and
# di % 4 != 0 (4-byte copies); wkv6 (B, T, H, N) with T short of, one past
# and ragged against the 16-step chunk, at N = 64, 32 and 16.
MAMBA_EDGES = [(2, 100, 200, 16), (2, 45, 96, 4), (2, 50, 100, 32), (1, 77, 70, 32)]
WKV6_EDGES = [(2, 15, 3, 64), (1, 17, 2, 64), (2, 17, 3, 32), (3, 47, 2, 16), (1, 2, 5, 32),
              (1, 1, 3, 16)]
# Hymba's mixer kernels (the causal conv + SiLU, the gated scan) at the LM
# path's shape and the hymba-prefill-32k cell's (B=2, T=32768), d_inner
# 3200, state 16, conv width 4.
MIXER_SHAPES = ((4, 2048), (2, 32768))
MIXER_DIMS = (3200, 16, 4)
# The special-function unit's exponentials: 16 MUFU.EX2 results a clock
# on each of the 132 SMs at the 1.98 GHz boost clock (published figures).
MUFU_EX2_PER_S = 16 * 132 * 1.98e9
# The LM serving path: hymba-1.5b's prefill shape and the checks' limits.
LM_ARCH = "hymba-1.5b"
LM_BATCH, LM_PROMPT = 4, 2048
PREFILL_TOL = dict(rtol=1e-2, atol=5e-2)   # tests/test_kernels.py's mixer tolerance
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)    # tests/test_models.py's decode check
DECODE_PROMPT = 256
DENSE_ARCH = "smollm-135m"
LM_KERNELS = ("flash_attention", "causal_conv", "mamba_scan", "wkv6")
HYMBA_KERNELS = ("flash_attention", "causal_conv", "mamba_scan")
# RWKV-6 serving: rwkv6-3b's prefill shape (40 heads of 64) and the bound,
# stated before the run, on the fp32 kernel prefill's last logits against
# the plain prefill's: max |diff| <= 1e-3.
RWKV_ARCH = "rwkv6-3b"
RWKV_HEADS, RWKV_HEAD = 40, 64
RWKV_PREFILL_TOL = dict(rtol=0.0, atol=1e-3)
# MoE and MLA serving at full width: qwen2-moe-a2.7b (flash at head dim
# 128; its fp32 kernel prefill held to the plain one within DECODE_TOL,
# stated before the run: only attention differs) and deepseek-v2-lite-16b
# (MLA: no kernel route, the plain prefill served).
MOE_ARCH = "qwen2-moe-a2.7b"
MLA_ARCH = "deepseek-v2-lite-16b"
# Routing is discontinuous: fp32 runs whose sums differ in order (kernel
# against plain, decode against prefill) pick other experts for tokens at
# near-ties of the top-k (qwen2-moe's fp32 kernel and plain prefills
# differed in 144 of 196608 (token, layer) expert sets, first at MoE
# layer 6, and their last logits by 1.4e-2). So the MoE checks replay
# the reference run's routing in the other run and hold the logits to
# the tolerance on shared routing; the free-running difference is
# reported. A flip is allowed only at a near-tie: the replayed expert
# within FLIP_TOL (router probability) of this run's own top-k.
FLIP_TOL = 1e-4
# hymba-1.5b's and rwkv6-3b's paths run at 8 of their 32 layers, at their
# published widths: their plain prefills and batchers (host-bound, per
# layer) are most of their time, and with the MoE, MLA and train phases
# the command took 638 s at 16 layers (PERF.md §6), past
# half its 1200 s limit. The serving CLI still builds them at full depth.
EARLIER_LM_LAYERS = 8
# The train phase: smollm-135m at full width and depth (the reference
# launcher's example architecture), train_4k's sequence of 4096 with the
# global batch cut from 256 to 16 for one card, through launch.steps'
# accumulated step, for which choose_microbatches picks 8 on one card.
TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 16, 4096, 8, 8
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)    # card against CPU, reduced fp32
# On these random weights fp32 gradients sit up to 1.1e-4 of a leaf's
# largest entry from float64 ones (tools/train_numerics.py), and the two
# devices' up to 1.6e-4 from each other (PERF.md §6): each leaf's gradients
# are held within GRAD_TOL of its largest entry. AdamW moves an entry by about
# lr * m / sqrt(v), lr * sign(g) at a first step, so an entry whose
# gradient the two devices do not agree on moves up to 2 lr apart, and a
# trajectory that diverges there changes every later gradient. So each of
# the three steps starts the card from the CPU's state; its loss is held
# within TRAIN_TOL, and its new parameters too at every entry whose
# gradients agree within ADAM_REL (relative). The other entries may be at
# most ADAM_LOOSE_SHARE of each leaf's (entry, step) pairs (fp32 against
# float64: at most 0.36% of a leaf's, tools/train_numerics.py on the CPU).
# The card's AdamW update is held on the CPU's gradients too, at every
# entry.
GRAD_TOL = 5e-4
ADAM_REL, ADAM_LOOSE_SHARE = 1e-2, 2e-2
ACCUM_LOSS_RTOL, ACCUM_GNORM_RTOL = 1e-4, 1e-3
LOSS0_SLACK = 0.5                         # step 0 against ln(vocab)
RESTART_RTOL = 1e-6
# The dry run (launch/dryrun.py) with the CLI's default knobs (chunked
# WKV): each card cell counted on the meta device at its shape's global
# batch within DRYRUN_COUNT_S of host time, then run once on the card at
# the batch it fits (hymba-1.5b and rwkv6-3b prefill_32k through their
# kernels, the batch cut from 32 to 1; smollm-135m decode_32k on the plain
# step, cut from 128 to 32: a 24.2 GB bf16 KV cache, where 128 would need
# 96.6 GB); then each kernel of the prefill cells at the shape the cell
# gives it (B = 1, S = 32768: bf16 flash at 25/5 heads of 64, window 1024;
# mamba_scan at d_inner 3200, state 16; wkv6 at 40 heads of 64), its whole
# output against its plain version within TOL; then the two prefill cells'
# kernel route against their plain route (per-step scans) at S = 32768, at
# DRYRUN_PARITY_LAYERS layers, in fp32, on the hidden states of every
# position, within the prefill phases' limits. The phase must end within
# DRYRUN_BUDGET_S.
DRYRUN_CELLS = (("hymba-1.5b", "prefill_32k", 1, HYMBA_KERNELS),
                ("rwkv6-3b", "prefill_32k", 1, ("wkv6",)),
                ("smollm-135m", "decode_32k", 32, ()))
DRYRUN_COUNT_S = 30.0
DRYRUN_PARITY_LAYERS = 2
DRYRUN_BUDGET_S = 150.0
# The mesh phase: the mesh layer on virtual ranks (core/spmd.py), every
# rank's block on the card. smollm-135m at full width and depth, fp32,
# B=4, S=2048 on a (data=2, model=4) mesh with sequence sharding: the
# prefill through sp_attention (one call a layer), then
# MESH_DECODE_STEPS decode steps through sp_decode_attention (kv heads 3
# do not divide the model axis, so the cache shards on its sequence)
# from a cache of MESH_DECODE_CACHE seeded entries; every position's
# hidden states, the last logits and the decode's logits held to the
# no-mesh run within MESH_TOL, its atol scaled by the largest |entry|
# (``_scaled``). qwen2-moe-a2.7b at full width,
# CAPACITY_FACTOR MESH_MOE_CAPACITY (no drops, so the expert-parallel and
# dense paths agree; tests/test_distributed.py sets the same): layer 0's
# MoE block through _moe_shard_map against _moe_dense, routing compared
# first, then the prefill through the bf16 flash kernel and the EP MoE in
# every layer, on the no-mesh kernel prefill's routing and held to it
# within TOL["bfloat16"], its fp32 twin the same way within DECODE_TOL
# (the MoE serving phase's limit). Its depth is cut to
# MESH_MOE_LAYERS of 24: 16 layers' fp32 weights are 41.3 GB with the
# embeddings, and one layer's EP or dense transients at this shape about
# 20 GB, where 24 layers (60.59 GB) leave no room. The GPipe pipeline
# over pod=2 on smollm-135m's 30 blocks, PIPE_MICRO microbatches of 1 at
# S=PIPE_SEQ, against the sequential stack: the blocks' output within
# the scaled MESH_TOL, each leaf's token-loss gradient within GRAD_TOL of
# the leaf's largest entry. The phase must end within MESH_BUDGET_S.
MESH_SHAPE = (2, 4)
MESH_BATCH, MESH_PROMPT = 4, 2048
MESH_DECODE_STEPS, MESH_DECODE_CACHE = 64, 2048
MESH_TOL = TOL["float32"]
MESH_MOE_CAPACITY = 16.0
MESH_MOE_LAYERS = 16
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 2, 4, 1024
MESH_BUDGET_S = 150.0
# The production-mesh phase: cells of the dry run's 256-chip single mesh,
# with the reference's compiled figures for them (python -m
# repro.launch.dryrun --mesh single, jax 0.9.0 on 256 fake CPU devices:
# compile-time numbers, no time on any chip) printed beside the port's.
PROD_CELLS = (("smollm-135m", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"))
PROD_REFERENCE = {
    "smollm-135m": {"flops": 8.596e12, "argument": 38373108, "temp": 3.809e9,
                    "collectives": {"all-gather": 1.164e10, "all-reduce": 1.022e10,
                                    "all-to-all": 8.49e8, "reduce-scatter": 1.89e8}},
    "qwen2-moe-a2.7b": {"flops": 4.566e13, "argument": 3786994176, "temp": 2.79e9,
                        "collectives": {"all-gather": 3.16e10, "all-reduce": 1.29e10,
                                        "all-to-all": 9.46e9}},
}
PROD_BUDGET_S = 120.0
# The production cells with values: a gloo world of 4 processes sharing
# card 0 on a (data=2, model=2) mesh in a Mapple cyclic mapper's device
# order, fp32; each cell's gathered outputs against the same step in this
# one process on the same seeded whole values. Name: (arch, layers (None:
# all), shape, mode, MoE capacity factor); the cuts: train_4k's batch 256
# -> 8, prefill_32k's 32 x 32768 -> 2 x 4096 at 4 of 24 layers,
# decode_32k's 128 x 32768 -> 8 x 4096.
CELL_MESH = (2, 2)
CELL_JOBS = {
    "smollm-135m train_4k": ("smollm-135m", None, ("train_4k", 4096, 8, "train"), "fsdp", 1.25),
    "qwen2-moe-a2.7b prefill_32k": ("qwen2-moe-a2.7b", 4, ("prefill_32k", 4096, 2, "prefill"),
                                    "tp", 16.0),
    "smollm-135m decode_32k": ("smollm-135m", None, ("decode_32k", 4096, 8, "decode"), None,
                               1.25),
}
# Limits against the one-process step: each leaf's largest difference over
# its largest |entry| (the mesh rule), the train step's loss absolutely
# and its grad norm relatively; qwen2-moe's fp32 prefill keeps the mesh
# phase's limit for two orders of summation at its width.
CELL_LEAF_REL = {"train": 1e-4, "prefill": 2e-3, "decode": 1e-4}
CELL_LOSS_ABS = 1e-4
CELL_GRAD_NORM_REL = 1e-3
CELL_BUDGET_S = 150.0
# The launcher's restart run, and one step of the other families at their
# published widths and 2 layers (their plain recurrences loop over time).
TRAIN_CLI = ["--arch", TRAIN_ARCH, "--scale", "full", "--steps", "12", "--batch", "8",
             "--seq", "2048", "--save-every", "4"]
TRAIN_FAIL_AT = 9
TRAIN_OTHER, TRAIN_OTHER_LAYERS, TRAIN_OTHER_SHAPE = ("hymba-1.5b", "rwkv6-3b"), 2, (2, 256)


# The process-group apps: each rank's blocks against the virtual ranks'
# output (circuit's scatter-adds and reduce-scatter sum in another order:
# its oracle tolerance), the one-rank NCCL world's Cannon product, and the
# phase's budget.
PG_VIRTUAL_REL = 1e-5
PG_CIRCUIT_REL = 1e-3
PG_REPEATS = 5              # runs of each app; walls are medians of runs 2..5
PG_NCCL_MATMUL = 2048
PG_BUDGET_S = 180.0


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tflops(flops: float, ms: float) -> str:
    return f"{flops / ms / 1e9:.1f} TFLOP/s"


def _kernel_name(mangled: str) -> str:
    """``ns::name<arg>`` of a mangled kernel in a namespace, as
    ``name<arg>`` (an int, bool or type argument); else as it is."""
    import re

    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    rest = rest[m.end() + int(m.group(1)):]
    arg = re.match(r"IL[ib](\d+)E", rest)
    if arg:
        return f"{name}<{arg.group(1)}>"
    arg = re.match(r"I(\d+)", rest)
    if arg:
        return f"{name}<{rest[arg.end():arg.end() + int(arg.group(1))]}>"
    return name


def ptxas_report(log: str) -> None:
    """Each kernel function's registers, shared memory and spill bytes, as
    ``nvcc -Xptxas -v`` printed them; fails on a spill in ``NO_SPILL``."""
    import re

    source, func, spills, failures = "", "", 0, []
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif "Compiling entry function" in line:
            func = _kernel_name(re.search(r"'([^']+)'", line).group(1))
            spills = 0
        elif "spill stores" in line:
            spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            print(f"  ptxas: {source:24s} {func:28s} {regs:>3s} registers, "
                  f"{smem.group(1) if smem else 0} bytes static smem, {spills} bytes spilled")
            if spills and any(f in func for f in NO_SPILL.get(source, ())):
                failures.append(f"{source} {func} spills {spills} bytes")
            spills = 0
    if failures:
        fail("; ".join(failures))


def sass_report(lib) -> None:
    """Counts of ``HGEMM_SASS`` in the bf16 matmul kernel's SASS, from the
    toolkit's ``cuobjdump``; fails if either is 0 (the kernel would not be
    on the tensor cores, or not fed by TMA)."""
    import re

    from repro_torch.kernels import build

    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib.path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    bodies = [f for f in re.split(r"\n\s*Function : ", sass)[1:]
              if HGEMM_FUNCTION in f.split("\n", 1)[0]]
    if len(bodies) != 1:
        fail(f"cuobjdump shows {len(bodies)} functions named {HGEMM_FUNCTION}, not 1")
    counts = {op: len(re.findall(rf"\b{op}\b", bodies[0])) for op in HGEMM_SASS}
    print(f"  sass: matmul.cu {HGEMM_FUNCTION}: "
          + ", ".join(f"{n} {op}" for op, n in counts.items()))
    missing = [op for op, n in counts.items() if n == 0]
    if missing:
        fail(f"{HGEMM_FUNCTION} has no {' or '.join(missing)} in its SASS")


def occupancy_report() -> None:
    """Registers per thread and resident warps per SM of the recurrence
    kernels at their main paths' sizes, as the CUDA runtime reports them."""
    from repro_torch.kernels import mamba_scan as ms_mod
    from repro_torch.kernels import wkv6 as wkv_mod

    for name, (regs, warps) in (("mamba_scan n=16", ms_mod.occupancy(16)),
                                (f"wkv6 N={RWKV_HEAD}", wkv_mod.occupancy(RWKV_HEAD))):
        print(f"  occupancy: {name:16s} {regs} registers a thread, {warps} resident "
              f"warps an SM")


def app_shapes():
    """Block shapes the apps hand the kernels at their default procs."""
    from repro_torch import apps
    from repro_torch.apps import definitions

    p = definitions.MATMUL_PROBLEM
    mm = []
    for app in apps.iter_apps(kind=apps.MATMUL):
        g = app.tile_grid(app.default_procs)
        batch = 1
        for s in g:
            batch *= s
        if len(g) == 2 or app.name == "solomonik":   # blocks over (x, y)
            shape = (batch, p.m // g[0], p.k // g[1], p.n // g[1])
        else:                              # johnson, cosma: A (x, z), B (z, y)
            shape = (batch, p.m // g[0], p.k // g[2], p.n // g[1])
        if shape not in mm:
            mm.append(shape)
    st = apps.get("stencil")
    gx, gy = st.tile_grid(st.default_procs)
    nx, ny = definitions.STENCIL_LENGTHS
    return mm, (gx * gy, nx // gx + 2, ny // gy + 2), (nx, ny)


def check_close(name: str, out, expect, dtype: str) -> float:
    import torch

    err = float((out.float() - expect.float()).abs().max())
    if not torch.allclose(out.float(), expect.float(), **TOL[dtype]):
        fail(f"{name} disagrees with its plain version: max |diff| {err:.3e} "
             f"beyond rtol/atol {TOL[dtype]}")
    return err


def parity_and_timing(mm_shapes, stencil_block, stencil_field) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import stencil as st_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}

    # ---- matmul: every app block shape in fp32 and bf16, a ragged one, and
    # each kernel's tile edges. The bf16 app blocks must reach the kernel
    # as they are (no padding, no copy).
    cases = [(s, dt, False) for s in mm_shapes for dt in ("float32", "bfloat16")]
    cases += [((3, 1000, 777, 513), "float32", False), ((3, 1000, 777, 513), "bfloat16", False)]
    cases += [(s, "float32", False) for s in MM_EDGES]
    cases += [(s[:4], "bfloat16", s[4]) for s in MM_BF16_EDGES]
    for (b, m, k, n), dt, misaligned in cases:
        dtype = getattr(torch, dt)
        if misaligned:
            a = torch.randn((b * m * k + 4,), generator=gen, device="cuda").to(dtype)[4:]
            a = a.view(b, m, k)
        else:
            a = torch.randn((b, m, k), generator=gen, device="cuda").to(dtype)
        w = torch.randn((b, k, n), generator=gen, device="cuda").to(dtype)
        route = ""
        if dt == "bfloat16":
            a_in, w_in = mm_mod.tma_operands(a, w)
            copied = [x for x, y in (("a", a_in is a), ("b", w_in is w)) if not y]
            route = (f" ({'padded/copied ' + ' and '.join(copied) if copied else 'as it is'})")
            if (b, m, k, n) in mm_shapes and copied:
                fail(f"the bf16 app block {(b, m, k, n)} is padded or copied before the kernel")
            if misaligned and "a" not in copied:
                fail("the misaligned bf16 matmul operand reached the kernel uncopied")
        err = check_close(f"matmul {dt} {(b, m, k, n)}",
                          mm_mod.matmul_cuda(a, w), ref.matmul(a, w), dt)
        print(f"parity matmul {dt:8s} batch={b} {m}x{k}x{n}{route}: "
              f"max_abs_err={err:.3e}")
        # Timed: fp32 at every app block shape; bf16 (which the bf16 app
        # pass runs at the same shapes) at the first, the apps' 4 x 2048^3.
        if (b, m, k, n) not in mm_shapes[:1 if dt == "bfloat16" else None]:
            continue
        ref.no_tf32()
        ms = time_ms(lambda: mm_mod.matmul_cuda(a, w), reps=10)
        plain = time_ms(lambda: ref.matmul(a, w), reps=10)
        lib = time_ms(lambda: torch.matmul(a, w), reps=10)
        flops = 2.0 * b * m * n * k
        bnd, by = bound_ms(flops, a.element_size() * b * (m * k + k * n + m * n), dt)
        print(f"time   matmul {dt:8s} batch={b} {m}x{k}x{n}: kernel {ms:.4f} ms "
              f"({tflops(flops, ms)}, {bnd / ms:.1%} of bound), plain {plain:.4f} ms, "
              f"torch.matmul {lib:.4f} ms ({tflops(flops, lib)}); kernel / torch.matmul "
              f"{ms / lib:.3f} (target <= {MM_TARGET})")
        if (b, m, k, n) != mm_shapes[0]:
            continue
        row = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
               "bound_by": by, "max_abs_err": err, "shape": [b, m, k, n], "dtype": dt}
        if dt == "float32":
            rows["matmul"] = row
        else:
            rows["matmul"]["bfloat16"] = row

    # ---- stencil: the edge-replicate step on the app's field, and the
    # interior sweep on the app's halo-padded rank blocks (timed).
    field = torch.randn(stencil_field, generator=gen, device="cuda")
    err_step = check_close("stencil step", st_mod.stencil_cuda(field, interior=False),
                           ref.stencil(field), "float32")
    print(f"parity stencil step {stencil_field}: max_abs_err={err_step:.3e}")
    blocks = torch.randn(stencil_block, generator=gen, device="cuda")
    err = check_close("stencil interior", st_mod.stencil_cuda(blocks, interior=True),
                      ref.stencil_interior(blocks), "float32")
    print(f"parity stencil interior {stencil_block}: max_abs_err={err:.3e}")
    weight = torch.tensor([[0.0, 0.2, 0.0], [0.2, 0.2, 0.2], [0.0, 0.2, 0.0]],
                          device="cuda").reshape(1, 1, 3, 3)
    conv_in = blocks.unsqueeze(1)
    ms = time_ms(lambda: st_mod.stencil_cuda(blocks, interior=True), reps=500)
    plain = time_ms(lambda: ref.stencil_interior(blocks), reps=500)
    lib = time_ms(lambda: F.conv2d(conv_in, weight), reps=500)
    b, h, w = stencil_block
    out_elems = b * (h - 2) * (w - 2)
    bnd, by = bound_ms(5.0 * out_elems, 4.0 * (b * h * w + out_elems), "float32")
    rows["stencil"] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bnd, "bound_by": by,
                       "max_abs_err": max(err, err_step),
                       "shape": list(stencil_block), "dtype": "float32"}
    return rows


def apps_phase() -> dict[str, int]:
    """The main path: all nine apps at the registry's sizes, kernels on.

    A pass at the small validation sizes comes first, uncounted, so that
    the counted pass does not pay for first-call set-up (lazy loading of
    PyTorch's kernels). ``first ms`` is each app's first run at its full
    size; the steady-state times come from an uncounted pass after it.
    """
    from repro_torch import apps
    from repro_torch.apps import validate
    from repro_torch.kernels import ops

    for app in apps.iter_apps():
        if not validate.run(app, device="cuda")["ok"]:
            fail(f"{app.name} out of tolerance at the validation size")
    print(f"{'app':10s} {'procs':>5s} {'grid':>8s} {'max_err':>10s} "
          f"{'rel_err':>10s} {'first ms':>10s} {'matmul':>6s} {'stencil':>7s} ok")
    ops.reset_launch_counts()
    failures = []
    for app in apps.iter_apps():
        before = ops.launch_counts()
        res = validate.run(app, device="cuda", full=True)
        after = ops.launch_counts()
        raised = {k: after[k] - before[k] for k in after}
        grid = "x".join(str(g) for g in app.tile_grid(app.default_procs))
        rel = f"{res['rel_err']:10.3e}" if "rel_err" in res else f"{'-':>10s}"
        print(f"{app.name:10s} {app.default_procs:5d} {grid:>8s} "
              f"{res['max_err']:10.3e} {rel} {res['ms'][0]:10.3f} "
              f"{raised['matmul']:6d} {raised['stencil']:7d} {res['ok']}")
        if not res["ok"]:
            failures.append(f"{app.name} out of tolerance ({res})")
        if app.kind == apps.MATMUL and raised["matmul"] == 0:
            failures.append(f"{app.name} never launched the matmul kernel")
        if app.name == "stencil" and raised["stencil"] == 0:
            failures.append("stencil never launched the stencil kernel")
    counts = ops.launch_counts()
    if failures:
        fail("; ".join(failures))
    return counts


def _cpu(out):
    return tuple(_cpu(o) for o in out) if isinstance(out, tuple) \
        else out.detach().contiguous().cpu()


def process_group_apps_phase(smi: str) -> dict[str, int]:
    """The nine apps with one process per mesh rank, sharing the card over
    gloo, against the virtual ranks; then a one-rank NCCL world. Returns
    the matmul and stencil launches summed over the ranks."""
    import torch

    from repro_torch import apps
    from repro_torch.apps import run as runner
    from repro_torch.apps import validate

    t0 = time.perf_counter()
    jobs, virtual_ms, failures = [], {}, []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as tmp:
        hold_to = {}
        for app in apps.iter_apps():
            res = validate.run(app, device="cuda", full=True, repeats=PG_REPEATS)
            if not res["ok"]:
                fail(f"{app.name} virtual ranks out of tolerance ({res['max_err']})")
            virtual_ms[app.name] = res["ms"][1:]
            hold_to[app.name] = str(Path(tmp, f"{app.name}.pt"))
            torch.save(_cpu(res["out"]), hold_to[app.name])
            jobs.append((app.name, app.default_procs))
            del res
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        worlds = runner.run_worlds(jobs, "gloo", "cuda", share_card=True, full=True,
                                   repeats=PG_REPEATS, hold_to=hold_to,
                                   timeout=PG_BUDGET_S)
        worlds_s = time.perf_counter() - t1
    print(f"process-group apps: gloo worlds of {' and '.join(map(str, sorted(worlds)))} "
          f"processes, every rank on card 0 (--share-card), {smi}; spawn, set-up and "
          f"runs {worlds_s:.1f} s")
    print(f"walls: median of runs 2..{PG_REPEATS} (min-max), a process-group run's "
          f"wall the largest over its ranks; launches and staged bytes over the "
          f"{PG_REPEATS} runs and the check")
    print(f"{'app':10s} {'ranks':>5s} {'max_err':>10s} {'vs virtual':>10s} "
          f"{'pg ms':>22s} {'virtual ms':>22s} {'ratio':>7s} {'matmul':>6s} "
          f"{'stencil':>7s} {'staged B':>10s} blocks ok")
    launches = {"matmul": 0, "stencil": 0}
    staged = set()
    for name, procs in jobs:
        r = runner.summarize(worlds[procs], name)
        staged.update(r["staged"])
        for k in launches:
            launches[k] += r["launches"].get(k, 0)
        pg, vr = r["walls_ms"][1:], virtual_ms[name]
        v_med = statistics.median(vr)
        print(f"{name:10s} {r['ranks']:5d} {r['max_err']:10.3e} {r['virtual_rel']:10.3e} "
              f"{r['wall_ms']:9.3f} ({min(pg):.3f}-{max(pg):.3f}) "
              f"{v_med:9.3f} ({min(vr):.3f}-{max(vr):.3f}) "
              f"{r['wall_ms'] / v_med:7.2f} {r['launches'].get('matmul', 0):6d} "
              f"{r['launches'].get('stencil', 0):7d} {r['staged_bytes']:10d} "
              f"{','.join(r['blocks_on'])} {r['ok']}")
        limit = PG_CIRCUIT_REL if name == "circuit" else PG_VIRTUAL_REL
        if not r["ok"]:
            failures.append(f"{name} out of its oracle's tolerance on a rank ({r['max_err']})")
        if r["virtual_rel"] > limit:
            failures.append(f"{name} {r['virtual_rel']:.3e} from the virtual ranks (> {limit})")
        if r["blocks_on"] != ["cuda:0"]:
            failures.append(f"{name} blocks on {r['blocks_on']}, not cuda:0")
        if apps.get(name).kind == apps.MATMUL and not r["launches"].get("matmul"):
            failures.append(f"{name} launched no matmul kernel on any rank")
        if name == "stencil" and not r["launches"].get("stencil"):
            failures.append("stencil launched no stencil kernel on any rank")
    print(f"staged through host memory: {', '.join(sorted(staged)) or 'none'}")
    if failures:
        fail("process-group apps: " + "; ".join(failures))
    for argv in (["--world", "nccl"], ["--world", "gloo"]):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = runner.main(["--all", "--execute", *argv])
        said = err.getvalue().strip().splitlines()[-1:]
        print(f"apps.run --all --execute {' '.join(argv)} on {torch.cuda.device_count()} "
              f"card(s): exit {rc}: {said}")
        if rc != 1 or "ranks" not in err.getvalue() or "wall_ms" in out.getvalue():
            fail(f"{' '.join(argv)} on one card was not refused with the cards and ranks")
    nccl_one_rank_phase()
    wall = time.perf_counter() - t0
    print(f"process-group phase: {wall:.1f} s (budget {PG_BUDGET_S} s)")
    if wall > PG_BUDGET_S:
        fail(f"process-group phase took {wall:.1f} s, beyond {PG_BUDGET_S} s")
    return launches


def nccl_one_rank_phase() -> None:
    """A one-rank NCCL world: the rank bound to the card its mesh
    position's id names, each spmd collective and Cannon's shard_map on a
    1 x 1 mesh against the same on virtual ranks."""
    import socket

    import numpy as np
    import torch

    from repro_torch.apps.validate import MATMUL_REL_TOL
    from repro_torch.core import spmd, world
    from repro_torch.core.spmd import P
    from repro_torch.kernels import ops, ref
    from repro_torch.matmul import ALGORITHMS
    from repro_torch.matmul.common import MatmulGrid, make_inputs

    def body(b):
        y = spmd.all_gather(b, "y", dim=-1)
        y = spmd.psum(y, "x") + spmd.pmax(y, ("x", "y"))
        y = spmd.psum_scatter(y, "y", -1)
        y = spmd.all_to_all(y.reshape(*y.shape[:-2], 1, -1), "x", -2, -2)
        return spmd.ppermute(y.reshape(b.shape), "x", [(0, 0)])

    base = spmd.Mesh(np.zeros((1, 1), np.int64), ("x", "y"), "cuda")
    x = torch.randn(64, 96, generator=torch.Generator().manual_seed(0)).cuda()
    a, b = make_inputs(PG_NCCL_MATMUL, PG_NCCL_MATMUL, PG_NCCL_MATMUL, seed=3,
                       device="cuda")
    want = spmd.shard_map(body, base, (P("x", "y"),), P("x", "y"))(x)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    with world.world("nccl", 1, address=f"tcp://127.0.0.1:{port}") as w:
        mesh = w.place(base)
        spmd.reset_counts()
        world.reset_staged()
        got = spmd.shard_map(body, mesh, (P("x", "y"),), P("x", "y"))(x).full_tensor()
        ops.reset_launch_counts()
        c = ALGORITHMS["cannon"].matmul(a, b, MatmulGrid(mesh, ("x", "y")), use_kernel=True)
        mm = ops.launch_counts()["matmul"]
        c_full = c.full_tensor()
        torch.cuda.synchronize()
        ran, staged = spmd.counts(), world.staged_bytes()
        local = str(c.to_local().device)
    wall = time.perf_counter() - t0
    expect = ref.matmul(a, b)
    diff = float((got - want).abs().max())
    rel = float((c_full - expect).abs().max() / expect.abs().max())
    print(f"nccl one-rank world: rank 0 on {mesh.device} (device_ids {base.device_ids.tolist()}), "
          f"collectives {dict(sorted(ran.items()))}, max |diff| vs virtual {diff:.3e}; "
          f"cannon {PG_NCCL_MATMUL}^3 rel err {rel:.3e}, {mm} matmul launches, block on "
          f"{local}; staged {staged or 'none'}; {wall:.2f} s with the group's start-up")
    if diff > 0 or rel > MATMUL_REL_TOL or mm < 1 or local != "cuda:0" or staged:
        fail("nccl one-rank world: the collectives or Cannon's product disagree, or a "
             "block left card 0, or something was staged")


def matmul_bf16_phase() -> dict[str, int]:
    """The six matmul apps once on bf16 inputs through
    ``<algo>.matmul(..., use_kernel=True)``, at the registry's problem and
    default processor counts, counters set to 0 just before each run and
    read just after; each held to an fp32 ``torch.matmul`` of the same bf16
    inputs (TF32 off) within ``MM_BF16_APP_REL`` of its largest |entry|.
    Prints the counted run's wall time and a second, uncounted one's.
    Returns each app's bf16 matmul launches."""
    import torch

    from repro_torch import apps
    from repro_torch.apps import definitions
    from repro_torch.kernels import ops, ref
    from repro_torch.matmul import ALGORITHMS
    from repro_torch.matmul.common import MatmulGrid, make_inputs

    p = definitions.MATMUL_PROBLEM
    a, b = make_inputs(p.m, p.k, p.n, seed=0, dtype=torch.bfloat16, device="cuda")
    ref.no_tf32()
    expect = torch.matmul(a.float(), b.float())
    largest = float(expect.abs().max())

    def run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    print(f"bf16 apps at {p.m}x{p.k}x{p.n} (largest |entry| {largest:.3e}; limit "
          f"{MM_BF16_APP_REL} of it):")
    print(f"{'app':10s} {'procs':>5s} {'max_err':>10s} {'rel_err':>10s} {'first ms':>10s} "
          f"{'again ms':>10s} {'matmul':>6s} ok")
    launches, failures = {}, []
    for app in apps.iter_apps(kind=apps.MATMUL):
        plan = app.spmd_plan(app.default_procs, device="cuda")
        grid = MatmulGrid(mesh=plan.mesh, axis_names=plan.axis_names)
        fn = lambda: ALGORITHMS[app.name].matmul(a, b, grid, use_kernel=True)  # noqa: E731
        ops.reset_launch_counts()
        out, first = run(fn)
        launches[app.name] = ops.launch_counts()["matmul"]
        _, again = run(fn)
        err = float((out.float() - expect).abs().max())
        ok = (out.dtype == torch.bfloat16 and tuple(out.shape) == tuple(expect.shape)
              and bool(torch.isfinite(out.float()).all()) and err <= MM_BF16_APP_REL * largest)
        print(f"{app.name:10s} {app.default_procs:5d} {err:10.3e} {err / largest:10.3e} "
              f"{first:10.3f} {again:10.3f} {launches[app.name]:6d} {ok}")
        if not ok:
            failures.append(f"{app.name} bf16: max |diff| {err:.3e} of largest {largest:.3e}")
        if launches[app.name] == 0:
            failures.append(f"{app.name} bf16 never launched the matmul kernel")
    if failures:
        fail("; ".join(failures))
    return launches


def steady_times(repeats: int = 6) -> None:
    """Per-app wall time after the first full-size run (uncounted): median,
    min and max of runs 2..``repeats`` on the same inputs."""
    import statistics

    from repro_torch import apps
    from repro_torch.apps import validate

    print(f"{'app':10s} {'median ms':>10s} {'min ms':>10s} {'max ms':>10s} "
          f"(runs 2..{repeats} of {repeats})")
    for app in apps.iter_apps():
        res = validate.run(app, device="cuda", full=True, repeats=repeats)
        if not res["ok"]:
            fail(f"{app.name} out of tolerance in the timing pass ({res})")
        ms = res["ms"][1:]
        print(f"{app.name:10s} {statistics.median(ms):10.3f} {min(ms):10.3f} "
              f"{max(ms):10.3f}")


def segment_rowmax_phase() -> dict:
    """segment_rowmax against its plain version at the pricer's table
    shapes (2048 x 4096 and 1536 x 4096 at 4096 procs) and two ragged
    ones, then timed at 2048 x 4096 float64 for seg 1 and 4."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import segment_reduce as sr_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cases = [((r, c), seg, dt) for (r, c) in ((2048, 4096), (1536, 4096))
             for seg in (1, 4) for dt in ("float64", "float32")]
    cases += [((1000, 780), 4, dt) for dt in ("float64", "float32")]
    cases += [((7, 5), 1, dt) for dt in ("float64", "float32")]
    errs, tables = {}, {}
    for shape, seg, dt in cases:
        vals = torch.rand(shape, generator=gen, device="cuda",
                          dtype=getattr(torch, dt))
        out = sr_mod.segment_rowmax_cuda(vals, seg)
        expect = ref.segment_rowmax(vals, seg)
        torch.cuda.synchronize()
        err = float((out - expect).abs().max())
        if out.shape != expect.shape or not torch.allclose(out, expect, **SR_TOL[dt]):
            fail(f"segment_rowmax {dt} {shape} seg={seg} disagrees with its "
                 f"plain version: max |diff| {err:.3e} beyond {SR_TOL[dt]}")
        print(f"parity segment_rowmax {dt:8s} {shape[0]}x{shape[1]} seg={seg}: "
              f"max_abs_err={err:.3e}")
        errs[dt] = max(errs.get(dt, 0.0), err)
        if shape == (2048, 4096) and dt == "float64":
            tables[seg] = vals

    timed = {}
    for seg, vals in tables.items():
        rows, cols = vals.shape
        ms = time_ms(lambda: sr_mod.segment_rowmax_cuda(vals, seg), reps=500)
        plain = time_ms(lambda: ref.segment_rowmax(vals, seg), reps=500)
        # seg 1 is a row max, torch.amax; no single PyTorch call sums
        # segments and takes their max.
        lib = (time_ms(lambda: torch.amax(vals, 1), reps=500) if seg == 1
               else None)
        bnd, by = bound_ms(float(rows * cols), 8.0 * (rows * cols + rows),
                           "float64")
        timed[seg] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                      "bound_ms": bnd, "bound_by": by}
        print(f"time   segment_rowmax float64 {rows}x{cols} seg={seg}: kernel "
              f"{ms:.5f} ms, plain {plain:.5f} ms, bound {bnd:.5f} ms ({by}), "
              + (f"torch.amax {lib:.5f} ms" if lib is not None
                 else "no single PyTorch call computes it"))
    return {"segment_rowmax": {
        **timed[1], "max_abs_err": max(errs.values()),
        "max_abs_err_by_dtype": errs, "shape": [2048, 4096, 1],
        "dtype": "float64", "seg4": timed[4]}}


def _balanced_grid(model, app, procs: int):
    """The most balanced grid of ``app`` at ``procs`` that the time model
    accepts (minimal aspect ratio; the shape a tuner shortlists)."""
    best = None
    for grid in app.search_space.grids(procs):
        try:
            model._validate(grid)
        except ValueError:
            continue
        key = (max(grid) / min(grid), grid)
        if best is None or key < best[0]:
            best = (key, grid)
    return None if best is None else best[1]


def _max_rel(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b))) if a.size else 0.0


def pricer_phase() -> None:
    """The torch pricing engine on the card against the NumPy engine and
    against its own plain reduction, at 4096 processors."""
    import numpy as np

    from repro_torch import apps
    from repro_torch.kernels import ops
    from repro_torch.sim.cost import time_search_space
    from repro_torch.sim.torch_backend import _export_for, to_torch

    print(f"{'app':10s} {'grid':>9s} {'mode':>6s} {'table':>10s} {'rel_np':>9s} "
          f"{'rel_plain':>9s} {'launches':>8s} {'numpy ms':>9s} {'torch ms':>9s} "
          f"{'plain ms':>9s}")
    failures = []
    for app in apps.iter_apps():
        space = time_search_space(app)
        model = space.cost_model(PRICER_PROCS, dict(space.default_options))
        grid = _balanced_grid(model, app, PRICER_PROCS)
        if grid is None:
            failures.append(f"{app.name} has no simulable grid at {PRICER_PROCS}")
            continue
        rng = np.random.default_rng(7)
        stack = np.stack([rng.permutation(PRICER_PROCS) for _ in range(PRICER_ROWS)])
        eng = model.batch(grid)
        t0 = time.perf_counter()
        want = eng.step_times(stack[:PRICER_NUMPY_ROWS])
        np_ms = (time.perf_counter() - t0) * 1e3
        kern = to_torch(eng, device="cuda")
        plain_eng = to_torch(eng, device="cuda", use_kernel=False)
        exp = _export_for(eng.schedule, eng.topology)
        chunk = min(exp.chunk(exp.mode), PRICER_ROWS)
        ops.reset_launch_counts()
        got = kern.step_times(stack)
        launches = ops.launch_counts()["segment_rowmax"]
        plain = plain_eng.step_times(stack)

        def best_ms(engine):
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                engine.step_times(stack)
                best = min(best, time.perf_counter() - t0)
            return best * 1e3

        t_kern, t_plain = best_ms(kern), best_ms(plain_eng)
        rel_np = _max_rel(got[:PRICER_NUMPY_ROWS], want)
        rel_plain = _max_rel(got, plain)
        table = f"{chunk * exp.u}x{exp.ntiles}"
        g = "x".join(map(str, grid))
        print(f"{app.name:10s} {g:>9s} {exp.mode:>6s} {table:>10s} {rel_np:9.2e} "
              f"{rel_plain:9.2e} {launches:8d} {np_ms:9.2f} {t_kern:9.2f} "
              f"{t_plain:9.2f}")
        if not (np.isfinite(got).all() and got.shape == (PRICER_ROWS,)):
            failures.append(f"{app.name}: prices not finite of shape ({PRICER_ROWS},)")
        if rel_np > PRICER_RTOL:
            failures.append(f"{app.name}: torch vs NumPy engine {rel_np:.2e} > "
                            f"{PRICER_RTOL}")
        if rel_plain > KERNEL_VS_PLAIN_RTOL:
            failures.append(f"{app.name}: kernel vs plain reduction {rel_plain:.2e} "
                            f"> {KERNEL_VS_PLAIN_RTOL}")
        if exp.mode == "dense" and launches == 0:
            failures.append(f"{app.name}: dense schedule never launched "
                            f"segment_rowmax")
        if app.name == SCATTER_APP:
            failures += scatter_check(eng, kern, rng)
    if failures:
        fail("; ".join(failures))


def scatter_check(eng, kern, rng) -> list[str]:
    """Non-bijective rows take the scatter formulation (``index_add_``,
    atomic on the card): parity with the NumPy engine, and whether two
    runs agree bit for bit (reported; atomics may reorder the sums)."""
    import numpy as np

    stack = rng.integers(0, PRICER_PROCS, size=(PRICER_NUMPY_ROWS, PRICER_PROCS))
    want = eng.step_times(stack)
    first, second = kern.step_times(stack), kern.step_times(stack)
    rel = _max_rel(first, want)
    print(f"scatter {SCATTER_APP}: {PRICER_NUMPY_ROWS} non-bijective rows, "
          f"rel_np {rel:.2e}, two runs bit-identical: "
          f"{bool(np.array_equal(first, second))} (max rel diff "
          f"{_max_rel(first, second):.2e})")
    return ([] if rel <= PRICER_RTOL else
            [f"scatter pricing vs NumPy engine {rel:.2e} > {PRICER_RTOL}"])


def tune_phase(work: Path) -> tuple[int, dict, float]:
    """The tune path: ``apps.run.tune`` over the nine apps at 4096 procs,
    time domain, on the torch engine on the card (counted) and on the
    NumPy engine, each from cold schedule caches; same winners, placed
    seconds within 1e-6 relative. The torch tune stores its winners in an
    empty plan cache under ``work/stale`` (``warm_start_from``: no seeds,
    so the tune is the cold one), the stale plans of the remap phase.
    Returns segment_rowmax's launches in the torch run, the torch rows by
    app, and the torch tune's wall time."""
    from repro_torch import apps
    from repro_torch.apps import run as runner
    from repro_torch.kernels import ops
    from repro_torch.sim.collectives import clear_caches

    selection = list(apps.iter_apps())
    results, walls = {}, {}
    for backend in ("torch", "numpy"):
        path = str(work / f"{backend}.json")
        clear_caches()        # both tunes build their schedules cold
        if backend == "torch":
            ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = runner.tune(selection, PRICER_PROCS, report=lambda line: None,
                         json_path=path, time_domain=True, backend=backend,
                         device="cuda",
                         warm_start_from=str(work / "stale") if backend == "torch" else None)
        walls[backend] = time.perf_counter() - t0
        if backend == "torch":
            launches = ops.launch_counts()["segment_rowmax"]
        if rc != 0:
            fail(f"the {backend} tune at {PRICER_PROCS} procs exited {rc}")
        results[backend] = {row["app"]: row for row in
                            json.loads(Path(path).read_text())["apps"]}
    failures = []
    print(f"{'app':10s} {'winner (torch)':34s} {'placed_s':>12s} {'rel':>9s} same")
    for name, row in results["numpy"].items():
        mine = results["torch"].get(name)
        if mine is None:
            failures.append(f"{name}: not tuned on the torch engine")
            continue
        same = mine["best"]["candidate"] == row["best"]["candidate"]
        pairs = [(a["placed_cost"], b["placed_cost"])
                 for a, b in zip(mine["leaderboard"], row["leaderboard"])
                 if a["placed_cost"] is not None and b["placed_cost"] is not None]
        rel = _max_rel([a for a, _ in pairs], [b for _, b in pairs])
        print(f"{name:10s} {mine['best']['candidate']:34s} "
              f"{mine['best']['placed_cost']:12.6e} {rel:9.2e} {same}")
        if not same:
            failures.append(f"{name}: winner {mine['best']['candidate']} on torch, "
                            f"{row['best']['candidate']} on NumPy")
        if rel > PRICER_RTOL or len(mine["leaderboard"]) != len(row["leaderboard"]):
            failures.append(f"{name}: placed seconds differ by {rel:.2e} (or the "
                            f"leaderboards differ in length)")
    print(f"tune wall: torch {walls['torch']:.2f} s, numpy {walls['numpy']:.2f} s; "
          f"segment_rowmax launches in the torch tune: {launches}")
    if launches == 0:
        failures.append("the torch tune never launched segment_rowmax")
    if any(row["warm_seeds"] for row in results["torch"].values()):
        failures.append("the torch tune took warm seeds from an empty plan cache")
    if failures:
        fail("; ".join(failures))
    return launches, results["torch"], walls["torch"]


def _leader_costs(leaderboard) -> dict:
    """A leaderboard's placed seconds by candidate (``row()`` dicts or
    ``ScoredCandidate``\\ s)."""
    rows = [s if isinstance(s, dict) else s.row() for s in leaderboard]
    return {r["candidate"]: r["placed_cost"] for r in rows}


def _hold_winner(what: str, mine: str, mine_board, ref: str, ref_board) -> list[str]:
    """A search's winner against a reference search's (the NumPy engine's,
    or an earlier run's): the same candidate, or one whose reference placed
    seconds tie the reference winner's (to float64 round-off,
    ``WINNER_TIE_RTOL``). Placed seconds within the pricer's 1e-6 rank by
    rank (so a leaderboard may end on another of candidates that tie at
    its cut) and candidate by candidate."""
    costs, theirs = _leader_costs(mine_board), _leader_costs(ref_board)
    failures = []
    if mine != ref:
        best = theirs[ref]
        tied = {c for c, v in theirs.items() if v is not None and best is not None
                and abs(v - best) <= WINNER_TIE_RTOL * abs(best)}
        print(f"  {what}: winner {mine}, reference {ref}; reference ties "
              f"{sorted(tied)}")
        if mine not in tied:
            failures.append(f"{what}: winner {mine}, reference {ref}")
    if len(costs) != len(theirs):
        failures.append(f"{what}: leaderboards of {len(costs)} and {len(theirs)}")
    pairs = [(costs[c], theirs[c]) for c in costs if c in theirs]
    pairs += list(zip(costs.values(), theirs.values()))
    pairs = [(a, b) for a, b in pairs if a is not None and b is not None]
    rel = _max_rel([a for a, _ in pairs], [b for _, b in pairs])
    if rel > PRICER_RTOL:
        failures.append(f"{what}: placed seconds differ by {rel:.2e}")
    return failures


def _scenarios(spec) -> dict:
    """The two failure scenarios of benchmarks/resilience_bench.py (the
    first of each twin): processor ``nprocs-1`` dead, and port 0 of
    level 0 (level 1 where the machine's first dimension is 1) slowed by
    ``REMAP_CONTENTION``."""
    from repro_torch.core.machine import DegradedMachine

    level = 0 if int(spec.shape[0]) >= 2 else 1
    return {"node-death": DegradedMachine.fail_procs(spec, [spec.nprocs - 1]),
            "contention": DegradedMachine.contend(spec, level, {0: REMAP_CONTENTION})}


def remap_phase(work: Path) -> int:
    """The fault remapper at 4096 procs: each app's stale plan (the tune
    phase's torch winner) remapped warm and cold under both scenarios on
    the torch engine on the card, with no work on a dead processor and
    the remapped degraded step time no worse than the stale plan's; each
    warm remap, and the cold ones of ``REMAP_NUMPY_COLD_APPS``, held to
    the same remap on the NumPy engine: the same sub-machine shape, the
    same winner, placed seconds within 1e-6. Returns segment_rowmax's
    launches in the phase."""
    import numpy as np

    from repro_torch import apps
    from repro_torch.kernels import ops
    from repro_torch.search.remap import remap_plan
    from repro_torch.serving.mapsvc import plan_key_for
    from repro_torch.serving.plan_cache import PlanCache
    from repro_torch.sim.collectives import clear_caches
    from repro_torch.sim.cost import spec_for, time_tuned_app

    stale_plans = PlanCache(work / "stale" / "plans")
    walls = {(e, m): 0.0 for e in ("batched-torch", "batched") for m in ("warm", "cold")}
    failures = []
    print(f"{'app':10s} {'scenario':10s} {'sub':>9s} {'winner (torch)':30s} "
          f"{'degraded_s':>12s} {'stale_s':>12s} {'torch warm/cold s':>18s} "
          f"{'numpy warm/cold s':>18s}")
    ops.reset_launch_counts()
    for app in apps.iter_apps():
        if app.search_space is None or not app.search_space.grids(PRICER_PROCS):
            print(f"{app.name:10s} skipped: no grid of its search space at "
                  f"{PRICER_PROCS} procs")
            continue
        tuned = time_tuned_app(app, engine="batched-torch", device="cuda")
        n, key, _ = plan_key_for(tuned, PRICER_PROCS, engine="batched-torch")
        stale = stale_plans.get(key)
        if stale is None:
            failures.append(f"{app.name}: no stale plan from the tune phase")
            continue
        spec = spec_for(app.machine_shape(n))
        for scenario, degraded in _scenarios(spec).items():
            res, secs = {}, {}
            for engine in ("batched-torch", "batched"):
                clear_caches()     # each engine's pair starts from cold schedules
                for mode in ("warm", "cold"):
                    if (engine, mode) == ("batched", "cold") \
                            and app.name not in REMAP_NUMPY_COLD_APPS:
                        continue
                    t0 = time.perf_counter()
                    res[engine, mode] = remap_plan(app, stale, degraded, mode=mode,
                                                   engine=engine, procs=n, device="cuda")
                    secs[engine, mode] = time.perf_counter() - t0
                    walls[engine, mode] += secs[engine, mode]
            dead = set(degraded.dead_procs)
            for mode in ("warm", "cold"):
                mine, ref = res["batched-torch", mode], res.get(("batched", mode))
                what = f"{app.name} {scenario} {mode}"
                if dead & {int(p) for p in mine.placement.reshape(-1)}:
                    failures.append(f"{what}: work placed on a dead processor")
                if not (np.isfinite(mine.degraded_step_s)
                        and mine.degraded_step_s <= mine.stale_step_s * (1 + STEP_SLACK)):
                    failures.append(f"{what}: degraded step {mine.degraded_step_s:.6e} s "
                                    f"worse than the stale plan's {mine.stale_step_s:.6e} s")
                if ref is None:
                    continue
                if mine.sub_shape != ref.sub_shape:
                    failures.append(f"{what}: sub-machine {mine.sub_shape} on torch, "
                                    f"{ref.sub_shape} on NumPy")
                failures += _hold_winner(what, mine.report.best.candidate.describe(),
                                         mine.report.leaderboard,
                                         ref.report.best.candidate.describe(),
                                         ref.report.leaderboard)
                if _max_rel([mine.degraded_step_s], [ref.degraded_step_s]) > PRICER_RTOL:
                    failures.append(f"{what}: degraded step {mine.degraded_step_s:.6e} s on "
                                    f"torch, {ref.degraded_step_s:.6e} s on NumPy")
            warm = res["batched-torch", "warm"]
            sub = "x".join(map(str, warm.sub_shape))
            numpy_cold = (f"{secs['batched', 'cold']:<9.3f}" if ("batched", "cold") in secs
                          else f"{'-':9s}")
            print(f"{app.name:10s} {scenario:10s} {sub:>9s} "
                  f"{warm.report.best.candidate.describe():30s} {warm.degraded_step_s:12.6e} "
                  f"{warm.stale_step_s:12.6e} "
                  f"{secs['batched-torch', 'warm']:8.3f}/{secs['batched-torch', 'cold']:<9.3f} "
                  f"{secs['batched', 'warm']:8.3f}/{numpy_cold}")
    launches = ops.launch_counts()["segment_rowmax"]
    print(f"remap wall s, summed over apps and scenarios: torch warm "
          f"{walls['batched-torch', 'warm']:.3f}, torch cold {walls['batched-torch', 'cold']:.3f}, "
          f"numpy warm {walls['batched', 'warm']:.3f}, numpy cold "
          f"{walls['batched', 'cold']:.3f} (cold on NumPy for "
          f"{', '.join(REMAP_NUMPY_COLD_APPS)} only); segment_rowmax launches in the "
          f"phase: {launches}")
    if launches == 0:
        failures.append("the torch remaps never launched segment_rowmax")
    if failures:
        fail("; ".join(failures))
    return launches


def service_trace() -> list:
    """``SERVICE_REQUESTS`` requests drawn as
    ``repro_torch.serving.serve.demo_trace`` draws them (seed 0, each
    request after the first repeats an earlier one with probability 0.7)
    from a pool of the nine apps at ``SERVICE_PROCS``."""
    import random

    from repro_torch import apps
    from repro_torch.serving import TuneRequest

    pool = [TuneRequest(app.name, procs) for app in apps.iter_apps()
            if app.search_space is not None for procs in SERVICE_PROCS]
    rng = random.Random(0)
    out = []
    for _ in range(SERVICE_REQUESTS):
        if out and rng.random() < 0.7:
            out.append(rng.choice(out))
        else:
            out.append(rng.choice(pool))
    return out


def _hold_plans(what: str, mine: list, ref: list) -> list[str]:
    """Two runs' results, request by request: both plans, the same winner
    (or a reference tie), placed seconds within 1e-6; for a remap also the
    same sub-machine and degraded step time."""
    from repro_torch.serving import MappingPlan

    failures = []
    for i, (a, b) in enumerate(zip(mine, ref)):
        if not (isinstance(a, MappingPlan) and isinstance(b, MappingPlan)):
            failures.append(f"{what} request {i}: {a!r} against {b!r}")
            continue
        tag = f"{what} request {i} ({a.app} at {a.procs})"
        failures += _hold_winner(tag, a.leaderboard[0]["candidate"], a.leaderboard,
                                 b.leaderboard[0]["candidate"], b.leaderboard)
        if _max_rel([a.placed_cost], [b.placed_cost]) > PRICER_RTOL:
            failures.append(f"{tag}: placed {a.placed_cost} against {b.placed_cost}")
        if (a.remap is None) != (b.remap is None):
            failures.append(f"{tag}: one answer is a remap, the other not")
        elif a.remap is not None:
            if a.remap["sub_shape"] != b.remap["sub_shape"]:
                failures.append(f"{tag}: sub-machine {a.remap['sub_shape']} against "
                                f"{b.remap['sub_shape']}")
            if _max_rel([a.remap["degraded_step_s"]], [b.remap["degraded_step_s"]]) \
                    > PRICER_RTOL:
                failures.append(f"{tag}: degraded step {a.remap['degraded_step_s']} "
                                f"against {b.remap['degraded_step_s']}")
    if len(mine) != len(ref):
        failures.append(f"{what}: {len(mine)} results against {len(ref)}")
    return failures


def service_phase(work: Path) -> int:
    """The mapping service: the trace plus two node-death remaps through a
    torch-engine service on the card (one worker), held to a NumPy-engine
    service on the same trace; a second service on the same directory
    answering every tune request from the plan cache; a two-worker service
    giving the serial run's plans; and the service CLI's ``--demo`` on the
    torch engine. Returns segment_rowmax's launches in the phase."""
    import numpy as np

    from repro_torch import apps
    from repro_torch.kernels import ops
    from repro_torch.serving import MappingPlan, MappingService, RemapRequest, serve
    from repro_torch.serving.mapsvc import replay
    from repro_torch.sim.collectives import clear_caches
    from repro_torch.sim.cost import spec_for

    trace = service_trace()
    big = list(dict.fromkeys(r.app for r in trace if r.procs == PRICER_PROCS))[:2]
    remaps = []
    for name in big:
        spec = spec_for(apps.get(name).machine_shape(PRICER_PROCS))
        remaps.append(RemapRequest(app=name, failures=[spec.nprocs - 1],
                                   procs=PRICER_PROCS))
    print(f"service trace: {len(trace)} requests, {len(set(trace))} distinct "
          f"({sorted({(r.app, r.procs) for r in trace})}), then node-death remaps "
          f"of {big} at {PRICER_PROCS}")
    runs = {}
    ops.reset_launch_counts()
    for run, engine, workers, root in (("torch", "batched-torch", 1, "svc"),
                                       ("numpy", "batched", 1, "svc_numpy"),
                                       ("cached", "batched-torch", 1, "svc"),
                                       ("two workers", "batched-torch", 2, "svc_two")):
        clear_caches()
        t0 = time.perf_counter()
        with MappingService(work / root, engine=engine, device="cuda",
                            workers=workers) as svc:
            # The remaps follow the resolved trace, so their stale plans
            # are in the cache whatever the batch boundaries were.
            runs[run] = replay(svc, trace)
            if run != "cached":
                runs[run] += replay(svc, remaps)
        wall = time.perf_counter() - t0
        summary = svc.stats.summary()
        print(f"service {run:11s} ({engine}, {workers} worker{'s' * (workers > 1)}): "
              f"{len(runs[run])} requests in {wall:.3f} s, {summary['cache_hits']} cache hits, "
              f"{summary['searches']} searches, {summary['remaps']} remaps, p50 "
              f"{summary['latency']['p50_s']:.4f} s, p95 {summary['latency']['p95_s']:.4f} s")
        print(f"service {run} stats: {json.dumps(summary)}")
    failures = _hold_plans("torch vs numpy", runs["torch"], runs["numpy"])
    failures += _hold_plans("cached vs first", runs["cached"], runs["torch"][:len(trace)])
    failures += [f"cached run request {i}: provenance {p.provenance}"
                 for i, p in enumerate(runs["cached"])
                 if getattr(p, "provenance", None) != "cache"]
    failures += _hold_plans("two workers vs serial", runs["two workers"], runs["torch"])
    for req, plan in zip(remaps, runs["torch"][len(trace):]):
        if isinstance(plan, MappingPlan) and \
                np.isin(np.asarray(plan.remap["placement"]), req.failures).any():
            failures.append(f"service remap of {plan.app} placed work on a dead processor")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--demo", "20", "--backend", "torch", "--json"])
    answered = [json.loads(line) for line in out.getvalue().splitlines()
                if line.startswith('{"app"')]
    print(f"serve --demo 20 --backend torch --json: exit {rc}, {len(answered)} answers, "
          f"value tags {sorted({a.get('value_tag', a.get('rejected')) for a in answered})}")
    if len(answered) != 20:
        failures.append(f"serve --demo 20 answered {len(answered)} requests")
    if rc != 0:
        failures.append(f"repro_torch.serving.serve --demo 20 --backend torch exited {rc}")
    launches = ops.launch_counts()["segment_rowmax"]
    print(f"segment_rowmax launches in the service phase: {launches}")
    if launches == 0:
        failures.append("the torch services never launched segment_rowmax")
    if failures:
        fail("; ".join(failures))
    return launches


def warm_start_phase(work: Path, tuned: dict, cold_wall: float) -> int:
    """``apps.run.tune`` at 4096 procs on the torch engine, seeded from the
    plan cache the service filled (``warm_start_from``): it must pick the
    tune phase's nine winners with placed seconds within 1e-6. Returns
    segment_rowmax's launches in the run."""
    from repro_torch import apps
    from repro_torch.apps import run as runner
    from repro_torch.kernels import ops
    from repro_torch.sim.collectives import clear_caches

    path = work / "warm.json"
    clear_caches()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = runner.tune(list(apps.iter_apps()), PRICER_PROCS, report=lambda line: None,
                     json_path=str(path), time_domain=True, backend="torch",
                     device="cuda", warm_start_from=str(work / "svc"))
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()["segment_rowmax"]
    if rc != 0:
        fail(f"the warm-started torch tune at {PRICER_PROCS} procs exited {rc}")
    rows = {row["app"]: row for row in json.loads(path.read_text())["apps"]}
    failures = []
    for name, want in tuned.items():
        row = rows.get(name)
        if row is None:
            failures.append(f"{name}: not tuned warm")
            continue
        print(f"warm-start {name:10s} seeds {row['warm_seeds']} winner "
              f"{row['best']['candidate']:30s} placed {row['best']['placed_cost']:.6e}")
        if row["best"]["candidate"] != want["best"]["candidate"]:
            failures.append(f"{name}: warm winner {row['best']['candidate']}, cold "
                            f"{want['best']['candidate']}")
        if _max_rel([row["best"]["placed_cost"]], [want["best"]["placed_cost"]]) > PRICER_RTOL:
            failures.append(f"{name}: warm placed {row['best']['placed_cost']}, cold "
                            f"{want['best']['placed_cost']}")
    print(f"warm-start tune wall: {wall:.3f} s (the tune phase's cold torch tune "
          f"{cold_wall:.3f} s); {sum(r['warm_seeds'] for r in rows.values())} seeds; "
          f"segment_rowmax launches {launches}")
    if launches == 0:
        failures.append("the warm-started tune never launched segment_rowmax")
    if failures:
        fail("; ".join(failures))
    return launches


def _attention_pairs(S: int, window: int, causal: bool = True) -> int:
    """(query, key) pairs the mask lets through, per (batch, head)."""
    total = 0
    for q in range(S):
        lo = max(0, q - window + 1) if window > 0 else 0
        hi = q + 1 if causal else S
        total += hi - lo
    return total


def _sdpa(q, k, v, window: int):
    """The library yardstick: one ``F.scaled_dot_product_attention`` call
    on the (B, heads, S, d) views, causal with the window as a boolean
    mask, GQA in the call."""
    import torch
    import torch.nn.functional as F

    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    ok = pos[:, None] >= pos[None, :]
    if window > 0:
        ok = ok & (pos[:, None] - pos[None, :] < window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=ok,
                                                  enable_gqa=True)


def flash_edges_phase(gen) -> dict[str, float]:
    """Each flash kernel against its plain version at its tile edges
    (bf16 ``FLASH_EDGES``, fp32 ``FLASH_F32_EDGES``); each list's last case
    hands the kernel a k whose heads start 16 - 8 bytes into a padded row,
    which the wrapper copies. Returns the largest error of each dtype."""
    import torch

    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops

    err_all = {}
    for dt, edges in (("bfloat16", FLASH_EDGES), ("float32", FLASH_F32_EDGES)):
        dtype = getattr(torch, dt)
        skew = 8 // torch.empty((), dtype=dtype).element_size()   # 8 bytes off 16
        err_all[dt] = 0.0
        for B, S, H, Kv, d, window, causal, misaligned in edges:
            q = torch.randn((B, S, H, d), generator=gen, device="cuda").to(dtype)
            if misaligned:
                k = torch.randn((B, S, Kv * d + skew), generator=gen, device="cuda").to(
                    dtype)[..., skew:].unflatten(-1, (Kv, d))
                if fa_mod.kernel_ready(k):
                    fail(f"the misaligned {dt} flash operand counts as aligned")
            else:
                k = torch.randn((B, S, Kv, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((B, S, Kv, d), generator=gen, device="cuda").to(dtype)
            out = fa_mod.flash_attention_cuda(q, k, v, window=window, causal=causal)
            expect = ops.flash_attention_plain(q, k, v, window=window, causal=causal)
            torch.cuda.synchronize()
            tag = (f"flash_attention {dt} B={B} S={S} H={H}/{Kv} d={d} window={window}"
                   f"{'' if causal else ' not causal'}{' misaligned k' if misaligned else ''}")
            if not torch.isfinite(out.float()).all():
                fail(f"{tag}: non-finite output")
            err = check_close(tag, out, expect, dt)
            err_all[dt] = max(err_all[dt], err)
            print(f"parity {tag}: max_abs_err={err:.3e}")
    return err_all


def lm_kernel_phase() -> dict:
    """flash_attention and mamba_scan against their plain versions at the
    LM serving path's shapes, then timed with their bounds."""
    import torch

    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import mamba_scan as ms_mod
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    # (B, S, H, Kv, d, window): hymba prefill, smollm prefill, qwen2-moe
    # prefill (head dim 128), ragged.
    shapes = [(LM_BATCH, LM_PROMPT, 25, 5, 64, 1024), (LM_BATCH, LM_PROMPT, 9, 3, 64, 0),
              (LM_BATCH, LM_PROMPT, 16, 16, 128, 0), (2, 1000, 25, 5, 64, 1024)]
    fa_rows, fa_err = {}, 0.0
    for B, S, H, Kv, d, window in shapes:
        for dt in ("bfloat16", "float32"):
            dtype = getattr(torch, dt)
            q = torch.randn((B, S, H, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((B, S, Kv, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((B, S, Kv, d), generator=gen, device="cuda").to(dtype)
            out = fa_mod.flash_attention_cuda(q, k, v, window=window)
            expect = ops.flash_attention_plain(q, k, v, window=window)
            torch.cuda.synchronize()
            tag = f"flash_attention {dt} B={B} S={S} H={H}/{Kv} d={d} window={window}"
            if not torch.isfinite(out.float()).all():
                fail(f"{tag}: non-finite output")
            err = check_close(tag, out, expect, dt)
            fa_err = max(fa_err, err)
            print(f"parity {tag}: max_abs_err={err:.3e}")
            if S != LM_PROMPT:
                continue
            ms = time_ms(lambda: fa_mod.flash_attention_cuda(q, k, v, window=window), reps=10)
            plain = time_ms(lambda: ops.flash_attention_plain(q, k, v, window=window),
                            reps=3, warmup=1)
            lib = time_ms(_sdpa(q, k, v, window), reps=10)
            es = q.element_size()
            nbytes = es * (2 * q.numel() + k.numel() + v.numel())
            flops = 4.0 * d * B * H * _attention_pairs(S, window)
            bnd, by = bound_ms(flops, nbytes, dt)
            print(f"time   {tag}: kernel {ms:.4f} ms ({tflops(flops, ms)}, "
                  f"{bnd / ms:.1%} of bound), plain {plain:.4f} ms, sdpa {lib:.4f} ms "
                  f"({tflops(flops, lib)}), bound {bnd:.5f} ms ({by}); kernel / sdpa "
                  f"{ms / lib:.3f}" + (" (target <= 1)" if dt == "bfloat16" else ""))
            fa_rows[(H, dt)] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                                "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
                                "shape": [B, S, H, Kv, d, window], "dtype": dt}

    edge_err = flash_edges_phase(gen)
    fa_err = max(fa_err, *edge_err.values())

    # mamba_scan: hymba's prefill shape (timed), a ragged one, the tile edges.
    ms_err, ms_row = 0.0, None
    for B, T, di, n in ((LM_BATCH, LM_PROMPT, 3200, 16), (2, 100, 24, 8), *MAMBA_EDGES):
        xs = 0.5 * torch.randn((B, T, di), generator=gen, device="cuda")
        dtt = 0.2 * torch.nn.functional.softplus(
            torch.randn((B, T, di), generator=gen, device="cuda"))
        Bs = 0.5 * torch.randn((B, T, n), generator=gen, device="cuda")
        Cs = 0.5 * torch.randn((B, T, n), generator=gen, device="cuda")
        A = -torch.exp(0.3 * torch.randn((di, n), generator=gen, device="cuda"))
        y, s = ms_mod.mamba_scan_cuda(xs, dtt, Bs, Cs, A)
        y_ref, s_ref = ref.mamba_scan(xs, dtt, Bs, Cs, A)
        torch.cuda.synchronize()
        tag = f"mamba_scan float32 B={B} T={T} di={di} n={n}"
        err = max(check_close(tag + " y", y, y_ref, "float32"),
                  check_close(tag + " state", s, s_ref, "float32"))
        ms_err = max(ms_err, err)
        print(f"parity {tag}: max_abs_err={err:.3e}")
        if T != LM_PROMPT:
            continue
        ms = time_ms(lambda: ms_mod.mamba_scan_cuda(xs, dtt, Bs, Cs, A), reps=20)
        plain = time_ms(lambda: ref.mamba_scan(xs, dtt, Bs, Cs, A), reps=3, warmup=1)
        elems = B * T * di * n
        nbytes = 4.0 * (3 * B * T * di + 2 * B * T * n + di * n + B * di * n)
        bnd, by = bound_ms(7.0 * elems + B * T * di, nbytes, "float32")
        exp_ms = elems / MUFU_EX2_PER_S * 1e3
        print(f"time   {tag}: kernel {ms:.4f} ms ({bnd / ms:.1%} of bound), plain "
              f"{plain:.4f} ms, bound {bnd:.5f} ms ({by}); one exponential an element "
              f"takes {exp_ms:.5f} ms on the MUFU ({exp_ms / ms:.1%} of the kernel's "
              f"time); no single PyTorch call computes the scan")
        ms_row = {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": bnd,
                  "bound_by": by, "shape": [B, T, di, n], "dtype": "float32"}
    main_fa = fa_rows[(25, "bfloat16")]
    return {
        "flash_attention": {**main_fa, "max_abs_err": fa_err,
                            "float32": fa_rows[(25, "float32")],
                            "smollm": {"bfloat16": fa_rows[(9, "bfloat16")],
                                       "float32": fa_rows[(9, "float32")]},
                            "qwen2_moe": {"bfloat16": fa_rows[(16, "bfloat16")],
                                          "float32": fa_rows[(16, "float32")]}},
        "mamba_scan": {**ms_row, "max_abs_err": ms_err},
    }


def mixer_kernel_phase() -> tuple[dict, dict]:
    """Hymba's mixer kernels at ``MIXER_SHAPES`` on the mixer's layouts (xz's
    and bc's halves read in place), bf16 and fp32, each against its plain
    twin in ``ops`` (the conv's tail and the scan's state too); timed in
    bf16 with their bounds, beside their plain twins, the operator chain
    each replaced (the mixer's zero-state route before them) and the fp32
    plain scan on the same values. Returns the conv's row and the gated
    scan's, each at the cell's shape with the LM path's under ``lm``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import causal_conv as cc_mod
    from repro_torch.kernels import mamba_scan as ms_mod
    from repro_torch.kernels import ops
    from repro_torch.models.hymba import _causal_conv

    gen = torch.Generator(device="cuda")
    gen.manual_seed(30)
    di, n, W = MIXER_DIMS
    conv_rows, scan_rows, err_c, err_s = [], [], 0.0, 0.0

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    for B, T in MIXER_SHAPES:
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            xz, w = randn(B, T, 2 * di).to(dtype), (0.5 * randn(W, di)).to(dtype)
            dt_raw, bc = randn(B, T, di).to(dtype), (0.5 * randn(B, T, 2 * n)).to(dtype)
            A, dt_bias = -torch.exp(0.3 * randn(di, n)), -1.5 + 0.1 * randn(di)
            D = randn(di).to(dtype)
            x, z = xz[..., :di], xz[..., di:]
            xs, tail = cc_mod.causal_conv_silu_cuda(x, w)
            xs_ref, tail_ref = ops.causal_conv_silu_plain(x, w)
            args = (xs, dt_raw, bc[..., :n], bc[..., n:], A, dt_bias, D, z)
            y, s = ms_mod.mamba_scan_gated_cuda(*args)
            y_ref, s_ref = ops.mamba_scan_gated_plain(*args)
            torch.cuda.synchronize()
            tag_c = f"causal_conv {dt} B={B} T={T} di={di} W={W}"
            tag_s = f"mamba_scan gated {dt} B={B} T={T} di={di} n={n}"
            if not (torch.isfinite(xs.float()).all() and torch.isfinite(y.float()).all()):
                fail(f"{tag_c} / {tag_s}: non-finite output")
            e_c = max(check_close(tag_c + " y", xs, xs_ref, dt),
                      check_close(tag_c + " tail", tail, tail_ref, dt))
            e_s = max(check_close(tag_s + " y", y, y_ref, dt),
                      check_close(tag_s + " state", s, s_ref, "float32"))
            err_c, err_s = max(err_c, e_c), max(err_s, e_s)
            print(f"parity {tag_c}: max_abs_err={e_c:.3e}")
            print(f"parity {tag_s}: max_abs_err={e_s:.3e} (max |y| "
                  f"{float(y_ref.float().abs().max()):.3e})")
            del xs_ref, tail_ref, y_ref, s_ref
            if dt != "bfloat16":
                continue
            es = xz.element_size()
            conv_ms = time_ms(lambda: cc_mod.causal_conv_silu_cuda(x, w), reps=20)
            conv_plain = time_ms(lambda: ops.causal_conv_silu_plain(x, w), reps=5)
            conv_chain = time_ms(lambda: F.silu(_causal_conv(x, w)[0]), reps=5)
            # x read and y written once, the weights read, the tail written.
            nbytes = es * (2 * B * T * di + W * di + (W - 1) * B * di)
            bnd, by = bound_ms((2 * W + 4) * B * T * di, nbytes, "float32")
            print(f"time   {tag_c}: kernel {conv_ms:.4f} ms ({bnd / conv_ms:.1%} of bound), "
                  f"plain {conv_plain:.4f} ms, the chain it replaced (_causal_conv + silu) "
                  f"{conv_chain:.4f} ms, bound {bnd:.5f} ms ({by})")
            conv_rows.append({"ms": conv_ms, "plain_ms": conv_plain, "chain_ms": conv_chain,
                              "library_ms": None, "bound_ms": bnd, "bound_by": by,
                              "shape": [B, T, di, W], "dtype": dt})

            def chain():       # the mixer's zero-state route before the gated scan
                dtf = F.softplus(dt_raw.float() + dt_bias)
                y32, _ = ms_mod.mamba_scan_cuda(xs.float(), dtf, bc[..., :n].float(),
                                                bc[..., n:].float(), A)
                return (y32.to(dtype) + xs * D) * F.silu(z)

            f32 = (xs.float(), F.softplus(dt_raw.float() + dt_bias),
                   bc[..., :n].float().contiguous(), bc[..., n:].float().contiguous(), A)
            scan_ms = time_ms(lambda: ms_mod.mamba_scan_gated_cuda(*args), reps=10)
            f32_ms = time_ms(lambda: ms_mod.mamba_scan_cuda(*f32), reps=10)
            scan_chain = time_ms(chain, reps=5)
            scan_plain = time_ms(lambda: ops.mamba_scan_gated_plain(*args), reps=1, warmup=0)
            del f32
            # xs, dt, z read and y written in bf16 with B and C; A, dt_bias,
            # D read and the state written. Operations: the plain scan's 7
            # an element and about 10 a (step, channel) for the softplus,
            # the D skip and the gate.
            elems = B * T * di * n
            nbytes = es * (4 * B * T * di + 2 * B * T * n + di) + 4.0 * (di * n + di + B * di * n)
            bnd, by = bound_ms(7.0 * elems + 10.0 * B * T * di, nbytes, "float32")
            exp_ms = elems / MUFU_EX2_PER_S * 1e3
            print(f"time   {tag_s}: kernel {scan_ms:.4f} ms ({bnd / scan_ms:.1%} of bound), "
                  f"plain {scan_plain:.4f} ms, the chain it replaced (casts, softplus, the "
                  f"fp32 scan, gate) {scan_chain:.4f} ms, the fp32 scan alone {f32_ms:.4f} "
                  f"ms, bound {bnd:.5f} ms ({by}); the scan's exponentials take "
                  f"{exp_ms:.5f} ms on the MUFU")
            scan_rows.append({"ms": scan_ms, "plain_ms": scan_plain, "chain_ms": scan_chain,
                              "float32_scan_ms": f32_ms, "library_ms": None,
                              "bound_ms": bnd, "bound_by": by, "shape": [B, T, di, n],
                              "dtype": dt})
            del xz, dt_raw, bc, xs, y, s
            torch.cuda.empty_cache()
    conv_row = {**conv_rows[-1], "max_abs_err": err_c, "lm": conv_rows[0]}
    scan_row = {**scan_rows[-1], "max_abs_err": err_s, "lm": scan_rows[0]}
    return conv_row, scan_row


def _wkv6_inputs(gen, B: int, T: int, H: int, N: int):
    """Drawn as tests/test_kernels.py::test_wkv6_shapes draws them: r, k, v
    at 0.5, w = sigmoid(.)*0.5+0.4, u at 0.1; the model layout."""
    import torch

    r, k, v = (0.5 * torch.randn((B, T, H, N), generator=gen, device="cuda")
               for _ in range(3))
    w = torch.sigmoid(torch.randn((B, T, H, N), generator=gen, device="cuda")) * 0.5 + 0.4
    u = 0.1 * torch.randn((H, N), generator=gen, device="cuda")
    return r, k, v, w, u


def wkv6_kernel_phase() -> dict:
    """wkv6 against its plain version at the rwkv6-3b prefill shape (timed,
    with its bound), a ragged T and the smaller head sizes."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv6 as wkv_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    shapes = [(LM_BATCH, LM_PROMPT, RWKV_HEADS, RWKV_HEAD), (2, 1000, RWKV_HEADS, RWKV_HEAD),
              (3, 333, 8, 32), (2, 512, 8, 16), *WKV6_EDGES]
    err_all, row = 0.0, None
    for B, T, H, N in shapes:
        r, k, v, w, u = _wkv6_inputs(gen, B, T, H, N)
        y, s = wkv_mod.wkv6_cuda(r, k, v, w, u)
        y_ref, s_ref = ops.wkv6_plain(r, k, v, w, u)
        torch.cuda.synchronize()
        tag = f"wkv6 float32 B={B} T={T} H={H} N={N}"
        if not (torch.isfinite(y).all() and torch.isfinite(s).all()):
            fail(f"{tag}: non-finite output")
        err = max(check_close(tag + " y", y, y_ref, "float32"),
                  check_close(tag + " state", s, s_ref, "float32"))
        err_all = max(err_all, err)
        print(f"parity {tag}: max_abs_err={err:.3e} (max |y| {float(y_ref.abs().max()):.3e})")
        if (B, T) != (LM_BATCH, LM_PROMPT):
            continue
        ms = time_ms(lambda: wkv_mod.wkv6_cuda(r, k, v, w, u), reps=50)
        plain = time_ms(lambda: ops.wkv6_plain(r, k, v, w, u), reps=3, warmup=1)
        # Bytes: r, k, v, w and u read once, y and the state written once.
        # Operations: 5*N^2 per (batch, head, step), the least the
        # recurrence needs (r.S 2N^2; decay, outer product and sum of the
        # state update 3N^2; the bonus term is O(N)).
        nbytes = 4.0 * (5 * B * T * H * N + H * N + B * H * N * N)
        bnd, by = bound_ms(5.0 * N * N * B * H * T, nbytes, "float32")
        print(f"time   {tag}: kernel {ms:.4f} ms ({bnd / ms:.1%} of bound), plain "
              f"{plain:.4f} ms, bound {bnd:.5f} ms ({by}); no single PyTorch call "
              f"computes the recurrence")
        row = {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": bnd,
               "bound_by": by, "shape": [B, T, H, N], "dtype": "float32"}
    return {"wkv6": {**row, "max_abs_err": err_all}}


def _full(arch: str, dtype: str, n_layers: int | None = None):
    """``arch`` at its published widths, at ``n_layers`` if given."""
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config(arch)
    return build(dataclasses.replace(cfg, dtype=dtype, n_layers=n_layers or cfg.n_layers))


def _tokens(cfg, B: int, S: int, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")


def _wall_s(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _counted(step, params, toks, expect: dict, what: str):
    """One counted run of a prefill step: counters to 0 just before, read
    just after; fails unless each kernel launched ``expect[name]`` times."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = step(params, toks)
    torch.cuda.synchronize()
    got = {k: ops.launch_counts()[k] for k in expect}
    if got != expect:
        fail(f"{what}: kernel launches {got}, expected {expect}")
    if not torch.isfinite(out.float()).all():
        fail(f"{what}: non-finite logits")
    return out, got


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _weights_gb(tree) -> float:
    if isinstance(tree, dict):
        return sum(_weights_gb(v) for v in tree.values())
    return tree.numel() * tree.element_size() / 1e9


def _peak_gb() -> str:
    import torch

    return f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"


@contextlib.contextmanager
def _routing(replay: list | None = None):
    """Patch ``moe.route`` for one run: record each call's expert ids
    (G, Ng, K) and top-k margin (the K-th minus the (K+1)-th router
    probability), in call order, kept on the card until read. With
    ``replay`` (ids recorded from another run, one entry a call in this
    run's order), each call returns those ids instead, gated by this run's
    probabilities renormalised, and records this run's own ids and the
    shortfall: this run's K-th probability minus the smallest replayed
    one (0 where the two sets agree). Routing is discontinuous: a near-tie
    in the top-k flips a token's experts when sums change order, so two
    runs are held to each other on shared routing, and every flip to a
    shortfall within ``FLIP_TOL``."""
    import torch

    from repro_torch.models import moe

    log, real = [], moe.route

    def recording(params, xg, cfg):
        logits, probs, gates, idx = real(params, xg, cfg)
        top = torch.topk(probs, cfg.topk + 1, dim=-1).values
        entry = {"ids": idx, "margin": top[..., -2] - top[..., -1]}
        if replay is not None:
            entry["own_ids"], idx = idx, replay[len(log)]
            entry["ids"] = idx
            chosen = torch.gather(probs, -1, idx)
            gates = chosen / torch.clamp(chosen.sum(-1, keepdim=True), min=1e-9)
            entry["shortfall"] = top[..., -2] - chosen.min(dim=-1).values
        log.append(entry)
        return logits, probs, gates, idx

    moe.route = recording
    try:
        yield log
    finally:
        moe.route = real


def _routing_check(what: str, log: list, ref: list, last: list[int]) -> None:
    """A replayed run's flips (tokens whose own expert set differs from the
    replayed one) and largest shortfall, and the reference run's smallest
    top-k margin over all tokens and at the ``last`` flat token indices
    (ref's entries a MoE layer); fails on a shortfall beyond FLIP_TOL."""
    import torch

    flips = sum(int((torch.sort(e["own_ids"], dim=-1).values
                     != torch.sort(e["ids"], dim=-1).values).any(-1).sum()) for e in log)
    shortfall = max(float(e["shortfall"].max()) for e in log)
    margins = torch.stack([e["margin"] for e in ref]).flatten(1)    # (L, G*Ng)
    print(f"{what}: routing flips {flips} of {margins.numel()} (token, MoE layer) expert "
          f"sets, largest shortfall {shortfall:.3e} (limit {FLIP_TOL:g}); the reference's "
          f"smallest top-k probability margin {float(margins.min()):.3e} over all tokens, "
          f"{float(margins[:, last].min()):.3e} at the last tokens")
    if shortfall > FLIP_TOL:
        fail(f"{what}: a replayed expert falls {shortfall:.3e} short of the top-k, beyond "
             f"{FLIP_TOL:g}: more than a near-tie")


def _refuses_kernels(step, params, toks, what: str) -> None:
    """MLA with use_kernel=True must raise its ValueError, launching no
    kernel; anything else fails the run."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    try:
        step(params, toks)
    except ValueError as e:
        if "MLA" not in str(e):
            fail(f"{what}: use_kernel=True raised a ValueError that does not name MLA: {e}")
        print(f"{what}: use_kernel=True raises ValueError: {e}")
    else:
        fail(f"{what}: use_kernel=True ran instead of raising the MLA ValueError")
    if any(ops.launch_counts().values()):
        fail(f"{what}: launched {ops.launch_counts()} before raising")


def lm_prefill_phase(arch: str, kernels: tuple[str, ...], tol: dict | None,
                     seed: int, n_layers: int | None = None) -> tuple[dict, dict]:
    """An LM serving path's prefill at ``arch``'s full width (at ``n_layers``
    if given, else its full depth): one counted
    bf16 prefill (each of ``kernels`` launched once per layer, every other
    kernel never), the fp32 kernel prefill against the plain one within
    ``tol``, and the bf16 wall time with and without the kernels. With no
    kernels (MLA), the served prefill is the plain one, counted with no
    launch; ``use_kernel=True`` must raise; the walls time the plain
    prefill. MoE configs print their routing diagnostic. Returns the counts
    and the state for decode and serving."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step

    torch.cuda.reset_peak_memory_stats()
    model, model32 = _full(arch, "bfloat16", n_layers), _full(arch, "float32", n_layers)
    cfg = model.cfg
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    moe_desc = (f", {cfg.n_experts} experts (padded to {cfg.padded_experts}) top-"
                f"{cfg.topk} of d_ff {cfg.moe_d_ff} + {cfg.n_shared_experts} shared, "
                f"{cfg.first_dense_layers} dense first" if cfg.n_experts else "")
    mla_desc = (f", MLA rank {cfg.kv_lora_rank}, qk {cfg.qk_nope_dim}+{cfg.qk_rope_dim}, "
                f"v {cfg.v_head_dim}" if cfg.use_mla else "")
    print(f"{arch}: {model.n_params} parameters, {_weights_gb(params):.2f} GB of fp32 "
          f"weights on the card ({time.perf_counter() - t0:.2f} s to draw), "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads} of {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, window "
          f"{cfg.sliding_window}, d_inner {cfg.d_inner}, state {cfg.ssm_state}, "
          f"vocabulary {cfg.vocab_size}{moe_desc}{mla_desc}")
    toks = _tokens(cfg, LM_BATCH, LM_PROMPT, seed=seed)
    expect = {k: cfg.n_layers if k in kernels else 0 for k in ops.launch_counts()}
    none = {k: 0 for k in expect}
    plain = make_prefill_step(model, use_kernel=False)
    plain32 = make_prefill_step(model32, use_kernel=False)
    last = [(b + 1) * LM_PROMPT - 1 for b in range(LM_BATCH)]
    want_shape = (LM_BATCH, 1, cfg.padded_vocab)

    if not kernels:
        # MLA: no kernel route. The served prefill is the plain one.
        for m in (model, model32):
            _refuses_kernels(make_prefill_step(m), params, toks,
                             f"{arch} {m.cfg.dtype} prefill")
        out_bf16, counts = _counted(plain, params, toks, none,
                                    f"{arch} bf16 plain prefill (the served route)")
        if tuple(out_bf16.shape) != want_shape:
            fail(f"{arch} prefill logits of shape {tuple(out_bf16.shape)}, not {want_shape}")
        ref32, _ = _counted(plain32, params, toks, none, f"{arch} fp32 plain prefill")
        print(f"{arch} prefill bf16: plain vs fp32 plain max |diff| "
              f"{_max_diff(out_bf16, ref32):.3e} (max |logit| {float(ref32.abs().max()):.3e}; "
              f"reported, no limit)")
        walls = {"plain": [_wall_s(lambda: plain(params, toks)) for _ in range(3)]}
    else:
        kern = make_prefill_step(model)
        kern32 = make_prefill_step(model32)
        # The main path: one counted bf16 prefill through the kernels.
        out_bf16, counts = _counted(kern, params, toks, expect, f"{arch} bf16 prefill")
        if tuple(out_bf16.shape) != want_shape:
            fail(f"{arch} prefill logits of shape {tuple(out_bf16.shape)}, not {want_shape}")
        out32, _ = _counted(kern32, params, toks, expect, f"{arch} fp32 prefill")
        with _routing() as log_p:
            ref32, _ = _counted(plain32, params, toks, none, f"{arch} fp32 plain prefill")
        ref_bf16, _ = _counted(plain, params, toks, none, f"{arch} bf16 plain prefill")
        if cfg.n_experts:
            free = _max_diff(out32, ref32)
            with _routing([e["ids"] for e in log_p]) as log_r:
                out32, _ = _counted(kern32, params, toks, expect,
                                    f"{arch} fp32 prefill on the plain prefill's routing")
            _routing_check(f"{arch} fp32 prefill, kernels on the plain prefill's routing",
                           log_r, log_p, last)
            print(f"{arch} fp32 prefill kernels vs plain, each routing freely: max |diff| "
                  f"{free:.3e} (reported; the check below shares the plain routing)")
        err32 = _max_diff(out32, ref32)
        print(f"{arch} prefill B={LM_BATCH} S={LM_PROMPT} last logits, kernels vs plain "
              f"max |diff|: fp32 {err32:.3e} (limit {tol}; max |logit| "
              f"{float(ref32.abs().max()):.3e}), bf16 {_max_diff(out_bf16, ref_bf16):.3e} "
              f"(finite; no limit)")
        if not torch.allclose(out32, ref32, **tol):
            fail(f"{arch} fp32 kernel prefill disagrees with the plain prefill: max |diff| "
                 f"{err32:.3e} beyond {tol}")
        print(f"{arch} prefill bf16: kernels vs fp32 plain max |diff| "
              f"{_max_diff(out_bf16, ref32):.3e}, bf16 plain vs fp32 plain "
              f"{_max_diff(ref_bf16, ref32):.3e} (reported, no limit)")
        if cfg.n_experts:
            again = kern(params, toks)
            print(f"{arch} bf16 kernel prefill run twice: max |diff| "
                  f"{_max_diff(again, out_bf16):.3e} (the scatter-adds' order; reported)")
        # Wall time in turns: kernels, plain, plain, kernels, kernels, plain.
        walls = {"kernels": [], "plain": []}
        for which in ("kernels", "plain", "plain", "kernels", "kernels", "plain"):
            step = kern if which == "kernels" else plain
            walls[which].append(_wall_s(lambda: step(params, toks)))
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"{arch} prefill bf16 B={LM_BATCH} S={LM_PROMPT} wall s, median of 3: "
          + ", ".join(f"{k} {med[k]:.4f} {v}" for k, v in walls.items()))
    print(f"{arch} prefill phase peak memory {_peak_gb()} (weights "
          f"{_weights_gb(params):.2f} GB)")
    return counts, {"params": params, "model": model, "model32": model32,
                    "use_kernel": bool(kernels)}


def lm_decode_phase(state: dict, arch: str) -> None:
    """A 256-token prompt teacher-forced through decode_step (fp32) against
    the prefill's last logits (through the kernels where the path has
    them); MoE configs on the prefill's routing (see FLIP_TOL)."""
    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    torch.cuda.reset_peak_memory_stats()
    model32, params = state["model32"], state["params"]
    cfg = model32.cfg
    toks = _tokens(cfg, 1, DECODE_PROMPT, seed=2)
    with _routing() as log_p:
        want = make_prefill_step(model32, use_kernel=state["use_kernel"])(params, toks)
    step = make_serve_step(model32)

    # MoE configs decode on the prefill's routing (decode calls the router
    # once a MoE layer a step: step-major); see FLIP_TOL.
    replay = ([e["ids"][:, t:t + 1] for t in range(DECODE_PROMPT) for e in log_p]
              if cfg.n_experts else None)
    cache = model32.init_cache(1, DECODE_PROMPT, device="cuda")
    torch.cuda.synchronize()
    with _routing(replay) as log_d:
        t0 = time.perf_counter()
        for t in range(DECODE_PROMPT):
            logits, cache = step(params, cache, t, toks[:, t:t + 1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    err = _max_diff(logits, want)
    print(f"{arch} decode fp32: {DECODE_PROMPT} teacher-forced steps (B=1) in {wall:.3f} s "
          f"({DECODE_PROMPT / wall:.1f} tok/s"
          + ("; on the prefill's routing, the replay's few ops a layer included"
             if cfg.n_experts else "")
          + f"); last logits vs {'kernel' if state['use_kernel'] else 'plain'} prefill "
          f"max |diff| {err:.3e}")
    if cfg.n_experts:
        _routing_check(f"{arch} decode on the prefill's routing", log_d, log_p,
                       [DECODE_PROMPT - 1])
    print(f"{arch} decode phase peak memory {_peak_gb()}")
    if not torch.allclose(logits, want, **DECODE_TOL):
        fail(f"{arch} decode disagrees with the prefill: max |diff| {err:.3e} beyond "
             f"{DECODE_TOL}")


def lm_serving_phase(state: dict, arch: str) -> None:
    """The continuous batcher on the phase's weights, then, with those
    freed (the CLI draws its own; two copies of an MoE config's fp32
    weights do not fit on the card), the serving CLI at full width."""
    import gc

    import numpy as np
    import torch

    from repro_torch.launch import serve
    from repro_torch.serving import ContinuousBatcher, Request

    torch.cuda.reset_peak_memory_stats()
    model, params = state["model"], state["params"]
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=rng.integers(0, model.cfg.vocab_size,
                                               size=int(rng.integers(16, 129))),
                    max_new_tokens=16) for i in range(8)]
    batcher = ContinuousBatcher(model, params, n_slots=4, max_len=128 + 16 + 1,
                                device="cuda")
    t0 = time.perf_counter()
    for r in reqs:
        batcher.submit(r)
    stats = batcher.run_until_drained()
    wall = time.perf_counter() - t0
    summary = stats.summary()
    print(f"{arch} batcher: 4 slots, 8 requests (prompts {[len(r.prompt) for r in reqs]}), "
          f"{wall:.3f} s, {summary['tokens_out'] / wall:.1f} generated tok/s, peak memory "
          f"{_peak_gb()}: {json.dumps(summary)}")
    if summary["completed"] != 8 or any(len(r.generated) != 16 for r in reqs):
        fail(f"the {arch} batcher did not answer all 8 requests with 16 tokens: "
             f"{summary}")

    del batcher, params, model
    state.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--arch", arch, "--scale", "full", "--batch", "4",
                         "--prompt-len", "32", "--gen", "16"])
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        print(f"serve {arch}: {line}")
    if rc != 0:
        fail(f"repro_torch.launch.serve exited {rc}")
    row = json.loads(lines[-1])
    if not (row["decode_tok_per_s"] > 0 and row["decode_s"] > 0):
        fail(f"serve reported no decode throughput: {row}")
    print(f"serve {arch}: peak memory {_peak_gb()}")
    gc.collect()
    torch.cuda.empty_cache()


def dense_prefill_phase() -> dict:
    """smollm-135m at full width: the causal flash shape with no window."""
    import torch

    from repro_torch.launch.steps import make_prefill_step

    model, model32 = _full(DENSE_ARCH, "bfloat16"), _full(DENSE_ARCH, "float32")
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    toks = _tokens(model.cfg, LM_BATCH, LM_PROMPT, seed=3)
    L = model.cfg.n_layers
    expect = {k: L if k == "flash_attention" else 0 for k in LM_KERNELS}
    _, counts = _counted(make_prefill_step(model), params, toks, expect,
                         f"{DENSE_ARCH} bf16 prefill")
    out32, _ = _counted(make_prefill_step(model32), params, toks, expect,
                        f"{DENSE_ARCH} fp32 prefill")
    ref32 = make_prefill_step(model32, use_kernel=False)(params, toks)
    err = _max_diff(out32, ref32)
    walls = [_wall_s(lambda: make_prefill_step(model)(params, toks)) for _ in range(3)]
    print(f"{DENSE_ARCH} prefill B={LM_BATCH} S={LM_PROMPT}: {counts} launches; fp32 "
          f"kernels vs plain max |diff| {err:.3e}; bf16 kernel prefill wall s "
          f"{walls}")
    if not torch.allclose(out32, ref32, **DECODE_TOL):
        fail(f"{DENSE_ARCH} kernel prefill disagrees with the plain prefill: max "
             f"|diff| {err:.3e} beyond {DECODE_TOL}")
    return counts


def _leaves_cpu(tree) -> list:
    import torch

    from repro_torch.models.params import tree_leaves

    # A copy: on the CPU .cpu() would alias tensors the step updates in place.
    return [t.detach().to("cpu", torch.float32, copy=True) for t in tree_leaves(tree)]


def _zero_launches(what: str) -> None:
    from repro_torch.kernels import ops

    if any(ops.launch_counts().values()):
        fail(f"{what}: kernels launched while training: {ops.launch_counts()}")


def train_parity_phase() -> None:
    """The loop's train step on the card against the same step on the CPU:
    reduced fp32 smollm-135m, parameters carried through numpy, the same
    batches, TF32 off; three steps, each from the CPU run's state, held
    as GRAD_TOL, TRAIN_TOL and ADAM_REL say, and the card's AdamW update
    on the CPU's gradients; no kernel launched."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.kernels import ops
    from repro_torch.models import build, params_from_numpy
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.training import AdamWConfig, TrainState, make_train_step
    from repro_torch.training import optimizer
    from repro_torch.training.loop import value_and_grad

    cfg = get_config(TRAIN_ARCH).reduced()
    model = build(cfg)
    tree = tree_map(lambda t: t.numpy(),
                    model.init(torch.Generator().manual_seed(0), device="cpu"))
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 64, 8, seed=1), device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(model, opt_cfg)
    params = params_from_numpy(tree, "cpu")
    state = TrainState(params, optimizer.init(params))
    n_leaves = len(tree_leaves(params))
    sizes = [t.numel() for t in tree_leaves(params)]
    loose = [0] * n_leaves
    worst_grad = worst = worst_update = 0.0
    beyond = beyond_update = 0
    losses = []
    ops.reset_launch_counts()
    for i in range(3):
        def copy_to(dev):
            return TrainState.from_tree(tree_map(lambda t: t.detach().to(dev, copy=True),
                                                 state.as_tree()))
        card, shared, shared_cpu = copy_to("cuda"), copy_to("cuda"), copy_to("cpu")
        batch = data.batch(i)
        card_batch = {k: v.to("cuda") for k, v in batch.items()}
        got = {}
        for dev, st, b in (("cpu", state, batch), ("cuda", card, card_batch)):
            _, g = value_and_grad(lambda p: model.loss(p, b), st.params)
            new, m = step(st, b)
            got[dev] = float(m["loss"]), g, _leaves_cpu(new.params), new
        (l_cpu, g_cpu, p_cpu, state), (l_gpu, g_gpu, p_gpu, _) = got["cpu"], got["cuda"]
        losses.append((l_gpu, l_cpu))
        # AdamW on the CPU's gradients, on both devices: every entry.
        optimizer.update(opt_cfg, g_cpu, shared_cpu.opt, shared_cpu.params)
        optimizer.update(opt_cfg, tree_map(lambda t: t.to("cuda"), g_cpu), shared.opt,
                         shared.params)
        for a, b in zip(_leaves_cpu(shared_cpu.params), _leaves_cpu(shared.params)):
            worst_update = max(worst_update, _max_diff(b, a))
            beyond_update += int((~torch.isclose(b, a, **TRAIN_TOL)).sum())
        for j, (a, b, pa, pb) in enumerate(zip(_leaves_cpu(g_cpu), _leaves_cpu(g_gpu),
                                               p_cpu, p_gpu)):
            worst_grad = max(worst_grad, _max_diff(b, a) / float(a.abs().max()))
            ok = (b - a).abs() <= ADAM_REL * a.abs()
            loose[j] += int((~ok).sum())
            worst = max(worst, _max_diff(pb[ok], pa[ok]))
            beyond += int((~torch.isclose(pb, pa, **TRAIN_TOL))[ok].sum())
        del card, shared, shared_cpu, got
    _zero_launches("card against CPU")
    share = max(n / (3 * size) for n, size in zip(loose, sizes))
    print(f"train parity (reduced fp32 {TRAIN_ARCH}, 3 steps from the CPU's state, B=8, "
          f"S=64): losses (card, CPU) {losses}; gradients max |diff| {worst_grad:.3e} of "
          f"their leaf's largest (limit {GRAD_TOL:g}); (entry, step) pairs with gradients "
          f"more than {ADAM_REL:g} apart, by leaf: {loose} (largest share {share:.3%}, "
          f"limit {ADAM_LOOSE_SHARE:.0%} of each leaf's); the rest: new parameters max "
          f"|diff| {worst:.3e}, {beyond} beyond {TRAIN_TOL}; the card's update on the CPU's "
          f"gradients: max |diff| {worst_update:.3e}, {beyond_update} beyond")
    if beyond or beyond_update or worst_grad > GRAD_TOL or share > ADAM_LOOSE_SHARE or not all(
            math.isclose(a, b, rel_tol=TRAIN_TOL["rtol"], abs_tol=TRAIN_TOL["atol"])
            for a, b in losses):
        fail("the card's train step disagrees with the CPU's")
    if int(state.opt.step) != 3:
        fail("the CPU run did not take three steps")


def _train_data(cfg, batch: int, seq: int, seed: int):
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens

    return SyntheticTokens(DataConfig(cfg.vocab_size, seq, batch, seed=seed), device="cuda")


def train_accumulation_phase(model, params) -> None:
    """One batch of 2 x TRAIN_SEQ at full width: the accumulated step at
    n_micro=2 against n_micro=1, each on its own copy of the parameters
    (the step updates them in place): loss and grad norm."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.params import tree_map
    from repro_torch.training import TrainState
    from repro_torch.training import optimizer

    shape = ShapeConfig("train", TRAIN_SEQ, 2, "train")
    batch = _train_data(model.cfg, 2, TRAIN_SEQ, seed=11).batch(0)
    got = {}
    for n in (1, 2):
        copy = tree_map(lambda t: t.detach().clone(), params)
        _, m = steps.make_train_step(model, shape, n_micro=n)(
            TrainState(copy, optimizer.init(copy)), batch)
        got[n] = float(m["loss"]), float(m["grad_norm"])
        del copy
    (l1, g1), (l2, g2) = got[1], got[2]
    print(f"train accumulation ({TRAIN_ARCH} full width, B=2, S={TRAIN_SEQ}): n_micro=1 "
          f"loss {l1:.6f} grad norm {g1:.6f}; n_micro=2 loss {l2:.6f} grad norm {g2:.6f}; "
          f"relative {abs(l2 - l1) / abs(l1):.3e} and {abs(g2 - g1) / abs(g1):.3e}")
    if abs(l2 - l1) > ACCUM_LOSS_RTOL * abs(l1) or abs(g2 - g1) > ACCUM_GNORM_RTOL * abs(g1):
        fail(f"accumulation over 2 microbatches disagrees with one batch beyond "
             f"{ACCUM_LOSS_RTOL:g} (loss) / {ACCUM_GNORM_RTOL:g} (grad norm)")
    torch.cuda.empty_cache()


def train_main_phase(smi: str) -> None:
    """smollm-135m at full width and depth, B=TRAIN_BATCH, S=TRAIN_SEQ,
    TRAIN_STEPS steps through launch.steps' accumulated train step, with
    the counters set to 0 just before and read just after; step time
    (median of steps 2 to last), tokens/s, peak memory and the model-FLOP
    share of the card's bf16 peak."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.config import SHAPES
    from repro_torch.training import TrainState
    from repro_torch.training import optimizer

    model = _full(TRAIN_ARCH, "bfloat16")
    cfg = model.cfg
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    train_accumulation_phase(model, params)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TRAIN_BATCH)
    n_micro = steps.choose_microbatches(cfg, shape)
    if n_micro != TRAIN_MICRO:
        fail(f"choose_microbatches picked {n_micro} for {TRAIN_ARCH} at B={TRAIN_BATCH}, "
             f"S={TRAIN_SEQ}, not {TRAIN_MICRO}")
    step = steps.make_train_step(model, shape)
    data = _train_data(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    state = TrainState(params, optimizer.init(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    walls, rows = [], []
    for i in range(TRAIN_STEPS):
        batch = data.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    launches = dict(ops.launch_counts())
    peak = torch.cuda.max_memory_allocated() / 1e9
    tokens = TRAIN_BATCH * TRAIN_SEQ
    med = statistics.median(walls[1:])
    attn = cfg.n_heads * cfg.resolved_head_dim
    flops = 6 * model.n_params * tokens + 12 * cfg.n_layers * attn * TRAIN_SEQ * tokens
    print(f"train {TRAIN_ARCH} full width and depth ({model.n_params} parameters, fp32 "
          f"weights, bf16 activations), B={TRAIN_BATCH}, S={TRAIN_SEQ}, n_micro={n_micro}: "
          f"losses {[round(r[0], 5) for r in rows]}, grad norms "
          f"{[round(r[1], 5) for r in rows]}; launches {launches}")
    print(f"train {TRAIN_ARCH}: step wall s {[round(w, 4) for w in walls]}; median of steps "
          f"2-{TRAIN_STEPS} {med:.4f} s, {tokens / med:.1f} tokens/s, peak memory "
          f"{peak:.2f} GB, model FLOPs {flops:.4e} a step (6 N T + 12 L H hd S T), "
          f"{flops / med / PEAK_OPS['bfloat16']:.2%} of the bf16 peak; on {smi}")
    if not all(math.isfinite(x) for r in rows for x in r):
        fail("a training loss or grad norm is not finite")
    if abs(rows[0][0] - math.log(cfg.padded_vocab)) > LOSS0_SLACK:
        fail(f"step-0 loss {rows[0][0]:.4f} is not within {LOSS0_SLACK} of "
             f"ln({cfg.padded_vocab}) = {math.log(cfg.padded_vocab):.4f}")
    if any(launches.values()):
        fail(f"the train steps launched kernels: {launches}")
    del state, params, model
    torch.cuda.empty_cache()


def train_launcher_phase() -> None:
    """``repro_torch.launch.train`` at full width with checkpoints every 4
    steps and a failure injected at step TRAIN_FAIL_AT: one restart, and
    the restarted steps' losses within RESTART_RTOL of an uninterrupted
    run's on the same seed."""
    import gc

    import torch

    from repro_torch.launch import train as train_cli

    whole, _ = train_cli.train(train_cli.parse_args(TRAIN_CLI))
    by_step = {h["step"]: h["loss"] for h in whole}
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            after, summary = train_cli.train(train_cli.parse_args(
                TRAIN_CLI + ["--ckpt-dir", d, "--fail-at", str(TRAIN_FAIL_AT)]))
        wall = time.perf_counter() - t0
    for line in out.getvalue().strip().splitlines() + [json.dumps(summary)]:
        print(f"train CLI: {line}")
    restarts = out.getvalue().count("restarting from latest checkpoint")
    worst = max(abs(h["loss"] - by_step[h["step"]]) / abs(by_step[h["step"]])
                for h in after)
    print(f"train CLI restart: {restarts} restart(s), steps {[h['step'] for h in after]} "
          f"after it, largest relative loss difference from the uninterrupted run "
          f"{worst:.3e} (limit {RESTART_RTOL:g}); restart run wall {wall:.1f} s")
    if restarts != 1 or [h["step"] for h in after] != list(range(8, 12)):
        fail("the launcher did not restart once from the step-8 checkpoint")
    if worst > RESTART_RTOL:
        fail("the restarted losses differ from the uninterrupted run's: the checkpoint "
             "lost state")
    gc.collect()
    torch.cuda.empty_cache()


def train_guard_phase() -> None:
    """use_kernel=True under autograd: the flash (smollm), causal conv
    (Hymba's mixer, its first kernel) and WKV6 (RWKV-6) entry points raise,
    launching nothing."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.models.hymba import mamba_mixer
    from repro_torch.models.params import tree_leaves

    def reduced(arch):
        model = build(get_config(arch).reduced())
        params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
        for p in tree_leaves(params):
            p.requires_grad_(True)
        return model, params

    toks = _tokens(get_config(TRAIN_ARCH).reduced(), 2, 64, seed=2)
    batch = {"inputs": toks, "labels": toks}
    smollm, sp = reduced(TRAIN_ARCH)
    rwkv, rp = reduced(RWKV_ARCH)
    hymba, hp = reduced(LM_ARCH)
    x = torch.randn((2, 64, hymba.cfg.d_model), device="cuda")
    calls = {"flash_attention": lambda: smollm.loss(sp, batch, use_kernel=True),
             "wkv6": lambda: rwkv.loss(rp, batch, use_kernel=True),
             "causal_conv": lambda: mamba_mixer({k: v[0] for k, v in
                                                 hp["layers"]["mamba"].items()},
                                                x, hymba.cfg, use_kernel=True)}
    ops.reset_launch_counts()
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if not str(e).startswith(f"{name}: the CUDA kernel has no backward"):
                fail(f"guard: use_kernel=True under autograd raised another error: {e}")
            print(f"train guard: {e}")
        else:
            fail(f"guard: {name} ran under autograd instead of raising")
    _zero_launches("guard")


def train_other_phase() -> None:
    """One train step each of hymba-1.5b and rwkv6-3b at their published
    widths and TRAIN_OTHER_LAYERS layers: a finite loss and grad norm, and
    no kernel launched."""
    import gc

    import torch

    from repro_torch.kernels import ops
    from repro_torch.training import AdamWConfig, init_state, make_train_step

    B, S = TRAIN_OTHER_SHAPE
    for arch in TRAIN_OTHER:
        model = _full(arch, "bfloat16", n_layers=TRAIN_OTHER_LAYERS)
        torch.cuda.reset_peak_memory_stats()
        state = init_state(model, torch.Generator(device="cuda").manual_seed(0),
                           AdamWConfig(), device="cuda")
        batch = _train_data(model.cfg, B, S, seed=0).batch(0)
        step = make_train_step(model, AdamWConfig())
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        print(f"train {arch} (full width, {TRAIN_OTHER_LAYERS} layers, {model.n_params} "
              f"parameters, B={B}, S={S}): loss {loss:.5f}, grad norm {gnorm:.5f}, step "
              f"wall {wall:.3f} s, peak memory {_peak_gb()}; launches "
              f"{ops.launch_counts()}")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"{arch}: non-finite training loss or grad norm")
        _zero_launches(arch)
        del state, model
        gc.collect()
        torch.cuda.empty_cache()


def _windowed_plain(q, k, v, window: int, block: int = 1024):
    """``ops.flash_attention_plain`` at a length whose (S, S) scores do not
    fit (25 heads at S = 32768 would take 107 GB): each block of queries
    runs through it together with the window - 1 positions before the
    block, which hold every key its queries see, and keeps its own rows."""
    import torch

    from repro_torch.kernels import ops

    S = q.shape[1]
    out = torch.empty_like(q)
    for q0 in range(0, S, block):
        k0, q1 = max(0, q0 - window + 1), min(S, q0 + block)
        sub = ops.flash_attention_plain(q[:, k0:q1], k[:, k0:q1], v[:, k0:q1],
                                        window=window)
        out[:, q0:q1] = sub[:, q0 - k0:]
    return out


def dryrun_kernel_phase(prompt: int) -> dict[str, float]:
    """Each kernel of the prefill cells at the shape the cell gives it
    (B = 1, S = ``prompt``), its whole output against its plain version
    within TOL, and its time there. Returns each kernel's max |diff|."""
    import torch

    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import mamba_scan as ms_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import wkv6 as wkv_mod

    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    errs = {}
    H, Kv, d, window = 25, 5, 64, 1024
    q, k, v = (torch.randn((1, prompt, h, d), generator=gen, device="cuda").to(torch.bfloat16)
               for h in (H, Kv, Kv))
    out = fa_mod.flash_attention_cuda(q, k, v, window=window)
    expect = _windowed_plain(q, k, v, window)
    torch.cuda.synchronize()
    tag = f"flash_attention bfloat16 B=1 S={prompt} H={H}/{Kv} d={d} window={window}"
    if not torch.isfinite(out.float()).all():
        fail(f"dryrun {tag}: non-finite output")
    errs["flash_attention"] = check_close("dryrun " + tag, out, expect, "bfloat16")
    ms = time_ms(lambda: fa_mod.flash_attention_cuda(q, k, v, window=window), reps=5)
    print(f"dryrun parity {tag}: max_abs_err={errs['flash_attention']:.3e} over the whole "
          f"output; kernel {ms:.4f} ms")
    del q, k, v, out, expect

    di, n = 3200, 16
    xs = 0.5 * torch.randn((1, prompt, di), generator=gen, device="cuda")
    dtt = 0.2 * torch.nn.functional.softplus(
        torch.randn((1, prompt, di), generator=gen, device="cuda"))
    Bs, Cs = (0.5 * torch.randn((1, prompt, n), generator=gen, device="cuda")
              for _ in range(2))
    A = -torch.exp(0.3 * torch.randn((di, n), generator=gen, device="cuda"))
    y, st = ms_mod.mamba_scan_cuda(xs, dtt, Bs, Cs, A)
    y_ref, st_ref = ref.mamba_scan(xs, dtt, Bs, Cs, A)
    torch.cuda.synchronize()
    tag = f"mamba_scan float32 B=1 T={prompt} di={di} n={n}"
    errs["mamba_scan"] = max(check_close(f"dryrun {tag} y", y, y_ref, "float32"),
                             check_close(f"dryrun {tag} state", st, st_ref, "float32"))
    ms = time_ms(lambda: ms_mod.mamba_scan_cuda(xs, dtt, Bs, Cs, A), reps=5)
    print(f"dryrun parity {tag}: max_abs_err={errs['mamba_scan']:.3e} over y and the "
          f"state; kernel {ms:.4f} ms")
    del xs, dtt, Bs, Cs, y, st, y_ref, st_ref

    r, k, v, w, u = _wkv6_inputs(gen, 1, prompt, RWKV_HEADS, RWKV_HEAD)
    y, st = wkv_mod.wkv6_cuda(r, k, v, w, u)
    y_ref, st_ref = ops.wkv6_plain(r, k, v, w, u)
    torch.cuda.synchronize()
    tag = f"wkv6 float32 B=1 T={prompt} H={RWKV_HEADS} N={RWKV_HEAD}"
    errs["wkv6"] = max(check_close(f"dryrun {tag} y", y, y_ref, "float32"),
                       check_close(f"dryrun {tag} state", st, st_ref, "float32"))
    ms = time_ms(lambda: wkv_mod.wkv6_cuda(r, k, v, w, u), reps=5)
    print(f"dryrun parity {tag}: max_abs_err={errs['wkv6']:.3e} over y and the state; "
          f"kernel {ms:.4f} ms")
    torch.cuda.empty_cache()
    return errs


def dryrun_phase() -> tuple[dict[str, int], dict[str, float]]:
    """The dry run: meta counts of the card cells (each within
    DRYRUN_COUNT_S), the card cells through ``run_cell(device="cuda")``
    (each named kernel launched once a layer, no other), each of their
    kernels against its plain version at the cell's shape, and the prefill
    cells' kernel route against their plain route at S = 32768. Returns
    the card cells' launches of each kernel (the ``dryrun`` path) and the
    kernels' largest errors there."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, flops, knobs, roofline
    from repro_torch.models.config import SHAPES

    t0 = time.perf_counter()
    knob = knobs.Knobs(wkv_impl="chunked")
    for arch, shape, _, _ in DRYRUN_CELLS:
        cfg = get_config(arch)
        with knobs.apply(knob):
            c = flops.count_cell(cfg, SHAPES[shape])
        mf = roofline.model_flops(cfg, SHAPES[shape])
        print(f"dryrun meta count {arch} x {shape} (B={SHAPES[shape].global_batch}): flops "
              f"{c.flops:.6e}, model flops {mf:.6e}, useful {mf / c.flops:.4f}, unfused "
              f"bytes {c.bytes_unfused:.6e}, count {c.seconds:.2f} s on the host")
        if c.seconds > DRYRUN_COUNT_S:
            fail(f"dryrun: the meta count of {arch} x {shape} took {c.seconds:.1f} s, "
                 f"beyond {DRYRUN_COUNT_S} s")
    launches = {k: 0 for k in LM_KERNELS}
    for arch, shape, batch, kernels in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, device="cuda", batch=batch, knobs=knob)
        torch.cuda.empty_cache()
        if rec["status"] != "ok":
            fail(f"dryrun {arch} x {shape} on the card: {rec.get('error')}\n"
                 f"{rec.get('traceback', '')}")
        layers = get_config(arch).n_layers
        want = {k: layers if k in kernels else 0 for k in rec["launches"]}
        if rec["launches"] != want:
            fail(f"dryrun {arch} x {shape}: launches {rec['launches']}, expected {want}")
        for k in LM_KERNELS:
            launches[k] += rec["launches"][k]
        rt = rec["roofline"]
        print(f"dryrun card cell {arch} x {shape} B={rec['batch']} (cut from "
              f"{rec['global_batch']}): step {rec['step_s']:.4f} s, peak memory "
              f"{rec['peak_memory_bytes'] / 1e9:.2f} GB, counted flops at B (plain route) "
              f"{rec['flops_at_batch']:.6e}, model flops at B "
              f"{rec['model_flops_at_batch']:.6e}, roofline_share (model flops) "
              f"{rec['roofline_share']:.4%} of 989 TFLOP/s, unfused bytes / s "
              f"{rec['bytes_unfused_per_s_upper'] / 1e12:.3f} TB/s (an upper bound); at the "
              f"shape's batch: compute {rt['compute_s']:.4e} s, memory <= "
              f"{rt['memory_s']:.4e} s -> {rt['bottleneck']}-bound, useful "
              f"{rt['useful_flops_ratio']:.4f}")
    prompt = SHAPES["prefill_32k"].seq_len
    errs = dryrun_kernel_phase(prompt)
    for arch, tol, seed in ((LM_ARCH, PREFILL_TOL, 8), (RWKV_ARCH, RWKV_PREFILL_TOL, 9)):
        cfg = dc.replace(get_config(arch), n_layers=DRYRUN_PARITY_LAYERS, dtype="float32")
        model, params, (toks,) = dryrun.card_inputs(cfg, SHAPES["prefill_32k"], 1, seed=seed)
        t1 = time.perf_counter()
        with torch.no_grad():
            out, _ = model.hidden_states(params, toks, use_kernel=True, remat=False)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            with knobs.apply(knobs.Knobs(wkv_impl="scan")):
                want, _ = model.hidden_states(params, toks, use_kernel=False, remat=False)
        torch.cuda.synchronize()
        err = _max_diff(out, want)
        print(f"dryrun parity {arch} fp32 B=1 S={prompt} at {DRYRUN_PARITY_LAYERS} layers: "
              f"kernels vs plain max |diff| {err:.3e} over the hidden states of all "
              f"{prompt} positions (limit {tol}; max |h| {float(want.abs().max()):.3e}); "
              f"kernels {t2 - t1:.2f} s, plain {time.perf_counter() - t2:.2f} s")
        if not (torch.isfinite(out).all() and torch.allclose(out, want, **tol)):
            fail(f"dryrun: {arch}'s kernel prefill at S={prompt} disagrees with the plain "
                 f"prefill: max |diff| {err:.3e} beyond {tol}")
        del model, params, toks
        torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"dryrun phase: {wall:.1f} s (budget {DRYRUN_BUDGET_S} s); launches {launches}")
    if wall > DRYRUN_BUDGET_S:
        fail(f"dryrun phase took {wall:.1f} s, beyond {DRYRUN_BUDGET_S} s")
    return launches, errs


def _card_mesh(names: tuple[str, ...], shape: tuple[int, ...]):
    """A mesh of virtual ranks as ``launch.mesh`` builds it; fails unless
    it lives on the card."""
    from repro_torch.launch.mesh import small_mesh

    mesh = small_mesh(names, shape)
    if mesh.device.type != "cuda":
        fail(f"mesh: the virtual mesh {shape} lives on {mesh.device}, not the card")
    return mesh


def _mesh_calls(name: str) -> int:
    from repro_torch.core import spmd

    return spmd.counts().get(name, 0)


def _hold(what: str, out, want, tol: dict) -> float:
    """Fails unless ``out`` is finite and within ``tol`` of ``want``."""
    import torch

    err = _max_diff(out, want)
    print(f"mesh: {what}: max |diff| {err:.3e} (limit {tol}; max |ref| "
          f"{float(want.float().abs().max()):.3e})")
    if not (torch.isfinite(out.float()).all()
            and torch.allclose(out.float(), want.float(), **tol)):
        fail(f"mesh: {what} beyond {tol}: max |diff| {err:.3e}")
    return err


def _scaled(want) -> dict:
    """MESH_TOL with its atol scaled by the largest |entry| of ``want``
    (at least 1): on random weights the residual stream reaches the
    thousands and the final norm puts entries of 5 beside near-zero ones,
    so two fp32 orders of summation differ by more than 1e-4 at the
    large ones (``tests/test_torch_mesh.py::_close_scaled``)."""
    top = max(1.0, float(want.float().abs().max()))
    return dict(rtol=MESH_TOL["rtol"], atol=MESH_TOL["atol"] * top)


def _turns(runs: dict) -> dict:
    """Wall seconds of each named run in turns (a, b, b, a, a, b); the
    medians."""
    walls = {k: [] for k in runs}
    a, b = runs
    for k in (a, b, b, a, a, b):
        walls[k].append(_wall_s(runs[k]))
    return {k: statistics.median(v) for k, v in walls.items()}


def _to_ranks(ids, B: int, S: int):
    """Dense routing (1, B*S, K) in the order of the (data, model) mesh's
    ranks: rank (d, m) holds batch block d, sequence block m."""
    dp, ep = MESH_SHAPE
    K = ids.shape[-1]
    return (ids.reshape(dp, B // dp, ep, S // ep, K).transpose(1, 2)
            .reshape(dp * ep, B * S // (dp * ep), K))


def mesh_dense_phase(mesh, smi: str) -> None:
    """smollm-135m on the mesh: the prefill through sp_attention and the
    decode through sp_decode_attention, each against its no-mesh run."""
    import torch

    from repro_torch.core import spmd
    from repro_torch.launch.steps import make_prefill_step, make_serve_step, mesh_settings
    from repro_torch.models.config import ShapeConfig

    torch.cuda.reset_peak_memory_stats()
    model = _full(DENSE_ARCH, "float32")
    cfg, L, B = model.cfg, model.cfg.n_layers, MESH_BATCH
    params = model.init(torch.Generator(device="cuda").manual_seed(11), device="cuda")
    toks = _tokens(cfg, B, MESH_PROMPT, seed=12)
    prefill = ShapeConfig("mesh_prefill", MESH_PROMPT, B, "prefill")
    step = make_prefill_step(model, use_kernel=False)
    with torch.no_grad():
        want_h, _ = model.hidden_states(params, toks, remat=False)
        want = step(params, toks)
        with mesh_settings(cfg, prefill, mesh):
            spmd.reset_counts()
            h, _ = model.hidden_states(params, toks, remat=False)
            torch.cuda.synchronize()
            calls_h = _mesh_calls("sp_attention")
            spmd.reset_counts()
            out = step(params, toks)
            torch.cuda.synchronize()
            calls = _mesh_calls("sp_attention")
    if calls_h != L or calls != L:
        fail(f"mesh: smollm-135m's prefill called sp_attention {calls_h} and {calls} "
             f"times, not once a layer ({L})")
    _hold(f"{DENSE_ARCH} fp32 B={B} S={MESH_PROMPT} prefill, sp_attention on "
          f"{MESH_SHAPE}, hidden states of every position", h, want_h, _scaled(want_h))
    _hold(f"{DENSE_ARCH} prefill last logits", out, want, _scaled(want))
    del h, want_h

    def meshed():
        with mesh_settings(cfg, prefill, mesh):
            step(params, toks)

    med = _turns({"no mesh": lambda: step(params, toks), "mesh": meshed})
    print(f"mesh: {DENSE_ARCH} prefill wall s (median of 3): mesh {med['mesh']:.4f}, no mesh "
          f"{med['no mesh']:.4f}; sp_attention calls {calls}; {smi}")

    # Decode: the cache holds MESH_DECODE_CACHE seeded entries, then each
    # step adds one (C divides by the model axis).
    C = MESH_DECODE_CACHE + MESH_DECODE_STEPS
    cache = model.init_cache(B, C, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(13)
    for v in cache.values():
        v[:, :, :MESH_DECODE_CACHE] = torch.randn(
            v[:, :, :MESH_DECODE_CACHE].shape, generator=gen, device="cuda")
    dtoks = _tokens(cfg, B, MESH_DECODE_STEPS, seed=14)
    decode = ShapeConfig("mesh_decode", C, B, "decode")

    def run(c, meshed: bool):
        ctx = mesh_settings(cfg, decode, mesh) if meshed else contextlib.nullcontext()
        serve, logits = make_serve_step(model), []
        with ctx:
            for t in range(MESH_DECODE_STEPS):
                lg, c = serve(params, c, MESH_DECODE_CACHE + t, dtoks[:, t:t + 1])
                logits.append(lg)
        return torch.stack(logits)

    # Each run writes its steps at slots past the seeded ones, each before
    # it is read, so the two runs start from copies of one cache.
    plain_cache = {k: v.clone() for k, v in cache.items()}
    logits = {}
    wall_plain = _wall_s(lambda: logits.update(plain=run(plain_cache, False)))
    spmd.reset_counts()
    wall_mesh = _wall_s(lambda: logits.update(mesh=run(cache, True)))
    calls = _mesh_calls("sp_decode_attention")
    if calls != MESH_DECODE_STEPS * L:
        fail(f"mesh: the decode called sp_decode_attention {calls} times, not "
             f"{MESH_DECODE_STEPS} x {L}")
    _hold(f"{DENSE_ARCH} fp32 B={B} decode, {MESH_DECODE_STEPS} steps from a "
          f"{MESH_DECODE_CACHE}-entry cache, sp_decode_attention on {MESH_SHAPE}, "
          f"logits of every step", logits["mesh"], logits["plain"],
          _scaled(logits["plain"]))
    print(f"mesh: {DENSE_ARCH} decode wall s for {MESH_DECODE_STEPS} steps: mesh "
          f"{wall_mesh:.3f}, no mesh {wall_plain:.3f}; sp_decode_attention calls {calls} "
          f"({L} a step); peak memory {_peak_gb()}; {smi}")


@contextlib.contextmanager
def _capacity(factor: float):
    from repro_torch.models import moe

    saved, moe.CAPACITY_FACTOR = moe.CAPACITY_FACTOR, factor
    try:
        yield
    finally:
        moe.CAPACITY_FACTOR = saved


def _flips(a, b) -> int:
    """Tokens whose expert sets differ between two routings."""
    import torch

    return int((torch.sort(a, dim=-1).values != torch.sort(b, dim=-1).values).any(-1).sum())


def mesh_moe_block_phase(mesh, smi: str) -> None:
    """qwen2-moe-a2.7b's layer-0 MoE block at full width (only its weights
    drawn), B=4, S=2048: _moe_shard_map on the mesh against _moe_dense,
    routing compared first (and replayed if it flipped)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import spmd
    from repro_torch.launch.steps import mesh_settings
    from repro_torch.models import moe
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.params import init_params

    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MOE_ARCH), dtype="float32")
    B, S, D = MESH_BATCH, MESH_PROMPT, cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(15)
    params = init_params(moe.moe_schema(cfg), gen, "cuda")
    x = torch.randn((B, S, D), generator=gen, device="cuda")
    x = x / x.pow(2).mean(-1, keepdim=True).sqrt()     # unit RMS, as ffn_norm hands it
    shape = ShapeConfig("mesh_prefill", S, B, "prefill")
    with torch.no_grad(), _capacity(MESH_MOE_CAPACITY):
        with _routing() as log_d:
            want, want_aux = moe._moe_dense(params, x, cfg)
        with mesh_settings(cfg, shape, mesh), _routing() as log_e:
            spmd.reset_counts()
            out, aux = moe.moe_apply(params, x, cfg)
            torch.cuda.synchronize()
            calls = _mesh_calls("moe_shard_map")
        if calls != 1:
            fail(f"mesh: moe_apply on the mesh took _moe_shard_map {calls} times, not once")
        ranks = _to_ranks(log_d[0]["ids"], B, S)
        Nl = ranks.shape[1]
        C = moe.capacity(Nl, cfg.n_experts, cfg.topk)
        _, keep = moe.dispatch_slots(log_e[0]["ids"], cfg.padded_experts, C)
        _, keep_d = moe.dispatch_slots(log_d[0]["ids"], cfg.padded_experts,
                                       moe.dispatch_capacity(B * S, cfg))
        if not (bool(keep.all()) and bool(keep_d.all())):
            fail(f"mesh: at capacity factor {MESH_MOE_CAPACITY} a path dropped tokens "
                 f"(EP {int((~keep).sum())}, dense {int((~keep_d).sum())}): the two "
                 f"paths agree only without drops")
        flips = _flips(log_e[0]["ids"], ranks)
        print(f"mesh: {MOE_ARCH} layer-0 MoE block fp32 B={B} S={S}, EP on {MESH_SHAPE} "
              f"(capacity {C} a rank, factor {MESH_MOE_CAPACITY:g}) vs dense: routing "
              f"identical for {B * S - flips} of {B * S} tokens, no drops in either")
        if flips:
            with mesh_settings(cfg, shape, mesh), _routing([ranks]) as log_r:
                out, aux = moe.moe_apply(params, x, cfg)
            _routing_check(f"{MOE_ARCH} EP block on the dense routing", log_r, log_d,
                           [(b + 1) * S - 1 for b in range(B)])
        _hold(f"{MOE_ARCH} layer-0 MoE block, _moe_shard_map vs _moe_dense", out, want,
              DECODE_TOL)
        print(f"mesh: {MOE_ARCH} block aux {float(aux):.6f} vs dense {float(want_aux):.6f} "
              f"(the EP z-loss term is rank 0's, as in the reference; reported)")

        def meshed():
            with mesh_settings(cfg, shape, mesh):
                moe.moe_apply(params, x, cfg)

        med = _turns({"dense": lambda: moe._moe_dense(params, x, cfg), "EP": meshed})
    print(f"mesh: {MOE_ARCH} block wall s (median of 3): EP {med['EP']:.4f}, dense "
          f"{med['dense']:.4f}; peak memory {_peak_gb()}; {smi}")


def mesh_moe_prefill_phase(mesh, smi: str) -> int:
    """qwen2-moe-a2.7b at full width and MESH_MOE_LAYERS layers on the
    mesh: the counted bf16 prefill through the flash kernel and the EP MoE
    (flash once a layer), the fp32 twin against the no-mesh kernel prefill
    on shared routing. Returns the counted run's flash launches."""
    import torch

    from repro_torch.core import spmd
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step, mesh_settings
    from repro_torch.models.config import ShapeConfig

    torch.cuda.reset_peak_memory_stats()
    model = _full(MOE_ARCH, "bfloat16", MESH_MOE_LAYERS)
    model32 = _full(MOE_ARCH, "float32", MESH_MOE_LAYERS)
    cfg, B, S, L = model.cfg, MESH_BATCH, MESH_PROMPT, MESH_MOE_LAYERS
    params = model.init(torch.Generator(device="cuda").manual_seed(16), device="cuda")
    toks = _tokens(cfg, B, S, seed=17)
    shape = ShapeConfig("mesh_prefill", S, B, "prefill")
    kern, kern32 = make_prefill_step(model), make_prefill_step(model32)
    expect = {k: L if k == "flash_attention" else 0 for k in ops.launch_counts()}
    last = [(b + 1) * S - 1 for b in range(B)]
    with _capacity(MESH_MOE_CAPACITY):
        with _routing() as log_b:
            ref = kern(params, toks)
        # The main path: one counted bf16 prefill on the mesh, replaying
        # the no-mesh run's routing.
        with mesh_settings(cfg, shape, mesh), \
                _routing([_to_ranks(p["ids"], B, S) for p in log_b]) as log_rb:
            spmd.reset_counts()
            out, counts = _counted(kern, params, toks, expect,
                                   f"{MOE_ARCH} bf16 prefill on the mesh")
            calls = _mesh_calls("moe_shard_map")
        if calls != L:
            fail(f"mesh: {MOE_ARCH}'s prefill took _moe_shard_map {calls} times, not "
                 f"once a layer ({L})")
        print(f"mesh: {MOE_ARCH} bf16 kernel prefill B={B} S={S} at {L} layers: flash "
              f"launches {counts['flash_attention']}, _moe_shard_map calls {calls}")
        _routing_check(f"{MOE_ARCH} bf16 mesh prefill on the no-mesh routing", log_rb, log_b,
                       last)
        _hold(f"{MOE_ARCH} bf16 kernel prefill at {L} layers, mesh (EP MoE) vs no mesh, "
              f"shared routing, last logits", out, ref, TOL["bfloat16"])
        with _routing() as log_p:
            ref32, _ = _counted(kern32, params, toks, expect, f"{MOE_ARCH} fp32 prefill")
        with mesh_settings(cfg, shape, mesh), _routing() as log_f:
            free32 = kern32(params, toks)
        flips = sum(_flips(f["ids"], _to_ranks(p["ids"], B, S)) for f, p in zip(log_f, log_p))
        print(f"mesh: {MOE_ARCH} fp32 kernel prefill, mesh vs no mesh each routing freely: "
              f"{flips} of {B * S * L} (token, layer) expert sets differ, last logits max "
              f"|diff| {_max_diff(free32, ref32):.3e} (reported)")
        replay = [_to_ranks(p["ids"], B, S) for p in log_p]
        with mesh_settings(cfg, shape, mesh), _routing(replay) as log_r:
            out32 = kern32(params, toks)
        _routing_check(f"{MOE_ARCH} fp32 mesh prefill on the no-mesh routing", log_r, log_p,
                       last)
        _hold(f"{MOE_ARCH} fp32 kernel prefill at {L} layers, mesh (EP MoE) vs no mesh, "
              f"shared routing, last logits", out32, ref32, DECODE_TOL)

        def meshed():
            with mesh_settings(cfg, shape, mesh):
                kern(params, toks)

        med = _turns({"no mesh": lambda: kern(params, toks), "mesh": meshed})
    print(f"mesh: {MOE_ARCH} bf16 kernel prefill wall s (median of 3): mesh "
          f"{med['mesh']:.4f}, no mesh {med['no mesh']:.4f}; peak memory {_peak_gb()} "
          f"(weights {_weights_gb(params):.2f} GB); {smi}")
    return counts["flash_attention"]


def mesh_pipeline_phase(smi: str) -> None:
    """The GPipe pipeline over pod=PIPE_STAGES on smollm-135m's 30 blocks
    at full width against the sequential stack: the blocks' output, and
    the gradient of the token loss (final norm, tied unembedding,
    cross-entropy on seeded labels) in every block weight: the output
    within MESH_TOL scaled by its largest |entry| (``_scaled``), the
    gradients leaf by leaf within GRAD_TOL of the leaf's largest entry."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import spmd
    from repro_torch.models import layers
    from repro_torch.models.params import tree_leaves, tree_map, unstack
    from repro_torch.models.transformer import block_apply
    from repro_torch.training.pipeline import bubble_fraction, pipelined_apply, split_stages

    model = _full(DENSE_ARCH, "float32")
    cfg, M = model.cfg, PIPE_MICRO
    params = model.init(torch.Generator(device="cuda").manual_seed(18), device="cuda")
    labels = _tokens(cfg, M, PIPE_SEQ, seed=20).reshape(-1)
    with torch.no_grad():
        x = layers.embed(params["embed"], _tokens(cfg, M, PIPE_SEQ, seed=19), torch.float32)
    x = x.reshape(M, 1, PIPE_SEQ, cfg.d_model)
    positions = torch.arange(PIPE_SEQ, device="cuda")[None, :]

    def layer_fn(p, h):
        return block_apply(p, h, cfg, positions)[0]

    def loss_fn(y, p):
        h = layers.rmsnorm(p["final_norm"], y.reshape(-1, cfg.d_model), cfg.norm_eps)
        return F.cross_entropy(layers.unembed(p["embed"], h), labels)

    def sequential(p):
        stack = tree_map(lambda t: t.detach().requires_grad_(True), p["dense_layers"])
        h = x.to(p["final_norm"]["scale"].dtype).reshape(M, PIPE_SEQ, cfg.d_model)
        for lp in unstack(stack):
            h = layer_fn(lp, h)
        y = h.reshape(x.shape)
        return y.detach(), torch.autograd.grad(loss_fn(y, p), tree_leaves(stack))

    mesh = _card_mesh(("pod",), (PIPE_STAGES,))
    apply = pipelined_apply(layer_fn, mesh, n_microbatches=M)
    res, walls, peaks = {}, {}, {}

    def pipelined():
        stack = tree_map(lambda t: t.detach().requires_grad_(True), params["dense_layers"])
        spmd.reset_counts()
        y = apply(split_stages(stack, PIPE_STAGES), x)
        res["pipe"] = (y.detach(), torch.autograd.grad(loss_fn(y, params), tree_leaves(stack)))
        res["ticks"] = _mesh_calls("ppermute")

    for name, fn in (("pipelined", pipelined),
                     ("sequential", lambda: res.update(seq=sequential(params)))):
        torch.cuda.reset_peak_memory_stats()
        walls[name] = _wall_s(fn)
        peaks[name] = _peak_gb()
    if res["ticks"] != M + PIPE_STAGES - 1:
        fail(f"mesh: the pipeline ran {res['ticks']} ppermute ticks, not "
             f"{M + PIPE_STAGES - 1}")
    _hold(f"{DENSE_ARCH} pipeline over pod={PIPE_STAGES}, {M} microbatches of 1 at "
          f"S={PIPE_SEQ}, pipelined vs sequential blocks' output", res["pipe"][0],
          res["seq"][0], _scaled(res["seq"][0]))
    worst = 0.0
    for g, g_seq in zip(res["pipe"][1], res["seq"][1]):
        e = _max_diff(g, g_seq) / max(float(g_seq.abs().max()), 1e-30)
        if not e <= GRAD_TOL:
            fail(f"mesh: a pipeline gradient is {e:.3e} of its leaf's largest entry from "
                 f"the sequential stack's, beyond {GRAD_TOL}")
        worst = max(worst, e)
    print(f"mesh: pipeline token-loss gradients of {len(res['pipe'][1])} stacked leaves, "
          f"pipelined vs sequential: worst max |diff| {worst:.3e} of a leaf's largest "
          f"entry (limit {GRAD_TOL})")
    print(f"mesh: pipeline forward + backward wall s: pipelined {walls['pipelined']:.3f} "
          f"({M + PIPE_STAGES - 1} ticks, bubble fraction "
          f"{bubble_fraction(PIPE_STAGES, M):.3f}), sequential {walls['sequential']:.3f}; "
          f"peak memory pipelined {peaks['pipelined']}, sequential {peaks['sequential']}; "
          f"{smi}")


def mesh_phase(smi: str) -> int:
    """The mesh layer on virtual ranks on the card. Returns the flash
    launches of its counted qwen2-moe prefill."""
    import torch

    t0 = time.perf_counter()
    mesh = _card_mesh(("data", "model"), MESH_SHAPE)
    mesh_dense_phase(mesh, smi)
    torch.cuda.empty_cache()
    mesh_moe_block_phase(mesh, smi)
    torch.cuda.empty_cache()
    flash = mesh_moe_prefill_phase(mesh, smi)
    torch.cuda.empty_cache()
    mesh_pipeline_phase(smi)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"mesh phase: {wall:.1f} s (budget {MESH_BUDGET_S} s)")
    if wall > MESH_BUDGET_S:
        fail(f"mesh phase took {wall:.1f} s, beyond {MESH_BUDGET_S} s")
    return flash


def production_mesh_phase(smi: str) -> None:
    """The dry run's production meshes: each PROD_CELLS cell counted on a
    fake group of 256 ranks, then rank (0, 0)'s share once on the card."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, knobs

    t0 = time.perf_counter()
    for arch, shape in PROD_CELLS:
        ops.reset_launch_counts()
        rec = dryrun.run_mesh_cell(arch, shape, "single", device="cuda",
                                   knobs=knobs.Knobs(wkv_impl="chunked"), verbose=False)
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        torch.cuda.empty_cache()
        if rec["status"] != "ok":
            fail(f"production mesh {arch} x {shape}: {rec.get('error')}\n"
                 f"{rec.get('traceback', '')}")
        if launched:
            fail(f"production mesh {arch} x {shape}: kernels launched {launched}; the "
                 f"cells run the plain route")
        r0, mem = rec["rank0"], rec["memory_analysis"]
        if r0["local_devices"] != ["cuda:0"] or r0["output_devices"] != ["cuda:0"]:
            fail(f"production mesh {arch} x {shape}: rank 0's blocks on "
                 f"{r0['local_devices']}, outputs on {r0['output_devices']}")
        if r0["argument_bytes"] != mem["argument_size_in_bytes"]:
            fail(f"production mesh {arch} x {shape}: {r0['argument_bytes']} argument bytes "
                 f"on the card, {mem['argument_size_in_bytes']} in the meta count")
        peak = r0["peak_memory_bytes"]
        if not r0["argument_bytes"] <= peak < 80e9:
            fail(f"production mesh {arch} x {shape}: peak {peak} bytes against arguments "
                 f"{r0['argument_bytes']}")
        ref = PROD_REFERENCE[arch]
        coll = rec["collectives"]["bytes"]
        print(f"production mesh {arch} x {shape} single (256 ranks, {rec['sharding_mode']}, "
              f"rank 0 on {smi}): per-device flops {rec['flops']:.4e} (reference "
              f"{ref['flops']:.4e}, x{rec['flops'] / ref['flops']:.3f}); argument bytes "
              f"{mem['argument_size_in_bytes']} (reference {ref['argument']}); temp bytes "
              f"{mem['temp_size_in_bytes']:.4e} = peak {peak:.4e} less the arguments "
              f"(reference {ref['temp']:.4e}); rank 0's step {r0['step_s']:.3f} s on the "
              f"card, count {rec['count_s']:.1f} s on the host; no kernel launched")
        for kind in sorted(set(coll) | set(ref["collectives"])):
            mine, want = coll.get(kind, 0.0), ref["collectives"].get(kind, 0.0)
            print(f"  collective {kind:18s} {mine:.4e} bytes (reference {want:.4e}"
                  + (f", x{mine / want:.3f})" if want else ")"))
    wall = time.perf_counter() - t0
    print(f"production mesh phase: {wall:.1f} s (budget {PROD_BUDGET_S} s)")
    if wall > PROD_BUDGET_S:
        fail(f"production mesh phase took {wall:.1f} s, beyond {PROD_BUDGET_S} s")


def production_cells_phase(smi: str) -> None:
    """The production cells with values: ``CELL_JOBS`` on a gloo world of
    4 processes sharing card 0 (``launch.dryrun.run_world_cells``), each
    rank's gathered outputs held to the one-process step on the card."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import GPU, Machine, linear_cyclic_mapper, spmd
    from repro_torch.launch import dryrun
    from repro_torch.launch.knobs import Knobs
    from repro_torch.launch.mesh import mapper_permutation
    from repro_torch.models.config import ShapeConfig

    t0 = time.perf_counter()
    perm = mapper_permutation(linear_cyclic_mapper(Machine(GPU, shape=CELL_MESH)), CELL_MESH)
    mesh = spmd.Mesh(np.asarray(perm).reshape(CELL_MESH), ("data", "model"), "cuda")
    one_s, jobs, moved = {}, [], {}

    def least_update(job, out):
        """The one-process step's smallest parameter change, the leaf's
        largest |new - seeded| over its largest |new|, and its path: an
        unwritten parameter fails the limit only if this exceeds it."""
        seeded = dryrun.job_values(job, "cuda")
        return min((float((v - seeded("state" + p[len("out/0"):], v)).abs().max()
                          / v.abs().max()), p)
                   for p, v in out.items() if p.startswith("out/0/params/"))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cells_") as tmp:
        for name, (arch, layers, shape, mode, capacity) in CELL_JOBS.items():
            cfg = get_config(arch)
            cfg = dataclasses.replace(cfg, dtype="float32", n_layers=layers or cfg.n_layers)
            twin = str(Path(tmp, f"{len(jobs)}.pt"))
            job = dryrun.CellJob(name=name, arch=arch, cfg=cfg, shape=ShapeConfig(*shape),
                                 mesh=mesh, mode=mode, knobs=Knobs(moe_capacity=capacity),
                                 seed=len(jobs), hold_to={"one_process": twin})
            out, one_s[name] = dryrun.one_process_outputs(job, "cuda")
            if shape[3] == "train":
                moved[name] = least_update(job, out)
            torch.save({k: v.cpu() for k, v in out.items()}, twin)
            del out
            torch.cuda.empty_cache()
            jobs.append(job)
        t1 = time.perf_counter()
        (ranks,) = dryrun.run_world_cells(jobs, "gloo", "cuda", share_card=True,
                                          timeout=CELL_BUDGET_S).values()
        world_s = time.perf_counter() - t1
    print(f"production cells with values: a gloo world of {len(ranks)} processes on "
          f"{CELL_MESH} (device ids {mesh.device_ids.tolist()}), every rank on card 0, "
          f"{smi}; one-process steps {t1 - t0:.1f} s, the world {world_s:.1f} s")
    failures = []
    for job in jobs:
        rows = [r[job.name] for r in ranks]
        for rank, row in enumerate(rows):
            if "error" in row:
                fail(f"cell {job.name}: rank {rank} failed: {row['error']}\n"
                     f"{row.get('traceback', '')}")
        kind = job.shape.kind
        devices = sorted({d for r in rows for d in r["local_devices"] + r["output_devices"]})
        launched = {k: v for r in rows for k, v in r["launches"].items() if v}
        staged = {}
        for r in rows:
            for k, v in r["staged"].items():
                staged[k] = max(staged.get(k, 0), v)
        worst = 0.0
        for rank, row in enumerate(rows):
            for path, (diff, scale) in row["held"]["one_process"].items():
                if path == "out/1/loss":
                    bad, err = diff > CELL_LOSS_ABS, diff
                elif path == "out/1/grad_norm":
                    err = diff / max(scale, 1e-30)
                    bad = err > CELL_GRAD_NORM_REL
                else:
                    err = diff / max(scale, 1e-30)
                    bad = err > CELL_LEAF_REL[kind]
                    worst = max(worst, err)
                if bad:
                    failures.append(f"{job.name} rank {rank} {path}: {err:.3e}")
        walls = [r["step_s"] for r in rows]
        print(f"cell {job.name} ({rows[0]['mode']}, n_micro {rows[0]['n_micro']}): wall "
              f"{max(walls):.3f} s (largest over the ranks; one run) against "
              f"{one_s[job.name]:.3f} s in one process (x{max(walls) / one_s[job.name]:.2f}); "
              f"worst leaf {worst:.3e} of its largest |entry| "
              f"(limit {CELL_LEAF_REL[kind]:g}); blocks on {','.join(devices)}; "
              f"launches {launched or 0}")
        if kind == "train":
            m = rows[0]["metrics"]
            held = rows[0]["held"]["one_process"]
            least, at = moved[job.name]
            print(f"  loss {m['loss']:.7f} (|diff| {held['out/1/loss'][0]:.3e}), grad_norm "
                  f"{m['grad_norm']:.7f} (rel {held['out/1/grad_norm'][0] / held['out/1/grad_norm'][1]:.3e}); "
                  f"the step moves every parameter leaf by at least {least:.3e} of its largest "
                  f"|entry| ({at}), so one left unwritten breaks the limit")
            if least <= CELL_LEAF_REL[kind]:
                failures.append(f"{job.name}: the step moves {at} by {least:.3e} of its "
                                f"largest |entry|, within the limit; an unwritten "
                                f"parameter would pass")
        peaks = ", ".join(f"{r['peak_memory_bytes'] / 1e9:.2f}" for r in rows)
        step_staged = max((r["staged_step"] for r in rows), key=lambda d: sum(d.values()))
        print(f"  peak memory by rank (GB): {peaks}; staged bytes by collective (busiest "
              f"rank), the step's: {step_staged}; with the check's gather: {staged}")
        if devices != ["cuda:0"]:
            failures.append(f"{job.name}: blocks on {devices}, not cuda:0")
        if launched:
            failures.append(f"{job.name}: kernels launched {launched}; the cells run the "
                            f"plain route")
    wall = time.perf_counter() - t0
    print(f"production cells phase: {wall:.1f} s (budget {CELL_BUDGET_S} s)")
    if failures:
        fail("production cells: " + "; ".join(failures))
    if wall > CELL_BUDGET_S:
        fail(f"production cells phase took {wall:.1f} s, beyond {CELL_BUDGET_S} s")


def train_phase(smi: str) -> None:
    """The training path: card against CPU, the full-width smollm-135m run
    (with the accumulation check), the launcher's restart, the kernel
    guard and the other families."""
    t0 = time.perf_counter()
    train_parity_phase()
    train_main_phase(smi)
    train_launcher_phase()
    train_guard_phase()
    train_other_phase()
    print(f"train phase: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA card; this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    from repro_torch.kernels import build, ref

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    ref.no_tf32()

    t0 = time.perf_counter()
    lib = build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.seconds:.2f} s) -> {lib.path.relative_to(ROOT)}")
    ptxas_report(lib.log)
    sass_report(lib)
    occupancy_report()

    mm_shapes, stencil_block, stencil_field = app_shapes()
    rows = parity_and_timing(mm_shapes, stencil_block, stencil_field)
    rows.update(segment_rowmax_phase())
    rows.update(lm_kernel_phase())
    rows["causal_conv"], rows["mamba_scan"]["gated"] = mixer_kernel_phase()
    rows.update(wkv6_kernel_phase())
    counts = apps_phase()
    bf16_paths = matmul_bf16_phase()
    rows["matmul"]["bfloat16"].update(launches=sum(bf16_paths.values()),
                                      launches_by_path=bf16_paths)
    steady_times()
    torch.cuda.empty_cache()
    pg = process_group_apps_phase(smi)
    rows["matmul"]["launches_by_path"] = {"apps": counts["matmul"],
                                          "process_group": pg["matmul"]}
    rows["stencil"]["launches_by_path"] = {"apps": counts["stencil"],
                                           "process_group": pg["stencil"]}
    for name in pg:
        counts[name] += pg[name]
    pricer_phase()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_map_") as tmp:
        work = Path(tmp)
        launches, tuned, cold_wall = tune_phase(work)
        by_path = {"tune": launches, "remap": remap_phase(work),
                   "service": service_phase(work),
                   "warm_start": warm_start_phase(work, tuned, cold_wall)}
    counts["segment_rowmax"] = launches
    rows["segment_rowmax"]["launches_by_path"] = by_path
    torch.cuda.empty_cache()
    lm_counts, lm_state = lm_prefill_phase(LM_ARCH, HYMBA_KERNELS, PREFILL_TOL, seed=1,
                                           n_layers=EARLIER_LM_LAYERS)
    counts["mamba_scan"] = lm_counts["mamba_scan"]
    counts["causal_conv"] = lm_counts["causal_conv"]
    lm_decode_phase(lm_state, LM_ARCH)
    lm_serving_phase(lm_state, LM_ARCH)
    del lm_state
    torch.cuda.empty_cache()
    flash_paths = {LM_ARCH: lm_counts["flash_attention"],
                   DENSE_ARCH: dense_prefill_phase()["flash_attention"]}
    torch.cuda.empty_cache()
    rwkv_counts, rwkv_state = lm_prefill_phase(RWKV_ARCH, ("wkv6",), RWKV_PREFILL_TOL,
                                               seed=4, n_layers=EARLIER_LM_LAYERS)
    counts["wkv6"] = rwkv_counts["wkv6"]
    lm_decode_phase(rwkv_state, RWKV_ARCH)
    lm_serving_phase(rwkv_state, RWKV_ARCH)
    del rwkv_state
    torch.cuda.empty_cache()
    moe_counts, moe_state = lm_prefill_phase(MOE_ARCH, ("flash_attention",), DECODE_TOL,
                                             seed=6)
    flash_paths[MOE_ARCH] = moe_counts["flash_attention"]
    lm_decode_phase(moe_state, MOE_ARCH)
    lm_serving_phase(moe_state, MOE_ARCH)
    del moe_state
    torch.cuda.empty_cache()
    _, mla_state = lm_prefill_phase(MLA_ARCH, (), None, seed=7)
    lm_decode_phase(mla_state, MLA_ARCH)
    lm_serving_phase(mla_state, MLA_ARCH)
    del mla_state
    torch.cuda.empty_cache()
    dry, dry_err = dryrun_phase()
    flash_paths["dryrun"] = dry["flash_attention"]
    flash_paths["mesh"] = mesh_phase(smi)
    torch.cuda.empty_cache()
    production_mesh_phase(smi)
    torch.cuda.empty_cache()
    production_cells_phase(smi)
    counts["flash_attention"] = sum(flash_paths.values())
    rows["flash_attention"]["launches_by_path"] = flash_paths
    for name, arch in (("mamba_scan", LM_ARCH), ("causal_conv", LM_ARCH),
                       ("wkv6", RWKV_ARCH)):
        rows[name]["launches_by_path"] = {arch: counts[name], "dryrun": dry[name]}
        counts[name] += dry[name]
    for name, err in dry_err.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    train_phase(smi)

    for name, row in rows.items():
        print(f"bound share {name:16s} {row['dtype']:8s} kernel {row['ms']:.5f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}): {row['bound_ms'] / row['ms']:.1%}"
              + (f"; library {row['library_ms']:.5f} ms, kernel / library "
                 f"{row['ms'] / row['library_ms']:.3f}" if row["library_ms"] else ""))
    kernels = []
    for name, row in rows.items():
        kernels.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": counts[name], **row,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
