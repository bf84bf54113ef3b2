#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Builds the port's ten CUDA sources from ``src/repro_torch/csrc`` (into
``build/`` on first use, the ten nvcc runs started together), then:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the fabric-step, fused-accumulate, flash-attention (forward and
   backward, each a float32 source and a bfloat16 wgmma source),
   selective-scan (forward and fused backward), state-scan and int8
   quantize/dequantize kernels,
   reports the build time and checks that the wgmma libraries' SASS holds
   tensor-core (HGMMA) and TMA (UTMALDG) instructions;
3. holds the fabric-step kernel against its plain PyTorch version on the
   card at the characterization grids' shapes, at the shapes and batch
   sizes each figure path gives it (Fig. 1's 8-node ring AllReduce, Fig.
   3's three 4-node single cells, Fig. 6's six quick grids and its 2 MiB
   burst x pause grid) and on random shapes, with and without the aux
   observer (DESIGN.md §13 tolerance, bit-exact where every segment has
   one contributor, NaN where and only where the plain version has it);
   checks ten launches on the same inputs bit-equal, and each cell
   launched alone bit-equal to its row of the batched launch, at every
   slice shape, figure-path grid and random shape; the same at the three
   wide alltoall shapes (LUMI at 128 and 256 nodes, Leonardo at 256),
   whose rows partly live in the global-memory workspace, and the wide
   layout bit-equal to the shared one where both take a cell; records
   (and prints) the block, cluster, layout and workspace the wrapper
   picks at each shape;
4. holds the fused-accumulate kernel bit-equal to its plain version at
   the fig1 tiles and (300, 640), in four type pairs and two scales, with
   acc unaligned, and in the bfloat16 256 + 1 case;
5. runs 50 lock-step engine steps with the kernel and with the plain
   version on leonardo/64/incast and cresco8/256/alltoall;
6. drives the main path: the fig4_nslb quick points and four fig5_steady
   quick grids through ``repro_torch.core.scenarios`` on the card, held to
   ``artifacts/bench_cache_torch/jax_reference.json`` (equal iteration
   counts, times within 2%) and to the paper's behaviour pins, and checks
   that every engine step launched the kernel once;
7. drives the figure runner's paths, each with the launch counts reset
   before it and read after it: Fig. 1 at its three sizes through
   ``benchmarks/pt_fig1_breakdown.run_sizes`` (network time, iteration
   counts and wire bytes against JAX; kernel 2 launched), Fig. 3's six
   goodput traces through ``benchmarks/pt_fig3_sawtooth.run_points``
   (trace length, goodput and CV against JAX; the Obs. 1 pin) and Fig. 6's
   six quick grids plus the leonardo/64/incast 2 MiB burst x pause grid
   (iteration counts and times against JAX; the Obs. 3 pin); and Figs.
   7-8 through the scale-batched engine (``bench.run_scale_grid``): the
   fig7_fig8_scale quick grid and a reduced alltoall grid with LUMI at 256
   nodes (iteration counts and times against JAX; the Fig. 7 pin), and,
   in both buckets, each padded cell bit-equal to itself run alone;
7b. ``scenarios``: kernel 1 with per-cell link capacities scaled by fault
   tables (some links at or below ``FAULT_FLOOR``) against its plain
   version at the link_fault quick bucket's shapes (the wide layout
   forced and held bit-equal to the shared one) and at lumi/256/alltoall
   (the wide layout), ten launches bit-equal and each cell alone
   bit-equal to its row; the inertness gate on the card (an all-``none``
   table and ``node_cap = inf`` against no table, 48 steps of
   leonardo/16, every state leaf bit for bit); the first quick grid of
   each beyond-paper and fault family (``FAMILY_GRIDS``; phased_collectives'
   first flat/phased pair; less the ``FAMILY_CUTS`` cells, for time)
   through ``scenarios.run_grid_spec``, held to
   ``jax_reference.json["scenarios_quick"]`` (iteration counts equal,
   times and ``job_times`` within 2%) and to the fault drivers' pins
   (flap < 0.9, degrade < 0.95, intra-node monotone), one kernel-1 launch
   a step; and the link_fault and intra_node buckets' padded cells
   bit-equal to themselves run alone;
7c. ``fleet_replay``: kernel 1 against its plain version at the fleet
   buckets' shapes (the registry's quick point, both quick templates x 8
   seeds, and its full point, both full templates x 256 seeds; per-flow
   CC kinds, idle short slots injecting nothing), ten launches and cells
   alone bit-equal; the seed lowering on the card against the CPU (the
   integer draws bit for bit) and JAX's stored lowering; the quick replay
   held to ``jax_reference.json["fleet_replay_quick"]`` (sample counts and
   completions equal, percentiles within a bin, slowdowns within 1e-3)
   with ``benchmarks/fleet_replay.py``'s four sanity gates; the metrics carry on
   and off bit-equal in the engine state, and each padded template's
   streaming leaves bit-equal to it alone (``FLEET_CUT_HORIZON``); the
   registry's full point once (seeds/s and simulated s a wall s, beside
   the other fabric phases; the device's share of a step's wall from a
   64-step sample taken alone, ``fleet_share``), with the sanity gates;
   the StepMonitor demo's pins; one kernel-1 launch a step;
7d. ``mitigation``: the quick lab (every candidate a cell of one batch)
   with its three claims at their limits and each candidate's worst-cell
   ratio within 2% of JAX's, its winner JAX's; the fault panel's
   per-fabric winners JAX's; the agents' convergence gate (CMA-ES or BO
   to the grid target in fewer evaluations than random search); one
   kernel-1 launch a step; then the gradient tier, 2 Adam steps on the
   card on the step core's plain version (kernel 1 has no gradient), its
   history within ``GRAD_HIST_REL`` of the CPU's;
7e. ``whatif``: kernel 1 against its plain version at the first coalesced
   what-if wave's inputs (three mixed-bucket queries, built by
   ``search.candidate_rows_inputs`` as the server builds them), ten
   launches and each cell alone bit-equal; ``benchmarks/pt_whatif.py``'s
   full demo coalesced and then serial: the tables bit-identical, fewer
   coalesced calls, and each query's winner, frontier (up to candidates
   that tie in JAX's table), finish reason, evaluations and the stats'
   calls and lanes JAX's, table entries within 2%
   (``jax_reference.json["whatif_full"]``); one kernel-1 launch a step;
7f. ``sweep``: the sharded sweep launcher's measured workload (the quick
   scale grid and mitigation panel) on one device and twice in two shards
   on ``cuda:0``, digest-equal all three, rows held to
   ``jax_reference.json["sweep_quick"]``; one kernel-1 launch a step;
   meanwhile ``launch.sweep``'s tiny smoke in fresh processes, the cold
   one building kernel 1 into an empty build directory and the warm one
   only loading it (its build-cache checks present and true);
7g. ``kernel1_large``: kernel 1 above 16,384 flows a cell, at
   ``scale_sweep``'s 512-node alltoall bucket (the four 512-node cells
   padded together, B = 4: 65,536 flows on a cluster of eight blocks of
   four 2,048-flow parts, the wide layout), with and without aux: within
   §13 of plain, ten launches bit-equal, each cell alone (the bucket's
   operands on its own flows and links) bit-equal to its row; a random
   cell of ten parts in the shared layout, the wide layout bit-equal to
   it, and a cluster of two whose one-pass sort shares its scratch with
   the hop tables; the pad check with cresco8/128 and cresco8/512 in one
   bucket (32 KiB, steady); the four cells through
   ``bench.run_scale_grid`` held to ``jax_reference.json["scale512"]``
   (iteration counts equal, times within 2%), one kernel-1 launch a step;
8. times kernels 1 (also at the two fleet buckets and the 512-node
   alltoall bucket) and 2, their plain
   versions, their bounds and, for the fused accumulate, the library call
   ``torch.add``, per shape (kernel 1
   beside its time before its redesign, ``EARLIER_MS``, and its time in
   the last redesign's measurement, ``REDESIGN_MS``; kernel 2 and
   ``torch.add`` also in alternating graph replays, medians and spread);
8b. ``engine_graph``: 256 engine steps of the leonardo/256/incast grid
   captured as one CUDA graph, whose replay must be bit-equal to the same
   steps run eagerly; prints the wall ms a step of both (a diagnostic for
   capturing the engine's step loop; the main path does not use it);
9. holds the flash-attention kernel (kernel 7) against its plain version
   at hymba-1.5b's head shapes (25 query heads over 5 KV heads of 64) at
   S = 128, 1000, 1024 and 1280 (the 1024-token window binds), float32
   and bfloat16, and at the serve shape; plus a G = 1, a D = 128 and a
   non-causal case; and, in bfloat16, the wgmma kernel's edges: lengths
   no tile divides (37, 300, 1000), a window starting mid-tile, D = 16
   and 128 with G = 1 non-causal, Sq != Skv and rows with no live key,
   and the head sizes 96 and 112 and G = 48 (in float32 too);
   each call's launch counts show bfloat16 on the wgmma source and
   float32 on the float32 one, and the row log-sum-exp agrees;
10. holds the selective-scan kernel (kernel 6) against its plain version
   at d_inner 3200, N 16, T = 1, 256 and 1280, x in float32 and
   bfloat16, at the serve shape, and at a d_inner no block divides;
11. ``lm_vs_jax``: hymba-1.5b at full width, 2 layers, float32 (TF32 off
   for matmuls and cuDNN) through the kernels, held to
   ``artifacts/bench_cache_torch/jax_lm_reference.json``: prefill and 8
   teacher-forced decode steps;
12. ``serve``: full-depth bfloat16 hymba-1.5b through ``BatchedServer``
   (12 requests, 2 waves; ``benchmarks/pt_serve.py``), with the launch
   counts reset before and read after (each new kernel 32 x 2 times, every
   attention launch on the wgmma source), and wave 1's prefill logits
   held kernel vs plain on the same weights;
13. times kernels 6 and 7 at the serve shape (B = 8, S = 1280, bfloat16)
   (kernel 6 also at the training shape, B = 4) beside their plain
   versions, bounds and, for attention, PyTorch's
   ``scaled_dot_product_attention`` at S = 1024, with the achieved
   TFLOP/s of the function's 4 * D flops a live pair;
14. ``quant_vs_plain``: kernels 3 and 4 bit-equal to their plain versions
   on ragged row counts, an all-zero block, exact .5 ties and the largest
   leaf of hymba-1.5b's gradient tree (``embed.tok``, padded as
   ``compress_leaf`` pads it);
15. ``ssm_scan_vs_plain``: kernel 5, forward and reverse, at the training
   shape (4, 1280, 3200, 16), a ragged d_inner and N = 8 (kernel 5 runs on
   no model path: the training backward is the fused one below);
15b. ``selective_scan_bwd_vs_plain``: the selective scan's fused backward
   against ``ref.fused_selective_scan_bwd`` and autograd of
   ``ref.fused_selective_scan``, every gradient within GRAD_REL of its
   largest magnitude (a bfloat16 d_x within one bfloat16 step more), at
   the training shape (4, 1280, 3200, 16) with x float32 and bfloat16, T =
   1, 37 and 1000, a ragged d_inner and N = 8, all with non-zero h0 and
   dh_T; two launches on the same inputs bit-equal;
16. ``flash_attention_bwd_vs_plain``: the attention backward against
   ``ref.flash_attention_bwd`` and autograd of the plain forward, at the
   training shape (B = 4, S = 1280, 25/5 heads x 64, window 1024) in
   float32 and bfloat16, S = 1000, G = 1 with D = 128, and non-causal
   with a window (rows with no live key); in bfloat16 also the wgmma
   kernels' edges as in 9 (the new head sizes in float32 too), and two
   launches on the same inputs bit-equal;
17. ``train_vs_jax``: full-width 2-layer hymba-1.5b, float32 (TF32 off),
   3 AdamW steps through the kernels, held to
   ``artifacts/bench_cache_torch/jax_train_reference.json``;
18. ``train``: full-depth bfloat16 hymba-1.5b through the port's
   ``Trainer`` (``benchmarks/pt_train.py``): 8 steps at B = 4, S = 1280,
   a checkpoint every 4, a node failure injected at step 6, with the
   launch counts reset before and read after (per step 64 of kernels 6
   and 7, 32 of the selective scan's backward and of the attention
   backward, none of kernel 5; every attention launch on the wgmma
   sources), and then the kernel path against the plain one on the
   trained weights at 2 layers, float32 and bfloat16; a profile of one
   forward + backward with the top operators by device time and their
   input shapes;
19. ``compression``: error-feedback compression of the trained model's
   last gradient tree through kernels 3 and 4, bit-equal to the plain
   versions, with the residual bound and two steps telescoping;
20. ``timing_train``: kernels 3 and 4 at the largest leaf, kernel 5 forward
   and reverse and the selective scan's backward at the training shape,
   and the attention backward at the training shape and at S = 1024
   beside the backward of ``scaled_dot_product_attention``, with achieved
   TFLOP/s (10 * D flops a live pair).
21. ``collectives``, ``moe_vs_jax``, ``serve_moe``, ``timing_moe``: the
   §III-B schedules on 8 gloo ranks on the card (kernels 2-4 on that
   path), and grok-1 at full width, 4 layers, served (kernel 7 at its
   prefill shape against plain and SDPA);
22. ``encdec_vs_jax``: whisper-tiny at full width and depth (4 + 4
   layers), float32 (TF32 off) through the kernels, over 1,500 seeded
   frames, held to ``jax_reference.json["encdec"]``: the prefill (kernel 7
   twelve times, on the float32 source), one decode step and the loss;
23. ``serve_encdec``: whisper-tiny, bfloat16, the twelve requests in two
   waves, the launch counts reset before and read after (kernel 7 twelve
   times a prefill: encoder, causal self and cross-attention over the
   1,500 frames; all on the wgmma source); wave 1's prefill kernel vs
   plain over seeded frames within the bfloat16 limit;
24. ``serve_vlm``: internvl2-76b at full width, 8 of its 80 layers,
   bfloat16, served likewise (kernel 7 once a layer a prefill, causal
   over the 256 patches and the prompt); wave 1's prefill kernel vs plain
   over seeded patches, and 4 decode steps each against a prefill of the
   prompt grown by the tokens before it;
25. ``timing_encdec``: kernel 7 at whisper's three shapes and internvl2's
   prefill shape (``ENCDEC_SHAPES``, which ``FA_EDGES`` also holds in 9
   and 16) beside its plain version, its bound and SDPA;
26. ``dense_vs_jax``: phi3-mini-3.8b at full width, 2 layers, float32
   (TF32 off) through the kernels (kernel 7's float32 source at D = 96),
   held to ``artifacts/bench_cache_torch/jax_dense_reference.json``:
   prefill and 8 teacher-forced decode steps within DENSE_TOL;
27. ``serve_dense``: the dense family at full width and depth, bfloat16,
   served likewise: phi3-mini-3.8b (kernel 7 at 32/32 heads x 96), then
   granite-20b (48/1 heads x 128, MQA: G = 48), each once a layer a
   prefill, all on the wgmma source; wave 1's prefill kernel vs plain;
28. ``serve_kimi``: kimi-k2 at full width on ``KIMI_LAYERS`` of its 61
   layers (384 experts top-8; kernel 7 at 64/8 heads x 112), served
   likewise;
28a. ``dryrun_vs_card``: phi3-mini's wave-1 prefill of 27 (the same
   model drawn again from its seed, full width and depth, bfloat16)
   counted by the dry run on meta tensors (``launch.steps.lower_cell`` on
   the host layout, ``hlo_stats.StepCounter``), then run on the card under
   ``FlopCounterMode`` with kernel 7's FLOPs by the dry run's formula
   times its launches (32): the two FLOP counts equal, the meta peak of
   live bytes past the arguments within ``DRYRUN_PEAK_REL`` of the rise of
   ``max_memory_allocated`` over the prefill; the prefill's device ms
   beside the H100 roofline bound of the count (``roofline_fraction``);
28b. ``tp_moe``: grok-1's ``moe_ffn`` at full width (d 6144, f 32768, 8
   experts top-2, capacity 400 at 1 x 1280 tokens a data shard), bfloat16,
   on 8 gloo ranks of the card (``spawn_group``, each layout's row and
   column subgroups): ``2d`` and ``2d_full`` on a (1, 8) data x model
   layout, ``ep`` on (2, 4); each rank draws only its share of the expert
   leaves (blocks keyed by leaf, expert and 4,096-column block), holds
   each to the one-rank TP-1 function of the same weights
   (``moe.tp_fold`` for ``ep``/``2d``) within ``TP_MOE_REL`` of the
   largest |output|; µs a call, bytes staged through the host and kernel
   2's launches in the ring reduce-scatters;
29. ``timing_dense``: kernel 7 and its backward at the three prefill
   shapes of 27 and 28 (``DENSE_SHAPES``, which ``FA_EDGES`` also holds
   in 9 and 16, and whose float32 runs 9 and 16 make with the D = 96,
   D = 112 and G = 48 edges of ``FA_HEAD_EDGES``) beside their plain
   versions, their bounds, SDPA and SDPA's backward.

Phases 6 to 7g run at once, in the groups of ``CONCURRENT``, each group
in a process of its own with its launch counts its own (the main process
runs 3 to 5 and kernel 1 at the fleet buckets meanwhile, and prints each
group's log when it ends); phases 8 to 29 run after them, one at a time.

It prints a ``{"kernels": [...]}`` line before the last and ends with
``{"ok": true, "device": {...}}``; any failed check exits non-zero
without that line. Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(ROOT, "artifacts", "bench_cache_torch",
                         "jax_reference.json")
LM_REFERENCE = os.path.join(ROOT, "artifacts", "bench_cache_torch",
                            "jax_lm_reference.json")
REPORT = os.path.join(ROOT, "chiprun_out", "chip_smoke.json")

# H100 SXM published peaks (NVIDIA data sheet) for the bound column
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12  # dense tensor-core peak
SFU_EXP_PER_SM_CLOCK = 16  # special-function units: exps per SM per clock
FS_TOL = dict(rtol=2e-4, atol=1.0)  # DESIGN.md §13
REPEATS = 10  # kernel-1 launches on the same inputs held bit-equal
TIME_RTOL = 0.02
# lock-step leaves held tighter than §13's atol: times in seconds, and
# integers and flags held exactly
SECONDS_LEAVES = ("t", "idle", "last_dec", "gap", "t_done", "qdel")
INT_LEAVES = ("rc", "ph", "it", "active", "advance", "wrap", "done")
KERNEL = {"name": "fabric_step_core", "route": "cuda",
          "source": "src/repro_torch/csrc/fabric_step.cu",
          "replaces": "src/repro/kernels/fabric_step.py:175"}
KERNEL2 = {"name": "fused_accumulate", "route": "cuda",
           "source": "src/repro_torch/csrc/fused_reduce.cu",
           "replaces": "src/repro/kernels/fused_reduce.py:27"}
KERNEL6 = {"name": "fused_selective_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/ssm_scan.cu",
           "replaces": "src/repro/kernels/ssm_scan.py:87"}
KERNEL7 = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
           "sources": {
               "bfloat16": "src/repro_torch/csrc/flash_attention_sm90.cu",
               "float32": "src/repro_torch/csrc/flash_attention.cu"},
           "replaces": "src/repro/kernels/flash_attention.py:74"}
KERNEL3 = {"name": "quantize_int8", "route": "cuda",
           "source": "src/repro_torch/csrc/quant.cu",
           "replaces": "src/repro/kernels/quant.py:30"}
KERNEL4 = {"name": "dequantize_int8", "route": "cuda",
           "source": "src/repro_torch/csrc/quant.cu",
           "replaces": "src/repro/kernels/quant.py:53"}
KERNEL5 = {"name": "ssm_scan", "route": "cuda",
           "source": "src/repro_torch/csrc/state_scan.cu",
           "replaces": "src/repro/kernels/ssm_scan.py:33"}
KERNEL6B = {"name": "fused_selective_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/ssm_scan_bwd.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:87",
            "note": "the gradient of kernel 6; the TPU package has no "
                    "backward kernel (XLA differentiates "
                    "src/repro/models/ssm.py:91-103)"}
KERNEL7B = {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
            "sources": {
                "bfloat16":
                    "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                "float32": "src/repro_torch/csrc/flash_attention_bwd.cu"},
            "replaces": "src/repro/kernels/flash_attention.py:74",
            "note": "the gradient of kernel 7; the TPU package has no "
                    "backward kernel (XLA differentiates "
                    "src/repro/models/layers.py:225)"}
# hymba-1.5b's attention heads (H, KH, D), its window, its SSM (Di, N)
# and the serve shape (B, S)
HYMBA_HEADS = (25, 5, 64)
HYMBA_WINDOW = 1024
HYMBA_SSM = (3200, 16)
SERVE_B, SERVE_S = 8, 1280
# kernel 7 vs plain: float32 within 1e-5 absolute (outputs of order one;
# only the summation order differs); bfloat16 within one bfloat16 step of
# the plain value (2**-7 relative) + 1e-5, as both round one float32
# result. Kernel 6 vs plain: 2e-6 of the largest |y| or |h_T| (float32
# throughout; the kernel's fused multiply-adds and the y contraction's
# order differ)
FA_F32_ATOL = 1e-5
FA_BF16_RTOL = 2.0 ** -7
# kernel 7's shapes on the encoder-decoder and VLM prefill paths at B =
# SERVE_B: (label, (Sq, Skv, (H, KH, D), causal, window)). whisper-tiny
# runs it three ways a layer over 1,500 frames, G = 1, D = 64 (the last
# 64-key tile ragged: 1,500 = 23 x 64 + 28); internvl2 causal over its
# 256 patches and the wave's 1,280 prompt tokens, G = 8, D = 128
WHISPER_HEADS = (6, 6, 64)
WHISPER_FRAMES = 1500
VLM_HEADS = (64, 8, 128)
VLM_PATCHES = 256
ENCDEC_SHAPES = (
    ("whisper encoder", (WHISPER_FRAMES, WHISPER_FRAMES, WHISPER_HEADS,
                         False, 0)),
    ("whisper decoder self", (SERVE_S, SERVE_S, WHISPER_HEADS, True, 0)),
    ("whisper cross", (SERVE_S, WHISPER_FRAMES, WHISPER_HEADS, False, 0)),
    ("internvl2 prefill", (VLM_PATCHES + SERVE_S, VLM_PATCHES + SERVE_S,
                           VLM_HEADS, True, 0)))
# kernel 7's shapes on the dense and kimi-k2 serve prefills (B = SERVE_B,
# the wave's 1,280 tokens, causal, no window): phi3-mini 32/32 heads x 96,
# kimi-k2 64/8 x 112 and granite-20b's MQA 48/1 x 128 (G = 48: 48 of a
# warpgroup's 64 rows live). The serve phases check their configs' heads
# against these
DENSE_SHAPES = (
    ("phi3-mini prefill", (SERVE_S, SERVE_S, (32, 32, 96), True, 0)),
    ("kimi-k2 prefill", (SERVE_S, SERVE_S, (64, 8, 112), True, 0)),
    ("granite-20b prefill", (SERVE_S, SERVE_S, (48, 1, 128), True, 0)))
# the head sizes and grouping that only those configs bring, at ragged
# lengths, then DENSE_SHAPES: run on all four sources (bfloat16 in FA_EDGES,
# float32 beside it), forward and backward
FA_HEAD_EDGES = (
    ("D=96 G=1 non-causal S=300", 2, 300, 300, (4, 4, 96), False, 0),
    ("D=112 G=8 S=300 w=100 (window starts mid-tile)", 2, 300, 300,
     (16, 2, 112), True, 100),
    ("G=48 D=128 S=300", 1, 300, 300, (48, 1, 128), True, 0)) \
    + tuple((label, SERVE_B) + shape for label, shape in DENSE_SHAPES)
# the bfloat16 (wgmma) attention kernels' edge cases, forward and
# backward: (label, B, Sq, Skv, (H, KH, D), causal, window); the last
# ten are ENCDEC_SHAPES and FA_HEAD_EDGES
FA_EDGES = (
    ("S=37", 2, 37, 37, (25, 5, 64), True, 1024),
    ("S=300 w=100 (window starts mid-tile)", 2, 300, 300, (25, 5, 64),
     True, 100),
    ("S=1000 non-causal", 1, 1000, 1000, (25, 5, 64), False, 0),
    ("D=16 G=1 non-causal S=300", 2, 300, 300, (8, 8, 16), False, 0),
    ("D=128 G=1 non-causal S=300", 2, 300, 300, (4, 4, 128), False, 0),
    ("Sq=300 Skv=150 non-causal w=100, dead rows", 1, 300, 150,
     (25, 5, 64), False, 100),
    ("Sq=300 Skv=200 causal w=64, dead rows", 1, 300, 200, (25, 5, 64),
     True, 64),
    ("Sq=37 Skv=1000 non-causal", 1, 37, 1000, (25, 5, 64), False, 0)) \
    + tuple((label, SERVE_B) + shape for label, shape in ENCDEC_SHAPES) \
    + FA_HEAD_EDGES
SCAN_REL = 2e-6
# the selective scan's backward vs plain and vs autograd of the plain
# forward: each gradient within GRAD_REL of its largest magnitude (sums
# over n, d, b and t in another order; the limit of
# tests/test_torch_ssm_scan.py); a bfloat16 d_x within one bfloat16 step
# (BF16_STEP of each value) more, as both round one float32 result
GRAD_REL = 2e-5
BF16_STEP = 2.0 ** -7
SCAN_GRADS = ("d_dt", "d_A", "d_B", "d_C", "d_x", "d_h0")
# (label, (B, T, Di, N), x type) of the backward's checks
SCAN_BWD_CASES = (
    ("train x float32", (4, 1280, 3200, 16), "float32"),
    ("train x bfloat16", (4, 1280, 3200, 16), "bfloat16"),
    ("T=1", (2, 1, 3200, 16), "bfloat16"),
    ("T=37", (2, 37, 3200, 16), "float32"),
    ("T=1000", (2, 1000, 3200, 16), "bfloat16"),
    ("ragged Di", (2, 200, 3000, 16), "float32"),
    ("N=8", (1, 100, 1000, 8), "bfloat16"))
# lm_vs_jax: logits within LM_TOL absolute of the JAX rows; greedy tokens
# equal wherever JAX's top-2 margin exceeds 10 x LM_TOL
LM_TOL = 8e-6
# dense_vs_jax (phi3-mini, d_model 3072, d_ff 8192): logits within
# DENSE_TOL absolute of the JAX rows. LM_TOL is below the float32 noise at
# this width: the port's plain path on the CPU is 3.4e-5-4.7e-5 from the
# rows, the kernels on the card 1.06e-5-3.28e-5, and each package's
# float32 logits 8e-6 from its own float64 ones at one layer of 64 tokens
# (the reference's compiled float32 rope adds a position-proportional
# term: its K cache is 4.5e-4 from the port's at position 1,279). A 0.1%
# error in the attention scale moves the rows 6.2e-3, a causal mask one
# key wide 3.3e-2 (PERF.md §6)
DENSE_TOL = 1e-4
# serve: prefill logits, kernel vs plain on the same weights, relative to
# the largest |logit|. In bfloat16 (wave 1) rounding alone moves them
# 0.035 through 32 layers, as much as a window one key too wide (0.048):
# the bfloat16 limit catches gross faults only. In float32 (both waves)
# the two are 8.9e-6 apart and that window fault moves wave 1's 1.5e-2
# (H100, PERF.md §6)
SERVE_BF16_REL = 0.1
SERVE_F32_REL = 1e-4
TRAIN_REFERENCE = os.path.join(ROOT, "artifacts", "bench_cache_torch",
                               "jax_train_reference.json")
# the training shape (B, S), its steps, checkpoint interval and failure
TRAIN_B, TRAIN_S = 4, 1280
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 8, 4, 6
# kernel 5 and the attention backward vs plain. Kernel 5: hs and h_T
# within 2e-6 of the largest |h| (both round a product and a sum per step,
# --fmad=false, so they are expected bit-equal). The backward in float32:
# 1e-5 of the largest gradient magnitude (sums over up to ~5,000 rows in
# another order: 4.5e-6 measured at the training shape); in bfloat16 one
# bfloat16 step (2**-7) of each value plus that, as both round one float32
# result
STATE_SCAN_REL = 2e-6
FA_BWD_F32_REL = 1e-5
# kernel 7's row log-sum-exp vs the plain one, absolute, where a row has a
# live key (a row with none must be -inf in both): a float32 max plus the
# log of a sum of up to 1280 exps in another order, |lse| ~ 8 on these
# inputs, so a few float32 steps at 8 (~1e-6) are expected
FA_LSE_ABS = 2e-5
# train: the trained weights at 2 layers, kernel path vs plain, loss and
# per-leaf gradient norms relative. float32: float32 summation order only;
# the paths have read loss equal and norms 5.9e-8 apart, while a window one
# key too wide in the backward moved them 6.7e-5 on the CPU (PERF.md §2).
# bfloat16: rounding of activations and gradients, read 7.6e-7 and 3.0e-4
TRAIN_F32_REL = {"loss": 1e-6, "grad_norm": 2e-6}
TRAIN_BF16_REL = {"loss": 1e-4, "grad_norm": 5e-3}
# kernel 2's float32 tiles on the fig1 path (1, 16 and 128 MiB), the
# reference's edge-tile test shape, and the tile the kernels line reports
FIG1_TILES = ((64, 512), (1024, 512), (8192, 512))
EDGE_TILE = (300, 640)
MAIN_TILE = (8192, 512)
# (acc, x) type pairs and scales kernel 2 is checked at
FR_TYPES = (("float32", "float32"), ("bfloat16", "bfloat16"),
            ("float32", "bfloat16"), ("bfloat16", "float32"))
FR_SCALES = (1.0, 0.25)
# Fig. 3 CV against JAX: within CV_ATOL + CV_RTOL * |cv|. The port has
# agreed to 1.5e-8; a wrong run moves nanjing_nslb's CV, the Obs. 1 pin's
# denominator, by far more (PERF.md §6)
CV_RTOL, CV_ATOL = 1e-3, 1e-5
# Obs. 3 in the 2 MiB burst x pause grid: short bursts hurt less; the
# longest bursts approach steady congestion (fig5 leonardo/64/incast)
OBS3_SHORT_BURST_MS, OBS3_SHORT_MIN = 0.5, 0.9
OBS3_LONG_BURST_MS = 8.0
# fig5_steady quick grids on the main path: (system, n_nodes, aggressor)
FIG5_GRIDS = (("leonardo", 64, "incast"), ("leonardo", 256, "incast"),
              ("lumi", 256, "incast"), ("cresco8", 256, "incast"))
# (label, system, n_nodes, victim, aggressor) of the kernel's slice shapes
SLICE_SHAPES = (("nanjing_ecmp/8/alltoall", "nanjing_ecmp", 8, "alltoall",
                 "alltoall"),
                ("leonardo/64/incast", "leonardo", 64, "ring_allgather",
                 "incast"),
                ("leonardo/256/incast", "leonardo", 256, "ring_allgather",
                 "incast"),
                ("lumi/256/incast", "lumi", 256, "ring_allgather", "incast"),
                ("cresco8/256/alltoall", "cresco8", 256, "ring_allgather",
                 "alltoall"))
MAIN_SHAPE = "leonardo/256/incast"  # the main path's longest grid
# kernel 1's ms a launch at each slice shape before its redesign (the
# timing phase on an H100 80GB HBM3 at 700 W, PERF.md §6), printed beside
# the new times
EARLIER_MS = {"nanjing_ecmp/8/alltoall": 0.0149, "leonardo/64/incast": 0.0287,
              "leonardo/256/incast": 0.0497, "lumi/256/incast": 0.0461,
              "cresco8/256/alltoall": 0.1934}
# kernel 1's ms a launch at the slice shapes after its redesign for Hopper
# (the timing phase on an H100 80GB HBM3 at 700 W; PERF.md §6): the shapes
# keep their times within 5% of these
REDESIGN_MS = {"nanjing_ecmp/8/alltoall": 0.0156, "leonardo/64/incast": 0.0243,
             "leonardo/256/incast": 0.0345, "lumi/256/incast": 0.0340,
             "cresco8/256/alltoall": 0.0848}
# (label, system, n_nodes, victim, aggressor) of the alltoall cells whose
# rows do not fit a block's shared memory: kernel 1's wide layout (LUMI at
# 256 nodes is also Fig. 8's alltoall bucket)
WIDE_SHAPES = (("lumi/128/alltoall", "lumi", 128, "ring_allgather",
                "alltoall"),
               ("lumi/256/alltoall", "lumi", 256, "ring_allgather",
                "alltoall"),
               ("leonardo/256/alltoall", "leonardo", 256, "ring_allgather",
                "alltoall"))
# Figs. 7-8: the reduced alltoall scale grid held to JAX (cells, size,
# (burst, pause) s, n_iters, warmup: benchmarks/pt_jax_reference.py) and
# the iterations and chunk of the padded-vs-alone bit checks
FIG8_ALLTOALL = ((("cresco8", 128), ("lumi", 256)), (2 << 20,),
                 ((2e-3, 0.2e-3),), 8, 2)
PAD_CHECK_ITERS, PAD_CHECK_CHUNK = 3, 256
# kernel 1 above 16,384 flows a cell: scale_sweep's four 512-node alltoall
# cells (65,536 flows each; padded together, a cluster of eight blocks of
# four 2,048-flow parts) held to jax_reference.json's "scale512" (victim
# ring_allgather; sizes, n_iters, warmup; the steady profile), the pad
# check's pair (a 128-node cell of two parts in the 65,536-flow bucket)
# and a random shape of ten parts that both layouts take
LARGE_CELLS = (("haicgu_ib", 512), ("leonardo", 512), ("cresco8", 512),
               ("lumi", 512))
LARGE_GRID = ((32 << 10,), 4, 1)
LARGE_LABEL = "scale_sweep 512-node alltoall bucket"
LARGE_PAD_CELLS = (("cresco8", 128), ("cresco8", 512))
PARTS_SHAPE = (20000, 1, 40, 9, 6)
# a cluster of two in the shared layout whose one-pass sort leaves the hop
# items in the scratch a cluster's hop tables reuse
ONE_PASS_SHAPE = (3000, 1, 40, 9, 6)
# the beyond-paper families (their first quick grid; phased_collectives'
# first flat/phased pair) held to jax_reference.json's scenarios_quick
FAMILY_GRIDS = (("ramp_onset", (0,)), ("random_telegraph", (0,)),
                ("multi_tenant", (0,)), ("phased_collectives", (0, 1)),
                ("multi_job_mix", (0,)), ("scale_sweep", (0,)),
                ("mixed_topology", (0,)), ("link_fault", (0,)),
                ("intra_node", (0,)))
# cells of those grids left out to keep the script's wall near 900 s (the
# slowest of each grid; pt_run --only scenarios runs them): a profile
# label or a (system, n_nodes) cell per family
FAMILY_CUTS = {"ramp_onset": ("steady",),
               "mixed_topology": (("haicgu_ib", 16),)}
# the sim time (s) at which kernel 1's fault-scaled capacities are taken:
# inside every window of the tables fault_tables builds
FAULT_T = 0.5e-3
INERT_NODES = 16  # leonardo allocation of the on-card inertness gate
# fleet replay: seeds of the quick and full registry points (their kernel-1
# shapes), and the horizon, seeds and chunk of the metrics on/off and
# padded/alone bit checks (the quick templates cut to 0.5 ms, for time)
FLEET_QUICK_SEEDS, FLEET_FULL_SEEDS = 8, 256
FLEET_CUT_HORIZON, FLEET_CUT_SEEDS, FLEET_CUT_CHUNK = 0.5e-3, 4, 256
# the card's lowering against JAX's stored one: float draws relative
LOWER_REL = 1e-6
# the gradient tier on the card (plain core) against the CPU: knobs, engine
# steps of the objective and the history's relative limit
GRAD_KNOBS = ("md", "rai_frac", "kmin")
GRAD_STEPS = 800
GRAD_HIST_REL = 1e-4
# the fabric phases that run at once, each group in a process of its own
# (spawned, a CUDA context each, WORKER_TIMEOUT_S from their start): the
# host's Python binds them, not the card (an engine step keeps the card busy
# a tenth to a quarter of its wall), so together they take about as long as
# the longest group. The main process meanwhile holds kernels 1 and 2 to
# their plain versions; every phase that times something runs after the
# groups have ended, alone on the card.
CONCURRENT = (("main_path", "kernel1_large"),
              ("fig1", "fig3", "fig6", "scenarios"),
              ("fleet_replay", "sweep"), ("fig7_fig8", "mitigation",
                                          "whatif"))
WORKER_TIMEOUT_S = 700
# the collectives phase: ranks of its gloo group (all on cuda:0) and the
# vector whose shards its checks move (the bench's 2 MiB)
COLLECTIVE_RANKS = 8
COLLECTIVE_VECTOR = 2 << 20
# serve_moe: grok-1 at full width, cut to this many layers (4.92 B
# parameters a layer, ~42.6 GB with embedding and head in bfloat16; the
# 64 layers, 630 GB, fit no card)
GROK_LAYERS = 4
# serve_vlm: internvl2-76b at full width, cut to this many of its 80
# layers (855.6 M parameters a layer; 8.95 B, 17.9 GB in bfloat16 with
# embedding and head; the 80 layers, 137 GB, fit no card); and the decode
# steps held to the grown prompt's prefill
VLM_LAYERS = 8
DECODE_CHECK = 4
MOE_REFERENCE = os.path.join(ROOT, "artifacts", "bench_cache_torch",
                             "jax_moe_reference.json")
DENSE_REFERENCE = os.path.join(ROOT, "artifacts", "bench_cache_torch",
                               "jax_dense_reference.json")
# serve_dense: phi3-mini-3.8b (32 layers, 3.82 B parameters, 7.6 GB) and
# granite-20b (52 layers, 28.17 B, 56.3 GB) at full width and depth, in
# this order; serve_kimi: kimi-k2 at full width on this many of its 61
# layers (19.38 B parameters with embedding and head, 38.8 GB; two layers,
# 72.8 GB, leave no room for the activations). Each dense architecture
# with its DENSE_SHAPES label
DENSE_ARCHS = (("phi3-mini-3.8b", "phi3-mini prefill"),
               ("granite-20b", "granite-20b prefill"))
KIMI_LAYERS = 1
# dryrun_vs_card: the meta count's peak of live bytes past the arguments
# against the card's rise of max_memory_allocated over the same prefill
DRYRUN_PEAK_REL = 0.10
# tp_moe: (mode, (data, model) layout) cases of grok-1's moe_ffn on 8 gloo
# ranks of the card, the tokens of a data shard, the column block its
# expert leaves are drawn in, the seed, the limit of each case against its
# one-rank TP-1 function (relative to the largest |output|; measured
# 0.0087-0.0117 on the H100: the TP sums round each rank's partial to
# bfloat16, the TP-1 function rounds once), and the timed calls a rank
# makes
TP_MOE_CASES = (("2d", (1, 8)), ("2d_full", (1, 8)), ("ep", (2, 4)))
TP_MOE_TOKENS = 1280
TP_MOE_BLOCK = 4096
TP_MOE_SEED = 91
TP_MOE_REL = 2.0 ** -5
TP_MOE_CALLS = 3
# (F, H, L, n_src, n_sw) random shapes, as the reference's kernel tests
RANDOM_SHAPES = ((7, 3, 13, 4, 5), (130, 5, 300, 33, 17),
                 (256, 4, 255, 8, 8), (1, 1, 2, 1, 2))


def log(*a):
    print(*a, flush=True)


def run_group(names, out, threads):
    """Run the named phases (one group of CONCURRENT) in this process,
    spawned by main: the log goes to ``out + ".log"``; the failures, the
    report and what the phases set on the Smoke (launch counts, errors)
    are pickled to ``out``."""
    import pickle
    sys.stdout = open(out + ".log", "w", buffering=1)
    import torch
    torch.set_num_threads(threads)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    s = Smoke(torch)
    for name in names:
        s.phase(name, getattr(s, name))
    attrs = {}
    for k, v in vars(s).items():
        try:
            if k not in ("torch", "failures", "report"):
                attrs[k] = pickle.loads(pickle.dumps(v))
        except Exception:
            pass
    with open(out, "wb") as f:
        pickle.dump({"failures": s.failures, "report": s.report,
                     "attrs": attrs, "ended": time.time()}, f)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = "cuda"
        self.failures = []
        self.report = {"phases": {}}

    def check(self, ok: bool, what: str):
        if not ok:
            self.failures.append(what)
            log(f"FAIL: {what}")

    def phase(self, name, fn):
        log(f"== {name}")
        t0 = time.time()
        try:
            fn()
        except Exception:  # a failed phase fails the run, after the rest
            self.failures.append(f"{name}: {traceback.format_exc()}")
            log(f"FAIL: phase {name}\n{traceback.format_exc()}")
        self.report["phases"][name] = round(time.time() - t0, 3)
        log(f"   {name}: {time.time() - t0:.1f}s")

    def start_groups(self, workdir):
        """Spawn one process a group of CONCURRENT; returns
        [(names, pickle path, process, start time)]."""
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        threads = max(1, len(os.sched_getaffinity(0)) // len(CONCURRENT))
        procs = []
        for i, names in enumerate(CONCURRENT):
            out = os.path.join(workdir, f"group{i}.pkl")
            pr = ctx.Process(target=run_group, args=(names, out, threads),
                             daemon=True)
            pr.start()
            procs.append((names, out, pr, time.time()))
        log(f"   started {len(procs)} processes ({threads} ATen threads "
            f"each): {' | '.join(', '.join(n) for n, *_ in procs)}")
        return procs

    def join_groups(self, procs):
        """Wait for every group (stopping one still running
        WORKER_TIMEOUT_S after its start), print its log, and merge its
        failures, report and attributes into this Smoke; records each
        group's wall from its spawn to its end."""
        import pickle
        walls = self.report.setdefault("concurrent", {})
        for names, out, pr, t0 in procs:
            label = ", ".join(names)
            pr.join(max(0.0, t0 + WORKER_TIMEOUT_S - time.time()))
            if pr.is_alive():
                pr.kill()
                pr.join()
                self.check(False, f"[{label}] still running after "
                           f"{WORKER_TIMEOUT_S} s; stopped")
            log(f"== [{label}] (a process of its own, exit code "
                f"{pr.exitcode})")
            if os.path.exists(out + ".log"):
                with open(out + ".log") as f:
                    sys.stdout.write(f.read())
                sys.stdout.flush()
            if not os.path.exists(out):
                self.check(False, f"[{label}] left no result (exit code "
                           f"{pr.exitcode})")
                continue
            with open(out, "rb") as f:
                got = pickle.load(f)
            walls[label] = round(got["ended"] - t0, 3)
            log(f"   [{label}]: {walls[label]:.1f}s from its spawn")
            self.failures.extend(got["failures"])
            for k, v in got["report"].items():
                if isinstance(v, dict) and isinstance(
                        self.report.get(k), dict):
                    self.report[k].update(v)
                else:
                    self.report[k] = v
            for k, v in got["attrs"].items():
                setattr(self, k, v)

    # ---------------------------------------------------------------- 1
    def device(self):
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        self.smi = smi.stdout.strip().splitlines()[0] if smi.stdout \
            else "nvidia-smi: unavailable"
        log(self.smi)
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        self.sm_clock_hz = float(clock[0]) * 1e6 if clock else 1.98e9
        self.n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        log(f"max SM clock {self.sm_clock_hz / 1e6:.0f} MHz, {self.n_sm} SMs")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} "
            f"count {torch.cuda.device_count()}")
        self.report["card"] = self.smi

    # ---------------------------------------------------------------- 2
    def build(self):
        from concurrent.futures import ThreadPoolExecutor
        from repro_torch.kernels import _build
        from repro_torch.kernels import fabric_step as fs
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import fused_reduce as fr
        from repro_torch.kernels import quant as qt
        from repro_torch.kernels import ssm_scan as ss
        # (source, flags, loader): one nvcc per source, all started together
        sources = ((fs.SOURCE, fs.FLAGS, fs._load),
                   (fr.SOURCE, fr.FLAGS, fr._load),
                   (fa.SOURCE, fa.FLAGS, fa._load),
                   (fa.BWD_SOURCE, fa.FLAGS, fa._load_bwd),
                   (fa.SM90_SOURCE, fa.FLAGS, fa._load_sm90),
                   (fa.SM90_BWD_SOURCE, fa.FLAGS, fa._load_sm90_bwd),
                   (ss.SOURCE, ss.FLAGS, ss._load),
                   (ss.BWD_SOURCE, ss.FLAGS, ss._load_bwd),
                   (ss.SCAN_SOURCE, ss.FLAGS, ss._load_scan),
                   (qt.SOURCE, qt.FLAGS, qt._load))
        t0 = time.time()
        with ThreadPoolExecutor(len(sources)) as pool:
            libs = list(pool.map(lambda k: _build.build(k[0], k[1]),
                                 sources))
        for _, _, load in sources:
            load()
        self.report["build_s"] = time.time() - t0
        self.report["ptxas"] = {}
        for (src, flags, _), lib in zip(sources, libs):
            log(f"built {os.path.relpath(lib, ROOT)}")
            entry = None
            for line in _build.log(src, flags).splitlines():
                if "Compiling entry function" in line:
                    entry = line.split("'")[1] if "'" in line else None
                if "registers" in line or "smem" in line or "spill" in line:
                    # a spill names its kernel (the mangled name holds
                    # the template's head size and consumer count)
                    spills = any(int(n) for n in re.findall(
                        r"(\d+) bytes spill", line))
                    text = f"{entry}: {line.strip()}" if spills \
                        else line.strip()
                    log("   ptxas:", text)
                    self.report["ptxas"].setdefault(src.name, []).append(
                        text)
        log(f"   all {len(sources)} built in {time.time() - t0:.1f}s")
        # the wgmma kernels run on the tensor cores and TMA: their SASS
        # must hold HGMMA and UTMALDG
        tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
        self.report["sass"] = {}
        for src in (fa.SM90_SOURCE, fa.SM90_BWD_SOURCE):
            sass = subprocess.run(
                [tool, "-sass", str(_build.library_path(src, fa.FLAGS))],
                capture_output=True, text=True, timeout=120).stdout
            n = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
            log(f"   {src.name} SASS: {n}")
            self.check(all(n.values()), f"build: {src.name} SASS lacks "
                       f"HGMMA or UTMALDG: {n}")
            self.report["sass"][src.name] = n

    # ------------------------------------------------------------ inputs
    def grid_case(self, system, n, victim, aggr, sizes=None, profiles=None):
        """A grid's geometry and stacked params on the card, as run_grid
        builds them (bench.grid_inputs: sizes x baseline/profiles; by
        default the fig5 sizes and the steady profile)."""
        from repro_torch.core import bench, congestion as cong
        from repro_torch.core.fabric import systems
        if sizes is None:
            sizes = (4 << 20, 16 << 20) if system.startswith("nanjing") \
                else (32 << 10, 2 << 20)
        if profiles is None:
            profiles = (cong.steady(),)
        case, _, params = bench.grid_inputs(systems.get_system(system), n,
                                            victim, aggr, sizes, profiles)
        return case, case.geom.to(self.dev), params.to(self.dev)

    def path_cases(self):
        """(label, geometry, stacked params, pads idle) on the card of
        every figure path's kernel-1 inputs, built by the same functions
        its driver runs, at the points this script drives: the main path's
        Fig. 4 points as one scale grid (scenarios.fig4_grid through
        bench.scale_grid_inputs: both Nanjing routings in one bucket, one
        geometry row a cell, B=8), Fig. 1's sizes as one grid
        (pt_fig1_breakdown.network_grid through bench.grid_inputs, B=6),
        Fig. 3's points as one bucket (pt_fig3_sawtooth.trace_points
        through bench.goodput_inputs, B=6, pad flows padded in), Fig. 6's
        quick grids (B=5) and its 2 MiB burst x pause grid (B=10). Where
        pads are idle, a flow with 0 bytes injects nothing, as in the
        engine."""
        from benchmarks import pt_fig1_breakdown as fig1
        from benchmarks import pt_fig3_sawtooth as fig3
        from benchmarks import pt_fig6_bursty as fig6
        from repro_torch.core import bench, scenarios
        from repro_torch.core.fabric import simulator as sim
        ref = self.reference()
        _, _, grid = scenarios.fig4_grid(
            [(w["mode"], w["vector_bytes"]) for w in ref["fig4_nslb"]])
        _, _, stacked, p = bench.scale_grid_inputs(*grid)
        geom, p = sim.hetero_cells(stacked, p, self.dev)
        yield "main path fig4 bucket", geom, p, True
        case, _, p = bench.grid_inputs(*fig1.network_grid(
            [w["vector_bytes"] for w in ref["fig1_breakdown"]]))
        yield (f"fig1 haicgu_ib/{fig1.N_NODES}/ring_allreduce grid",
               case.geom.to(self.dev), p.to(self.dev), True)
        stacked, p = bench.goodput_inputs(fig3.trace_points(
            [(w["system"], w["vector_bytes"]) for w in ref["fig3_sawtooth"]]))
        geom, p = sim.hetero_cells(stacked, p, self.dev)
        yield f"fig3 bucket ({fig3.N_NODES}/{fig3.COLLECTIVE})", geom, p, True
        grids = scenarios.get("fig6_bursty", True).grids + (
            fig6.grid_at_size("leonardo", "incast", 2 << 20),)
        for g in grids:
            _, geom, p = self.grid_case(g.system, g.n_nodes, g.victim,
                                        g.aggressor, g.sizes, g.profiles)
            yield (f"fig6 {g.system}/{g.n_nodes}/{g.aggressor} "
                   f"{g.sizes[0]:.0f}", geom, p, False)

    def core_inputs(self, geom, p, seed, caps=None, idle=False):
        """Step-core operands at a grid's shapes (a geometry of one row, or
        one a cell): each flow on one of its candidate paths, rates up to
        its NIC cap, queues up to qmax; ``caps`` in place of the
        geometry's link capacities; with ``idle`` a flow of 0 bytes (a pad
        flow, an idle short slot) injects nothing."""
        torch = self.torch
        import numpy as np
        rng = np.random.RandomState(seed)
        B = p.dt.shape[0]
        F = geom.n_flows
        paths = geom.paths.expand(B, *geom.paths.shape[-3:])
        n_paths = geom.n_paths.expand(B, F).cpu().numpy()
        choice = torch.as_tensor((rng.rand(B, F) * n_paths).astype(np.int64),
                                 device=self.dev)
        plinks = paths.gather(2, choice[:, :, None, None].expand(
            B, F, 1, paths.shape[-1]))[:, :, 0].contiguous()
        inject = (p.host_caps * torch.as_tensor(
            rng.rand(B, F), dtype=torch.float32, device=self.dev)).contiguous()
        if idle:
            inject = (inject * (p.bytes_per_iter > 0)).contiguous()
        q = torch.as_tensor(rng.rand(B, geom.L + 1), dtype=torch.float32,
                            device=self.dev) * p.qmax_bytes[:, None] * 0.9
        q[:, -1] = 0.0
        occ = q / p.qmax_bytes[:, None]
        return (plinks, inject, geom.src_id, p.host_caps, q, occ,
                geom.caps_finite if caps is None else caps, geom.src_sw,
                geom.dst_sw, p.dt, p.qmax_bytes, p.hol_factor, p.hol_start,
                p.burst_jitter), dict(n_src=geom.n_src, n_sw=geom.n_sw)

    def random_inputs(self, shape, seed, B=2):
        torch = self.torch
        import numpy as np
        F, H, L, n_src, n_sw = shape
        rng = np.random.RandomState(seed)
        t = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
            x, dtype=dt, device=self.dev).contiguous()
        q = rng.rand(B, L + 1) * 1e6
        sc = [t(rng.uniform(lo, hi, B)) for lo, hi in
              ((1e-6, 4e-6), (2e6, 2e6), (0.0, 0.9), (0.5, 0.8), (0, 0.1))]
        args = (t(rng.randint(0, L + 1, (B, F, H)), torch.int32),
                t(rng.rand(B, F) * 1e9), t(rng.randint(0, n_src, F),
                                           torch.int32),
                t((rng.rand(B, F) + 0.5) * 1e9), t(q), t(q / 2e6),
                t((rng.rand(L + 1) + 0.1) * 1e9),
                t(rng.randint(0, n_sw, L + 1), torch.int32),
                t(rng.randint(0, n_sw, L + 1), torch.int32), *sc)
        return args, dict(n_src=n_src, n_sw=n_sw)

    def zero_capacity(self, args, n_zero=3, silent=2):
        """The same operands with the first ``n_zero`` links at zero
        capacity and the first ``silent`` flows sending nothing: an
        unloaded zero-capacity link divides 0 by 0, and the flows that
        cross it carry the NaN on, in the kernel as in the plain version."""
        args = list(args)
        args[6] = args[6].clone()
        args[6][..., :n_zero] = 0.0
        args[1] = args[1].clone()
        args[1][..., :silent] = 0.0
        return tuple(args)

    def disjoint_inputs(self):
        """At most one contributor per (link, hop), source and switch."""
        torch = self.torch
        import numpy as np
        F, H = 6, 3
        L = F * H + 4
        args, kw = self.random_inputs((F, H, L, F + 1, L + 2), 0, B=1)
        args = list(args)
        args[0] = torch.arange(F * H, dtype=torch.int32,
                               device=self.dev).view(1, F, H)
        args[2] = torch.arange(F, dtype=torch.int32, device=self.dev)
        args[7] = torch.arange(1, L + 2, dtype=torch.int32, device=self.dev)
        args[8] = torch.as_tensor(np.roll(np.arange(1, L + 2), 1),
                                  dtype=torch.int32, device=self.dev)
        return tuple(args), kw

    # ---------------------------------------------------------------- 3
    def compare(self, label, args, kw, with_aux, exact=False):
        """Kernel vs plain on the same card tensors, and REPEATS launches
        of the kernel bit-equal; returns max abs err."""
        torch = self.torch
        from repro_torch.kernels import fabric_step as fs, ref
        runs = [fs.fabric_step_core(*args, with_aux=with_aux, **kw)
                for _ in range(REPEATS)]
        pl = ref.fabric_step_core(*args, with_aux=with_aux, **kw)
        torch.cuda.synchronize()
        k1 = runs[0]
        worst, parts = 0.0, []
        for k, want in pl.items():
            if want is None:
                continue
            got = k1[k]
            # NaN where, and only where, the plain version has NaN
            nan = torch.isnan(want)
            self.check(bool(torch.equal(torch.isnan(got), nan)),
                       f"{label}: {k} NaN pattern differs")
            got, want = got[~nan], want[~nan]
            err = (got - want).abs()
            tol = FS_TOL["atol"] + FS_TOL["rtol"] * want.abs()
            mabs = float(err.max()) if err.numel() else 0.0
            mrel = float((err / want.abs().clamp_min(1e-30)).max()) \
                if err.numel() else 0.0
            worst = max(worst, mabs)
            parts.append(f"{k} {mabs:.3g}/{mrel:.3g}"
                         + (f" ({int(nan.sum())} NaN)" if nan.any() else ""))
            if exact:
                self.check(bool(torch.equal(got, want)),
                           f"{label}: {k} not bit-exact")
            self.check(bool((err <= tol).all()) and bool(
                torch.isfinite(got).all()),
                f"{label}: {k} beyond §13 (max abs {mabs}, rel {mrel})")
        same = all(bits_equal(torch, run[k], k1[k]) for run in runs[1:]
                   for k in k1 if k1[k] is not None)
        self.check(same, f"{label} aux={int(with_aux)}: {REPEATS} launches "
                   f"not bit-equal")
        log(f"   {label:32s} aux={int(with_aux)} max abs/rel err: "
            f"{', '.join(parts)}; {REPEATS} launches bit-equal: {same}")
        return worst

    def batch_invariance(self, label, args, kw, cells=None):
        """Each cell launched alone (or each of ``cells``) gives its row of
        the batched launch bit for bit, with and without the aux
        observer."""
        torch = self.torch
        from repro_torch.kernels import fabric_step as fs
        B = args[0].shape[0]
        held = True
        for aux in (False, True):
            whole = fs.fabric_step_core(*args, with_aux=aux, **kw)
            same = True
            for b in range(B) if cells is None else cells:
                alone = fs.fabric_step_core(*cell_args(args, b),
                                            with_aux=aux, **kw)
                same &= all(bits_equal(torch, alone[k][0], whole[k][b])
                            for k in whole if whole[k] is not None)
            self.check(same, f"{label} aux={int(aux)}: a cell alone differs "
                       f"from its row of the batch")
            held &= same
        log(f"   {label:32s} B={B}: {'each cell' if cells is None else cells}"
            f" alone bit-equal to its row (aux 0 and 1): {held}")

    def launch_config(self, label, args, kw):
        """The block, cluster and layout the wrapper picks at these
        shapes."""
        from repro_torch.kernels import fabric_step as fs
        B, F, H = args[0].shape
        cfg = fs.launch_config(B, F, H, args[4].shape[1], kw["n_src"],
                               kw["n_sw"])
        self.report.setdefault("launch_config", {})[label] = {
            "threads": cfg.threads, "cluster": cfg.cluster,
            "smem_bytes": cfg.smem, "grid": cfg.grid,
            "layout": "wide" if cfg.workspace else "shared",
            "workspace_rows": list(cfg.workspace),
            "workspace_bytes_a_block": cfg.ws_bytes}
        return cfg

    def kernel_vs_plain(self):
        from repro_torch.kernels import fabric_step as fs
        self.shapes = {}
        for i, (label, system, n, victim, aggr) in enumerate(SLICE_SHAPES):
            case, geom, p = self.grid_case(system, n, victim, aggr)
            args, kw = self.core_inputs(geom, p, seed=100 + i)
            B, F, H = args[0].shape
            self.shapes[label] = (args, kw)
            cfg = self.launch_config(label, args, kw)
            log(f"   {label}: B={B} F={F} H={H} L={geom.L} "
                f"n_sw={geom.n_sw} n_src={geom.n_src}; {cfg.threads} "
                f"threads, cluster {cfg.cluster}, {cfg.smem} B shared")
            for aux in (False, True):
                err = self.compare(label, args, kw, aux)
                if label == MAIN_SHAPE and not aux:
                    self.main_err = err
            self.batch_invariance(label, args, kw)
        for i, (label, system, n, victim, aggr) in enumerate(WIDE_SHAPES):
            case, geom, p = self.grid_case(system, n, victim, aggr)
            args, kw = self.core_inputs(geom, p, seed=150 + i)
            B, F, H = args[0].shape
            self.shapes[label] = (args, kw)
            cfg = self.launch_config(label, args, kw)
            log(f"   {label}: B={B} F={F} H={H} L={geom.L} "
                f"n_sw={geom.n_sw} n_src={geom.n_src}; {cfg.threads} "
                f"threads, cluster {cfg.cluster}, {cfg.smem} B shared, "
                f"wide layout: {len(cfg.workspace)} rows "
                f"({', '.join(cfg.workspace)}) in a workspace of "
                f"{cfg.ws_bytes} B a block, {B * cfg.cluster * cfg.ws_bytes} "
                f"B in all")
            self.check(bool(cfg.workspace), f"{label}: not the wide layout")
            for aux in (False, True):
                self.compare(label, args, kw, aux)
            self.batch_invariance(label, args, kw)
        # the wide layout moves rows, not work: where both layouts take a
        # cell, the bits are the shared layout's
        for label in ("leonardo/64/incast", "cresco8/256/alltoall"):
            args, kw = self.shapes[label]
            for aux in (False, True):
                shared = fs.fabric_step_core(*args, with_aux=aux, **kw)
                wide = fs.fabric_step_core(*args, with_aux=aux, wide=True,
                                           **kw)
                same = all(bits_equal(self.torch, wide[k], shared[k])
                           for k in shared if shared[k] is not None)
                self.check(same, f"{label} aux={int(aux)}: the wide layout "
                           f"differs from the shared one")
                log(f"   {label:32s} aux={int(aux)} wide layout bit-equal "
                    f"to shared: {same}")
        for i, (label, geom, p, idle) in enumerate(self.path_cases()):
            args, kw = self.core_inputs(geom, p, seed=200 + i, idle=idle)
            B, F, H = args[0].shape
            cfg = self.launch_config(label, args, kw)
            log(f"   {label}: B={B} F={F} H={H} L={geom.L} "
                f"n_sw={geom.n_sw} n_src={geom.n_src}; {cfg.threads} "
                f"threads, cluster {cfg.cluster}")
            for aux in (False, True):
                self.compare(label, args, kw, aux)
            self.batch_invariance(label, args, kw)
        for i, shape in enumerate(RANDOM_SHAPES):
            args, kw = self.random_inputs(shape, seed=i)
            for aux in (False, True):
                self.compare(f"random {shape}", args, kw, aux)
            self.batch_invariance(f"random {shape}", args, kw)
        args, kw = self.disjoint_inputs()
        self.compare("disjoint (bit-exact)", args, kw, True, exact=True)
        self.compare("disjoint, zero-capacity links (bit-exact)",
                     self.zero_capacity(args), kw, True, exact=True)
        args, kw = self.random_inputs(RANDOM_SHAPES[1], seed=9)
        self.compare(f"random {RANDOM_SHAPES[1]}, zero-capacity links",
                     self.zero_capacity(args, n_zero=30, silent=40), kw, True)

    # ------------------------------------------------------------ 3b
    def large_bucket(self):
        """Kernel 1's operands at scale_sweep's 512-node alltoall bucket
        (LARGE_CELLS padded together by bench.scale_grid_inputs), B = 4:
        each cell's steady sub-cell at 32 KiB on its geometry row; and
        each cell's own case."""
        torch = self.torch
        from repro_torch.core import bench, congestion as cong
        from repro_torch.core.fabric import simulator as sim
        cases, _, stacked, p = bench.scale_grid_inputs(
            LARGE_CELLS, "ring_allgather", "alltoall", LARGE_GRID[0],
            (cong.steady(),))
        geom, p = sim.hetero_cells(stacked, p, self.dev)
        # (baseline, steady) a cell: the steady ones
        rows = torch.arange(1, p.dt.shape[0], 2, device=self.dev)
        args, kw = self.core_inputs(geom.take(rows), p.take(rows), seed=400)
        return cases, args, kw

    def kernel1_large(self):
        """Kernel 1 above 16,384 flows a cell: at the 512-node alltoall
        bucket (B = 4) within §13 of plain, REPEATS launches bit-equal,
        each cell alone (the bucket's operands on its own flows and links)
        bit-equal to its row; at PARTS_SHAPE (ten parts, two a block) the
        wide layout bit-equal to the shared one; the pad check with a
        128-node cell in the 65,536-flow bucket; and the four cells through
        bench.run_scale_grid held to jax_reference.json's "scale512"."""
        torch = self.torch
        from repro_torch.core import bench, congestion as cong
        from repro_torch.core.fabric import simulator as sim
        from repro_torch.kernels import fabric_step as fs
        cases, args, kw = self.large_bucket()
        B, F, H = args[0].shape
        L1 = args[4].shape[1]
        cfg = self.launch_config(LARGE_LABEL, args, kw)
        bs = fs.block_shape(F, H, L1, kw["n_src"], kw["n_sw"], cfg.cluster)
        log(f"   {LARGE_LABEL}: B={B} F={F} H={H} L+1={L1} "
            f"n_src={kw['n_src']} n_sw={kw['n_sw']}; {cfg.threads} threads, "
            f"cluster {cfg.cluster}, {bs.parts} parts ({bs.nf} flows, "
            f"{bs.n_items} hop items) a block, {cfg.smem} B shared, "
            f"{len(cfg.workspace)} rows in a workspace of {cfg.ws_bytes} B "
            f"a block")
        self.check(cfg.cluster == 8 and bs.parts == 4 and cfg.workspace,
                   f"{LARGE_LABEL}: cluster {cfg.cluster}, {bs.parts} parts "
                   f"a block, workspace {cfg.workspace}")
        for aux in (False, True):
            err = self.compare(LARGE_LABEL, args, kw, aux)
            if not aux:
                self.large_err = err
        # each cell alone on its own flows and links (the sink moved back
        # past them) against its row of the bucket
        sink = L1 - 1
        for aux in (False, True):
            whole = fs.fabric_step_core(*args, with_aux=aux, **kw)
            same = True
            for b, case in enumerate(cases):
                g = case.geom
                links = torch.cat([torch.arange(g.L, device=self.dev),
                                   torch.tensor([sink], device=self.dev)])
                own = cell_args(args, b)
                plinks = own[0][:, :g.n_flows]
                plinks = torch.where(plinks == sink, g.L, plinks)
                flow_rows = [x[:, :g.n_flows].contiguous()
                             for x in (own[1], own[2], own[3])]
                link_rows = [x[:, links].contiguous()
                             for x in (own[4], own[5], own[6], own[7],
                                       own[8])]
                alone = fs.fabric_step_core(
                    plinks.contiguous(), flow_rows[0], flow_rows[1],
                    flow_rows[2], *link_rows, *own[9:], n_src=g.n_src,
                    n_sw=g.n_sw, with_aux=aux)
                for k, x in alone.items():
                    if x is None:
                        continue
                    row = whole[k][b]
                    want = row[:g.n_flows] if k in ("inject", "achieved") \
                        else row[links]
                    same &= bits_equal(torch, x[0], want)
            self.check(same, f"{LARGE_LABEL} aux={int(aux)}: a cell alone "
                       f"differs from its row of the bucket")
            log(f"   {LARGE_LABEL} aux={int(aux)}: each cell alone "
                f"bit-equal to its row on its flows and links: {same}")
        # a cell of ten parts that both layouts take: the wide layout moves
        # rows, not work
        args_p, kw_p = self.random_inputs(PARTS_SHAPE, seed=7, B=3)
        label = f"random {PARTS_SHAPE}"
        cfg_p = self.launch_config(label, args_p, kw_p)
        F_p, H_p, L_p, n_src_p, n_sw_p = PARTS_SHAPE
        bs_p = fs.block_shape(F_p, H_p, L_p + 1, n_src_p, n_sw_p,
                              cfg_p.cluster)
        log(f"   {label}: cluster {cfg_p.cluster}, {bs_p.parts} parts a "
            f"block, {'wide' if cfg_p.workspace else 'shared'}")
        self.check(bs_p.parts == 2, f"{label}: {bs_p.parts} parts a block")
        for aux in (False, True):
            self.compare(label, args_p, kw_p, aux)
            shared = fs.fabric_step_core(*args_p, with_aux=aux, **kw_p)
            wide = fs.fabric_step_core(*args_p, with_aux=aux, wide=True,
                                       **kw_p)
            same = all(bits_equal(torch, wide[k], shared[k])
                       for k in shared if shared[k] is not None)
            self.check(same and not cfg_p.workspace,
                       f"{label} aux={int(aux)}: the wide layout differs "
                       f"from the shared one")
            log(f"   {label:32s} aux={int(aux)} wide layout bit-equal to "
                f"shared: {same}")
        self.batch_invariance(label, args_p, kw_p)
        args_o, kw_o = self.random_inputs(ONE_PASS_SHAPE, seed=8, B=3)
        label = f"random {ONE_PASS_SHAPE}"
        cfg_o = self.launch_config(label, args_o, kw_o)
        self.check(cfg_o.cluster == 2 and not cfg_o.workspace,
                   f"{label}: cluster {cfg_o.cluster}, {cfg_o.workspace}")
        for aux in (False, True):
            self.compare(label, args_o, kw_o, aux)
        self.batch_invariance(label, args_o, kw_o)
        sizes, n_iters, warmup = LARGE_GRID
        self.pad_check("512-node alltoall bucket", LARGE_PAD_CELLS,
                       "alltoall", sizes, [cong.steady()])
        ref = self.reference()
        rows = []

        def run():
            t0, s0 = time.time(), sim.step_count
            results = bench.run_scale_grid(
                LARGE_CELLS, "ring_allgather", "alltoall", sizes,
                [cong.steady()], n_iters=n_iters, warmup=warmup,
                device=self.dev)
            torch.cuda.synchronize()
            wall, steps = time.time() - t0, sim.step_count - s0
            log(f"   scale512 {LARGE_CELLS}: {steps} steps in {wall:.1f}s")
            for r in results:
                want = next(w for w in ref["scale512"] if (
                    w["system"], w["n_nodes"], w["vector_bytes"],
                    w["profile"]) == (r.system, r.n_nodes, r.vector_bytes,
                                      r.profile))
                rows.append(self.hold(
                    f"scale512 {r.system}/{r.n_nodes}/{r.aggressor} "
                    f"{r.vector_bytes:.0f} {r.profile}", r, want, wall,
                    steps))
            return ("fabric_step_core",)

        counts = self.path("kernel1_large", run)
        self.large_launches = counts["fabric_step_core"]
        self.check(len(rows) == len(LARGE_CELLS),
                   f"scale512: {len(rows)} rows, want {len(LARGE_CELLS)}")
        self.report["kernel1_large"] = rows

    # ------------------------------------------------------------- 4
    def fr_inputs(self, shape, acc_t, x_t, seed, offset=0):
        """Normal values at ``shape`` in the two types, on the card;
        ``offset`` > 0 starts acc that many elements into its storage, so
        the kernel takes its unaligned scalar loop."""
        torch = self.torch
        import numpy as np
        rng = np.random.RandomState(seed)
        n = shape[0] * shape[1]
        a = torch.as_tensor(rng.standard_normal(n + offset) * 8,
                            dtype=torch.float32, device=self.dev)
        x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device=self.dev)
        acc = a.to(getattr(torch, acc_t))[offset:].view(shape)
        return acc, x.to(getattr(torch, x_t)).view(shape)

    def fr_compare(self, label, acc, x, scale):
        """Kernel 2 vs plain on the same card tensors, held bit-equal: both
        round the product, then the sum, then the cast. Returns the max
        abs err."""
        torch = self.torch
        from repro_torch.kernels import fused_reduce as fr, ref
        got = fr.fused_accumulate(acc, x, scale)
        want = ref.fused_accumulate(acc, x, scale)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            self.check(False, f"{label}: dtype/shape {got.dtype} "
                       f"{tuple(got.shape)}, plain {want.dtype} "
                       f"{tuple(want.shape)}")
            return float("inf")
        mabs = float((got.float() - want.float()).abs().max())
        self.check(bool(torch.equal(got, want)),
                   f"{label}: not bit-equal, max abs err {mabs}")
        return mabs

    def fr_vs_plain(self):
        torch = self.torch
        n = 0
        self.fr_main_err = 0.0
        for shape in FIG1_TILES + (EDGE_TILE,):
            for acc_t, x_t in FR_TYPES:
                for scale in FR_SCALES:
                    acc, x = self.fr_inputs(shape, acc_t, x_t, seed=n)
                    err = self.fr_compare(f"{shape} {acc_t}/{x_t} x{scale}",
                                          acc, x, scale)
                    if shape == MAIN_TILE and acc_t == x_t == "float32":
                        self.fr_main_err = max(self.fr_main_err, err)
                    n += 1
        for acc_t, x_t in FR_TYPES:  # unaligned acc: the scalar loop
            acc, x = self.fr_inputs(EDGE_TILE, acc_t, x_t, seed=n, offset=1)
            self.fr_compare(f"{EDGE_TILE} {acc_t}/{x_t} unaligned", acc, x,
                            0.25)
            n += 1
        acc = torch.full((8, 128), 256.0, dtype=torch.bfloat16,
                         device=self.dev)
        one = torch.ones_like(acc)
        self.fr_compare("bf16 256 + 1", acc, one, 1.0)
        log(f"   {n + 1} cases held bit-equal")
        self.report["fused_accumulate_cases"] = n + 1

    # ---------------------------------------------------------------- 5
    def lockstep(self):
        torch = self.torch
        from repro_torch.core.fabric import simulator as sim
        for system, n, aggr in (("leonardo", 64, "incast"),
                                ("cresco8", 256, "alltoall")):
            _, geom, p = self.grid_case(system, n, "ring_allgather", aggr)
            state = sim.init_state(geom, p)
            worst = 0.0
            for i in range(50):
                sk, gk, ak = sim.step_debug(geom, p, state, core="kernel")
                sp, gp, ap = sim.step_debug(geom, p, state, core="plain")
                pairs = [(f"state {k}", sk[k], sp[k]) for k in sp] + \
                    [(f"aux {k}", ak[k], ap[k]) for k in ap] + \
                    [("goodput", gk, gp)]
                for what, got, want in pairs:
                    atol, rtol = leaf_tol(what.split()[-1], p.dt, want.dim())
                    got, want = got.double(), want.double()
                    err = (got - want).abs()
                    excess = err - atol - rtol * want.abs()
                    worst = max(worst, float(excess.max()))
                    self.check(bool((excess <= 0).all()),
                               f"lockstep {system}/{n}/{aggr} step {i} "
                               f"{what}: max abs err {float(err.max())}")
                state = sp
            torch.cuda.synchronize()
            log(f"   {system}/{n}/{aggr}: F={geom.n_flows} 50 steps kernel "
                f"vs plain, worst error less tolerance {worst:.3g} "
                f"(<= 0 passes), it {state['it'][:, 0].tolist()}")

    # ---------------------------------------------------------------- 6
    def main_path(self):
        torch = self.torch
        from repro_torch.core import scenarios
        from repro_torch.core.fabric import simulator as sim
        from repro_torch.kernels import fabric_step as fs, fused_reduce as fr
        ref = self.reference()
        log(f"   reference: jax {ref['jax_version']} "
            f"({ref['jax_backend']}) commit {ref['commit'][:12]}")
        rows = []
        fs.launches = fr.launches = sim.step_count = 0
        t_main = time.time()
        t0, s0 = time.time(), sim.step_count
        got = scenarios.run_fig4_points(
            [(w["mode"], w["vector_bytes"]) for w in ref["fig4_nslb"]],
            device=self.dev)
        torch.cuda.synchronize()
        wall, steps = time.time() - t0, sim.step_count - s0
        log(f"   fig4 quick points (one batch): {steps} steps in "
            f"{wall:.1f}s")
        for want, r in zip(ref["fig4_nslb"], got):
            rows.append(self.hold(f"fig4 {want['mode']} "
                                  f"{want['vector_bytes']:.0f}", r, want,
                                  wall, steps))
        scen = scenarios.get("fig5_steady", True)
        for system, n, aggr in FIG5_GRIDS:
            grid = next(g for g in scen.grids if (g.system, g.n_nodes,
                                                  g.aggressor) == (system, n,
                                                                   aggr))
            t0, s0 = time.time(), sim.step_count
            results = scenarios.run_grid_spec(scen, grid, device=self.dev)
            torch.cuda.synchronize()
            wall, steps = time.time() - t0, sim.step_count - s0
            log(f"   fig5 {system}/{n}/{aggr}: {steps} steps in {wall:.1f}s "
                f"({steps / wall:.0f} steps/s)")
            for r in results:
                want = next(w for w in ref["fig5_steady"] if
                            (w["system"], w["n_nodes"], w["aggressor"],
                             w["vector_bytes"]) == (system, n, aggr,
                                                    r.vector_bytes))
                rows.append(self.hold(f"fig5 {system}/{n}/{aggr} "
                                      f"{r.vector_bytes:.0f}", r, want,
                                      wall, steps))
        self.main_launches = fs.launches
        self.main_steps = sim.step_count
        log(f"   main path: {sim.step_count} engine steps, "
            f"{fs.launches} kernel launches, "
            f"{time.time() - t_main:.1f}s wall")
        self.report.setdefault("paths", {})["main_path"] = {
            "wall_s": time.time() - t_main, "steps": sim.step_count,
            "launches": {"fabric_step_core": fs.launches,
                         "fused_accumulate": fr.launches}}
        self.check(fs.launches == sim.step_count and fs.launches > 0,
                   f"kernel launches {fs.launches} != engine steps "
                   f"{sim.step_count}")
        by = {row["label"]: row["ratio"] for row in rows}
        for label, ratio in by.items():
            if label.startswith("fig4 nslb"):
                self.check(ratio >= 0.9, f"pin: {label} ratio {ratio} < 0.9")
            if label.startswith("fig4 ecmp"):
                self.check(ratio < 0.85,
                           f"pin: {label} ratio {ratio} >= 0.85")
            if label.startswith("fig5 lumi/256"):
                self.check(ratio >= 0.95,
                           f"pin: {label} ratio {ratio} < 0.95")
        lab = f"fig5 leonardo/256/incast {2 << 20}"
        self.check(by.get(lab, 1.0) < 0.2, f"pin: {lab} ratio "
                   f"{by.get(lab)} >= 0.2")
        self.report["main_path"] = rows

    def hold(self, label, r, want, wall, steps):
        import math
        du = r.t_uncongested_s / want["t_uncongested_s"] - 1
        dc = r.t_congested_s / want["t_congested_s"] - 1
        log(f"   {label}: ratio {r.ratio:.4f} (jax {want['ratio']:.4f}) "
            f"n_iters {r.n_iters} (jax {tuple(want['n_iters'])}) "
            f"dt_u {du:+.2e} dt_c {dc:+.2e}")
        self.check(list(r.n_iters) == list(want["n_iters"]),
                   f"{label}: n_iters {r.n_iters} != {want['n_iters']}")
        self.check(math.isfinite(r.ratio) and not r.dnf,
                   f"{label}: ratio {r.ratio}")
        self.check(abs(du) <= TIME_RTOL and abs(dc) <= TIME_RTOL,
                   f"{label}: times off by {du:+.3%} / {dc:+.3%}")
        return {"label": label, "ratio": r.ratio, "jax_ratio": want["ratio"],
                "n_iters": list(r.n_iters),
                "t_uncongested_s": r.t_uncongested_s,
                "t_congested_s": r.t_congested_s, "rel_err_t_u": du,
                "rel_err_t_c": dc, "grid_wall_s": wall,
                "grid_steps": steps}

    # ---------------------------------------------------------------- 7
    def counters(self):
        """{kernel name: its wrapper's launch count}."""
        from repro_torch.kernels import fabric_step as fs, fused_reduce as fr
        from repro_torch.kernels import flash_attention as fa, quant as qt
        from repro_torch.kernels import ssm_scan as ss
        return {"fabric_step_core": fs.launches,
                "fused_accumulate": fr.launches,
                "flash_attention": fa.launches,
                "flash_attention_bwd": fa.bwd_launches,
                "flash_attention_sm90": fa.sm90_launches,
                "flash_attention_bwd_sm90": fa.sm90_bwd_launches,
                "fused_selective_scan": ss.launches,
                "fused_selective_scan_bwd": ss.bwd_launches,
                "ssm_scan": ss.scan_launches,
                "quantize_int8": qt.launches,
                "dequantize_int8": qt.dq_launches}

    def path(self, name, fn):
        """Drive one path with every launch count set to 0 just before it
        and read just after; each kernel of the path must have launched,
        and kernel 1 once per engine step."""
        from repro_torch.core.fabric import simulator as sim
        from repro_torch.kernels import fabric_step as fs, fused_reduce as fr
        from repro_torch.kernels import flash_attention as fa, quant as qt
        from repro_torch.kernels import ssm_scan as ss
        fs.launches = fr.launches = fa.launches = ss.launches = 0
        fa.bwd_launches = ss.scan_launches = qt.launches = qt.dq_launches = 0
        ss.bwd_launches = 0
        fa.sm90_launches = fa.sm90_bwd_launches = 0
        sim.step_count = 0
        t0 = time.time()
        kernels = fn()
        wall = time.time() - t0
        counts = self.counters()
        log(f"   {name}: {sim.step_count} engine steps, launches "
            f"{ {k: v for k, v in counts.items() if v} }, {wall:.1f}s wall")
        self.check(fs.launches == sim.step_count,
                   f"{name}: kernel 1 launches {fs.launches} != engine "
                   f"steps {sim.step_count}")
        for k in kernels:
            self.check(counts[k] > 0, f"{name}: {k} never launched")
        self.report.setdefault("paths", {})[name] = {
            "wall_s": wall, "steps": sim.step_count, "launches": counts}
        return counts

    def reference(self):
        with open(REFERENCE) as f:
            return json.load(f)

    def fig1(self):
        from benchmarks import pt_fig1_breakdown as fig1
        ref = self.reference()["fig1_breakdown"]
        rows = []

        def run():
            got = fig1.run_sizes([w["vector_bytes"] for w in ref],
                                 device=self.dev)
            for want, r in zip(ref, got):
                v = want["vector_bytes"]
                dn = r["t_network_us"] / (want["t_uncongested_s"] * 1e6) - 1
                log(f"   fig1 {v:.0f}: network {r['t_network_us']:.1f} us "
                    f"(jax {want['t_uncongested_s'] * 1e6:.1f}, {dn:+.2e}) "
                    f"n_iters {r['n_iters']}; reduce "
                    f"{r['t_reduce_us']:.1f} us, memcpy "
                    f"{r['t_memcpy_us']:.1f} us, fused "
                    f"{r['t_fused_reduce_us']:.1f} us, compute fraction "
                    f"{r['compute_fraction']:.4f}")
                self.check(list(r["n_iters"]) == want["n_iters"],
                           f"fig1 {v}: n_iters {r['n_iters']} != "
                           f"{want['n_iters']}")
                self.check(abs(dn) <= TIME_RTOL,
                           f"fig1 {v}: network time off by {dn:+.3%}")
                self.check(r["wire_bytes"] == want["wire_bytes"],
                           f"fig1 {v}: wire bytes {r['wire_bytes']} != "
                           f"{want['wire_bytes']}")
                rows.append({**r, "vector_bytes": v, "rel_err_t_network": dn})
            return ("fabric_step_core", "fused_accumulate")

        self.fr_path_launches = self.path("fig1", run)["fused_accumulate"]
        self.report["fig1"] = rows

    def fig3(self):
        from benchmarks import pt_fig3_sawtooth as fig3
        ref = self.reference()["fig3_sawtooth"]
        rows = []

        def run():
            got = fig3.run_points([(w["system"], w["vector_bytes"])
                                   for w in ref], device=self.dev)
            for want, r in zip(ref, got):
                label = f"fig3 {want['system']} {want['vector_bytes']:.0f}"
                dg = r["goodput_gbps"] / want["goodput_gbps"] - 1
                dcv = r["cv"] - want["cv"]
                cv_tol = CV_ATOL + CV_RTOL * abs(want["cv"])
                log(f"   {label}: {r['goodput_gbps']:.2f} Gb/s ({dg:+.2e}) "
                    f"cv {r['cv']:.4g} (jax {want['cv']:.4g}) len "
                    f"{r['trace_len']} (jax {want['trace_len']}) "
                    f"n_iters {r['n_iters']}")
                self.check(r["trace_len"] == want["trace_len"],
                           f"{label}: trace length {r['trace_len']} != "
                           f"{want['trace_len']}")
                self.check(abs(dg) <= TIME_RTOL,
                           f"{label}: goodput off by {dg:+.3%}")
                self.check(abs(dcv) <= cv_tol,
                           f"{label}: cv {r['cv']} vs {want['cv']} (limit "
                           f"{cv_tol:.3g})")
                rows.append({**want, **r, "jax_cv": want["cv"], "cv_err": dcv,
                             "jax_goodput_gbps": want["goodput_gbps"]})
            return ("fabric_step_core",)

        self.path("fig3", run)
        for v in sorted({r["vector_bytes"] for r in rows}):
            ce = [r["cv"] for r in rows if r["vector_bytes"] == v
                  and r["system"] == "haicgu_ce8850"]
            others = [r["cv"] for r in rows if r["vector_bytes"] == v
                      and r["system"] != "haicgu_ce8850"]
            self.check(min(ce) > fig3.OBS1_FACTOR * max(others),
                       f"pin Obs. 1 at {v:.0f}: CE8850 cv {ce} <= "
                       f"{fig3.OBS1_FACTOR} x {max(others)}")
        self.report["fig3"] = rows

    def fig6(self):
        from benchmarks import pt_fig6_bursty as fig6
        from repro_torch.core import scenarios
        from repro_torch.core.fabric import simulator as sim
        ref = self.reference()
        rows = []

        def run_grid(scen, grid, wants):
            t0, s0 = time.time(), sim.step_count
            results = scenarios.run_grid_spec(scen, grid, device=self.dev)
            self.torch.cuda.synchronize()
            wall, steps = time.time() - t0, sim.step_count - s0
            log(f"   fig6 {grid.system}/{grid.n_nodes}/{grid.aggressor} "
                f"{grid.sizes}: {steps} steps in {wall:.1f}s")
            for r in results:
                want = next(w for w in wants if (
                    w["system"], w["aggressor"], w["vector_bytes"],
                    w["profile"]) == (grid.system, grid.aggressor,
                                      r.vector_bytes, r.profile))
                row = self.hold(f"fig6 {grid.system}/{grid.n_nodes}/"
                                f"{grid.aggressor} {r.vector_bytes:.0f} "
                                f"{r.profile}", r, want, wall, steps)
                rows.append({**row, "burst_ms": want["burst_ms"],
                             "pause_ms": want["pause_ms"]})

        def run():
            quick = scenarios.get("fig6_bursty", True)
            for grid in quick.grids:
                run_grid(quick, grid, ref["fig6_bursty_quick"])
            system, aggr = "leonardo", "incast"
            full = scenarios.get("fig6_bursty", False)
            grid = fig6.grid_at_size(system, aggr, 2 << 20)
            run_grid(full, grid, ref["fig6_burst_pause"])
            return ("fabric_step_core",)

        self.path("fig6", run)
        steady = next(w["ratio"] for w in ref["fig5_steady"] if (
            w["system"], w["n_nodes"], w["aggressor"], w["vector_bytes"]) ==
            ("leonardo", 64, "incast", 2 << 20))
        grid2 = [r for r in rows if r["label"].startswith(
            f"fig6 leonardo/64/incast {2 << 20}")]
        self.check(len(grid2) == 9, f"burst x pause grid: {len(grid2)} rows")
        for r in grid2:
            if r["burst_ms"] == OBS3_SHORT_BURST_MS:
                self.check(r["ratio"] >= OBS3_SHORT_MIN,
                           f"pin Obs. 3: {r['label']} ratio {r['ratio']} < "
                           f"{OBS3_SHORT_MIN}")
            if r["burst_ms"] == OBS3_LONG_BURST_MS:
                self.check(abs(r["ratio"] / steady - 1) <= TIME_RTOL,
                           f"pin Obs. 3: {r['label']} ratio {r['ratio']} "
                           f"vs steady {steady}")
        self.report["fig6"] = rows

    def fig7_fig8(self):
        """Figs. 7-8 through the scale-batched engine: the quick grid (four
        geometries in one bucket) and the reduced alltoall grid (CRESCO8 at
        128 nodes padded into LUMI's 256-node bucket: kernel 1's wide
        layout) held to JAX, the Fig. 7 pin, and each bucket's padded
        cells bit-equal to themselves run alone."""
        from repro_torch.core import bench, congestion as cong, scenarios
        from repro_torch.core.fabric import simulator as sim
        from repro_torch.kernels import fabric_step as fs
        ref = self.reference()
        rows = []

        def hold_all(label, results, wants, wall, steps):
            for r in results:
                want = next(w for w in wants if (
                    w["system"], w["n_nodes"], w["vector_bytes"],
                    w["profile"]) == (r.system, r.n_nodes, r.vector_bytes,
                                      r.profile))
                rows.append({**self.hold(
                    f"{label} {r.system}/{r.n_nodes}/{r.aggressor} "
                    f"{r.vector_bytes:.0f} {r.profile}", r, want, wall,
                    steps), "system": r.system, "n_nodes": r.n_nodes,
                    "aggressor": r.aggressor})

        def run():
            quick = scenarios.get("fig7_fig8_scale", True)
            for grid in quick.grids:
                t0, s0 = time.time(), sim.step_count
                results = scenarios.run_grid_spec(quick, grid,
                                                  device=self.dev)
                self.torch.cuda.synchronize()
                wall, steps = time.time() - t0, sim.step_count - s0
                log(f"   fig7_fig8 quick {grid.aggressor} {grid.cells}: "
                    f"{steps} steps in {wall:.1f}s")
                hold_all("fig7_fig8", results, ref["fig7_fig8_quick"], wall,
                         steps)
            cells, sizes, bp, n_iters, warmup = FIG8_ALLTOALL
            t0, s0, l0 = time.time(), sim.step_count, fs.launches
            results = bench.run_scale_grid(
                cells, "ring_allgather", "alltoall", sizes,
                [cong.bursty(b, p) for b, p in bp], n_iters=n_iters,
                warmup=warmup, device=self.dev)
            self.torch.cuda.synchronize()
            wall, steps = time.time() - t0, sim.step_count - s0
            log(f"   fig8 alltoall {cells}: {steps} steps, "
                f"{fs.launches - l0} kernel-1 launches in {wall:.1f}s")
            hold_all("fig8", results, ref["fig7_fig8_alltoall"], wall, steps)
            return ("fabric_step_core",)

        counts = self.path("fig7_fig8", run)
        self.fig78_launches = counts["fabric_step_core"]
        worst = {n: min(r["ratio"] for r in rows if r["system"] == "cresco8"
                        and r["n_nodes"] == n and r["aggressor"] == "incast")
                 for n in (64, 128)}
        log(f"   Fig. 7 pin: cresco8 incast worst ratio 64 nodes "
            f"{worst[64]:.4f}, 128 nodes {worst[128]:.4f}")
        self.check(worst[128] > worst[64], f"pin Fig. 7: cresco8 incast "
                   f"worst ratio at 128 nodes {worst[128]} <= at 64 "
                   f"{worst[64]}")
        self.report["fig7_fig8"] = rows
        # padded == alone, in both buckets
        quick = scenarios.get("fig7_fig8_scale", True).grids[0]
        self.pad_check("incast bucket", quick.cells, "incast",
                       quick.sizes, quick.profiles[:1])
        cells, sizes, bp, _, _ = FIG8_ALLTOALL
        self.pad_check("alltoall bucket", cells, "alltoall", sizes,
                       [cong.bursty(b, p) for b, p in bp])

    def pad_check(self, label, cells, aggr, sizes, profiles,
                  victim="ring_allgather"):
        """Each cell of a bucket run padded (run_cells_hetero) gives every
        output bit for bit as it gives run alone (run_cells), with the
        kernel; its real flows' and jobs' slots compared. Profiles with
        faults put the inert table on the other cells, a node-capped one
        arms the intra-node stage, as the grid runners do."""
        import numpy as np
        from repro_torch.core import bench, congestion as cong
        from repro_torch.core.fabric import simulator as sim, systems
        from repro_torch.kernels import fabric_step as fs
        with_ft = cong.needs_fault_table(profiles)
        intra = any(p.node_cap_frac > 0 for p in profiles)
        cases = [bench.build_case(systems.get_system(s), n, victim, aggr,
                                  intra_node=intra) for s, n in cells]
        dims, stacked = bench.bucket_stack([c.geom for c in cases])
        kw = dict(chunk=PAD_CHECK_CHUNK, max_chunks=400, stride=8,
                  device=self.dev)

        def params(case, n_flows=None):
            dts = bench._cell_dts(case, sizes, len(profiles), None,
                                  case.lat())
            sub = [(float(v), p) for v in sizes
                   for p in [cong.no_congestion(), *profiles]]
            return sim.stack_params([case.cell_params(
                v, p, d, n_flows, with_fault_table=with_ft)
                for (v, p), d in zip(sub, dts)])
        t0 = time.time()
        out = sim.run_cells_hetero(
            stacked, sim.stack_params([params(c, dims.n_flows)
                                       for c in cases]),
            PAD_CHECK_ITERS, **kw)
        bucket = fs.launch_config(1, dims.n_flows, dims.max_hops,
                                  dims.n_links + 1, dims.n_src, dims.n_sw)
        for k, case in enumerate(cases):
            alone = sim.run_cells(case.geom, params(case), PAD_CHECK_ITERS,
                                  **kw)
            F, J = case.geom.n_flows, case.geom.n_jobs
            bad = []
            for name, want in alone.items():
                got = out[name][k]
                if name == "fbytes":
                    got = got[:, :F]
                elif name in ("t_done", "it"):
                    got = got[:, :J]
                if got.shape != want.shape or not np.array_equal(
                        got.view(np.uint8), want.view(np.uint8)):
                    bad.append(name)
            g = case.geom
            mine = fs.launch_config(1, F, g.paths.shape[-1], g.L + 1,
                                    g.n_src, g.n_sw)
            log(f"   {label} {cells[k][0]}/{cells[k][1]}: alone cluster "
                f"{mine.cluster} {'wide' if mine.workspace else 'shared'}, "
                f"in the bucket cluster {bucket.cluster} "
                f"{'wide' if bucket.workspace else 'shared'}; it "
                f"{alone['it'][:, 0].tolist()}; bit-equal: {not bad}")
            self.check(not bad, f"{label} {cells[k]}: padded differs from "
                       f"alone in {bad}")
        log(f"   {label}: {time.time() - t0:.1f}s")

    # --------------------------------------------------------------- 7b
    def fault_tables(self, B, seed):
        """B different fault tables, each with a hot link down for good (its
        capacity at FAULT_FLOOR, or below where a switch outage hits it too)
        and, by cell, a degrading edge, a jittering fabric or a switch
        outage, all live at FAULT_T."""
        import numpy as np
        from repro_torch.core import congestion as cong
        out = []
        for b in range(B):
            ev = [cong.outage(0.0, 1.0, 1.0)]
            ev.append(cong.degrade(0.0, 1e-3, 0.7, cong.GROUP_EDGE_UP)
                      if b % 2 else
                      cong.jitter(0.0, 1.0, 0.6, cong.GROUP_FABRIC,
                                  seed=seed + b))
            if b % 3 == 0:
                ev.append(cong.switch_outage(0.0, 1.0, 0.9))
            out.append(cong.fault_table(ev))
        return self.torch.as_tensor(np.stack(out), device=self.dev)

    def fault_core_inputs(self, geom, p, seed):
        """core_inputs with each cell's link capacities scaled by its fault
        table at FAULT_T, as the engine's fault stage scales them."""
        torch = self.torch
        from repro_torch.core import envelopes as env
        B, L1 = p.dt.shape[0], geom.L + 1
        scale = env.fault_scale_at(
            self.fault_tables(B, seed), geom.link_group.view(-1, L1),
            torch.full((B,), FAULT_T, dtype=torch.float32, device=self.dev),
            geom.link_sw_group.view(-1, L1))
        # rows multiply, so a link two events hit may sit below the floor
        floor = (scale <= env.FAULT_FLOOR).any(1)
        self.check(bool(floor.all()), "fault caps: a cell without a link at "
                   "or below FAULT_FLOOR")
        return self.core_inputs(geom, p, seed,
                                caps=(geom.caps_finite * scale).contiguous())

    def fault_kernel_checks(self):
        """Kernel 1 with per-cell fault-scaled capacities against its plain
        version: on the link_fault quick bucket (padded geometries, one row
        a cell; shared layout, and the wide layout forced and held to it)
        and on lumi/256/alltoall (the wide layout)."""
        from repro_torch.core import bench, congestion as cong, scenarios
        from repro_torch.core.fabric import simulator as sim, systems
        from repro_torch.kernels import fabric_step as fs
        grid = scenarios.get("link_fault", True).grids[0]
        cases = [bench.build_case(systems.get_system(s), n, grid.victim,
                                  grid.aggressor) for s, n in grid.cells]
        dims, stacked = bench.bucket_stack([c.geom for c in cases])
        subs = [(float(v), pr) for v in grid.sizes
                for pr in [cong.no_congestion(), *grid.profiles]]
        params, rows = [], []
        for k, case in enumerate(cases):
            dts = bench._cell_dts(case, grid.sizes, len(grid.profiles), None,
                                  case.lat())
            params += [case.cell_params(v, pr, d, dims.n_flows,
                                        with_fault_table=True)
                       for (v, pr), d in zip(subs, dts)]
            rows += [k] * len(subs)
        geom = stacked.to(self.dev).take(self.torch.as_tensor(
            rows, device=self.dev))
        p = sim.stack_params(params).to(self.dev)
        shapes = [("link_fault quick bucket", geom, p)]
        _, g256, p256 = self.grid_case("lumi", 256, "ring_allgather",
                                       "alltoall")
        shapes.append(("lumi/256/alltoall", g256, p256))
        for i, (label, g, pp) in enumerate(shapes):
            args, kw = self.fault_core_inputs(g, pp, seed=400 + i)
            B, F, H = args[0].shape
            cfg = self.launch_config(f"faults {label}", args, kw)
            log(f"   faults {label}: B={B} F={F} H={H} L={g.L} per-cell "
                f"caps {tuple(args[6].shape)}; cluster {cfg.cluster}, "
                f"{'wide' if cfg.workspace else 'shared'} layout")
            for aux in (False, True):
                err = self.compare(f"faults {label}", args, kw, aux)
                self.fault_err = max(getattr(self, "fault_err", 0.0), err)
            self.batch_invariance(f"faults {label}", args, kw)
            if not cfg.workspace:
                for aux in (False, True):
                    shared = fs.fabric_step_core(*args, with_aux=aux, **kw)
                    wide = fs.fabric_step_core(*args, with_aux=aux,
                                               wide=True, **kw)
                    same = all(bits_equal(self.torch, wide[k], shared[k])
                               for k in shared if shared[k] is not None)
                    self.check(same, f"faults {label} aux={int(aux)}: the "
                               f"wide layout differs from the shared one")
                    log(f"   faults {label:24s} aux={int(aux)} wide layout "
                        f"bit-equal to shared: {same}")

    def scenarios(self):
        """The beyond-paper families on the card: kernel 1 with
        fault-scaled per-cell capacities, the inertness gate, each family's
        first quick grid (phased_collectives' first flat/phased pair)
        through scenarios.run_grid_spec held to the JAX rows with the fault
        drivers' pins, and the link_fault and intra_node buckets' padded
        cells bit-equal to themselves alone."""
        import dataclasses
        import math
        from benchmarks import pt_fault_scenarios as pfs
        from repro_torch.core import scenarios
        from repro_torch.core.fabric import simulator as sim
        self.fault_kernel_checks()
        t0 = time.time()
        gate = pfs.inertness_gate(self.dev, n_nodes=INERT_NODES)
        log(f"   inertness (leonardo/{INERT_NODES}, {pfs.GATE_STEPS} steps, "
            f"kernel 1): all-none table {gate['table'] or 'bit-identical'}, "
            f"node_cap inf {gate['intra'] or 'bit-identical'} "
            f"({time.time() - t0:.1f}s)")
        self.check(not any(gate.values()), f"inertness: leaves differ {gate}")
        ref = self.reference()["scenarios_quick"]
        rows, walls = [], {}

        def run():
            for name, idx in FAMILY_GRIDS:
                scen = scenarios.get(name, True)
                t1, s1 = time.time(), sim.step_count
                for gi in idx:
                    cut = FAMILY_CUTS.get(name, ())
                    grid = dataclasses.replace(
                        scen.grids[gi],
                        profiles=tuple(p for p in scen.grids[gi].profiles
                                       if p.label() not in cut),
                        cells=tuple(c for c in scen.grids[gi].cells
                                    if c not in cut))
                    results = scenarios.run_grid_spec(scen, grid,
                                                      device=self.dev)
                    self.torch.cuda.synchronize()
                    wants = [w for w in ref[name] if w["grid"] == gi]
                    for r in results:
                        want = next(w for w in wants if (
                            w["system"], w["n_nodes"], w["vector_bytes"],
                            w["profile"]) == (r.system, r.n_nodes,
                                              r.vector_bytes, r.profile))
                        label = (f"{name} {r.system}/{r.n_nodes}/"
                                 f"{r.victim}/{r.aggressor} {r.profile}")
                        row = self.hold(label, r, want, 0.0, 0)
                        got_j = [(n, k) for n, _, k in r.job_times]
                        want_j = [(n, k) for n, _, k in want["job_times"]]
                        self.check(got_j == want_j, f"{label}: job_times "
                                   f"{got_j} != {want_j}")
                        for (_, t, _), (_, wt, _) in zip(r.job_times,
                                                         want["job_times"]):
                            self.check(abs(t / wt - 1) <= TIME_RTOL,
                                       f"{label}: job time {t} vs {wt}")
                        rows.append({**row, "family": name, "grid": gi,
                                     "profile": r.profile,
                                     "job_times": list(r.job_times)})
                walls[name] = {"wall_s": time.time() - t1,
                               "steps": sim.step_count - s1}
                log(f"   {name}: {walls[name]['steps']} steps in "
                    f"{walls[name]['wall_s']:.1f}s")
            return ("fabric_step_core",)

        counts = self.path("scenarios", run)
        self.scen_launches = counts["fabric_step_core"]
        c = pfs.checks([r for r in rows if r["family"] == "link_fault"],
                       [r for r in rows if r["family"] == "intra_node"])
        log(f"   pins: flap {c['flap']} (< 0.9), degrade {c['optic']} "
            f"(< 0.95), intra-node means {c['intra']}")
        self.check(c["ok_flap"], f"pin: flap ratios {c['flap']} not < 0.9")
        self.check(c["ok_optic"], f"pin: degrade ratios {c['optic']} not "
                   f"< 0.95")
        self.check(c["ok_intra"], f"pin: intra-node means {c['intra']} not "
                   f"monotone")
        self.check(all(math.isfinite(r["ratio"]) for r in rows),
                   "scenarios: a ratio is not finite")
        self.report["scenarios"] = {"rows": rows, "families": walls,
                                    "pins": {k: c[k] for k in (
                                        "flap", "optic", "intra")}}
        for name in ("link_fault", "intra_node"):
            grid = scenarios.get(name, True).grids[0]
            self.pad_check(f"{name} bucket", grid.cells, grid.aggressor,
                           grid.sizes, grid.profiles, victim=grid.victim)

    # --------------------------------------------------------------- 7c
    def fleet_case(self, quick, n_seeds):
        """The fleet replay's bucket on the card, as workload.run_replay
        builds it: the registry's templates (quick or full) padded into one
        bucket, ``n_seeds`` seeds lowered on each, one geometry row a
        (template, seed) cell. Returns (templates, padded, geometry,
        params with one leading cell axis)."""
        import numpy as np
        from benchmarks import pt_fleet_replay as pfr
        from repro_torch.core import scenarios, workload as wl
        from repro_torch.core.fabric import simulator as sim
        points = scenarios.get("fleet_replay", quick).points
        templates = [wl.build_template(s) for s in pfr.specs(points, quick)]
        padded, stacked, p = wl.replay_inputs(templates, np.arange(n_seeds),
                                              self.dev)
        geom, flat = sim.hetero_cells(stacked, p, self.dev)
        return templates, padded, geom, flat

    def fleet_kernel_checks(self):
        """Kernel 1 against its plain version at the fleet buckets' shapes
        (the quick registry point: both quick templates x 8 seeds; the full
        point: both full templates x 256 seeds): per-flow CC kinds in the
        params, idle short slots and pad flows injecting nothing; ten
        launches bit-equal, each cell alone bit-equal to its row. Both
        shapes join the timing phase."""
        for label, quick, n_seeds, seed in (
                ("fleet quick bucket", True, FLEET_QUICK_SEEDS, 500),
                ("fleet full bucket", False, FLEET_FULL_SEEDS, 501)):
            _, _, geom, p = self.fleet_case(quick, n_seeds)
            args, kw = self.core_inputs(geom, p, seed, idle=True)
            kinds = sorted(set(p.kind.reshape(-1).tolist()))
            idle = int((p.bytes_per_iter == 0).sum())
            B, F, H = args[0].shape
            cfg = self.launch_config(label, args, kw)
            log(f"   {label}: B={B} F={F} H={H} L={geom.L} n_src="
                f"{geom.n_src}; per-flow CC kinds {kinds}, {idle} idle "
                f"(flow, cell) slots; {cfg.threads} threads, cluster "
                f"{cfg.cluster}, {'wide' if cfg.workspace else 'shared'} "
                f"layout")
            for aux in (False, True):
                err = self.compare(label, args, kw, aux)
                self.fleet_err = max(getattr(self, "fleet_err", 0.0), err)
            # the full bucket's 512 cells: the first, one inside, the last
            self.batch_invariance(label, args, kw, cells=None if B <= 64
                                  else (0, B // 2 + 1, B - 1))
            self.shapes[label] = (args, kw)
            if not quick:
                self.fleet_full = (geom, p, B)

    def fleet_lowering(self):
        """lower_seeds on the card against the CPU (integer draws bit for
        bit, floats reported) and against JAX's stored lowering of seeds
        0-7 (integers equal, floats within LOWER_REL)."""
        import numpy as np
        from repro_torch.core import workload as wl
        ref = self.reference()["fleet_replay_lowering"]
        templates, *_ = self.fleet_case(True, 1)
        seeds = ref["seeds"]
        for t, want in zip(templates, ref["templates"]):
            tag = f"{t.spec.system}/{t.spec.n_nodes}"
            self.check((want["system"], want["n_nodes"], want["n_flows"],
                        want["short_idx"]) == (t.spec.system, t.spec.n_nodes,
                                               t.n_flows,
                                               t.short_idx.tolist()),
                       f"fleet lowering {tag}: template differs from JAX's")
            gpu = wl.lower_seeds(t, seeds, self.dev)
            cpu = wl.lower_seeds(t, seeds, "cpu")
            g = {k: getattr(gpu, k).cpu().numpy() for k in (
                "kind", "bytes_per_iter", "flow_start", "fct_mask")}
            c = {k: getattr(cpu, k).numpy() for k in g}
            j = {k: np.asarray(want[k]) for k in g}
            short = t.short_idx
            ints = {"kind": g["kind"], "fct_mask": g["fct_mask"],
                    "active": g["bytes_per_iter"][:, short] > 0}
            for k, v in ints.items():
                cv = c[k] if k != "active" else \
                    c["bytes_per_iter"][:, short] > 0
                jv = j[k] if k != "active" else \
                    j["bytes_per_iter"][:, short] > 0
                self.check(np.array_equal(v, cv), f"fleet lowering {tag}: "
                           f"{k} differs between the card and the CPU")
                self.check(np.array_equal(v, jv), f"fleet lowering {tag}: "
                           f"{k} differs from JAX's")
            worst = {}
            for k in ("bytes_per_iter", "flow_start"):
                rel = np.abs(g[k] - j[k]) / np.maximum(np.abs(j[k]), 1e-30)
                worst[k] = float(rel.max())
                self.check(worst[k] <= LOWER_REL, f"fleet lowering {tag}: "
                           f"{k} {worst[k]:.3g} from JAX's")
            same_cpu = {k: bool(np.array_equal(g[k].view(np.int32),
                                               c[k].view(np.int32)))
                        for k in ("bytes_per_iter", "flow_start")}
            log(f"   lowering {tag}, seeds {seeds[0]}-{seeds[-1]}: kinds, "
                f"active slots and fct_mask equal on card, CPU and JAX; "
                f"floats vs JAX max rel {worst}; floats bit-equal to the "
                f"CPU {same_cpu}")

    def device_share(self, geom, p, n_steps=64):
        """(wall ms a step, device busy ms a step) of ``n_steps`` metrics-on
        engine steps of a batch, busy time from torch.profiler."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core.fabric import simulator as sim
        state = sim.init_state(geom, p, metrics=True)
        consts = sim.run_constants(p, geom, True)

        def run(n):
            nonlocal state
            t0 = time.perf_counter()
            for _ in range(n):
                state, _ = sim._step_impl(geom, p, state, False,
                                          consts=consts)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        run(8)
        wall = run(n_steps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(n_steps)
        cuda = torch.autograd.DeviceType.CUDA
        dev = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                                getattr(e, "self_cuda_time_total", 0))
        busy_us = sum(dev(e) for e in prof.key_averages()
                      if getattr(e, "device_type", None) == cuda)
        return 1e3 * wall / n_steps, busy_us / 1e3 / n_steps

    def fleet_replay(self):
        """Fleet replay on the card: kernel 1 at the fleet buckets'
        shapes, the lowering against the CPU and JAX, the quick replay held
        to JAX's summaries with the four sanity gates, metrics on and off
        bit-equal in the engine state, a padded template's streaming
        leaves bit-equal to it alone, the registry's full point once, and
        the StepMonitor demo's pins; kernel 1 launched once a step. Kernel
        1 at the fleet buckets' shapes is ``fleet_kernel``'s, and the
        device's share of the full point's step ``fleet_share``'s: those
        run in the main process."""
        import numpy as np
        from benchmarks import pt_fault_scenarios as pfs
        from benchmarks import pt_fleet_replay as pfr
        from repro_torch.core import workload as wl
        from repro_torch.core.fabric import simulator as sim
        self.fleet_lowering()
        want = self.reference()["fleet_replay_quick"]
        rep = self.report.setdefault("fleet_replay", {})

        def replay(templates, n_seeds, chunk, metrics=True):
            t0, s0 = time.time(), sim.step_count
            out, padded = wl.run_replay(templates, np.arange(n_seeds),
                                        chunk=chunk, metrics=metrics,
                                        device=self.dev)
            return out, padded, time.time() - t0, sim.step_count - s0

        def run():
            # the quick registry point, held to JAX
            templates = [wl.build_template(s) for s in pfr.specs(
                [p for p in self.fleet_points(True)], True)]
            out, padded, wall, steps = replay(templates, want["n_seeds"],
                                              want["chunk"])
            summ = wl.summarize_replay(out, padded)
            bad = pfr.compare_summaries(summ, want["systems"])
            fails = pfr.sanity(out, padded, np.arange(want["n_seeds"]),
                               summ, self.dev)
            for s in summ:
                log(f"   quick {s['system']}/{s['n_nodes']}: qdelay p50 "
                    f"{s['qdelay_s']['0.5']:.3g} p99 "
                    f"{s['qdelay_s']['0.99']:.3g}, fct p99 "
                    f"{s['fct_s']['0.99']:.3g} ({s['fct_samples']:.0f} "
                    f"completions, {s['qdelay_samples']:.0f} qdelay samples)")
            log(f"   quick replay ({want['n_seeds']} seeds x "
                f"{len(templates)} templates, {steps} steps, {wall:.1f}s): "
                f"vs JAX {bad or 'equal counts, percentiles within a bin, '
                'slowdowns within 1e-3'}; sanity {fails or 'ok'}")
            self.check(not bad, f"fleet quick replay vs JAX: {bad}")
            self.check(not fails, f"fleet quick replay sanity: {fails}")
            rep["quick"] = {"systems": summ, "wall_s": wall, "steps": steps,
                            "jax_disagreements": bad, "sanity": fails}
            # metrics on vs off, and padded vs alone, at a cut horizon
            cut = [wl.build_template(dataclasses.replace(
                t.spec, horizon_s=FLEET_CUT_HORIZON)) for t in templates]
            on, _, _, _ = replay(cut, FLEET_CUT_SEEDS, FLEET_CUT_CHUNK)
            off, _, _, _ = replay(cut, FLEET_CUT_SEEDS, FLEET_CUT_CHUNK,
                                  metrics=False)
            same = [k for k in ("fbytes", "t", "it", "t_done", "qd_acc",
                                "chunks")
                    if not np.array_equal(np.ascontiguousarray(on[k]).view(
                        np.uint8), np.ascontiguousarray(off[k]).view(
                        np.uint8))]
            self.check(not same, f"fleet metrics on vs off differ in {same}")
            padded_bad = []
            for k, t in enumerate(cut):
                alone, _, _, _ = replay([t], FLEET_CUT_SEEDS,
                                        FLEET_CUT_CHUNK)
                F, J = t.n_flows, t.n_jobs
                for name in ("h_qd", "h_fct", "t", "it", "fbytes", "wn",
                             "wmean", "wm2"):
                    a, b = alone[name][0], on[name][k]
                    if name == "fbytes":
                        b = b[:, :F]
                    elif name in ("wn", "wmean", "wm2", "it"):
                        b = b[:, :J]
                    if not np.array_equal(np.ascontiguousarray(a).view(
                            np.uint8), np.ascontiguousarray(b).view(np.uint8)):
                        padded_bad.append(f"{t.spec.system}:{name}")
            self.check(not padded_bad, f"fleet padded template differs from "
                       f"itself alone in {padded_bad}")
            self.check(float(on["h_fct"].sum()) > 0,
                       "fleet cut replay: no FCT samples to compare")
            log(f"   horizon {FLEET_CUT_HORIZON * 1e3:g} ms, "
                f"{FLEET_CUT_SEEDS} seeds: metrics on vs off bit-equal in "
                f"the engine state: {not same}; each padded template's "
                f"streaming leaves bit-equal to it alone: {not padded_bad}")
            # the registry's full point, once
            full = [wl.build_template(s) for s in pfr.specs(
                self.fleet_points(False), False)]
            n_full = int(self.fleet_points(False)[0][2])
            out, padded, wall, steps = replay(full, n_full, 2048)
            summ = wl.summarize_replay(out, padded)
            fails = pfr.sanity(out, padded, np.arange(n_full), summ,
                               self.dev)
            self.check(not fails, f"fleet full point sanity: {fails}")
            cells = n_full * len(full)
            sim_s = float(np.asarray(out["t"]).sum())
            row = {"n_seeds": n_full, "cells": cells, "steps": steps,
                   "wall_s": wall, "seeds_per_sec": cells / wall,
                   "sim_s_per_wall_s": sim_s / wall,
                   "beside": list(CONCURRENT),
                   "systems": summ, "sanity": fails}
            rep["full"] = row
            log(f"   full point ({n_full} seeds x {len(full)} templates, "
                f"{cells} cells of {padded[0].n_flows} flows): {steps} steps "
                f"in {wall:.1f}s, {row['seeds_per_sec']:.2f} seeds/s, "
                f"{row['sim_s_per_wall_s']:.4g} sim-s/wall-s (run beside "
                f"the other phases of CONCURRENT); sanity {fails or 'ok'}")
            for s in summ:
                log(f"   full {s['system']}/{s['n_nodes']}: qdelay p50 "
                    f"{s['qdelay_s']['0.5']:.3g} p99 "
                    f"{s['qdelay_s']['0.99']:.3g}, fct p99 "
                    f"{s['fct_s']['0.99']:.3g}")
            mon = pfs.monitor_demo(self.dev)
            self.check(mon["ok"], f"monitor demo pins: {mon}")
            rep["monitor"] = mon
            return ("fabric_step_core",)

        counts = self.path("fleet_replay", run)
        self.fleet_launches = counts["fabric_step_core"]

    def fleet_share(self):
        """The device's share of a step's wall at the fleet full point's
        bucket: a 64-step metrics-on sample, taken while no other phase
        runs."""
        geom, p, B = self.fleet_full
        wall_ms, busy_ms = self.device_share(geom, p)
        row = self.report.setdefault("fleet_replay", {}).setdefault(
            "full", {})
        row.update(sample_wall_ms_per_step=wall_ms,
                   sample_device_busy_ms_per_step=busy_ms,
                   device_share=busy_ms / wall_ms)
        log(f"   fleet full bucket ({B} cells), a "
            f"64-step sample: {wall_ms:.3f} ms wall, {busy_ms:.4f} ms device "
            f"busy a step, device share {busy_ms / wall_ms:.3f}")

    def fleet_points(self, quick):
        from repro_torch.core import scenarios
        return scenarios.get("fleet_replay", quick).points

    # --------------------------------------------------------------- 7d
    def mitigation(self):
        """The mitigation lab on the card: the quick lab's three claims at
        their limits and its candidates' worst-cell ratios within 2% of
        JAX's, the fault panel's per-fabric winners equal to JAX's, the
        agents' convergence gate, kernel 1 launched once a step; then the
        gradient tier for 2 Adam steps on the card with the step core's
        plain version, its history held to the CPU's."""
        import numpy as np
        from benchmarks import pt_fault_scenarios as pfs
        from benchmarks import pt_mitigation_lab as pml
        from repro_torch.core.mitigation import search
        rep = self.report.setdefault("mitigation", {})

        def run():
            lab = pml.lab(True, self.dev)
            c = lab["claims"]
            for k in ("ok_fig4", "ok_cc", "ok_saw"):
                self.check(c[k], f"mitigation claim {k}: {c}")
            agree = pml.jax_agreement(lab["scores"], lab["winner"],
                                      lab["front"])
            log(f"   quick lab vs JAX: {agree}")
            self.check(agree["ok"], f"mitigation quick lab vs JAX: {agree}")
            rep["lab"] = {"claims": c, "jax": agree, "winner": lab["winner"],
                          "frontier": lab["front"], "wall_s": lab["wall_s"],
                          "steps": lab["steps"],
                          "ratio_min": {s.candidate: s.ratio_min
                                        for s in lab["scores"]}}
            panel = pfs.fault_panel(True, self.dev)
            self.check(panel["ok"], f"fault panel: {panel}")
            rep["fault_panel"] = panel
            conv = pml.run_convergence(self.dev)
            self.check(conv["ok"], f"agents' convergence gate: {conv}")
            rep["agents"] = conv
            return ("fabric_step_core",)

        counts = self.path("mitigation", run)
        self.mitigation_launches = counts["fabric_step_core"]
        # the gradient tier: plain step core on the card (kernel 1 has no
        # gradient), against the same descent on the CPU
        t0 = time.time()
        geom, params = pml.grad_case()
        card = search.gradient_refine(geom, params, GRAD_KNOBS, steps=2,
                                      n_steps=GRAD_STEPS, device=self.dev)
        wall = time.time() - t0
        cpu = search.gradient_refine(geom, params, GRAD_KNOBS, steps=2,
                                     n_steps=GRAD_STEPS, device="cpu")
        rel = float(np.max(np.abs(np.subtract(card["history"],
                                              cpu["history"]))
                           / np.abs(cpu["history"])))
        log(f"   gradient tier, a plain-core run (core='plain', kernel 1 has "
            f"no gradient) on the card: history {card['history']}, CPU "
            f"{cpu['history']}, max rel {rel:.3g} (limit {GRAD_HIST_REL}); "
            f"knobs {card['knobs']} ({wall:.1f}s)")
        self.check(rel <= GRAD_HIST_REL, f"gradient tier: card history "
                   f"{rel:.3g} from the CPU's")
        self.check(card["history"][1] < card["history"][0],
                   "gradient tier: no descent")
        rep["gradient"] = {"core": "plain", "card": card, "cpu": cpu,
                           "max_rel": rel, "wall_s": wall}

    # --------------------------------------------------------------- 7e
    def whatif(self):
        """The what-if service on the card: kernel 1 at the first coalesced
        wave's inputs (built as the server builds them,
        search.candidate_rows_inputs) against its plain version, ten
        launches and each cell alone bit-equal; then ``pt_whatif.py``'s
        full demo, coalesced and then serial, the tables bit-identical,
        coalescing cheaper, and every query held to JAX's full rows; one
        kernel-1 launch a step."""
        from benchmarks import pt_whatif as pw
        from repro_torch.core.fabric import simulator as sim
        rep = self.report.setdefault("whatif", {})
        label = "whatif first wave"
        stacked, p = pw.first_wave_inputs(False)
        geom, p = sim.hetero_cells(stacked, p, self.dev)
        args, kw = self.core_inputs(geom, p, 700, idle=True)
        B, F, H = args[0].shape
        cfg = self.launch_config(label, args, kw)
        log(f"   {label}: B={B} F={F} H={H} L={geom.L} n_src={geom.n_src}; "
            f"{cfg.threads} threads, cluster {cfg.cluster}, "
            f"{'wide' if cfg.workspace else 'shared'} layout")
        for aux in (False, True):
            err = self.compare(label, args, kw, aux)
            self.whatif_err = max(getattr(self, "whatif_err", 0.0), err)
        self.batch_invariance(label, args, kw)

        def run():
            out = pw.run(False, self.dev)
            pw.report(out)
            agree = pw.jax_agreement(out, False)
            log(f"   full demo vs JAX: {agree}")
            for what in pw.failures(out, agree):
                self.check(False, f"whatif: {what}")
            rep.update({k: v for k, v in out.items() if k != "queries"})
            rep["queries"] = [{k: v for k, v in q.items() if k != "table"}
                              for q in out["queries"]]
            rep["jax"] = agree
            return ("fabric_step_core",)

        counts = self.path("whatif", run)
        self.whatif_launches = counts["fabric_step_core"]

    # --------------------------------------------------------------- 7f
    def sweep(self):
        """The sharded sweep launcher on the card: the measured workload
        (``sweep._workload``, not tiny) once on one device and twice in two
        shards on ``cuda:0`` (the scale grid split on its cells, the panel
        on its lanes), digest-equal all three, the single run's rows held
        to JAX's (``sweep_quick``); one kernel-1 launch a step. Meanwhile
        the launcher's own tiny smoke (fresh processes, the cold one on an
        empty build directory) with its build-cache checks present and
        true."""
        from repro_torch.launch import sweep as sw
        from repro_torch.launch.mesh import make_sweep_mesh
        rep = self.report.setdefault("sweep", {})
        want = self.reference()["sweep_quick"]

        def run():
            single = sw.run_workload(None, tiny=False, device=self.dev)
            mesh = make_sweep_mesh(2, device="cuda:0")
            sharded = sw.run_workload(mesh, tiny=False)
            rerun = sw.run_workload(mesh, tiny=False)
            for k in ("digest_scale", "digest_panel"):
                same = single[k] == sharded[k] == rerun[k]
                self.check(same, f"sweep: {k} single {single[k][:12]} "
                           f"sharded {sharded[k][:12]} rerun "
                           f"{rerun[k][:12]}")
            worst = 0.0
            for g, w in zip(single["results_scale"], want["results_scale"]):
                self.check(list(g["n_iters"]) == list(w["n_iters"]),
                           f"sweep: {g['system']}/{g['n_nodes']} n_iters "
                           f"{g['n_iters']} != {w['n_iters']}")
                for f in ("t_uncongested_s", "t_congested_s"):
                    worst = max(worst, abs(g[f] / w[f] - 1))
            for g, w in zip(single["runs_panel"], want["runs_panel"]):
                for f in ("t_uncongested_s", "t_congested_s"):
                    worst = max(worst, abs(g[f] / w[f] - 1))
            self.check(len(single["results_scale"])
                       == len(want["results_scale"]) and len(
                           single["runs_panel"]) == len(want["runs_panel"])
                       and worst <= TIME_RTOL,
                       f"sweep: rows vs JAX's, worst time {worst:.3g}")
            for name, r in (("single", single), ("two shards", sharded),
                            ("rerun", rerun)):
                log(f"   sweep {name}: {r['steps']} steps, "
                    f"{r['kernel1_launches']} kernel-1 launches, "
                    f"{r['wall_s']:.1f}s; digests {r['digest_scale'][:12]} "
                    f"{r['digest_panel'][:12]}")
            log(f"   sweep rows vs JAX: worst time rel {worst:.3g}")
            rep["workload"] = {
                name: {k: r[k] for k in r
                       if k not in ("results_scale", "runs_panel")}
                for name, r in (("single", single), ("sharded", sharded),
                                ("rerun", rerun))}
            rep["jax_worst_time_rel"] = worst
            return ("fabric_step_core",)

        # the smoke's children are processes of their own (their launches
        # are theirs): they run while this process drives the workload
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.time()
        with ThreadPoolExecutor(1) as pool:
            pending = pool.submit(sw.run_smoke, 2, tiny=True, device="cuda")
            counts = self.path("sweep", run)
            smoke = pending.result()
        self.sweep_launches = counts["fabric_step_core"]
        rep["smoke"] = smoke
        rep["smoke_wall_s"] = time.time() - t0
        log(f"   sweep smoke --tiny ({time.time() - t0:.1f}s from the phase's "
            f"start, beside the workload): checks "
            f"{smoke['checks']}; builds cold {smoke['sharded_cold']['builds']}"
            f" in {smoke['sharded_cold']['build_s']}s, warm "
            f"{smoke['sharded_warm']['builds']} (found "
            f"{smoke['sharded_warm']['build_hits']}) in "
            f"{smoke['sharded_warm']['build_s']}s")
        for k in ("cache_populated", "cache_hit_on_relaunch",
                  "cache_cuts_compile"):
            self.check(smoke["checks"].get(k) is True,
                       f"sweep smoke: {k} {smoke['checks'].get(k)}")
        self.check(smoke["ok"], f"sweep smoke: {smoke['checks']}")

    # ---------------------------------------------------------------- 8
    def graphed(self, fn):
        """One call of fn captured as a CUDA graph, so a replay costs the
        host a few microseconds whatever fn's Python overhead."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        return g.replay

    def med_ms(self, fn, n=60, graph=True):
        """Median device time of one call between CUDA events, over n
        graph replays enqueued while the card sleeps, so no event pair
        spans host launch overhead. A failed capture fails the phase.
        ``graph=False`` enqueues the eager calls instead (for a backward
        through autograd, whose engine launches on the forward's stream
        and so outside a capture)."""
        import numpy as np
        torch = self.torch
        run = self.graphed(fn) if graph else fn
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        host_s = (time.perf_counter() - t0) / 5
        torch.cuda._sleep(int(2e9 * host_s * n * 4) + 20_000_000)
        pairs = []
        for _ in range(n):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            run()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        times = [s.elapsed_time(e) for s, e in pairs]
        span = pairs[0][0].elapsed_time(pairs[-1][1])
        return float(np.median(times)), span / n

    def timing(self):
        torch = self.torch
        from repro_torch.kernels import fabric_step as fs, ref
        self.timings = {}
        # kernel 1 above 16,384 flows: the 512-node alltoall bucket, built
        # here (kernel1_large ran in a process of its own)
        _, args, kw = self.large_bucket()
        self.launch_config(LARGE_LABEL, args, kw)
        self.shapes[LARGE_LABEL] = (args, kw)
        log(f"   {'shape':26s} {'kernel ms':>10s} {'was ms':>8s} "
            f"{'redesign':>8s} {'plain ms':>10s} {'bound ms':>10s}  bound by  "
            f"threads x cluster, layout  (mean of the event span)")
        for label, (args, kw) in self.shapes.items():
            k, k_span = self.med_ms(
                lambda: fs.fabric_step_core(*args, **kw))
            pl, pl_span = self.med_ms(
                lambda: ref.fabric_step_core(*args, **kw))
            bound, by = bound_ms(args, kw)
            cfg = self.report["launch_config"][label]
            was, c42 = EARLIER_MS.get(label), REDESIGN_MS.get(label)
            self.timings[label] = {
                "ms": k, "plain_ms": pl, "bound_ms": bound, "bound_by": by,
                "span_ms": k_span, "plain_span_ms": pl_span,
                "earlier_ms": was, "redesign_ms": c42,
                "vs_redesign": k / c42 - 1 if c42 else None,
                "threads": cfg["threads"], "cluster": cfg["cluster"],
                "layout": cfg["layout"]}
            log(f"   {label:26s} {k:10.4f} {was or float('nan'):8.4f} "
                f"{c42 or float('nan'):8.4f} {pl:10.4f} {bound:10.6f}  {by}  "
                f"{cfg['threads']} x {cfg['cluster']}, {cfg['layout']}  "
                f"({k_span:.4f} / {pl_span:.4f})"
                + (f"  {k / c42 - 1:+.1%} vs the redesign" if c42 else ""))
        self.report["timing"] = self.timings

        from repro_torch.kernels import fused_reduce as fr
        self.fr_timings = {}
        log(f"   {'fused_accumulate f32':26s} {'kernel ms':>10s} "
            f"{'plain ms':>10s} {'add ms':>10s} {'bound ms':>10s}")
        for shape in FIG1_TILES:
            acc, x = self.fr_inputs(shape, "float32", "float32", seed=1)
            k, k_span = self.med_ms(
                lambda: fr.fused_accumulate(acc, x, 1.0))
            pl, pl_span = self.med_ms(
                lambda: ref.fused_accumulate(acc, x, 1.0))
            lib, lib_span = self.med_ms(
                lambda: torch.add(acc, x, alpha=1.0))
            bound, by = fr_bound_ms(acc, x)
            self.fr_timings[str(shape)] = {
                "ms": k, "plain_ms": pl, "library_ms": lib,
                "bound_ms": bound, "bound_by": by, "span_ms": k_span,
                "plain_span_ms": pl_span, "library_span_ms": lib_span}
            log(f"   {str(shape):26s} {k:10.4f} {pl:10.4f} {lib:10.4f} "
                f"{bound:10.6f}  {by}  ({k_span:.4f} / {pl_span:.4f} / "
                f"{lib_span:.4f})")
        self.report["timing_fused_accumulate"] = self.fr_timings
        # kernel 2 against torch.add at the main tile: the two graphs'
        # replays alternate, so both see the same clocks and neighbours
        acc, x = self.fr_inputs(MAIN_TILE, "float32", "float32", seed=1)
        ab = self.alternate_ms(lambda: fr.fused_accumulate(acc, x, 1.0),
                               lambda: torch.add(acc, x, alpha=1.0))
        self.fr_timings["alternating"] = ab
        log(f"   {str(MAIN_TILE)} alternating replays x {ab['n']}: kernel "
            f"median {ab['a_ms']:.5f} ms (quartiles {ab['a_q1']:.5f}-"
            f"{ab['a_q3']:.5f}), torch.add {ab['b_ms']:.5f} ms "
            f"({ab['b_q1']:.5f}-{ab['b_q3']:.5f}); kernel slower beyond "
            f"the spread: {ab['a_q1'] > ab['b_q3']}")

    def alternate_ms(self, fa, fb, n=400):
        """Device ms of one call of fa and of fb, their graph replays
        alternating a, b, b, a, ... between CUDA events while the card is
        held busy; the medians and quartiles of each."""
        import numpy as np
        torch = self.torch
        ra, rb = self.graphed(fa), self.graphed(fb)
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        ev = {"a": [], "b": []}
        for i in range(n):
            order = (("a", ra), ("b", rb)) if i % 2 == 0 else \
                (("b", rb), ("a", ra))
            for key, run in order:
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                run()
                e.record()
                ev[key].append((s, e))
        torch.cuda.synchronize()
        out = {"n": n}
        for key, pairs in ev.items():
            t = np.array([s.elapsed_time(e) for s, e in pairs])
            out[f"{key}_ms"] = float(np.median(t))
            out[f"{key}_q1"] = float(np.percentile(t, 25))
            out[f"{key}_q3"] = float(np.percentile(t, 75))
        return out

    def engine_graph(self, n_steps=256):
        """A diagnostic for capturing the engine's step loop: n_steps engine
        steps of the leonardo/256/incast grid captured as one CUDA graph,
        whose replay must be bit-equal to the same steps run eagerly (every
        kernel of the step, kernel 1 included, is deterministic); prints the
        wall ms a step of both."""
        torch = self.torch
        from repro_torch.core.fabric import simulator as sim
        _, geom, p = self.grid_case("leonardo", 256, "ring_allgather",
                                    "incast")
        consts = sim.run_constants(p)

        def steps(state, n):
            for _ in range(n):
                state, _ = sim._step_impl(geom, p, state, False,
                                          consts=consts)
            return state

        def clone(state):
            return {k: v.clone() for k, v in state.items()}

        start = steps(sim.init_state(geom, p), 64)  # queues built up
        torch.cuda.synchronize()
        eager = steps(clone(start), n_steps)
        torch.cuda.synchronize()
        static = clone(start)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            steps(clone(start), 3)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = steps(static, n_steps)
        for k, v in start.items():
            static[k].copy_(v)
        g.replay()
        torch.cuda.synchronize()
        same = all(bits_equal(torch, out[k], eager[k]) for k in eager)
        self.check(same, f"engine_graph: {n_steps} steps replayed as a CUDA "
                   f"graph differ from the same steps run eagerly")
        walls = {}
        for mode in ("eager", "graph", "graph", "eager"):
            state = clone(start)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "graph":
                g.replay()
            else:
                steps(state, n_steps)
            torch.cuda.synchronize()
            walls.setdefault(mode, []).append(
                1e3 * (time.perf_counter() - t0) / n_steps)
        log(f"   leonardo/256/incast, B={p.dt.shape[0]}: {n_steps} steps as "
            f"one CUDA graph bit-equal to eager: {same}; wall ms a step "
            f"eager {walls['eager']}, graph {walls['graph']}")
        self.report["engine_graph"] = {"steps": n_steps, "bit_equal": same,
                                       "eager_ms_per_step": walls["eager"],
                                       "graph_ms_per_step": walls["graph"]}

    # ---------------------------------------------------------------- 9
    def attn_inputs(self, B, S, heads, dtype, seed, Skv=None):
        """Normal q (B, S, H, D), k and v (B, Skv, KH, D) on the card
        (Skv = S by default)."""
        torch = self.torch
        H, KH, D = heads
        g = torch.Generator(device=self.dev).manual_seed(seed)
        return [torch.randn(B, n, h, D, generator=g, device=self.dev)
                .to(dtype) for n, h in ((S, H), (Skv or S, KH),
                                        (Skv or S, KH))]

    def fa_compare(self, label, q, k, v, causal=True, window=0):
        """Kernel 7 vs plain on the same card tensors, without and with the
        row log-sum-exp (the output equal in both calls, the lse within
        FA_LSE_ABS of the plain one, -inf on the same rows); each launch
        must go to its type's source: bfloat16 to the wgmma kernel, float32
        to the float32 one. Returns the max abs error."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa, ref
        n, n90 = fa.launches, fa.sm90_launches
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        got2, lse = fa.flash_attention(q, k, v, causal=causal,
                                       window=window, return_lse=True)
        sm90 = fa.sm90_launches - n90
        routed = fa.launches - n == 2 and sm90 == (
            2 if q.dtype == torch.bfloat16 else 0)
        want, lse_plain = ref.flash_attention(q, k, v, causal=causal,
                                              window=window, return_lse=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if q.dtype == torch.float32:
            ok = bool((err <= FA_F32_ATOL).all())
        else:
            ok = bool((err <= FA_BF16_RTOL * want.float().abs()
                       + FA_F32_ATOL).all())
        ok = ok and got.dtype == q.dtype and bool(torch.isfinite(got).all())
        mabs = float(err.max())
        self.check(ok, f"flash_attention {label}: max abs err {mabs}")
        self.check(routed, f"flash_attention {label}: {q.dtype} launches "
                   f"{fa.launches - n}, {sm90} of them on the wgmma source")
        dead = torch.isinf(lse_plain)
        lse_err = float((lse - lse_plain).abs()[~dead].max()) \
            if bool((~dead).any()) else 0.0
        self.check(torch.equal(got, got2) and torch.equal(dead,
                                                          torch.isinf(lse))
                   and bool((lse[dead] < 0).all()) and lse_err <= FA_LSE_ABS,
                   f"flash_attention {label}: lse {lse_err} from plain, "
                   f"-inf rows differ, or the output moved with lse")
        log(f"   {label:44s} max abs err {mabs:.3g}, lse {lse_err:.3g} "
            f"({int(dead.sum())} -inf), on the wgmma source {sm90 // 2}")
        return mabs

    def fa_vs_plain(self):
        torch = self.torch
        H, KH, D = HYMBA_HEADS
        n = 0
        for S in (128, 1000, 1024, 1280):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = self.attn_inputs(2, S, HYMBA_HEADS, dtype, seed=n)
                self.fa_compare(f"B=2 S={S} {H}/{KH}x{D} {dtype} w="
                                f"{HYMBA_WINDOW}", q, k, v,
                                window=HYMBA_WINDOW)
                n += 1
        q, k, v = self.attn_inputs(SERVE_B, SERVE_S, HYMBA_HEADS,
                                   torch.bfloat16, seed=n)
        self.fa_main_err = self.fa_compare(
            f"serve B={SERVE_B} S={SERVE_S} bfloat16", q, k, v,
            window=HYMBA_WINDOW)
        for label, B, S, heads, causal, window in (
                ("G=1", 2, 300, (4, 4, 64), True, 0),
                ("D=128", 2, 256, (8, 2, 128), True, 0),
                ("non-causal", 2, 300, HYMBA_HEADS, False, 0),
                ("non-causal, window 100", 1, 300, HYMBA_HEADS, False, 100),
                ("serve wave 2", SERVE_B // 2, 256, HYMBA_HEADS, True,
                 HYMBA_WINDOW)):
            for dtype in (torch.float32, torch.bfloat16):
                n += 1
                q, k, v = self.attn_inputs(B, S, heads, dtype, seed=n)
                self.fa_compare(f"{label} B={B} S={S} {heads} {dtype}", q, k,
                                v, causal=causal, window=window)
        self.fa_edge_errs = {}
        for label, B, Sq, Skv, heads, causal, window in FA_EDGES:
            n += 1
            q, k, v = self.attn_inputs(B, Sq, heads, torch.bfloat16, n, Skv)
            self.fa_edge_errs[label] = self.fa_compare(
                f"{label} B={B}", q, k, v, causal=causal, window=window)
            del q, k, v
        # the float32 source at the new head sizes and prefill shapes
        for label, B, Sq, Skv, heads, causal, window in FA_HEAD_EDGES:
            n += 1
            q, k, v = self.attn_inputs(B, Sq, heads, torch.float32, n, Skv)
            self.fa_compare(f"{label} B={B} float32", q, k, v,
                            causal=causal, window=window)
            del q, k, v

    # --------------------------------------------------------------- 10
    def scan_inputs(self, B, T, Di, N, x_dtype, seed):
        """Selective-scan operands on the card: dt = softplus(normal), A =
        -exp(normal), normal B, C, x and h0."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)

        def f(*shape):
            return torch.randn(*shape, generator=g, device=self.dev)

        return (torch.nn.functional.softplus(f(B, T, Di)),
                -torch.exp(f(Di, N)), f(B, T, N), f(B, T, N),
                f(B, T, Di).to(x_dtype), f(B, Di, N))

    def scan_compare(self, label, args):
        torch = self.torch
        from repro_torch.kernels import ref, ssm_scan as ss
        got = ss.fused_selective_scan(*args)
        want = ref.fused_selective_scan(*args)
        torch.cuda.synchronize()
        worst, parts = 0.0, []
        for name, g, w in zip(("y", "h_T"), got, want):
            mabs = float((g - w).abs().max())
            rel = mabs / max(float(w.abs().max()), 1e-30)
            self.check(rel <= SCAN_REL and bool(torch.isfinite(g).all()),
                       f"fused_selective_scan {label}: {name} rel err {rel}")
            worst = max(worst, mabs)
            parts.append(f"{name} {mabs:.3g} ({rel:.2g} of max)")
        log(f"   {label:40s} max abs err {', '.join(parts)}")
        return worst

    def scan_vs_plain(self):
        torch = self.torch
        Di, N = HYMBA_SSM
        n = 0
        for T in (1, 256, 1280):
            for x_dtype in (torch.float32, torch.bfloat16):
                self.scan_compare(f"B=2 T={T} Di={Di} N={N} x {x_dtype}",
                                  self.scan_inputs(2, T, Di, N, x_dtype, n))
                n += 1
        self.scan_main_err = self.scan_compare(
            f"serve B={SERVE_B} T={SERVE_S} x bfloat16",
            self.scan_inputs(SERVE_B, SERVE_S, Di, N, torch.bfloat16, n))
        for label, shape in (("ragged Di", (2, 200, 3000, 16)),
                             ("N=8", (1, 100, 1000, 8))):
            n += 1
            self.scan_compare(f"{label} {shape}",
                              self.scan_inputs(*shape, torch.float32, n))
        n += 1
        self.scan_compare(
            f"serve wave 2 B={SERVE_B // 2} T=256 x bfloat16",
            self.scan_inputs(SERVE_B // 2, 256, Di, N, torch.bfloat16, n))

    # --------------------------------------------------------------- 11
    def lm_vs_jax(self):
        from benchmarks import pt_serve
        from repro_torch.kernels import flash_attention as fa, ssm_scan as ss
        self.rows_vs_jax("lm_vs_jax", LM_REFERENCE, pt_serve.LM_REFERENCE,
                         (fa, ss))

    def rows_vs_jax(self, label, path, r, kernels, pad_cache=False,
                    tol=LM_TOL):
        """The reference config ``r`` at float32 (TF32 off) through the
        kernels, on ``numpy_params``' weights, held to the JAX rows at
        ``path`` by ``hold_lm`` (``kernels``: the modules whose launch
        counts it reads, flash attention first)."""
        torch = self.torch
        from benchmarks import pt_serve
        from repro_torch import convert
        from repro_torch.models.api import build_model
        from repro_torch.models.layers import numpy_params
        # float32 means float32 here: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with open(path) as f:
            ref = json.load(f)
        cfg = pt_serve.reference_config(r)
        log(f"   reference: jax {ref['jax_version']} ({ref['jax_backend']}) "
            f"commit {ref['commit'][:12]}; {cfg.name}, {cfg.n_layers} layers "
            f"float32, heads {cfg.n_heads}/{cfg.n_kv_heads} x "
            f"{cfg.resolved_head_dim}; TF32 off (matmul and cuDNN)")
        model = build_model(cfg, device=self.dev).load_params(
            convert.lm_params_from_jax(
                numpy_params(cfg, ref["config"]["param_seed"]), cfg))
        for m in kernels:
            m.launches = 0
        kernels[0].sm90_launches = 0
        self.report[label] = self.hold_lm(label, model, ref, r,
                                          pad_cache=pad_cache,
                                          launches=kernels, tol=tol)
        del model
        torch.cuda.empty_cache()

    # --------------------------------------------------------------- 12
    def prefill_both(self, model, batch):
        """The model's prefill logits through the kernels and through
        their plain versions."""
        lk, _ = model.prefill(batch)
        model.core = "plain"
        lp, _ = model.prefill(batch)
        model.core = "kernel"
        self.torch.cuda.synchronize()
        return lk, lp

    def held_rel(self, label, lk, lp, limit):
        """Kernel-path logits vs plain-path ones, relative to the largest
        |logit|, held to ``limit``; returns the relative difference."""
        torch = self.torch
        top = float(lp.abs().max())
        rel = float((lk - lp).abs().max()) / top
        log(f"   {label} prefill logits, kernel vs plain: "
            f"{rel:.3g} of the largest |logit| {top:.3g} (limit {limit}); "
            f"greedy equal {bool(torch.equal(lk.argmax(-1), lp.argmax(-1)))}")
        self.check(rel <= limit, f"serve: {label} prefill kernel vs "
                   f"plain {rel} of the largest logit > {limit}")
        return rel

    def serve(self):
        torch = self.torch
        import dataclasses
        from benchmarks import pt_serve
        from repro_torch.configs import get_config
        from repro_torch.models.api import build_model
        cfg = get_config("hymba-1.5b")
        out = {}

        def run():
            server, model = pt_serve.serve(cfg, self.dev)
            torch.cuda.synchronize()
            out.update(server=server, model=model)
            return ("flash_attention", "fused_selective_scan")

        counts = self.path("serve", run)
        server, model = out["server"], out["model"]
        st = server.stats
        want = 2 * cfg.n_layers
        for k in ("flash_attention", "fused_selective_scan",
                  "flash_attention_sm90"):
            self.check(counts[k] == want,
                       f"serve: {k} launched {counts[k]} times, not {want}")
        mix = pt_serve.request_mix(cfg.vocab_size)
        self.check(st.requests_done == len(mix) and st.waves == 2,
                   f"serve: {st.requests_done} requests in {st.waves} waves")
        self.check(st.nonfinite_logits == 0,
                   f"serve: {st.nonfinite_logits} non-finite logits")
        for r, (prompt, n_new, _) in zip(server.done, mix):
            self.check(len(r.tokens) == n_new and r.finish_reason == "length",
                       f"serve: request {r.uid} gave {len(r.tokens)} of "
                       f"{n_new} tokens ({r.finish_reason})")
        # each wave's prefill, kernel vs plain on the same weights: wave 1
        # in bfloat16 as served, then both waves in float32
        waves = [server.done[:pt_serve.MAX_BATCH],
                 server.done[pt_serve.MAX_BATCH:]]
        batches = [server.make_batch_inputs(w, max(len(r.prompt) for r in w))
                   for w in waves]
        wave1 = waves[0]
        lk, lp = self.prefill_both(model, batches[0])
        rel = self.held_rel("wave 1 bfloat16", lk, lp, SERVE_BF16_REL)
        torch.backends.cuda.matmul.allow_tf32 = False
        m32 = build_model(dataclasses.replace(
            cfg, param_dtype="float32", compute_dtype="float32"),
            device=self.dev).load_params(
                {k: v.float() for k, v in model.state_dict().items()})
        rel32 = [self.held_rel(f"wave {i + 1} float32",
                               *self.prefill_both(m32, b), SERVE_F32_REL)
                 for i, b in enumerate(batches)]
        del m32
        # the repeated 256-token prompt (requests 5 and 6)
        a, b = wave1[4], wave1[5]
        same = bool((a.tokens == b.tokens).all())
        rows_equal = bool(torch.equal(lk[4], lk[5]))
        plain_rows_equal = bool(torch.equal(lp[4], lp[5]))
        log(f"   repeated prompt: tokens equal {same}; prefill logits rows "
            f"equal: kernel {rows_equal}, plain {plain_rows_equal}")
        self.check(rows_equal or not plain_rows_equal,
                   "serve: the repeated prompt's prefill rows differ on the "
                   "kernel path but not on the plain one")
        self.check(same or not plain_rows_equal,
                   "serve: the repeated prompt gave different tokens")
        dec_ms = [1e3 * d / max(c, 1) for d, c in zip(st.decode_s,
                                                       st.decode_calls)]
        log(f"   {cfg.name}, {cfg.n_layers} layers bfloat16: "
            f"{st.requests_done} requests, {st.waves} waves, "
            f"{st.decode_steps} decode steps, {st.tokens_generated} tokens, "
            f"{st.tokens_per_s:.1f} tokens/s; prefill ms per wave "
            f"{[round(1e3 * p, 1) for p in st.prefill_s]}; decode ms per "
            f"step {[round(d, 2) for d in dec_ms]}")
        self.serve_launches = counts
        self.report["serve"] = {
            "requests": st.requests_done, "waves": st.waves,
            "decode_steps": st.decode_steps, "tokens": st.tokens_generated,
            "tokens_per_s": st.tokens_per_s, "wall_s": st.wall_s,
            "prefill_ms": [1e3 * p for p in st.prefill_s],
            "decode_ms_per_step": dec_ms, "decode_calls": st.decode_calls,
            "prefill_kernel_vs_plain_rel": rel,
            "prefill_kernel_vs_plain_rel_float32": rel32,
            "repeated_prompt_tokens_equal": same,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del out, server, model
        torch.cuda.empty_cache()

    # --------------------------------------------------------------- 13
    def timing_lm(self):
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa, ref
        from repro_torch.kernels import ssm_scan as ss
        F = torch.nn.functional
        q, k, v = self.attn_inputs(SERVE_B, SERVE_S, HYMBA_HEADS,
                                   torch.bfloat16, seed=1)
        kernel, k_span = self.med_ms(
            lambda: fa.flash_attention(q, k, v, window=HYMBA_WINDOW))
        plain, p_span = self.med_ms(
            lambda: ref.flash_attention(q, k, v, window=HYMBA_WINDOW))
        bound, by = fa_bound_ms(q, k, HYMBA_WINDOW)
        # at S = 1024 the window is inert: the library's causal attention
        # computes the same function
        q1, k1, v1 = (t[:, :HYMBA_WINDOW].contiguous() for t in (q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q1, k1, v1))
        lib, l_span = self.med_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        k1024, _ = self.med_ms(
            lambda: fa.flash_attention(q1, k1, v1, window=HYMBA_WINDOW))
        # achieved TFLOP/s of the function's 4 * D flops a live pair
        f_serve = attn_flops(q, HYMBA_WINDOW, 4)
        f_1024 = attn_flops(q1, HYMBA_WINDOW, 4)
        self.fa_timing = {"ms": kernel, "plain_ms": plain, "bound_ms": bound,
                          "bound_by": by, "library_ms": lib,
                          "ms_at_1024": k1024, "span_ms": k_span,
                          "plain_span_ms": p_span, "library_span_ms": l_span,
                          "tflops": f_serve / kernel / 1e9,
                          "tflops_at_1024": f_1024 / k1024 / 1e9,
                          "library_tflops": f_1024 / lib / 1e9}
        t = self.fa_timing
        log(f"   flash_attention B={SERVE_B} S={SERVE_S} bfloat16: kernel "
            f"{kernel:.4f} ms ({t['tflops']:.1f} TFLOP/s), plain "
            f"{plain:.4f}, bound {bound:.4f} ({by}); at S=1024 kernel "
            f"{k1024:.4f} ({t['tflops_at_1024']:.1f} TFLOP/s), sdpa "
            f"{lib:.4f} ({t['library_tflops']:.1f} TFLOP/s)")
        Di, N = HYMBA_SSM
        args = self.scan_inputs(SERVE_B, SERVE_S, Di, N, torch.bfloat16, 1)
        kernel, k_span = self.med_ms(lambda: ss.fused_selective_scan(*args))
        plain, p_span = self.med_ms(lambda: ref.fused_selective_scan(*args))
        bound, by = scan_bound_ms(args, self.n_sm, self.sm_clock_hz)
        # and at the training shape (B = 4), where each step runs it twice
        # a layer
        t_args = self.scan_inputs(TRAIN_B, TRAIN_S, Di, N, torch.bfloat16, 2)
        k_train, _ = self.med_ms(lambda: ss.fused_selective_scan(*t_args))
        b_train, _ = scan_bound_ms(t_args, self.n_sm, self.sm_clock_hz)
        self.scan_timing = {"ms": kernel, "plain_ms": plain,
                            "bound_ms": bound, "bound_by": by,
                            "library_ms": None, "span_ms": k_span,
                            "plain_span_ms": p_span,
                            "ms_at_train_shape": k_train,
                            "bound_ms_at_train_shape": b_train}
        log(f"   fused_selective_scan B={SERVE_B} T={SERVE_S} Di={Di} N={N}: "
            f"kernel {kernel:.4f} ms, plain {plain:.4f}, bound {bound:.4f} "
            f"({by}); at B={TRAIN_B} kernel {k_train:.4f}, bound "
            f"{b_train:.4f}")
        self.report["timing_lm"] = {"flash_attention": self.fa_timing,
                                    "fused_selective_scan": self.scan_timing}

    # --------------------------------------------------------------- 14
    def quant_inputs(self, shape, seed):
        """Normal values at mixed row scales, an all-zero block, and a
        block whose max is 127 so that x / scale hits exact .5 ties."""
        torch = self.torch
        R, C = shape
        g = torch.Generator(device=self.dev).manual_seed(seed)
        x = torch.randn(R, C, generator=g, device=self.dev)
        x *= 10.0 ** torch.randint(-6, 4, (R, 1), generator=g,
                                   device=self.dev).float()
        x[0, :256] = 0.0
        if R > 1 or C > 256:
            t = x.view(-1)[256:512]
            t.copy_(0.5 * torch.randint(-254, 255, (256,), generator=g,
                                        device=self.dev).float())
            t[0] = 127.0
        return x

    def quant_compare(self, label, x):
        torch = self.torch
        from repro_torch.kernels import quant as qt, ref
        q, s = qt.quantize_int8(x)
        wq, ws = ref.quantize_int8(x)
        back = qt.dequantize_int8(wq, ws)
        wback = ref.dequantize_int8(wq, ws)
        torch.cuda.synchronize()
        ok = (torch.equal(q, wq) and torch.equal(s, ws)
              and torch.equal(back, wback))
        self.check(ok, f"quant {label}: kernels 3/4 not bit-equal to plain")
        log(f"   {label:40s} bit-equal {ok}")
        return 0.0 if ok else float((back - wback).abs().max())

    def quant_vs_plain(self):
        from repro_torch.configs import get_config
        from repro_torch.optim import compression as comp
        cfg = get_config("hymba-1.5b")
        n = 0
        for shape in ((1, 256), (3, 512), (7, 768), (130, 1024),
                      (1000, 256)):
            self.quant_compare(f"{shape}", self.quant_inputs(shape, n))
            n += 1
        # embed.tok's gradient, flattened and padded as compress_leaf does
        numel = cfg.vocab_padded * cfg.d_model
        x = self.quant_inputs((1, numel), n)
        x, _ = comp._pad_to_block(x.reshape(-1), comp.BLOCK)
        self.quant_main_err = self.quant_compare(
            f"embed.tok {cfg.vocab_padded} x {cfg.d_model} flat",
            x.reshape(1, -1))

    # --------------------------------------------------------------- 15
    def state_scan_compare(self, label, B, T, Di, N, seed):
        torch = self.torch
        from repro_torch.kernels import ref, ssm_scan as ss
        g = torch.Generator(device=self.dev).manual_seed(seed)
        dA = torch.rand(B, T, Di, N, generator=g, device=self.dev) * 0.5 + 0.5
        dBx = torch.randn(B, T, Di, N, generator=g, device=self.dev)
        h0 = torch.randn(B, Di, N, generator=g, device=self.dev)
        worst = 0.0
        for reverse in (False, True):
            got = ss.ssm_scan(dA, dBx, h0, reverse=reverse)
            want = ref.ssm_scan(dA, dBx, h0, reverse=reverse)
            torch.cuda.synchronize()
            parts = []
            for name, a, w in zip(("hs", "h_T"), got, want):
                mabs = float((a - w).abs().max())
                rel = mabs / max(float(w.abs().max()), 1e-30)
                self.check(rel <= STATE_SCAN_REL and
                           bool(torch.isfinite(a).all()),
                           f"ssm_scan {label} reverse={reverse}: {name} rel "
                           f"err {rel}")
                worst = max(worst, mabs)
                parts.append(f"{name} {mabs:.3g} bit-equal "
                             f"{bool(torch.equal(a, w))}")
            log(f"   {label:34s} reverse={reverse!s:5s} {', '.join(parts)}")
        return worst

    def ssm_scan_vs_plain(self):
        Di, N = HYMBA_SSM
        self.state_scan_err = self.state_scan_compare(
            f"train B={TRAIN_B} T={TRAIN_S} Di={Di} N={N}", TRAIN_B, TRAIN_S,
            Di, N, 0)
        self.state_scan_compare("ragged Di (2, 200, 3000, 16)", 2, 200, 3000,
                                16, 1)
        self.state_scan_compare("N=8 (1, 100, 1000, 8)", 1, 100, 1000, 8, 2)

    # -------------------------------------------------------------- 15b
    def scan_bwd_inputs(self, shape, x_dtype, seed):
        """The forward's operands (non-zero h0) and non-zero normal dy
        (B, T, Di) and dh_T (B, Di, N) on the card."""
        torch = self.torch
        B, T, Di, N = shape
        g = torch.Generator(device=self.dev).manual_seed(seed + 1000)
        return (*self.scan_inputs(B, T, Di, N, x_dtype, seed),
                torch.randn(B, T, Di, generator=g, device=self.dev),
                torch.randn(B, Di, N, generator=g, device=self.dev))

    def grads_close(self, label, got, want):
        """Each gradient within GRAD_REL of its largest magnitude (a
        bfloat16 one within one bfloat16 step of each value more); the
        largest absolute difference."""
        torch = self.torch
        worst, parts = 0.0, []
        for name, g, w in zip(SCAN_GRADS, got, want):
            g64, w64 = g.double(), w.double()
            diff = (g64 - w64).abs()
            scale = max(float(w64.abs().max()), 1e-30)
            slack = BF16_STEP * w64.abs() if g.dtype == torch.bfloat16 \
                else torch.zeros_like(w64)
            over = float((diff - slack).max()) / scale
            self.check(g.dtype == w.dtype and over <= GRAD_REL
                       and bool(torch.isfinite(g).all()),
                       f"fused_selective_scan_bwd {label}: {name} "
                       f"{over:.3g} of its largest magnitude over the "
                       "limit's slack")
            worst = max(worst, float(diff.max()))
            parts.append(f"{name} {float(diff.max()) / scale:.2g}")
        return worst, ", ".join(parts)

    def scan_bwd_vs_plain(self):
        torch = self.torch
        from repro_torch.kernels import ref, ssm_scan as ss
        self.scan_bwd_main_err = 0.0
        for i, (label, shape, x_name) in enumerate(SCAN_BWD_CASES):
            args = self.scan_bwd_inputs(shape, getattr(torch, x_name), i)
            got = ss.fused_selective_scan_bwd(*args)
            again = ss.fused_selective_scan_bwd(*args)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            self.check(same, f"fused_selective_scan_bwd {label}: two "
                       "launches differ")
            del again
            want = ref.fused_selective_scan_bwd(*args)
            err, text = self.grads_close(f"{label} vs plain", got, want)
            log(f"   {label:18s} {shape} vs plain: {text}; two launches "
                f"bit-equal {same}")
            del want
            torch.cuda.empty_cache()
            leaves = [t.detach().clone().requires_grad_()
                      for t in args[:6]]
            y, h_T = ref.fused_selective_scan(*leaves)
            auto = torch.autograd.grad((y, h_T), leaves, args[6:])
            del y, h_T, leaves
            err2, text = self.grads_close(f"{label} vs autograd", got, auto)
            log(f"   {label:18s} {shape} vs autograd: {text}")
            if label == "train x bfloat16":
                self.scan_bwd_main_err = max(err, err2)
            del got, auto, args
            torch.cuda.empty_cache()

    # --------------------------------------------------------------- 16
    def fa_bwd_compare(self, label, B, Sq, Skv, heads, dtype, causal, window,
                       seed, exact=False):
        """The attention backward vs ref.flash_attention_bwd on the same
        card tensors, and (float32) vs autograd of the plain forward;
        returns the max abs error. ``exact`` (float32): vs the plain
        version evaluated in float64 instead, the float32 plain and
        autograd's own distances from it logged beside."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa, ref
        H, KH, D = heads
        g = torch.Generator(device=self.dev).manual_seed(seed)
        q, k, v, do = (torch.randn(B, S, h, D, generator=g, device=self.dev)
                       .to(dtype) for S, h in ((Sq, H), (Skv, KH), (Skv, KH),
                                               (Sq, H)))
        o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                    return_lse=True)
        nb, n90 = fa.bwd_launches, fa.sm90_bwd_launches
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     window=window)
        bf16 = dtype == torch.bfloat16
        self.check(fa.bwd_launches - nb == 1
                   and fa.sm90_bwd_launches - n90 == int(bf16),
                   f"flash_attention_bwd {label}: {dtype} launch on the "
                   f"wrong source")
        same = None
        if bf16:  # deterministic: a second launch agrees bit for bit
            again = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal, window=window)
            same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
            self.check(same, f"flash_attention_bwd {label}: two launches "
                       f"differ")
        want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       window=window)
        plain_off = None
        if exact:
            want32 = want
            want = ref.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           dtype=torch.float64)
        auto = None
        if dtype == torch.float32:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            ref.flash_attention(*leaves, causal=causal,
                                window=window).backward(do)
            auto = [t.grad for t in leaves]
            if exact:  # float32's own rounding, for the record
                plain_off = max(float((a - w).abs().max()) / max(
                    float(w.abs().max()), 1e-30)
                    for a, w in zip(want32 + tuple(auto), want + want))
                auto = None
        _, lse_plain = ref.flash_attention(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        torch.cuda.synchronize()
        dead = torch.isinf(lse_plain)
        lse_err = float((lse - lse_plain).abs()[~dead].max()) \
            if bool((~dead).any()) else 0.0
        self.check(torch.equal(dead, torch.isinf(lse))
                   and bool((lse[dead] < 0).all())
                   and bool(torch.isfinite(lse[~dead]).all())
                   and lse_err <= FA_LSE_ABS,
                   f"flash_attention_bwd {label}: kernel lse {lse_err} from "
                   f"plain, or -inf rows differ")
        worst, parts = 0.0, [f"lse {lse_err:.3g} ({int(dead.sum())} -inf)"]
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            err = (a.float() - w.float()).abs()
            top = max(float(w.float().abs().max()), 1e-30)
            if dtype == torch.float32:
                ok = float(err.max()) <= FA_BWD_F32_REL * top
            else:
                ok = bool((err <= FA_BF16_RTOL * w.float().abs()
                           + FA_BWD_F32_REL * top).all())
            ok = ok and a.dtype == dtype and bool(torch.isfinite(a).all())
            self.check(ok, f"flash_attention_bwd {label}: {name} max abs "
                       f"err {float(err.max())} (largest {top})")
            worst = max(worst, float(err.max()))
            parts.append(f"{name} {float(err.max()):.3g}")
        if auto is not None:
            rel = max(float((a - w).abs().max()) / max(
                float(w.abs().max()), 1e-30) for a, w in zip(got, auto))
            self.check(rel <= FA_BWD_F32_REL, f"flash_attention_bwd {label}:"
                       f" {rel} from autograd of the plain forward")
            parts.append(f"vs autograd {rel:.3g} of max")
        if same is not None:
            parts.append(f"two launches bit-equal {same}")
        if plain_off is not None:
            parts.append(f"vs float64 (plain and autograd in float32: "
                         f"{plain_off:.3g} of max)")
        log(f"   {label:46s} {', '.join(parts)}")
        return worst

    def fa_bwd_vs_plain(self):
        torch = self.torch
        H, KH, D = HYMBA_HEADS
        n = 0
        for dtype in (torch.float32, torch.bfloat16):
            err = self.fa_bwd_compare(
                f"train B={TRAIN_B} S={TRAIN_S} {H}/{KH}x{D} {dtype} w="
                f"{HYMBA_WINDOW}", TRAIN_B, TRAIN_S, TRAIN_S, HYMBA_HEADS,
                dtype, True, HYMBA_WINDOW, n)
            if dtype == torch.bfloat16:
                self.fa_bwd_main_err = err
            n += 1
        for label, B, Sq, Skv, heads, causal, window in (
                ("S=1000", 2, 1000, 1000, HYMBA_HEADS, True, HYMBA_WINDOW),
                ("G=1 D=128", 2, 300, 300, (4, 4, 128), True, 0),
                ("non-causal w=100, dead rows", 1, 300, 150, HYMBA_HEADS,
                 False, 100)):
            for dtype in (torch.float32, torch.bfloat16):
                n += 1
                self.fa_bwd_compare(f"{label} B={B} {dtype}", B, Sq, Skv,
                                    heads, dtype, causal, window, n)
        self.fa_bwd_edge_errs = {}
        for label, B, Sq, Skv, heads, causal, window in FA_EDGES:
            n += 1
            self.fa_bwd_edge_errs[label] = self.fa_bwd_compare(
                f"{label} B={B} bfloat16", B, Sq, Skv, heads, torch.bfloat16,
                causal, window, n)
        # the float32 source at the new head sizes and prefill shapes, held
        # to the plain version in float64: at granite-20b's prefill a key's
        # sums run over 61,440 rows, where the float32 plain version and
        # autograd are 1.0e-5 and 1.6e-5 of the largest gradient from a
        # Kahan-summed kernel (FA_BWD_F32_REL is 1e-5)
        for label, B, Sq, Skv, heads, causal, window in FA_HEAD_EDGES:
            n += 1
            self.fa_bwd_compare(f"{label} B={B} float32", B, Sq, Skv, heads,
                                torch.float32, causal, window, n, exact=True)

    # --------------------------------------------------------------- 17
    def train_vs_jax(self):
        torch = self.torch
        from benchmarks import pt_train
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with open(TRAIN_REFERENCE) as f:
            ref = json.load(f)
        log(f"   reference: jax {ref['jax_version']} ({ref['jax_backend']}) "
            f"commit {ref['commit'][:12]}; TF32 off (matmul and cuDNN)")
        from repro_torch.kernels import flash_attention as fa
        n = (fa.launches, fa.bwd_launches, fa.sm90_launches,
             fa.sm90_bwd_launches)
        got = pt_train.reference_run(self.dev, ref)
        # float32 runs on the float32 sources
        self.check(fa.launches > n[0] and fa.bwd_launches > n[1]
                   and (fa.sm90_launches, fa.sm90_bwd_launches) == n[2:],
                   "train_vs_jax: float32 attention on the wgmma sources, "
                   "or not on the kernels")
        err = pt_train.reference_errors(got, ref)
        for i, (g, w) in enumerate(zip(got["steps"], ref["steps"])):
            log(f"   step {i}: loss {g['loss']:.7f} (jax {w['loss']:.7f}), "
                f"grad norm {g['grad_norm']:.7f} (jax {w['grad_norm']:.7f})")
        for k, limit in pt_train.TRAIN_TOL.items():
            log(f"   {k}: {err[k]:.3g} (limit {limit})")
            self.check(err[k] is not None and err[k] <= limit,
                       f"train_vs_jax: {k} {err[k]} > {limit}")
        self.report["train_vs_jax"] = {"steps": got["steps"],
                                       "errors": err}
        torch.cuda.empty_cache()

    # --------------------------------------------------------------- 18
    def leaf_grads(self, model, batch):
        """(loss, {name: float64 gradient norm}) of one forward/backward."""
        for p in model.parameters():
            p.grad = None
        loss, _ = model.loss(batch)
        loss.backward()
        return float(loss.detach()), {
            k: float(p.grad.double().norm()) for k, p in
            model.named_parameters()}

    def kernel_vs_plain_grads(self, label, model, batch, limits):
        """The model's loss and per-leaf gradient norms through the kernels
        and through the plain versions on the same weights."""
        lk, gk = self.leaf_grads(model, batch)
        model.core = "plain"
        lp, gp = self.leaf_grads(model, batch)
        model.core = "kernel"
        dl = abs(lk - lp) / abs(lp)
        dg = max(abs(gk[k] - gp[k]) / max(gp[k], 1e-30) for k in gp)
        log(f"   {label}: loss {lk:.7f} vs plain {lp:.7f} ({dl:.3g} rel, "
            f"limit {limits['loss']}); per-leaf gradient norms {dg:.3g} "
            f"rel at worst (limit {limits['grad_norm']})")
        self.check(dl <= limits["loss"], f"train {label}: loss {dl} rel")
        self.check(dg <= limits["grad_norm"],
                   f"train {label}: gradient norms {dg} rel")
        return {"loss_rel": dl, "grad_norm_rel": dg}

    def train(self):
        torch = self.torch
        import dataclasses
        from benchmarks import pt_train
        from repro_torch.configs import get_config
        from repro_torch.models.api import build_model
        cfg = get_config("hymba-1.5b")
        per_step, out = [], {}

        def instrument(trainer):
            step_fn = trainer.step_fn

            def timed(state, batch):
                c0 = self.counters()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = step_fn(state, batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                c1 = self.counters()
                per_step.append({
                    "step": state["step"], "ms": 1e3 * dt,
                    "tokens_per_s": TRAIN_B * TRAIN_S / dt,
                    "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": {k: c1[k] - c0[k] for k in c1
                                 if c1[k] != c0[k]}})
                return res

            trainer.step_fn = timed

        def run():
            trainer, res = pt_train.train(
                cfg, self.dev, steps=TRAIN_STEPS, batch=TRAIN_B,
                seq_len=TRAIN_S, ckpt_every=TRAIN_CKPT_EVERY,
                fail_at=(TRAIN_FAIL_AT,), instrument=instrument)
            out.update(trainer=trainer, res=res)
            return ("flash_attention", "flash_attention_bwd",
                    "fused_selective_scan", "fused_selective_scan_bwd")

        counts = self.path("train", run)
        trainer, res = out["trainer"], out["res"]
        L = cfg.n_layers
        # per step with remat="full": the forward and its recompute run
        # kernels 6 and 7 once a layer each; the backward runs the
        # selective scan's backward and the attention backward once a
        # layer, and kernel 5 not at all
        want = {"flash_attention": 2 * L, "fused_selective_scan": 2 * L,
                "fused_selective_scan_bwd": L, "ssm_scan": 0,
                "flash_attention_bwd": L,
                "flash_attention_sm90": 2 * L,
                "flash_attention_bwd_sm90": L}
        n = len(res["log"])
        for k, w in want.items():
            self.check(counts[k] == w * n, f"train: {k} launched {counts[k]}"
                       f" times in {n} steps, not {w} a step")
        for rec in per_step:
            ok = all(rec["launches"].get(k, 0) == w for k, w in want.items())
            self.check(ok, f"train: step {rec['step']} launches "
                       f"{rec['launches']} != {want}")
            log(f"   step {rec['step']}: {rec['ms']:.1f} ms, "
                f"{rec['tokens_per_s']:.0f} tokens/s, peak "
                f"{rec['max_memory_gb']:.2f} GB, launches {rec['launches']}")
        losses = [(r["step"], r["loss"]) for r in res["log"]]
        log(f"   losses {[(s, round(l, 6)) for s, l in losses]}; restarts "
            f"{res['restarts']}")
        self.check(res["restarts"] == 1, f"train: {res['restarts']} restarts")
        first, replay = {}, {}
        for s_, l_ in losses:
            (replay if s_ in first else first)[s_] = l_
        self.check(sorted(replay) == [TRAIN_CKPT_EVERY, TRAIN_FAIL_AT - 1],
                   f"train: replayed steps {sorted(replay)}")
        bit_equal = all(replay[s_] == first[s_] for s_ in replay)
        rel = max((abs(replay[s_] - first[s_]) / abs(first[s_])
                   for s_ in replay), default=0.0)
        log(f"   replayed steps {sorted(replay)}: losses bit-equal "
            f"{bit_equal}, {rel:.3g} relative at worst")
        self.check(rel <= 1e-6, f"train: replayed losses differ by {rel}")
        self.check(losses[-1][1] < losses[0][1],
                   f"train: final loss {losses[-1][1]} >= first "
                   f"{losses[0][1]}")
        self.check(all(math.isfinite(l_) for _, l_ in losses),
                   "train: a loss is not finite")
        self.train_launches = counts
        self.train_steps = n
        # the last step's gradients, for the compression phase
        self.last_grads = {k: p.grad for k, p in
                           trainer.model.named_parameters()}
        batch = pt_train.reference_data(cfg, {"seq_len": TRAIN_S,
                                              "batch": TRAIN_B,
                                              "data_seed": 0}).batch_at(0)
        try:  # diagnostic only: a profiler problem fails no check
            self.profile_train_step(trainer.model, batch)
        except Exception:
            log(f"train-step profile unavailable:\n{traceback.format_exc()}")
        # the trained weights at 2 layers, kernel path vs plain path, in
        # bfloat16 as trained and in float32
        state = {k: v.detach() for k, v in
                 trainer.model.state_dict().items()
                 if not k.startswith("layers.") or
                 int(k.split(".")[1]) < 2}
        del trainer, out
        torch.cuda.empty_cache()
        cut = dataclasses.replace(cfg, n_layers=2)
        cmp = {}
        m = build_model(cut, device=self.dev).load_params(state)
        m.requires_grad_(True)
        cmp["bfloat16"] = self.kernel_vs_plain_grads(
            "2 layers bfloat16", m, batch, TRAIN_BF16_REL)
        del m
        torch.backends.cuda.matmul.allow_tf32 = False
        m = build_model(dataclasses.replace(
            cut, param_dtype="float32", compute_dtype="float32"),
            device=self.dev).load_params(
                {k: v.float() for k, v in state.items()})
        m.requires_grad_(True)
        cmp["float32"] = self.kernel_vs_plain_grads(
            "2 layers float32", m, batch, TRAIN_F32_REL)
        del m, state
        torch.cuda.empty_cache()
        self.report["train"] = {
            "log": res["log"], "per_step": per_step,
            "restarts": res["restarts"], "replay_bit_equal": bit_equal,
            "replay_rel": rel, "kernel_vs_plain_2_layers": cmp,
            "launches": counts}

    # --------------------------------------------------------------- 19
    def compression(self):
        torch = self.torch
        from repro_torch.optim import compression as comp
        grads = self.last_grads
        n_elem = sum(g.numel() for g in grads.values())
        ef0 = comp.init_error_feedback(grads)
        out = {}

        def run():
            pay, ef1 = comp.ef_compress(grads, ef0)
            back1 = comp.ef_decompress(pay, grads)
            pay2, ef2 = comp.ef_compress(grads, ef1)
            back2 = comp.ef_decompress(pay2, grads)
            torch.cuda.synchronize()
            out.update(pay=pay, ef1=ef1, back1=back1, ef2=ef2, back2=back2)
            return ("quantize_int8", "dequantize_int8")

        counts = self.path("compression", run)
        n = len(grads)
        self.check(counts["quantize_int8"] == 2 * n and
                   counts["dequantize_int8"] == 4 * n,
                   f"compression: launches {counts} for {n} leaves")
        ppay, pef1 = comp.ef_compress(grads, ef0, core="plain")
        pback1 = comp.ef_decompress(ppay, grads, core="plain")
        equal = all(torch.equal(out["pay"][k][0], ppay[k][0]) and
                    torch.equal(out["pay"][k][1], ppay[k][1]) and
                    torch.equal(out["ef1"][k], pef1[k]) and
                    torch.equal(out["back1"][k], pback1[k]) for k in grads)
        self.check(equal, "compression: kernels not bit-equal to plain")
        del ppay, pef1, pback1
        # residual bound: after one step from zero each residual is the
        # rounding of v / scale to an integer, at most half its block's
        # scale, plus the float32 rounding of q * scale (|q| <= 127: 127 *
        # 2**-23 of the scale)
        bound_ok, tele = True, 0.0
        for k, g in grads.items():
            q, sc, _ = out["pay"][k]
            e = out["ef1"][k]
            pad = (-e.numel()) % comp.BLOCK
            e = torch.nn.functional.pad(e, (0, pad)).view(-1, comp.BLOCK)
            bound_ok &= bool((e.abs().amax(-1)
                              <= sc * (0.5 + 127 * 2.0 ** -23)).all())
            # two steps telescope: dq_1 + dq_2 = 2 g - ef_2
            gf = g.float().reshape(-1)
            lhs = (out["back1"][k] + out["back2"][k]).reshape(-1)
            rhs = 2 * gf - out["ef2"][k]
            tele = max(tele, float((lhs - rhs).abs().max())
                       / max(float(gf.abs().max()), 1e-30))
        self.check(bound_ok, "compression: a residual exceeds half its "
                   "block's scale")
        self.check(tele <= 1e-6, f"compression: two steps telescope to "
                   f"{tele} of the largest |g|")
        wb = comp.wire_bytes(n_elem, dtype_bytes=2, n=2)
        log(f"   {n} leaves, {n_elem} elements: kernels bit-equal to plain "
            f"{equal}; residuals within half a block scale {bound_ok}; two "
            f"steps telescope within {tele:.3g} of the largest |g|; wire "
            f"bytes (bf16 ring all-reduce vs int8 all-gather, 2 ranks) "
            f"{wb['uncompressed']:.4g} vs {wb['compressed']:.4g}, ratio "
            f"{wb['ratio']:.3f}")
        self.compression_launches = counts
        self.report["compression"] = {
            "leaves": n, "elements": n_elem, "bit_equal": equal,
            "residual_bound": bound_ok, "telescope_rel": tele,
            "wire_bytes": wb, "launches": counts}
        del out, ef0, self.last_grads
        torch.cuda.empty_cache()

    # --------------------------------------------------------------- 20
    def timing_train(self):
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.kernels import flash_attention as fa, quant as qt
        from repro_torch.kernels import ref, ssm_scan as ss
        F = torch.nn.functional
        cfg = get_config("hymba-1.5b")
        out = {}
        # kernels 3 and 4 at the largest leaf (embed.tok)
        x = self.quant_inputs((1, cfg.vocab_padded * cfg.d_model), 1)
        q, s = qt.quantize_int8(x)
        for name, fn, plain, bound in (
                ("quantize_int8", lambda: qt.quantize_int8(x),
                 lambda: ref.quantize_int8(x), quant_bound_ms(x.numel(),
                                                              True)),
                ("dequantize_int8", lambda: qt.dequantize_int8(q, s),
                 lambda: ref.dequantize_int8(q, s),
                 quant_bound_ms(x.numel(), False))):
            k_ms, k_span = self.med_ms(fn)
            p_ms, p_span = self.med_ms(plain)
            out[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0],
                         "bound_by": bound[1], "library_ms": None,
                         "shape": list(x.shape), "span_ms": k_span,
                         "plain_span_ms": p_span}
        del x, q, s
        # kernel 5 at the training shape, forward and reverse
        Di, N = HYMBA_SSM
        g = torch.Generator(device=self.dev).manual_seed(1)
        dA = torch.rand(TRAIN_B, TRAIN_S, Di, N, generator=g,
                        device=self.dev)
        dBx = torch.randn(TRAIN_B, TRAIN_S, Di, N, generator=g,
                          device=self.dev)
        h0 = torch.zeros(TRAIN_B, Di, N, device=self.dev)
        bound = state_scan_bound_ms(dA)
        for reverse in (False, True):
            k_ms, k_span = self.med_ms(
                lambda: ss.ssm_scan(dA, dBx, h0, reverse=reverse))
            p_ms, p_span = self.med_ms(
                lambda: ref.ssm_scan(dA, dBx, h0, reverse=reverse), n=10)
            out["ssm_scan" + ("_reverse" if reverse else "")] = {
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None,
                "shape": list(dA.shape), "span_ms": k_span,
                "plain_span_ms": p_span}
        del dA, dBx, h0
        torch.cuda.empty_cache()
        # the selective scan's backward at the training shape, x bfloat16
        # as on the training path; the plain version eagerly (its two
        # 1,280-step loops), each call between CUDA events
        args = self.scan_bwd_inputs((TRAIN_B, TRAIN_S, Di, N),
                                    torch.bfloat16, 3)
        k_ms, k_span = self.med_ms(lambda: ss.fused_selective_scan_bwd(*args))
        p_ms, p_span = self.med_ms(
            lambda: ref.fused_selective_scan_bwd(*args), n=3, graph=False)
        bound = scan_bwd_bound_ms(args, self.n_sm, self.sm_clock_hz)
        out["fused_selective_scan_bwd"] = {
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None,
            "shape": list(args[0].shape) + [N], "span_ms": k_span,
            "plain_span_ms": p_span, "plain_timed": "eager"}
        del args
        torch.cuda.empty_cache()
        # the attention backward at the training shape, bfloat16
        q, k, v = self.attn_inputs(TRAIN_B, TRAIN_S, HYMBA_HEADS,
                                   torch.bfloat16, seed=2)
        do = self.attn_inputs(TRAIN_B, TRAIN_S, HYMBA_HEADS, torch.bfloat16,
                              seed=3)[0]
        o, lse = fa.flash_attention(q, k, v, window=HYMBA_WINDOW,
                                    return_lse=True)
        k_ms, k_span = self.med_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, window=HYMBA_WINDOW))
        p_ms, p_span = self.med_ms(lambda: ref.flash_attention_bwd(
            q, k, v, o, lse, do, window=HYMBA_WINDOW), n=20)
        bound = fa_bwd_bound_ms(q, k, HYMBA_WINDOW)
        # at S = 1024 the window is inert: the library's causal attention
        # backward computes the same function
        q1, k1, v1, do1, o1 = (t[:, :HYMBA_WINDOW].contiguous()
                               for t in (q, k, v, do, o))
        o1, lse1 = fa.flash_attention(q1, k1, v1, window=HYMBA_WINDOW,
                                      return_lse=True)
        k1024, _ = self.med_ms(lambda: fa.flash_attention_bwd(
            q1, k1, v1, o1, lse1, do1, window=HYMBA_WINDOW))
        qt_, kt_, vt_ = (t.transpose(1, 2).detach().requires_grad_()
                         for t in (q1, k1, v1))
        lib_out = F.scaled_dot_product_attention(qt_, kt_, vt_,
                                                 is_causal=True,
                                                 enable_gqa=True)
        go = do1.transpose(1, 2)
        lib, l_span = self.med_ms(lambda: torch.autograd.grad(
            lib_out, (qt_, kt_, vt_), go, retain_graph=True), graph=False)
        # achieved TFLOP/s of the function's 10 * D flops a live pair
        f_train = attn_flops(q, HYMBA_WINDOW, 10)
        f_1024 = attn_flops(q1, HYMBA_WINDOW, 10)
        out["flash_attention_bwd"] = {
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib,
            "library_shape": f"B={TRAIN_B} S={HYMBA_WINDOW} bfloat16",
            "ms_at_library_shape": k1024, "span_ms": k_span,
            "plain_span_ms": p_span, "library_span_ms": l_span,
            "tflops": f_train / k_ms / 1e9,
            "tflops_at_library_shape": f_1024 / k1024 / 1e9,
            "library_tflops": f_1024 / lib / 1e9}
        for name, t in out.items():
            log(f"   {name:22s} kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} "
                f"({t['bound_by']}), library {t['library_ms']}"
                + (f"; at S=1024 kernel {t['ms_at_library_shape']:.4f}"
                   if "ms_at_library_shape" in t else "")
                + (f"; TFLOP/s {t['tflops']:.1f}, at S=1024 "
                   f"{t['tflops_at_library_shape']:.1f}, library "
                   f"{t['library_tflops']:.1f}" if "tflops" in t else ""))
        self.train_timing = out
        self.report["timing_train"] = out

    # ------------------------------------------------------- diagnostic
    # --------------------------------------------------------------- 21
    def collectives(self):
        """The §III-B schedules on 8 ranks of one gloo group, all on
        cuda:0 (one card: nccl needs one a rank),
        every buffer on the card, point-to-point sends staged through the
        host (``collectives.stage``, its bytes counted); each schedule held to
        a numpy model of its order, kernel 2 as the ring's add and kernels
        3/4 in ``compressed_psum_mean`` against their plain versions; then
        ``pt_collective_bench``'s table in the same spawn."""
        import numpy as np
        from benchmarks import pt_collective_bench as cb
        from repro_torch.core import scenarios
        from repro_torch.launch import mesh
        n = COLLECTIVE_RANKS
        inp = collective_inputs()
        sizes = list(scenarios.get("collective_microbench").microbench_sizes)
        t0 = time.time()
        ranks = mesh.spawn_group(collective_rank, n, backend="gloo",
                                 device=self.dev, args=(sizes,))
        dev = mesh.rank_devices(n, "gloo", self.dev)[0]
        log(f"   {n} ranks on {dev} over gloo: {time.time() - t0:.1f}s "
            "with the spawn")
        out = {k: np.stack([r[0][k] for r in ranks]) for k in ranks[0][0]}
        counts = [r[1] for r in ranks]
        starts, checked, ended = zip(*(c["times"] for c in counts))
        log(f"   spawn to the last rank's start {max(starts) - t0:.1f}s, "
            f"checks {max(checked) - min(starts):.1f}s, bench "
            f"{max(ended) - min(checked):.1f}s, teardown "
            f"{time.time() - max(ended):.1f}s")
        # numpy models of each schedule's result and order of additions
        want_rs = np.stack([_ring_order_sum(inp["y"], r) for r in range(n)])
        checks = {
            "ring_ag": np.broadcast_to(inp["x"], (n,) + inp["x"].shape),
            "bidir_ring_ag": np.broadcast_to(inp["x"],
                                             (n,) + inp["x"].shape),
            "ring_rs": want_rs, "ring_rs_kernel2": want_rs,
            "ring_ar": np.broadcast_to(want_rs, (n,) + want_rs.shape),
            "a2a_linear": inp["z"].transpose(1, 0, 2),
            "a2a_pairwise": inp["z"].transpose(1, 0, 2),
            "incast": np.stack([inp["w"]] + [np.zeros_like(inp["w"])]
                               * (n - 1))}
        for key, want in checks.items():
            same = np.array_equal(out[key], want)
            log(f"   {key:16s} bit-equal to its numpy model: {same}")
            self.check(same, f"collectives: {key} differs from its numpy "
                       "model")
        got, plain = out["compressed"], out["compressed_plain"]
        true = inp["c"].astype(np.float64).mean(axis=0)
        err = float(np.abs(got[0] - true).max())
        bound = float(np.abs(inp["c"]).max()) / 127
        ok = np.array_equal(got, plain) and all(
            np.array_equal(got[r], got[0]) for r in range(n))
        log(f"   compressed_psum_mean: kernels 3/4 bit-equal to plain and "
            f"every rank the same: {ok}; {err:.3g} from the float64 mean "
            f"(bound {bound:.3g})")
        self.check(ok and err <= bound and not got[0][:256].any(),
                   f"collectives: compressed_psum_mean (equal {ok}, err "
                   f"{err} > {bound}?)")
        k2 = [c["kernel2"] for c in counts]
        quant = [c["quant"] for c in counts]
        self.check(all(c == n - 1 for c in k2),
                   f"collectives: kernel 2 launches a rank a call {k2}, "
                   f"not {n - 1}")
        self.check(all(q == (1, 1) for q in quant),
                   f"collectives: kernels 3/4 launches a rank {quant}")
        staged = [c["staged_bytes"] for c in counts]
        log(f"   kernel 2 launches a rank in one ring reduce-scatter {k2}; "
            f"kernels 3/4 a rank in one compressed mean {quant}; staged "
            f"through the host (collectives.stage) by the checks, bytes a "
            f"rank {staged}")
        table = {s: {name: max(r[1]["bench"][s][name] for r in ranks)
                     for name, *_ in cb.CASES} for s in sizes}
        log(f"   {'us a call':24s} " + " ".join(f"{s:>10d}" for s in sizes))
        for name, *_ in cb.CASES:
            log(f"   {name:24s} " + " ".join(
                f"{table[s][name]:10.1f}" for s in sizes))
        try:
            mesh.rank_devices(n, "nccl", "cuda")
            nccl = "available"
        except RuntimeError as e:  # the expected answer on one card
            nccl = str(e)
        log(f"   nccl: {nccl}")
        self.collective_launches = {
            "fused_accumulate": sum(k2),
            "quantize_int8": sum(q[0] for q in quant),
            "dequantize_int8": sum(q[1] for q in quant)}
        self.report["collectives"] = {
            "ranks": n, "backend": "gloo", "device": str(dev),
            "kernel2_launches_per_rank_call": k2, "quant_launches": quant,
            "staged_bytes_per_rank": staged, "compressed_err": err,
            "bench_us_per_call": table, "nccl": nccl,
            "wall_s": time.time() - t0}

    # --------------------------------------------------------------- 22
    def hold_lm(self, label, model, ref, r, pad_cache=False, launches=None,
                extra=None, per_prefill=None, tol=LM_TOL):
        """A prefill of the reference's prompts (with the batch entries
        ``extra``: an encoder-decoder's frames), then its teacher-forced
        decode steps, each step's logits held to its rows (``tol``, greedy
        tokens where JAX's margin is wide). ``pad_cache`` gives a
        full-attention cache (``k``, ``v``) room for the decode steps.
        ``launches``: the kernel modules (flash attention first) whose
        counts were set to 0; the prefill must launch each
        ``per_prefill`` times (default once a layer), float32 attention on
        the float32 source."""
        torch = self.torch
        import numpy as np
        from benchmarks import pt_serve
        prompts = torch.as_tensor(np.array(ref["prompts"]), device=self.dev)
        probe = np.array(ref["probe_ids"])
        logits, cache = model.prefill({"tokens": prompts, **(extra or {})})
        if launches:
            L = per_prefill or model.cfg.n_layers
            counts = [m.launches for m in launches]
            self.check(all(c == L for c in counts)
                       and launches[0].sm90_launches == 0,
                       f"{label} prefill launches {counts} != {L}, or "
                       f"float32 on the wgmma source "
                       f"({launches[0].sm90_launches})")
        if pad_cache:
            cache = {k: torch.nn.functional.pad(
                v, (0, 0, 0, 0, 0, r["decode_steps"]))
                if k in ("k", "v") else v for k, v in cache.items()}
        S, rows = prompts.shape[1], []
        for t, want in enumerate(ref["steps"]):
            res = pt_serve.reference_errors(logits.cpu().numpy(), want, probe,
                                            tol)
            rows.append(res)
            log(f"   step {t}: max abs err {res['max_abs_err']:.3g}, greedy "
                f"{[w['token'] for w in want]} margins "
                f"{[round(w['margin'], 4) for w in want]}, mismatched rows "
                f"{res['greedy_mismatch']}")
            self.check(res["max_abs_err"] <= tol,
                       f"{label} step {t}: max abs err "
                       f"{res['max_abs_err']} > {tol}")
            self.check(not res["greedy_mismatch"],
                       f"{label} step {t}: greedy tokens differ in rows "
                       f"{res['greedy_mismatch']}")
            if t + 1 < len(ref["steps"]):
                tok = torch.as_tensor([[w["token"]] for w in want],
                                      device=self.dev)
                logits, cache = model.decode(cache, tok, S + t)
        return rows

    def moe_vs_jax(self):
        """grok-1 at full width, 1 layer, float32 (TF32 off) through the
        kernels, held to ``jax_moe_reference.json`` as ``lm_vs_jax`` holds
        hymba; its 6.53 B parameters drawn by ``numpy_param_leaves`` and
        moved to the card leaf by leaf. Without the file (the JAX rows
        need ~30 GB of host memory: ``pt_jax_reference.py --only moe``)
        it says so and holds nothing."""
        torch = self.torch
        from benchmarks import pt_serve
        from repro_torch import convert
        from repro_torch.models.api import build_model
        from repro_torch.models.layers import numpy_param_leaves
        if not os.path.exists(MOE_REFERENCE):
            why = (f"{os.path.relpath(MOE_REFERENCE, ROOT)} is absent: "
                   "grok-1 is not held to JAX at full width in this run "
                   "(the reduced configs are, on the CPU: "
                   "tests/test_torch_moe.py)")
            log(f"   {why}")
            self.report["moe_vs_jax"] = {"held": False, "why": why}
            return
        from repro_torch.kernels import flash_attention as fa
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with open(MOE_REFERENCE) as f:
            ref = json.load(f)
        r = pt_serve.MOE_REFERENCE
        cfg = pt_serve.reference_config(r)
        t0 = time.time()
        model = build_model(cfg, device=self.dev).load_params(
            convert.lm_params_from_leaves(
                numpy_param_leaves(cfg, ref["config"]["param_seed"]), cfg,
                device=self.dev))
        draw_s = time.time() - t0
        log(f"   reference: jax {ref['jax_version']} commit "
            f"{ref['commit'][:12]}; {cfg.name}, {cfg.n_layers} layer, "
            f"parameters drawn and moved in {draw_s:.1f}s")
        fa.launches = fa.sm90_launches = 0
        rows = self.hold_lm("moe_vs_jax", model, ref, r, pad_cache=True,
                            launches=(fa,))
        self.report["moe_vs_jax"] = {"held": True, "rows": rows,
                                     "draw_s": draw_s}
        del model
        torch.cuda.empty_cache()

    def grok_config(self):
        import dataclasses
        from repro_torch.configs import get_config
        return dataclasses.replace(get_config("grok-1-314b"),
                                   n_layers=GROK_LAYERS)

    def serve_moe(self):
        """grok-1 at full width, GROK_LAYERS layers, bfloat16, through
        ``BatchedServer`` (``pt_serve.serve``: hymba's twelve requests in
        two waves), the launch counts reset before and read after (kernel
        7 once a layer a prefill, every launch on the wgmma source); kernel
        7 first at the serve prefill's shape against its plain version;
        wave 1's prefill logits kernel vs plain on the same weights."""
        torch = self.torch
        from benchmarks import pt_serve
        cfg = self.grok_config()
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
        q, k, v = self.attn_inputs(SERVE_B, SERVE_S, heads, torch.bfloat16,
                                   seed=41)
        self.fa_grok_err = self.fa_compare(
            f"grok-1 serve B={SERVE_B} S={SERVE_S} {heads} bfloat16", q, k, v)
        del q, k, v
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = {}

        def run():
            t0 = time.time()
            server, model = pt_serve.serve(cfg, self.dev)
            torch.cuda.synchronize()
            out.update(server=server, model=model, wall=time.time() - t0)
            return ("flash_attention",)

        counts = self.path("serve_moe", run)
        server, model = out["server"], out["model"]
        st = server.stats
        want = 2 * cfg.n_layers
        for key in ("flash_attention", "flash_attention_sm90"):
            self.check(counts[key] == want, f"serve_moe: {key} launched "
                       f"{counts[key]} times, not {want}")
        mix = pt_serve.request_mix(cfg.vocab_size)
        self.check(st.requests_done == len(mix) and st.waves == 2,
                   f"serve_moe: {st.requests_done} requests in {st.waves} "
                   "waves")
        self.check(st.nonfinite_logits == 0,
                   f"serve_moe: {st.nonfinite_logits} non-finite logits")
        for req, (prompt, n_new, _) in zip(server.done, mix):
            self.check(len(req.tokens) == n_new
                       and req.finish_reason == "length",
                       f"serve_moe: request {req.uid} gave "
                       f"{len(req.tokens)} of {n_new} tokens")
        peak = torch.cuda.max_memory_allocated() / 1e9
        wave1 = server.done[:pt_serve.MAX_BATCH]
        batch = server.make_batch_inputs(wave1,
                                         max(len(r.prompt) for r in wave1))
        rel = self.held_rel("grok-1 wave 1 bfloat16",
                            *self.prefill_both(model, batch), SERVE_BF16_REL)
        t0 = time.perf_counter()
        model.prefill(batch)
        torch.cuda.synchronize()
        warm_ms = 1e3 * (time.perf_counter() - t0)
        log(f"   wave 1 prefill again, warm: {warm_ms:.1f} ms")
        try:  # diagnostic only: a profiler problem fails no check
            prof = self.profile_serve(model, batch)
        except Exception:
            prof = None
            log(f"   serve profile unavailable:\n{traceback.format_exc()}")
        dec_ms = [1e3 * d / max(c, 1) for d, c in zip(st.decode_s,
                                                       st.decode_calls)]
        n_params = sum(p.numel() for p in model.parameters())
        log(f"   {cfg.name}, {cfg.n_layers} layers bfloat16, "
            f"{n_params / 1e9:.2f} B parameters, d_model {cfg.d_model}, "
            f"{cfg.n_experts} experts top-{cfg.top_k}: {st.requests_done} "
            f"requests, {st.waves} waves, {st.decode_steps} decode steps, "
            f"{st.tokens_generated} tokens, {st.tokens_per_s:.1f} tokens/s; "
            f"prefill ms per wave {[round(1e3 * p, 1) for p in st.prefill_s]}"
            f"; decode ms per step {[round(d, 2) for d in dec_ms]}; peak "
            f"memory {peak:.1f} GB; {out['wall']:.1f}s with the weights' "
            "draw")
        self.serve_moe_launches = counts
        self.report["serve_moe"] = {
            "layers": cfg.n_layers, "params": n_params,
            "requests": st.requests_done, "waves": st.waves,
            "decode_steps": st.decode_steps, "tokens": st.tokens_generated,
            "tokens_per_s": st.tokens_per_s, "wall_s": st.wall_s,
            "prefill_ms": [1e3 * p for p in st.prefill_s],
            "decode_ms_per_step": dec_ms, "peak_memory_gb": peak,
            "prefill_kernel_vs_plain_rel": rel,
            "wall_with_draw_s": out["wall"], "warm_prefill_ms": warm_ms,
            "profile": prof}
        del out, server, model
        torch.cuda.empty_cache()

    def timing_moe(self):
        """Kernel 7 at grok-1's serve prefill shape (B = 8, S = 1280,
        48/8 heads x 128, causal, no window, bfloat16) beside its plain
        version, its bound and ``scaled_dot_product_attention``, which
        computes the same function there."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa, ref
        F = torch.nn.functional
        cfg = self.grok_config()
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
        q, k, v = self.attn_inputs(SERVE_B, SERVE_S, heads, torch.bfloat16,
                                   seed=42)
        kernel, k_span = self.med_ms(lambda: fa.flash_attention(q, k, v))
        plain, _ = self.med_ms(lambda: ref.flash_attention(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib, _ = self.med_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bound, by = fa_bound_ms(q, k, SERVE_S)  # causal, no window
        flops = attn_flops(q, SERVE_S, 4)
        self.fa_grok_timing = {
            "ms": kernel, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "library_ms": lib, "span_ms": k_span,
            "tflops": flops / kernel / 1e9,
            "library_tflops": flops / lib / 1e9,
            "shape": f"B={SERVE_B} S={SERVE_S} {heads} causal bfloat16"}
        t = self.fa_grok_timing
        log(f"   flash_attention grok-1 {t['shape']}: kernel {kernel:.4f} "
            f"ms ({t['tflops']:.1f} TFLOP/s), plain {plain:.4f}, bound "
            f"{bound:.4f} ({by}), sdpa {lib:.4f} "
            f"({t['library_tflops']:.1f} TFLOP/s)")
        self.report["timing_moe"] = t

    # --------------------------------------------------------------- 24
    def encdec_vs_jax(self):
        """whisper-tiny at full width and depth (4 + 4 layers), float32
        (TF32 off), through the kernels, held to
        ``jax_reference.json["encdec"]`` as ``lm_vs_jax`` holds hymba: the
        prefill over the rows' 1,500 seeded frames (kernel 7 twelve times,
        all on the float32 source), one teacher-forced decode step, and
        the loss with the prompts as labels."""
        torch = self.torch
        import numpy as np
        from benchmarks import pt_serve
        from repro_torch import convert
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.models.api import build_model
        from repro_torch.models.layers import numpy_params
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        with open(REFERENCE) as f:
            ref = json.load(f)["encdec"]
        r = pt_serve.ENCDEC_REFERENCE
        cfg = pt_serve.reference_config(r)
        log(f"   reference: jax {ref['jax_version']} ({ref['jax_backend']}) "
            f"commit {ref['commit'][:12]}; {cfg.name}, {cfg.enc_layers} + "
            f"{cfg.n_layers} layers float32, TF32 off")
        model = build_model(cfg, device=self.dev).load_params(
            convert.lm_params_from_jax(
                numpy_params(cfg, ref["config"]["param_seed"]), cfg))
        frames = torch.as_tensor(pt_serve.reference_frames(cfg, r),
                                 device=self.dev)
        fa.launches = fa.sm90_launches = 0
        rows = self.hold_lm("encdec_vs_jax", model, ref, r, pad_cache=True,
                            launches=(fa,), extra={"frames": frames},
                            per_prefill=cfg.enc_layers + 2 * cfg.n_layers)
        tokens = torch.as_tensor(np.array(ref["prompts"]), device=self.dev)
        with torch.no_grad():
            loss = float(model.loss({"tokens": tokens, "labels": tokens,
                                     "frames": frames})[0])
        err = abs(loss - ref["loss"])
        log(f"   loss {loss!r} against JAX's {ref['loss']!r}: {err:.3g}")
        self.check(err <= LM_TOL, f"encdec_vs_jax: loss {loss} is {err} "
                   f"from JAX's {ref['loss']} (> {LM_TOL})")
        self.report["encdec_vs_jax"] = {"rows": rows, "loss": loss,
                                        "loss_err": err}
        del model
        torch.cuda.empty_cache()

    def frontend_batch(self, server, wave, seed):
        """The wave's batch as the server builds it, an encoder-decoder's
        zero frames or a VLM's zero patches replaced by standard normal
        ones drawn from ``seed`` on the card (so the kernel-vs-plain checks
        see a live frontend); a decoder-only LM's batch as it is."""
        torch = self.torch
        batch = server.make_batch_inputs(wave, max(len(r.prompt)
                                                   for r in wave))
        g = torch.Generator(device=self.dev).manual_seed(seed)
        for key in ("frames", "patches"):
            if key in batch:
                batch[key] = torch.randn(batch[key].shape, generator=g,
                                         device=self.dev)
        return batch

    def serve_arch(self, name, cfg, per_prefill, seed):
        """Serve ``cfg`` (bfloat16, full width) through ``BatchedServer``
        (``pt_serve.serve``: hymba's twelve requests in two waves; the
        weights drawn on the card a leaf at a time), the launch counts
        reset before and read after: kernel 7 ``per_prefill`` times a
        wave's prefill, every launch on the wgmma source; every request
        its tokens, no non-finite logit; then wave 1's prefill, kernel vs
        plain on the same weights (over frames or patches drawn from
        ``seed`` where the model has a frontend), within SERVE_BF16_REL of
        the largest logit; a warm prefill and a profile of one prefill and
        one decode step. Returns (server, model, report)."""
        torch = self.torch
        from benchmarks import pt_serve
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = {}

        def run():
            t0 = time.time()
            server, model = pt_serve.serve(cfg, self.dev)
            torch.cuda.synchronize()
            out.update(server=server, model=model, wall=time.time() - t0)
            return ("flash_attention",)

        counts = self.path(name, run)
        server, model = out["server"], out["model"]
        st = server.stats
        want = st.waves * per_prefill
        for key in ("flash_attention", "flash_attention_sm90"):
            self.check(counts[key] == want, f"{name}: {key} launched "
                       f"{counts[key]} times, not {want}")
        mix = pt_serve.request_mix(cfg.vocab_size)
        self.check(st.requests_done == len(mix) and st.waves == 2,
                   f"{name}: {st.requests_done} requests in {st.waves} "
                   "waves")
        self.check(st.nonfinite_logits == 0,
                   f"{name}: {st.nonfinite_logits} non-finite logits")
        for req, (prompt, n_new, _) in zip(server.done, mix):
            self.check(len(req.tokens) == n_new
                       and req.finish_reason == "length",
                       f"{name}: request {req.uid} gave "
                       f"{len(req.tokens)} of {n_new} tokens")
        peak = torch.cuda.max_memory_allocated() / 1e9
        wave1 = server.done[:pt_serve.MAX_BATCH]
        batch = self.frontend_batch(server, wave1, seed)
        front = ", seeded frontend" if cfg.n_frontend_tokens else ""
        rel = self.held_rel(f"{cfg.name} wave 1 bfloat16{front}",
                            *self.prefill_both(model, batch), SERVE_BF16_REL)
        t0 = time.perf_counter()
        model.prefill(batch)
        torch.cuda.synchronize()
        warm_ms = 1e3 * (time.perf_counter() - t0)
        log(f"   wave 1 prefill again, warm: {warm_ms:.1f} ms")
        try:  # diagnostic only: a profiler problem fails no check
            prof = self.profile_serve(model, batch, server.n_front())
        except Exception:
            prof = None
            log(f"   serve profile unavailable:\n{traceback.format_exc()}")
        dec_ms = [1e3 * d / max(c, 1) for d, c in zip(st.decode_s,
                                                       st.decode_calls)]
        n_params = sum(p.numel() for p in model.parameters())
        dec_launches = prof["decode"]["launches"] if prof else None
        log(f"   {cfg.name}, {cfg.n_layers} layers bfloat16, "
            f"{n_params / 1e9:.3f} B parameters, d_model {cfg.d_model}: "
            f"{st.requests_done} requests, {st.waves} waves, "
            f"{st.decode_steps} decode steps, {st.tokens_generated} tokens, "
            f"{st.tokens_per_s:.1f} tokens/s; prefill ms per wave "
            f"{[round(1e3 * p, 1) for p in st.prefill_s]}; decode ms per "
            f"step {[round(d, 2) for d in dec_ms]} ({dec_launches} device "
            f"launches a step); peak memory {peak:.1f} GB; "
            f"{out['wall']:.1f}s with the weights' draw")
        report = {
            "layers": cfg.n_layers, "params": n_params,
            "requests": st.requests_done, "waves": st.waves,
            "decode_steps": st.decode_steps, "tokens": st.tokens_generated,
            "tokens_per_s": st.tokens_per_s, "wall_s": st.wall_s,
            "prefill_ms": [1e3 * p for p in st.prefill_s],
            "decode_ms_per_step": dec_ms, "peak_memory_gb": peak,
            "prefill_kernel_vs_plain_rel": rel,
            "wall_with_draw_s": out["wall"], "warm_prefill_ms": warm_ms,
            "launches": counts, "decode_launches": dec_launches,
            "profile": prof}
        return server, model, report

    def serve_encdec(self):
        """whisper-tiny at full width and depth, bfloat16, served
        (``serve_arch``): kernel 7 twelve times a prefill (4 encoder,
        4 causal self, 4 cross over the 1,500 frames), all on the wgmma
        source; the cross caches keep the frames' length."""
        from repro_torch.configs import get_config
        cfg = get_config("whisper-tiny")
        server, model, rep = self.serve_arch(
            "serve_encdec", cfg, cfg.enc_layers + 2 * cfg.n_layers, seed=51)
        wave1 = server.done[:8]
        _, cache = model.prefill(server.make_batch_inputs(
            wave1, max(len(r.prompt) for r in wave1)))
        shapes = {k: tuple(v.shape) for k, v in cache.items()}
        F = cfg.n_frontend_tokens
        self.check(shapes["xk"][2] == shapes["xv"][2] == F,
                   f"serve_encdec: cross caches {shapes}")
        log(f"   caches {shapes}")
        self.serve_encdec_launches = rep["launches"]
        self.report["serve_encdec"] = rep
        del server, model, cache
        self.torch.cuda.empty_cache()

    def serve_vlm(self):
        """internvl2-76b at full width cut to VLM_LAYERS layers, bfloat16,
        served (``serve_arch``): kernel 7 once a layer a prefill over
        the 256 patches and the prompts, all on the wgmma source; then
        prefill -> decode consistency on the card: wave 1 as served
        (zero patches), prefilled and decoded DECODE_CHECK steps on the
        server's own tokens at positions that count the patches, each
        step's logits against a prefill of the prompts grown by the tokens
        before it, within SERVE_BF16_REL of the largest logit."""
        torch = self.torch
        import numpy as np
        from repro_torch.configs import get_config
        cfg = dataclasses.replace(get_config("internvl2-76b"),
                                  n_layers=VLM_LAYERS)
        server, model, rep = self.serve_arch("serve_vlm", cfg, cfg.n_layers,
                                             seed=52)
        wave1 = server.done[:8]
        S = max(len(r.prompt) for r in wave1)
        batch = server.make_batch_inputs(wave1, S)
        gen = torch.as_tensor(np.stack([r.tokens for r in wave1]),
                              device=self.dev).long()
        P = cfg.n_frontend_tokens
        _, cache = model.prefill(batch)
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0,
                                                DECODE_CHECK))
                 for k, v in cache.items()}
        rels, same = [], []
        for t in range(DECODE_CHECK):
            logits, cache = model.decode(cache, gen[:, t:t + 1], P + S + t)
            grown = dict(batch, tokens=torch.cat([batch["tokens"],
                                                  gen[:, :t + 1]], 1))
            want, _ = model.prefill(grown)
            torch.cuda.synchronize()
            top = float(want.abs().max())
            rels.append(float((logits - want).abs().max()) / top)
            same.append(bool(torch.equal(logits.argmax(-1),
                                         want.argmax(-1))))
            self.check(rels[-1] <= SERVE_BF16_REL,
                       f"serve_vlm: decode step {t} is {rels[-1]} of the "
                       f"largest logit from the grown prompt's prefill")
        log(f"   prefill -> decode, {DECODE_CHECK} steps at positions "
            f"{P + S}..{P + S + DECODE_CHECK - 1}: "
            f"{[f'{r:.3g}' for r in rels]} of the largest logit (limit "
            f"{SERVE_BF16_REL}); greedy equal {same}")
        rep.update(decode_vs_prefill_rel=rels, decode_vs_prefill_greedy=same)
        self.serve_vlm_launches = rep["launches"]
        self.report["serve_vlm"] = rep
        del server, model, cache
        torch.cuda.empty_cache()

    def timing_encdec(self):
        """Kernel 7 at the encoder-decoder's and the VLM's prefill shapes
        (``ENCDEC_SHAPES``, B = SERVE_B, bfloat16) beside its plain
        version, its bound and ``scaled_dot_product_attention``, which
        computes the same function at each (no window)."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa, ref
        F = torch.nn.functional
        self.fa_encdec_timing = {}
        for n, (label, (Sq, Skv, heads, causal, window)) in enumerate(
                ENCDEC_SHAPES):
            q, k, v = self.attn_inputs(SERVE_B, Sq, heads, torch.bfloat16,
                                       seed=60 + n, Skv=Skv)
            kernel, k_span = self.med_ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, window=window))
            plain, _ = self.med_ms(lambda: ref.flash_attention(
                q, k, v, causal=causal, window=window))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib, _ = self.med_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
            bound, by = fa_bound_ms(q, k, window, causal)
            flops = attn_flops(q, window, 4, Skv, causal)
            t = {"ms": kernel, "plain_ms": plain, "bound_ms": bound,
                 "bound_by": by, "library_ms": lib, "span_ms": k_span,
                 "tflops": flops / kernel / 1e9,
                 "library_tflops": flops / lib / 1e9,
                 "max_abs_err": self.fa_edge_errs.get(label),
                 "shape": f"B={SERVE_B} Sq={Sq} Skv={Skv} {heads} "
                          f"{'causal' if causal else 'non-causal'} bfloat16"}
            self.fa_encdec_timing[label] = t
            log(f"   flash_attention {label} {t['shape']}: kernel "
                f"{kernel:.4f} ms ({t['tflops']:.1f} TFLOP/s), plain "
                f"{plain:.4f}, bound {bound:.4f} ({by}), sdpa {lib:.4f} "
                f"({t['library_tflops']:.1f} TFLOP/s)")
            del q, k, v, qt, kt, vt
        self.report["timing_encdec"] = self.fa_encdec_timing

    # --------------------------------------------------------------- 26
    def dense_vs_jax(self):
        """phi3-mini-3.8b at full width, 2 layers, float32 (TF32 off),
        through the kernels (kernel 7 on its float32 source at D = 96, G =
        1), held to ``jax_dense_reference.json`` as ``lm_vs_jax`` holds
        hymba: the prefill of two 1,280-token prompts and 8 teacher-forced
        decode steps, within DENSE_TOL."""
        from benchmarks import pt_serve
        from repro_torch.kernels import flash_attention as fa
        self.rows_vs_jax("dense_vs_jax", DENSE_REFERENCE,
                         pt_serve.DENSE_REFERENCE, (fa,), pad_cache=True,
                         tol=DENSE_TOL)

    def check_heads(self, name, cfg, label):
        """The config's attention heads are DENSE_SHAPES' ``label``."""
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
        want = dict(DENSE_SHAPES)[label][2]
        self.check(heads == want, f"{name}: {cfg.name}'s heads {heads} are "
                   f"not {label}'s {want}")

    def serve_dense(self):
        """The dense family at full width and depth, bfloat16, served
        (``serve_arch``): phi3-mini-3.8b (kernel 7 at G = 1, D = 96), then
        granite-20b (G = 48, D = 128, MQA), each once a layer a prefill,
        all on the wgmma source."""
        from benchmarks import pt_serve
        from repro_torch.configs import get_config
        self.serve_dense_launches, self.report["serve_dense"] = {}, {}
        for arch, label in DENSE_ARCHS:
            cfg = get_config(arch)
            self.check_heads("serve_dense", cfg, label)
            server, model, rep = self.serve_arch(
                f"serve_dense {arch}", cfg, cfg.n_layers, seed=53)
            self.serve_dense_launches[arch] = rep["launches"]
            self.report["serve_dense"][arch] = rep
            if arch == DENSE_ARCHS[0][0]:  # dryrun_vs_card's prefill
                self.dense_batch = (cfg, self.frontend_batch(
                    server, server.done[:pt_serve.MAX_BATCH], 53))
            del server, model
            self.torch.cuda.empty_cache()

    def serve_kimi(self):
        """kimi-k2 at full width on KIMI_LAYERS of its 61 layers,
        bfloat16, served (``serve_arch``): 384 experts top-8 dispatched
        by ``moe._dispatch_indices``' stable sort, kernel 7 once a layer a
        prefill at G = 8, D = 112, all on the wgmma source."""
        from repro_torch.configs import get_config
        cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b"),
                                  n_layers=KIMI_LAYERS)
        self.check_heads("serve_kimi", cfg, "kimi-k2 prefill")
        server, model, rep = self.serve_arch("serve_kimi", cfg, cfg.n_layers,
                                             seed=54)
        rep["experts"], rep["top_k"] = cfg.n_experts, cfg.top_k
        self.serve_kimi_launches = rep["launches"]
        self.report["serve_kimi"] = rep
        del server, model
        self.torch.cuda.empty_cache()

    def dryrun_vs_card(self):
        """The dry run of phi3-mini's wave-1 prefill against the same
        prefill on the card (module docstring, 28a)."""
        torch = self.torch
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.launch import hlo_stats, mesh, roofline
        from repro_torch.launch.steps import lower_cell
        from repro_torch.models.api import build_model
        from repro_torch.models.layers import init_params
        # serve_dense's model drawn again from its seed (pt_serve.serve's
        # 0), so serve_dense frees it before granite-20b's peak is read
        cfg, batch = self.dense_batch
        model = build_model(cfg, device=self.dev)
        model.load_params(init_params(
            cfg, torch.Generator(device=self.dev).manual_seed(0), None,
            self.dev))
        B, S = batch["tokens"].shape
        shape = ShapeConfig("serve wave 1", S, B, "prefill")
        layout = mesh.make_host_mesh()
        t0 = time.time()
        low = lower_cell(cfg, shape, layout, mesh.rules_for(cfg, layout))
        counter = hlo_stats.StepCounter(attn_chunk=cfg.attn_chunk,
                                        records=low.records)
        with counter:
            counter.arguments(low.arguments)
            outs = low.run()
        meta = counter.result(outs)
        count_s = time.time() - t0
        fwd = [c for c in counter.kernel_calls
               if c["kernel"] == "flash_attention"]
        # the card: the same prefill under FlopCounterMode, kernel 7 by the
        # dry run's formula times its launches
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()

        def run():
            with FlopCounterMode(display=False,
                                 custom_mapping=hlo_stats.FLOP_MAPPING) as fc:
                out = model.prefill(batch)
            torch.cuda.synchronize()
            run.aten, run.out = fc.get_total_flops(), out
            return ("flash_attention",)

        counts = self.path("dryrun_vs_card", run)
        rise = torch.cuda.max_memory_allocated() - before
        del run.out
        H, D = cfg.n_heads, cfg.resolved_head_dim
        per_call = 4 * hlo_stats.attention_units(B, S, S, H, D,
                                                 cfg.attn_chunk)
        card = run.aten + per_call * counts["flash_attention"]
        self.check(counts["flash_attention"] == cfg.n_layers == len(fwd),
                   f"dryrun_vs_card: kernel 7 launched "
                   f"{counts['flash_attention']} times, the count has "
                   f"{len(fwd)} calls, {cfg.n_layers} layers")
        self.check(card == meta["flops"], f"dryrun_vs_card: card FLOPs "
                   f"{card} != the dry run's {meta['flops']}")
        step_peak = meta["memory"]["peak_per_device_bytes"] \
            - meta["memory"]["argument_bytes"]
        peak_rel = abs(step_peak - rise) / rise
        self.check(peak_rel <= DRYRUN_PEAK_REL, f"dryrun_vs_card: meta peak "
                   f"{step_peak} B vs the card's rise {rise} B: {peak_rel:.3g}"
                   f" > {DRYRUN_PEAK_REL}")
        # device ms of the prefill (CUDA events, median of 5 warm runs)
        times = []
        for _ in range(5):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            model.prefill(batch)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        ms = sorted(times)[len(times) // 2]
        chip = roofline.H100
        terms = {"compute_s": meta["flops"] / chip.peak_flops,
                 "memory_s": meta["hbm_bytes"] / chip.hbm_bw,
                 "collective_s": 0.0}
        bound_ms = 1e3 * max(terms.values())
        by = max(terms, key=terms.get)
        log(f"   phi3-mini prefill B={B} S={S}: FLOPs card {card:.6g} "
            f"(aten {run.aten:.6g} + kernel 7 {per_call:.6g} x "
            f"{counts['flash_attention']}) vs meta {meta['flops']:.6g}; "
            f"peak past the arguments meta {step_peak / 1e9:.4f} GB vs card "
            f"rise {rise / 1e9:.4f} GB ({peak_rel:.3g}); counted in "
            f"{count_s:.1f}s; device {ms:.3f} ms vs H100 bound "
            f"{bound_ms:.3f} ms ({by}), roofline_fraction "
            f"{bound_ms / ms:.4f}")
        self.report["dryrun_vs_card"] = {
            "shape": f"B={B} S={S}", "flops_card": card,
            "flops_card_aten": run.aten, "flops_meta": meta["flops"],
            "kernel7_flops_a_call": per_call, "launches": counts,
            "meta_step_peak_bytes": step_peak, "card_rise_bytes": rise,
            "peak_rel": peak_rel, "meta_memory": meta["memory"],
            "hbm_bytes": meta["hbm_bytes"], "count_s": count_s,
            "device_ms": ms, "device_ms_runs": times,
            "bound_ms": bound_ms, "bound_by": by,
            "roofline_fraction": bound_ms / ms, "chip": chip.name}
        self.dryrun_launches = counts["flash_attention"]
        del self.dense_batch, model, batch
        torch.cuda.empty_cache()

    def tp_moe(self):
        """grok-1's tensor-parallel moe_ffn on 8 gloo ranks of the card
        against its one-rank TP-1 function (module docstring, 28b)."""
        torch = self.torch
        from repro_torch.launch import mesh
        from repro_torch.models import moe
        t0 = time.time()
        ranks = mesh.spawn_group(tp_moe_rank, COLLECTIVE_RANKS,
                                 backend="gloo", device=self.dev,
                                 args=(TP_MOE_CASES,))
        log(f"   {COLLECTIVE_RANKS} ranks: {time.time() - t0:.1f}s with the "
            "spawn")
        rep, self.tp_moe_launches = {}, 0
        for i, (mode, layout) in enumerate(TP_MOE_CASES):
            cfg = tp_moe_config(mode)
            tp = layout[1]
            got = [r[i] for r in ranks]
            # every TP row's ranks the same bits
            for r in got:
                self.check(r["sha"] == got[r["data"] * tp]["sha"],
                           f"tp_moe {mode}: rank {r['rank']} differs from "
                           "its row")
            full = tp_moe_weights(cfg, None, self.dev)
            one = dataclasses.replace(cfg, d_ff=cfg.d_ff // tp) \
                if mode in ("ep", "2d") else cfg
            p = moe.tp_fold(full, cfg, tp)
            del full
            errs, tops = [], []
            for i_data in range(layout[0]):
                x = tp_moe_tokens(cfg, i_data, self.dev)
                want, _ = moe.moe_ffn(x, p, one)
                have = got[i_data * tp]["out"].to(self.dev)
                errs.append(float((have.float() - want.float()).abs().max()))
                tops.append(float(want.float().abs().max()))
            del p
            torch.cuda.empty_cache()
            rel = max(errs) / max(tops)
            share = max(r["held_bytes"] for r in got)
            whole = 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * 2
            k2 = [r["kernel2"] for r in got]
            staged = [r["staged"] for r in got]
            us = max(r["us"] for r in got)
            self.tp_moe_launches += sum(k2)
            finite = all(r["finite"] for r in got)
            log(f"   {mode} on {layout}: {rel:.3g} of the largest |output| "
                f"{max(tops):.3g} from TP 1 (limit {TP_MOE_REL}); {us:.0f} "
                f"us a call (slowest rank, median of {TP_MOE_CALLS}); staged "
                f"{max(staged) / 1e6:.1f} MB a rank; kernel 2 {k2[0]} "
                f"launches a rank; a rank holds {share / 1e9:.3f} GB of "
                f"{whole / 1e9:.3f} GB of expert leaves; capacity "
                f"{got[0]['capacity']}")
            self.check(finite and rel <= TP_MOE_REL,
                       f"tp_moe {mode}: {rel} of the largest |output| from "
                       f"TP 1 > {TP_MOE_REL} (finite {finite})")
            self.check(share * tp <= whole,
                       f"tp_moe {mode}: a rank holds {share} B of {whole} B")
            self.check(all(c > 0 for c in k2) == (mode != "2d_full")
                       and all(c == k2[0] for c in k2),
                       f"tp_moe {mode}: kernel 2 launches {k2}")
            rep[mode] = {"layout": layout, "rel": rel, "max_abs_err":
                         max(errs), "top": max(tops), "us": us,
                         "us_ranks": [r["us"] for r in got],
                         "staged_bytes": staged, "kernel2": k2,
                         "held_bytes": share, "whole_bytes": whole,
                         "capacity": got[0]["capacity"]}
        self.report["tp_moe"] = rep

    def timing_dense(self):
        """Kernel 7 and its backward at the dense and kimi-k2 prefill
        shapes (``DENSE_SHAPES``, B = SERVE_B, bfloat16, causal) beside
        their plain versions, their bounds and
        ``scaled_dot_product_attention`` (``enable_gqa=True``, causal) and
        its backward, which compute the same functions there."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa, ref
        F = torch.nn.functional
        self.fa_dense_timing, self.fa_bwd_dense_timing = {}, {}
        for n, (label, (Sq, Skv, heads, causal, window)) in enumerate(
                DENSE_SHAPES):
            q, k, v = self.attn_inputs(SERVE_B, Sq, heads, torch.bfloat16,
                                       seed=70 + n, Skv=Skv)
            do = self.attn_inputs(SERVE_B, Sq, heads, torch.bfloat16,
                                  seed=80 + n, Skv=Skv)[0]
            kernel, k_span = self.med_ms(lambda: fa.flash_attention(
                q, k, v, causal=causal, window=window))
            plain, _ = self.med_ms(lambda: ref.flash_attention(
                q, k, v, causal=causal, window=window), n=20)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            lib, _ = self.med_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
            bound, by = fa_bound_ms(q, k, window, causal)
            flops = attn_flops(q, window, 4, Skv, causal)
            shape = (f"B={SERVE_B} Sq={Sq} Skv={Skv} {heads} "
                     f"{'causal' if causal else 'non-causal'} bfloat16")
            t = {"ms": kernel, "plain_ms": plain, "bound_ms": bound,
                 "bound_by": by, "library_ms": lib, "span_ms": k_span,
                 "tflops": flops / kernel / 1e9,
                 "library_tflops": flops / lib / 1e9,
                 "max_abs_err": self.fa_edge_errs.get(label),
                 "shape": shape}
            self.fa_dense_timing[label] = t
            log(f"   flash_attention {label} {shape}: kernel {kernel:.4f} "
                f"ms ({t['tflops']:.1f} TFLOP/s), plain {plain:.4f}, bound "
                f"{bound:.4f} ({by}), sdpa {lib:.4f} "
                f"({t['library_tflops']:.1f} TFLOP/s)")
            # the backward: causal without a window is fa_bwd_bound_ms'
            # window of Sq
            o, lse = fa.flash_attention(q, k, v, causal=causal,
                                        window=window, return_lse=True)
            kernel, k_span = self.med_ms(lambda: fa.flash_attention_bwd(
                q, k, v, o, lse, do, causal=causal, window=window))
            plain, _ = self.med_ms(lambda: ref.flash_attention_bwd(
                q, k, v, o, lse, do, causal=causal, window=window), n=10)
            lib_out = F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            go = do.transpose(1, 2)
            lib, _ = self.med_ms(lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), go, retain_graph=True), graph=False)
            bound, by = fa_bwd_bound_ms(q, k, window or Sq)
            flops = attn_flops(q, window, 10, Skv, causal)
            t = {"ms": kernel, "plain_ms": plain, "bound_ms": bound,
                 "bound_by": by, "library_ms": lib, "span_ms": k_span,
                 "tflops": flops / kernel / 1e9,
                 "library_tflops": flops / lib / 1e9,
                 "max_abs_err": self.fa_bwd_edge_errs.get(label),
                 "shape": shape}
            self.fa_bwd_dense_timing[label] = t
            log(f"   flash_attention_bwd {label}: kernel {kernel:.4f} ms "
                f"({t['tflops']:.1f} TFLOP/s), plain {plain:.4f}, bound "
                f"{bound:.4f} ({by}), sdpa backward {lib:.4f} "
                f"({t['library_tflops']:.1f} TFLOP/s)")
            del q, k, v, do, o, lse, qt, kt, vt, lib_out, go
            torch.cuda.empty_cache()
        self.report["timing_dense"] = {"forward": self.fa_dense_timing,
                                       "backward": self.fa_bwd_dense_timing}

    def device_profile(self, fn):
        """fn run once unprofiled, then once under torch.profiler: (wall s,
        the profile, its kernels by device time, the device-time getter
        in µs). ``fn`` must end in a synchronize."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        fn()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            fn()
        wall = time.perf_counter() - t0
        cuda = torch.autograd.DeviceType.CUDA
        dev = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                                getattr(e, "self_cuda_time_total", 0))
        kernels = sorted((e for e in prof.key_averages()
                          if getattr(e, "device_type", None) == cuda
                          and dev(e) > 0), key=dev, reverse=True)
        return wall, prof, kernels, dev

    def profile_serve(self, model, batch, n_front=0):
        """Where a model's serve time goes: one wave-1 prefill and one
        decode step (its cache from that prefill, a slot of room; a VLM's
        position after its ``n_front`` patches) under torch.profiler, each
        after one unprofiled call; device busy time against wall and the
        top kernels. Kernel 7's share of the device time is given only
        where the profile holds as many of its launches as its counter
        counted in the profiled call. A diagnostic: it checks nothing."""
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa
        _, cache = model.prefill(batch)
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1))
                 if k in ("k", "v") else v for k, v in cache.items()}
        S = batch["tokens"].shape[1] + n_front
        tok = batch["tokens"][:, -1:]

        def prefill():
            model.prefill(batch)
            torch.cuda.synchronize()

        def decode():
            model.decode(cache, tok, S)
            torch.cuda.synchronize()

        out = {}
        for name, fn in (("prefill", prefill), ("decode", decode)):
            n0 = fa.launches
            wall, prof, kernels, dev = self.device_profile(fn)
            counted = (fa.launches - n0) // 2  # fn ran twice
            busy = sum(dev(e) for e in kernels) / 1e3
            attn = [(e.key[:70], dev(e) / 1e3, e.count) for e in kernels
                    if "flash_attention" in e.key]
            seen = sum(c for _, _, c in attn)
            # the kernel's launches one by one in the trace, beside the
            # averages' count
            events = sum(1 for e in prof.events()
                         if "flash_attention" in e.name
                         and getattr(e, "device_type", None)
                         == torch.autograd.DeviceType.CUDA)
            share = (sum(ms for _, ms, _ in attn) / busy
                     if counted and seen == counted and busy else None)
            out[name] = {"wall_ms": 1e3 * wall, "device_busy_ms": busy,
                         "launches": sum(e.count for e in kernels),
                         "top": [(e.key[:70], dev(e) / 1e3, e.count)
                                 for e in kernels[:8]],
                         "attention": attn,
                         "attention_launches_profiled": seen,
                         "attention_events": events,
                         "attention_launches_counted": counted,
                         "attention_share": share}
            log(f"   profiled {name} (B={batch['tokens'].shape[0]}, S={S}): "
                f"{busy:.1f} ms device busy in {1e3 * wall:.1f} ms wall, "
                f"{out[name]['launches']} launches")
            for kname, ms, cnt in out[name]["top"]:
                log(f"      {ms:9.2f} ms x{cnt:<5d} {kname}")
            for kname, ms, cnt in attn:
                log(f"      attention {ms:.2f} ms x{cnt} {kname}")
            log(f"      kernel 7: {seen} launches in the profile's "
                f"averages, {events} in its events, {counted} counted; "
                + (f"{100 * share:.1f}% of the device time" if share
                   is not None else "no share read (the profile is short "
                   "of launches)" if counted else "not on this path"))
        return out

    def profile_train_step(self, model, batch):
        """Where a training step's device time goes: one forward + backward
        of the trained full-depth model on one batch under torch.profiler
        (after one unprofiled), device time summed by kernel name. The last
        step's gradients stay with the compression phase. A diagnostic: it
        checks nothing."""
        torch = self.torch

        def step():
            for p in model.parameters():
                p.grad = None
            model.loss(batch)[0].backward()
            torch.cuda.synchronize()

        wall, prof, kernels, dev = self.device_profile(step)
        for p in model.parameters():
            p.grad = None
        cuda = torch.autograd.DeviceType.CUDA
        busy_ms = sum(dev(e) for e in kernels) / 1e3
        attn = {e.key: (dev(e) / 1e3, e.count) for e in kernels
                if "flash_attention" in e.key or "attn_bwd" in e.key}
        # the operators that launched them, by input shape: each one's
        # own device time (its kernels', not its children's)
        ops = sorted((e for e in prof.key_averages(group_by_input_shape=True)
                      if getattr(e, "device_type", None) != cuda
                      and dev(e) > 0), key=dev, reverse=True)
        out = {"wall_ms": 1e3 * wall, "device_busy_ms": busy_ms,
               "launches": sum(e.count for e in kernels),
               "attention_ms": attn,
               "top": [(e.key[:70], dev(e) / 1e3, e.count)
                       for e in kernels[:12]],
               "top_ops": [(e.key, str(e.input_shapes)[:160], dev(e) / 1e3,
                            e.count) for e in ops[:16]]}
        log(f"   profiled forward + backward: {busy_ms:.1f} ms device busy "
            f"in {1e3 * wall:.1f} ms wall, {out['launches']} launches")
        for name, ms, cnt in out["top"]:
            log(f"      {ms:9.2f} ms x{cnt:<5d} {name}")
        log("   top operators by their own device time, with input shapes:")
        for name, shapes, ms, cnt in out["top_ops"]:
            log(f"      {ms:9.2f} ms x{cnt:<5d} {name} {shapes}")
        for name, (ms, cnt) in attn.items():
            log(f"      attention {ms:.2f} ms x{cnt} {name[:70]}")
        self.report["train_step_profile"] = out

    def profile_steps(self, n_steps=200):
        """Where an engine step's time goes on leonardo/256/incast: host
        wall per step, device busy time per step (torch.profiler), and the
        kernels that take it. A diagnostic: it checks nothing."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core.fabric import simulator as sim
        _, geom, p = self.grid_case("leonardo", 256, "ring_allgather",
                                    "incast")
        state = sim.init_state(geom, p)
        consts = sim.run_constants(p)

        def run(n):
            nonlocal state
            t0 = time.perf_counter()
            for _ in range(n):
                state, _ = sim._step_impl(geom, p, state, False,
                                          consts=consts)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        run(20)
        wall_plain = run(n_steps)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run(n_steps)
        cuda = torch.autograd.DeviceType.CUDA
        dev = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                                getattr(e, "self_cuda_time_total", 0))
        kernels = sorted((e for e in prof.key_averages()
                          if getattr(e, "device_type", None) == cuda
                          and dev(e) > 0), key=dev, reverse=True)
        busy_us = sum(dev(e) for e in kernels)
        launches = sum(e.count for e in kernels)
        out = {"steps": n_steps,
               "wall_ms_per_step": 1e3 * wall_plain / n_steps,
               "wall_ms_per_step_profiled": 1e3 * wall / n_steps,
               "device_busy_ms_per_step": busy_us / 1e3 / n_steps,
               "device_idle_share": 1 - busy_us / 1e6 / wall_plain,
               "device_kernels_per_step": launches / n_steps,
               "top": [(e.key[:60], dev(e) / n_steps, e.count // n_steps)
                       for e in kernels[:8]]}
        log(f"   leonardo/256/incast engine step: "
            f"{out['wall_ms_per_step']:.3f} ms wall "
            f"({out['wall_ms_per_step_profiled']:.3f} profiled), "
            f"{out['device_busy_ms_per_step']:.4f} ms device busy, idle "
            f"share {out['device_idle_share']:.3f}, "
            f"{out['device_kernels_per_step']:.0f} kernels/step")
        for name, us, cnt in out["top"]:
            log(f"      {us:9.2f} us/step x{cnt:<3d} {name}")
        self.report["profile"] = out


def collective_inputs():
    """Each schedule's global input (rank r's shard at [r]) at the
    collective bench's 2 MiB vector (collective_microbench): 65,536
    float32 a rank's shard, (8, 8,192) a rank's reduce and all-to-all
    buffer; and a 2**20-element leaf a rank for the compressed mean,
    its rows at scales 1e-3 to 1e2 and one all-zero block."""
    import numpy as np
    n, d = COLLECTIVE_RANKS, COLLECTIVE_VECTOR // 4 // COLLECTIVE_RANKS
    rng = np.random.default_rng(11)
    c = rng.standard_normal((n, 1 << 20), np.float32) * (
        np.float32(10.0) ** rng.integers(-3, 3, (n, 1)))
    c[:, :256] = 0
    return {"x": rng.standard_normal((n, d), np.float32),
            "y": rng.standard_normal((n, n, d // n), np.float32),
            "z": rng.standard_normal((n, n, d // n), np.float32),
            "w": rng.standard_normal((n, d), np.float32),
            "c": c.astype(np.float32)}


def _ring_order_sum(y, r):
    """Rank r's chunk of a ring reduce-scatter of y (n, n, d), in the
    schedule's order: starting at rank r + 1, each next rank adds its
    chunk r, ending at rank r; float32 throughout."""
    n = y.shape[0]
    acc = y[(r + 1) % n, r].copy()
    for s in range(2, n + 1):
        acc = acc + y[(r + s) % n, r]
    return acc


def collective_rank(ctx, sizes):
    """One rank of the collectives phase (``launch.mesh.spawn_group``):
    every schedule on this rank's shards on the card, the ring's add
    through kernel 2 with its launches counted, ``compressed_psum_mean``
    through kernels 3/4 and through their plain versions, the bytes
    staged through the host; then ``pt_collective_bench``'s timings."""
    import torch
    from benchmarks import pt_collective_bench as cb
    from repro_torch.core import collectives as C
    from repro_torch.kernels import fused_reduce as fr, quant as qt
    from repro_torch.optim.compression import compressed_psum_mean
    t0 = time.time()
    t = {k: torch.as_tensor(v[ctx.rank], device=ctx.device)
         for k, v in collective_inputs().items()}
    C.staged_bytes = 0
    out = {"ring_ag": C.ring_all_gather(t["x"]),
           "bidir_ring_ag": C.ring_all_gather(t["x"], bidirectional=True),
           "ring_rs": C.ring_reduce_scatter(t["y"]),
           "ring_ar": C.ring_all_reduce(t["y"]),
           "a2a_linear": C.linear_all_to_all(t["z"]),
           "a2a_pairwise": C.pairwise_all_to_all(t["z"]),
           "incast": C.incast_gather(t["w"], root=0)}
    fr.launches = 0
    out["ring_rs_kernel2"] = C.ring_reduce_scatter(t["y"], add=C.fused_add)
    k2 = fr.launches
    qt.launches = qt.dq_launches = 0
    out["compressed"] = compressed_psum_mean(t["c"])
    quant = (qt.launches, qt.dq_launches)
    out["compressed_plain"] = compressed_psum_mean(t["c"], core="plain")
    staged = C.staged_bytes
    out = {k: v.cpu().numpy() for k, v in out.items()}
    t1 = time.time()
    counts = {"kernel2": k2, "quant": quant, "staged_bytes": staged,
              "bench": cb.bench_rank(ctx, sizes),
              "times": (t0, t1, time.time())}
    return out, counts


def tp_moe_config(mode):
    """grok-1's config with ``moe_sharding`` = mode, bfloat16."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("grok-1-314b"), moe_sharding=mode)


def tp_moe_block(key, shape, std, device):
    """A standard normal block times ``std``, bfloat16, drawn on
    ``device`` from TP_MOE_SEED and ``key``."""
    import zlib
    import torch
    g = torch.Generator(device=device).manual_seed(
        TP_MOE_SEED * 1_000_003 + zlib.crc32(repr(key).encode()))
    return (torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32) * std).to(torch.bfloat16)


def tp_moe_weights(cfg, cut, device):
    """The MoE leaves (router whole; w1, w3 (E', d, f'), w2 (E', f', d))
    built from blocks keyed by (leaf, expert, column block): ``cut``
    (``moe.rank_slices``) keeps one rank's experts and f-blocks, ``None``
    all of them."""
    import numpy as np
    import torch
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    out_std = 0.02 / np.sqrt(2 * max(cfg.n_layers, 1))
    e_cut, f_cut = (cut["w1"][0], cut["w1"][2]) if cut else (
        slice(0, E), slice(0, f))
    blocks = range(f_cut.start // TP_MOE_BLOCK, f_cut.stop // TP_MOE_BLOCK)
    p = {"router": tp_moe_block(("router",), (d, E), 0.02, device)}
    for leaf, std in (("w1", 0.02), ("w3", 0.02), ("w2", out_std)):
        cat = 0 if leaf == "w2" else 1
        shape = (TP_MOE_BLOCK, d) if leaf == "w2" else (d, TP_MOE_BLOCK)
        p[leaf] = torch.stack([torch.cat(
            [tp_moe_block((leaf, e, b), shape, std, device) for b in blocks],
            dim=cat) for e in range(e_cut.start, e_cut.stop)])
    return p


def tp_moe_tokens(cfg, data_index, device):
    """Data shard ``data_index``'s (1, TP_MOE_TOKENS, d) bfloat16 tokens."""
    return tp_moe_block(("x", data_index), (1, TP_MOE_TOKENS, cfg.d_model),
                        1.0, device)


def tp_moe_rank(ctx, cases):
    """One rank of tp_moe: every case on its layout's subgroups (all made
    on every rank, in one order), its share of the leaves drawn here; the
    launch counts and staged bytes read around the checked call, then the
    wall of TP_MOE_CALLS more calls. Returns per case the rank's output
    (model index 0 only) and its sha256, the counts and times."""
    import hashlib
    import torch
    import torch.distributed as dist
    from repro_torch.core import collectives
    from repro_torch.kernels import fused_reduce
    from repro_torch.models import moe
    from repro_torch.models.layers import RankGroups
    from repro_torch.launch import mesh
    layouts = {}
    for layout in sorted({c[1] for c in cases}):
        layouts[layout] = mesh.layout_groups(layout, ctx.rank)
    out = []
    for mode, layout in cases:
        coords, row, col = layouts[layout]
        cfg = tp_moe_config(mode)
        rules = mesh.rules_for(cfg, mesh.RankLayout(("data", "model"),
                                                     layout))
        p = tp_moe_weights(cfg, moe.rank_slices(cfg, rules, coords),
                           ctx.device)
        x = tp_moe_tokens(cfg, coords["data"], ctx.device)
        groups = RankGroups(dp=col, ep=col, tp=row)
        torch.cuda.synchronize()
        dist.barrier()
        st0, k0 = collectives.staged_bytes, fused_reduce.launches
        o, _ = moe.moe_ffn(x, p, cfg, rules=rules, groups=groups)
        torch.cuda.synchronize()
        staged = collectives.staged_bytes - st0
        k2 = fused_reduce.launches - k0
        times = []
        for _ in range(TP_MOE_CALLS):
            dist.barrier()
            t0 = time.perf_counter()
            moe.moe_ffn(x, p, cfg, rules=rules, groups=groups)
            torch.cuda.synchronize()
            times.append(1e6 * (time.perf_counter() - t0))
        host = o.cpu()
        out.append({
            "rank": ctx.rank, "data": coords["data"],
            "out": host if coords["model"] == 0 else None,
            "sha": hashlib.sha256(host.view(torch.int16).numpy()
                                  .tobytes()).hexdigest(),
            "finite": bool(torch.isfinite(host.float()).all()),
            "staged": staged, "kernel2": k2,
            "us": sorted(times)[len(times) // 2],
            "held_bytes": sum(p[k].numel() * p[k].element_size()
                              for k in moe.EXPERT_LEAVES),
            "capacity": moe.capacity(x.shape[0] * x.shape[1], cfg)})
        del p, x, o
        torch.cuda.empty_cache()
    return out


def bits_equal(torch, a, b):
    """Bit for bit, NaN payloads included."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.contiguous().view(as_int), b.contiguous().view(as_int)
    return bool(torch.equal(a, b))


def cell_args(args, b):
    """Kernel 1's operands of cell b alone (B = 1): per-cell rows sliced,
    geometry rows shared by the batch (1-D) kept."""
    return tuple(a[b:b + 1] if i not in (2, 6, 7, 8) or a.dim() == 2
                 else a for i, a in enumerate(args))


def leaf_tol(name, dt, ndim):
    """(atol, rtol) of a state or aux leaf in the lock-step check: bytes
    and rates at §13 (atol 1.0, rtol 2e-4); times at rtol 2e-4 and an atol
    of a thousandth of the cell's step (the delay integral qd_acc at that
    times dt); integers and flags exact."""
    dt = dt.double().view(-1, *[1] * (ndim - 1))
    if name in INT_LEAVES:
        return 0.0, 0.0
    if name in SECONDS_LEAVES:
        return 1e-3 * dt, FS_TOL["rtol"]
    if name == "qd_acc":
        return 1e-3 * dt * dt, FS_TOL["rtol"]
    return FS_TOL["atol"], FS_TOL["rtol"]


def bound_ms(args, kw):
    """Least time for one launch: every input read once, every output
    written once, over HBM bandwidth; or its float operations over the
    FP32 peak. The larger bounds it."""
    plinks, inject = args[0], args[1]
    B, F, H = plinks.shape
    L1 = args[4].shape[1]
    n_sw = kw["n_sw"]
    read = sum(a.numel() * a.element_size() for a in args)
    written = 4 * (2 * B * F + 3 * B * L1)
    flops = B * (5 * F + 8 * L1 + 5 * n_sw + H * (2 * F + 3 * L1) + 6 * L1)
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def fr_bound_ms(acc, x):
    """Least time for one fused accumulate: acc and x read once, out
    written once, over HBM bandwidth; or its two float operations per
    element over the FP32 peak. The larger bounds it."""
    n = acc.numel()
    t_bytes = n * (2 * acc.element_size() + x.element_size()) \
        / HBM_BYTES_PER_S
    t_ops = 2 * n / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def live_pairs(Sq, Skv, causal, window):
    """Live (query, key) pairs of one head: key j < Skv, j <= i when
    causal, j > i - window when ``window`` > 0."""
    import numpy as np
    i = np.arange(Sq)
    hi = np.minimum(i + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(i - window + 1, 0) if window else 0
    return int(np.maximum(hi - lo, 0).sum())


def fa_bound_ms(q, k, window, causal=True):
    """Least time for one attention launch: q, k, v read once and o
    written once over HBM bandwidth; or 4 * D flops per live (query,
    key) pair (``live_pairs``) over the bf16 tensor-core peak. The larger
    bounds it."""
    t_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        / HBM_BYTES_PER_S
    t_ops = attn_flops(q, window, 4, k.shape[1], causal) / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def attn_flops(q, window, per_d, Skv=None, causal=True):
    """``per_d`` * D flops per live (query, key) pair (``live_pairs``;
    causal with Skv = S by default) of attention over q (B, S, H, D): 4
    for the forward, 10 for the backward (the flops the bounds count)."""
    B, S, H, D = q.shape
    return per_d * D * live_pairs(S, Skv or S, causal, window) * B * H


def scan_bound_ms(args, n_sm, clock_hz):
    """Least time for one scan launch: every input read once and y, h_T
    written once over HBM bandwidth; or its exponentials, one per state
    per step, over the special-function units' rate (16 per SM per
    clock). The larger bounds it."""
    dt, A, Bc, Cc, x, h0 = args
    read = sum(a.numel() * a.element_size() for a in args)
    written = 4 * (dt.numel() + h0.numel())
    t_bytes = (read + written) / HBM_BYTES_PER_S
    exps = dt.numel() * A.shape[1]
    t_ops = exps / (SFU_EXP_PER_SM_CLOCK * n_sm * clock_hz)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def scan_bwd_bound_ms(args, n_sm, clock_hz):
    """Least time for one backward of the scan: dt, A, B, C, x, h0, dy and
    dh_T read once and the six gradients (d_x in x's type) written once
    over HBM bandwidth; or its exponentials, one per state per step, over
    the special-function units' rate. The larger bounds it."""
    dt, A, Bc, Cc, x, h0, dy, dh_T = args
    read = sum(a.numel() * a.element_size() for a in args)
    written = sum(a.numel() * a.element_size()
                  for a in (dt, A, Bc, Cc, x, h0))
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = dt.numel() * A.shape[1] / (SFU_EXP_PER_SM_CLOCK * n_sm
                                       * clock_hz)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def quant_bound_ms(n, quantize: bool):
    """Least time for one quantize (dequantize) of n float32 elements: x
    read and q, scales written (or the reverse) over HBM bandwidth; or its
    few operations per element over the FP32 peak. The larger bounds it."""
    t_bytes = n * (4 + 1 + 4 / 256) / HBM_BYTES_PER_S
    t_ops = (3 if quantize else 1) * n / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def state_scan_bound_ms(dA):
    """Least time for one kernel-5 launch: dA, dBx and h0 read once, hs
    and h_T written once, over HBM bandwidth; or its two float operations
    per state per step over the FP32 peak. The larger bounds it."""
    B, T, Di, N = dA.shape
    t_bytes = 4 * (3 * dA.numel() + 2 * B * Di * N) / HBM_BYTES_PER_S
    t_ops = 2 * dA.numel() / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def fa_bwd_bound_ms(q, k, window):
    """Least time for one attention backward: q, k, v, o, dO and lse read
    once and dq, dk, dv written once over HBM bandwidth; or the five D-long
    products per live (query, key) pair -- the recomputed score, dO . V,
    and the dV, dK and dQ updates, 10 * D flops -- over the bf16
    tensor-core peak. The larger bounds it."""
    import numpy as np
    B, S, H, D = q.shape
    live = int(np.minimum(np.arange(S) + 1, window).sum())  # keys per head
    t_bytes = ((4 * q.numel() + 4 * k.numel()) * q.element_size()
               + 4 * B * H * S) / HBM_BYTES_PER_S
    t_ops = 10 * D * live * B * H / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: src/repro_torch not found beside {__file__}",
              file=sys.stderr)
        return 2
    s = Smoke(torch)
    s.phase("device", s.device)
    s.phase("build", s.build)
    if s.failures:
        log("\n".join(s.failures))
        return 1
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    procs = []
    try:
        procs = s.start_groups(workdir)
        for name, fn in (("kernel_vs_plain", s.kernel_vs_plain),
                         ("fused_accumulate_vs_plain", s.fr_vs_plain),
                         ("lockstep", s.lockstep),
                         ("fleet_kernel", s.fleet_kernel_checks)):
            s.phase(name, fn)
        s.join_groups(procs)
    finally:
        for _, _, pr, _ in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        shutil.rmtree(workdir, ignore_errors=True)
    for name, fn in (("fleet_share", s.fleet_share),
                     ("timing", s.timing),
                     ("engine_graph", s.engine_graph),
                     ("flash_attention_vs_plain", s.fa_vs_plain),
                     ("selective_scan_vs_plain", s.scan_vs_plain),
                     ("lm_vs_jax", s.lm_vs_jax), ("serve", s.serve),
                     ("timing_lm", s.timing_lm),
                     ("quant_vs_plain", s.quant_vs_plain),
                     ("ssm_scan_vs_plain", s.ssm_scan_vs_plain),
                     ("selective_scan_bwd_vs_plain", s.scan_bwd_vs_plain),
                     ("flash_attention_bwd_vs_plain", s.fa_bwd_vs_plain),
                     ("train_vs_jax", s.train_vs_jax), ("train", s.train),
                     ("compression", s.compression),
                     ("timing_train", s.timing_train),
                     ("collectives", s.collectives),
                     ("moe_vs_jax", s.moe_vs_jax),
                     ("serve_moe", s.serve_moe),
                     ("timing_moe", s.timing_moe),
                     ("encdec_vs_jax", s.encdec_vs_jax),
                     ("serve_encdec", s.serve_encdec),
                     ("serve_vlm", s.serve_vlm),
                     ("timing_encdec", s.timing_encdec),
                     ("dense_vs_jax", s.dense_vs_jax),
                     ("serve_dense", s.serve_dense),
                     ("serve_kimi", s.serve_kimi),
                     ("dryrun_vs_card", s.dryrun_vs_card),
                     ("tp_moe", s.tp_moe),
                     ("timing_dense", s.timing_dense)):
        s.phase(name, fn)
    try:  # diagnostic only: a profiler problem fails no check
        s.profile_steps()
    except Exception:
        log(f"profile diagnostic unavailable:\n{traceback.format_exc()}")
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    s.report["failures"] = s.failures
    with open(REPORT, "w") as f:
        json.dump(s.report, f, indent=1, default=str)
    if s.failures:
        log(f"chip_smoke: {len(s.failures)} failure(s)")
        return 1
    t = s.timings[MAIN_SHAPE]
    t2 = s.fr_timings[str(MAIN_TILE)]
    tt = s.train_timing
    pick = lambda d: {k: d[k] for k in (  # noqa: E731
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    wide = {label: {k: s.timings[label][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by")}
        for label, *_ in WIDE_SHAPES}
    large = {k: s.timings[LARGE_LABEL][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by")}
    print(json.dumps({"kernels": [{
        **KERNEL, "launches": s.main_launches, "max_abs_err": s.main_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "fig7_fig8_launches": s.fig78_launches,
        "scenarios_launches": s.scen_launches,
        "fleet_launches": s.fleet_launches,
        "mitigation_launches": s.mitigation_launches,
        "whatif_launches": s.whatif_launches,
        "sweep_launches": s.sweep_launches,
        "fleet_shapes": {label: {k: s.timings[label][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")}
            for label in ("fleet quick bucket", "fleet full bucket")},
        "fleet_max_abs_err": s.fleet_err,
        "whatif_max_abs_err": s.whatif_err,
        "fault_caps_max_abs_err": s.fault_err, "wide_shapes": wide,
        "large_shape": {"label": LARGE_LABEL, **large,
                        "launches": s.large_launches,
                        "max_abs_err": s.large_err}}, {
        **KERNEL2, "launches": s.fr_path_launches,
        "max_abs_err": s.fr_main_err, "ms": t2["ms"],
        "plain_ms": t2["plain_ms"], "bound_ms": t2["bound_ms"],
        "bound_by": t2["bound_by"], "library_ms": t2["library_ms"],
        "collectives_launches": s.collective_launches["fused_accumulate"],
        "tp_moe_launches": s.tp_moe_launches}, {
        **KERNEL7, "launches": s.serve_launches["flash_attention"],
        "max_abs_err": s.fa_main_err, **pick(s.fa_timing),
        "library_shape": f"B={SERVE_B} S={HYMBA_WINDOW} bfloat16",
        "ms_at_library_shape": s.fa_timing["ms_at_1024"],
        "tflops": s.fa_timing["tflops"],
        "sm90_launches": s.serve_launches["flash_attention_sm90"],
        "train_launches": s.train_launches["flash_attention"],
        "serve_moe_launches": s.serve_moe_launches["flash_attention"],
        "serve_moe_sm90_launches":
            s.serve_moe_launches["flash_attention_sm90"],
        "grok_serve_shape": {**pick(s.fa_grok_timing),
                             "shape": s.fa_grok_timing["shape"],
                             "tflops": s.fa_grok_timing["tflops"],
                             "max_abs_err": s.fa_grok_err},
        "serve_encdec_launches": s.serve_encdec_launches["flash_attention"],
        "serve_encdec_sm90_launches":
            s.serve_encdec_launches["flash_attention_sm90"],
        "serve_vlm_launches": s.serve_vlm_launches["flash_attention"],
        "serve_vlm_sm90_launches":
            s.serve_vlm_launches["flash_attention_sm90"],
        "encdec_shapes": {label: {**pick(t), "shape": t["shape"],
                                  "tflops": t["tflops"],
                                  "max_abs_err": t["max_abs_err"]}
                          for label, t in s.fa_encdec_timing.items()},
        "serve_dense_launches": {
            arch: {k: c[k] for k in ("flash_attention",
                                     "flash_attention_sm90")}
            for arch, c in s.serve_dense_launches.items()},
        "serve_kimi_launches": s.serve_kimi_launches["flash_attention"],
        "dryrun_vs_card_launches": s.dryrun_launches,
        "serve_kimi_sm90_launches":
            s.serve_kimi_launches["flash_attention_sm90"],
        "dense_shapes": {label: {**pick(t), "shape": t["shape"],
                                 "tflops": t["tflops"],
                                 "max_abs_err": t["max_abs_err"]}
                         for label, t in s.fa_dense_timing.items()}}, {
        **KERNEL6, "launches": s.serve_launches["fused_selective_scan"],
        "max_abs_err": s.scan_main_err, **pick(s.scan_timing),
        "ms_at_train_shape": s.scan_timing["ms_at_train_shape"],
        "train_launches": s.train_launches["fused_selective_scan"]}, {
        **KERNEL6B, "launches": s.train_launches["fused_selective_scan_bwd"],
        "max_abs_err": s.scan_bwd_main_err,
        **pick(tt["fused_selective_scan_bwd"])}, {
        **KERNEL3, "launches": s.compression_launches["quantize_int8"],
        "max_abs_err": s.quant_main_err,
        **pick(tt["quantize_int8"]),
        "collectives_launches": s.collective_launches["quantize_int8"]}, {
        **KERNEL4, "launches": s.compression_launches["dequantize_int8"],
        "max_abs_err": s.quant_main_err,
        **pick(tt["dequantize_int8"]),
        "collectives_launches": s.collective_launches["dequantize_int8"]}, {
        **KERNEL5, "launches": s.train_launches["ssm_scan"],
        "max_abs_err": s.state_scan_err, **pick(tt["ssm_scan"]),
        "reverse_ms": tt["ssm_scan_reverse"]["ms"],
        "note": "on no model path: training runs fused_selective_scan_bwd; "
                "launched and timed here only against its plain version"}, {
        **KERNEL7B, "launches": s.train_launches["flash_attention_bwd"],
        "max_abs_err": s.fa_bwd_main_err, **pick(tt["flash_attention_bwd"]),
        "library_shape": tt["flash_attention_bwd"]["library_shape"],
        "ms_at_library_shape":
            tt["flash_attention_bwd"]["ms_at_library_shape"],
        "tflops": tt["flash_attention_bwd"]["tflops"],
        "sm90_launches":
            s.train_launches["flash_attention_bwd_sm90"],
        "dense_shapes": {label: {**pick(t), "shape": t["shape"],
                                 "tflops": t["tflops"],
                                 "max_abs_err": t["max_abs_err"]}
                         for label, t in s.fa_bwd_dense_timing.items()}}]}))
    print(s.smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
