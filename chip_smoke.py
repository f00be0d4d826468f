#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, in the order they run; any failure exits non-zero before the
result line:
  1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` (all five
     sources, one nvcc per source, in parallel) into ``build/repro_torch/``;
  2. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes (Lloyd also with rows of only 2 of the 10
     classes, as a client holds them, so 80 of 100 slots are masked), at
     ragged ones and at the edges of the K-means row plan (N below a
     block's rows and one past whole blocks, K x D past the resident
     budget, D wide enough for column chunks, K = 1, every row masked,
     D % 4 != 0 off 16-byte bases; the kernel's shared-memory layout
     checked against the plan's) (Lloyd assign equal except at near-ties,
     sums/mindist/distances within 2e-3), and check that a Lloyd sweep
     gives the same bits twice and that its sums are, bit for bit, the
     ascending-row f32 sum of its own assignment; quantize byte-exact,
     codes and (xmin, scale), against the plain version on the card and
     on the CPU, one launch a call on the planned route: the main path's
     slots at 80 and at 20 of 100 rows valid, ragged, all masked,
     constant, NaN / +inf / -inf in a valid row, NaN in a masked row, a
     zero minimum of both signs, -0.0 only in a masked row, a
     payload past the resident budget (the L2 route), D % 4 != 0 off a
     16-byte base, N = 1, N = 1037, N = 0, D = 0, and both routes equal
     at one shape; the cohort entry (``quantize_affine_batched``), one
     launch a call, byte-exact per client against the plain version on
     the card and on the CPU: the main path's cohort (4 x 100 x 16384, 20
     of 100 rows valid each), mixed masks (a client all masked, one with
     NaN), B = 1, and more clients than SMs at a small D (the L2 route);
 2b. hold both attention kernels against their plain versions on the card
     (f32 within 2e-3, bf16 within 2e-2): llama3.2-1b's heads (H=32, KV=8,
     D=64) causal at S=1024 in bf16 and f32, ragged non-causal S=1000, a
     window of 128, MQA, gemma3's D=256 with window 1024; the tensor-core
     route's edges (S below one key tile, qwen2-0.5b's G=7 at an S that is
     no multiple of the tile, D=128 and D=256 with a window, D=96 and D=32
     that fill part of a 64-column panel, bf16 D=72 on the CUDA cores,
     qwen3-moe's 32/4 and phi3's 40/10 heads at D=128, MLA's D=192 in
     bf16 and f32), each case counted
     on the route its dtype and D pick; decode at S=32768 with 40 valid
     slots, at ragged S=300, with G=1, with G=7, at D=36 (element-wise
     loads), qwen3-moe's heads at its serve shape (batch 4, 32,768 slots)
     and phi3's at batch 4 over 4,096, MLA's D=192 (G=1), with each (q,
     cache) dtype pair, and with 1, 2 and many splits of S (the split
     count checked against the plan), one many-split case run twice and
     compared bit for bit; the
     prefill kernel's softmax statistics (lse, (B,H,S) f32) on the route
     each case takes, against the plain version's, the output unchanged
     bit for bit by asking for them, and the backward kernels (dq, dk, dv)
     against ``ref.flash_attention_bwd_ref`` fed the same inputs and
     statistics (``BWD_CASES``: llama3.2-1b's heads causal at S=1024 in
     bf16 and f32, S=1000 non-causal, a window of 128, MQA, qwen2-0.5b's
     G=7, gemma3's D=256 with window 1024, S below one tile, D=96, D=32,
     bf16 D=72, phi3's D=128 with a window, G=7 non-causal with a window,
     bf16 D=96, G=64, MLA's bf16 D=192), each on the route ``bwd_route``
     names (by the
     wrapper's count by route), three cases (two on the tensor cores, one
     on the CUDA cores) twice, bit for bit; then the backward at a key
     length Sk unlike S (``BWD_CROSS_CASES``: whisper's cross layer, S 300
     over Sk 1,500, in bf16 and f32, S 2,000 over 1,500, Sk 7 below one
     key tile, Sk 1,000 at D 128 with G 4, D 96 in f32) and whisper's
     encoder layer (S = Sk = 1,500, non-causal, bf16), each on the route
     ``bwd_route`` names and counted under its lengths, within ATT_TOL
     and ROW_REL_TOL of the plain version, one case a route twice bit for
     bit, and a causal or windowed call at Sk != S must raise;
  3. one round of a small WRN-10-1 on the card and on the CPU from the same
     seed: the ledger and the metadata count must be equal and the new
     weights agree to 2e-3;
 3b. a reduced llama3.2-1b in f32 on the card and on the CPU from the same
     parameters: one prefill of S=64 and 8 teacher-forced decode steps,
     logits within 2e-3;
 3c. two fresh ``FLSimulation`` runs of two rounds of the small WRN-10-1
     from one seed: weights, ledger, decoded selections, accuracies and
     Lloyd sweeps bit-identical;
 3d. the cohort engine against the client-by-client loop on the card: two
     rounds of the small WRN-10-1 (4 clients), then both again under a
     ``FaultPlan`` with crashes, bit flips, truncations and duplicates
     (checksums on): weights, ledger, decoded selections, accuracies and
     fault log bit-identical;
  4. drive the main path: ``FLSimulation`` for 2 rounds at the full width
     of WRN-40-1 (32x32x3 inputs, split after group 1 -> 16x32x32 maps,
     D = 16384), 4 clients x 2,500 samples of 2 classes, P = 200, 10
     clusters per class, 25 Lloyd iterations, the int8 codec. Launch
     counters are zeroed just before and read just after; every kernel
     must have launched, quantize once per upload (8);
 4b. the same run with ``distributed_selection=True`` (the cohort engine):
     weights, ledger, metadata counts, Lloyd sweeps and accuracies
     bit-identical to phase 4's; the cohort quantize launched once a round
     (2) and the per-client quantize never;
  7. the async service (``repro_torch.fl.service.FLService``) at phase 4's
     full width: 7a, ``DegenerateTraffic`` with a buffer of 4 for 2 ticks,
     bit-identical to phase 4's ``FLSimulation`` (weights, ledger,
     accuracies, |D_M|, K-means and quantize launches; staleness 0); 7b,
     Poisson arrivals (rate 2, uploads delayed up to 2 ticks), a buffer
     of 2, 4 ticks and a drain, traced: the arrivals and deferred uploads
     are the host ``PoissonTraffic`` schedule, staleness accrues and a
     flush is weighted; 7c, 7a again with ``observability=True``: the
     same bits, no unattributed byte, attributed bytes equal to the
     ledger's, one ``kernel.*`` span a launch, the trace written under
     ``build/`` and loaded back (span paths, tracing overhead); 7d,
     ``python -m repro_torch.launch.serve_fl --ticks 2 --sync-check`` in
     its own process must exit 0;
  8. the rest of selection, the checkpoint and the paper driver at phase
     4's full width: 8a, phase 4's run with ``pca_solver="randomized"``
     (every K-means kernel launched, quantize 8 times, W_G finite,
     metadata counts in range; the round walls; one client's PCA ms,
     randomized against exact, by CUDA events), then one client's
     randomized selection on the card against the CPU with the same test
     matrix and first centres (valid equal, >= 99% of the indices equal,
     each mismatch a near-tie) and its agreement with the exact one,
     printed; 8b, on phase 4's client maps, the all-rows path
     (``per_class=False``, K = 100) on the card against the CPU at the
     same level, ``select_metadata_batched`` over the 4 stacked clients
     against 4 single calls bit for bit, and the seed oracle
     (``select_metadata_reference``) against ``select_metadata``, >= 99%
     of the indices equal, with the K-means launches of each; 8c, phase
     4's W_G through ``CheckpointManager`` under ``build/`` (the
     reference's tree) and back onto the card bit for bit, a bf16 / int
     tree too, and ``python -m repro_torch.launch.paper_repro --full-wrn
     --rounds 2 --clients 4 --samples-per-client 2500`` in its own
     process: exit 0, the reference driver's JSON keys, and a checkpoint
     that restores into WRN-40-1's tree.
  6. serve llama3.2-1b at full width (16 layers, d_model 2048, 32 heads /
     8 KV, d_ff 8192, vocab 128,256; random weights from seed 0) in bf16:
     ``repro_torch.launch.serve`` decodes batch 32 against a 32,768-slot
     cache (prompt 32 teacher-forced, 16 new tokens), then one
     ``make_prefill_step`` call at S=32,768, batch 1. Launch counters are
     zeroed before and read after each: flash_decode must launch
     16 x (32 - 1 + 16) = 752 times, flash_attention 16; logits finite;
     then one prefill call and one decode step at those shapes under
     torch.profiler (device busy share, top kernels by device time);
  9. the federated LM training path: 9a, ``make_train_step`` at the full
     width of llama3.2-1b (f32 master weights from seed 0, bf16 compute,
     remat) on ``train_4k``'s 4,096-token sequences, G = 2 cohorts, 2
     local steps of one microbatch of 4, 2 clusters and 2 meta-training
     steps (the global batch cut 256 -> 16: ``TRAIN_*``), two rounds from
     numpy-seeded tokens: losses finite, every leaf moved, the cohorts
     bit-equal, ``selected`` <= G x clusters, round 1 replayed from the
     same state bit for bit, and the launches of the forward and backward
     attention kernels and of pairwise and Lloyd equal to the counts
     reckoned from the shapes (remat runs each layer's forward twice under
     grad), every backward on the tensor-core route; the round walls,
     tokens/s, peak memory, one profiled round (device busy share, top
     kernels, the attention kernels' device ms a launch), and the backward
     kernels at one layer's shape beside their plain version, SDPA's
     backward, their bound and the f32 backward (the CUDA-core route) at
     the same shape; 9b, a reduced-width
     f32 step on the card and on the CPU from the same parameters and
     draws (weights and metrics within 2e-3); 9c, ``python -m
     repro_torch.launch.train --smoke --steps 2 --ckpt-dir
     build/phase9_ckpt`` in its own process (exit 0; its checkpoint
     restores to the bits of the same run in this process); 9d, ``python
     -m repro_torch.launch.federated_lm --rounds 3`` in its own process
     (exit 0, its lines printed);
 10. serve the MoE and phi3 at full width: 10a, qwen3-moe-30b-a3b at full
     width and depth (48 layers, d_model 2048, 32 / 4 heads, head_dim 128,
     128 experts of d_ff 768, top 8, vocab 151,936; bf16 weights from seed
     0 made one layer slice at a time, 61.07 GB): ``launch.serve`` decodes
     batch 4 against a 32,768-slot cache (prompt 32 teacher-forced, 16 new
     tokens; flash_decode 48 x 47 = 2,256 launches), one
     ``make_prefill_step`` call at S=32,768, batch 1 (flash_attention 48
     launches, all tensor-core), a second call the same bits, logits
     finite, the peak memory, the dropped share of (token, choice) pairs in
     prefill and in 8 decode steps, one profiled prefill call and decode
     step (device busy share, top kernels, the MoE's route, dispatch,
     experts and combine ranges), and the work's bounds from the shapes;
     10b, one of its MoE layers on 1,024 tokens in f32 on the card against
     the CPU (routing, slots and drops equal but for near-ties at a
     relative gap of 1e-3, y and aux within 2e-3) and against a second
     card run (the same bits); 10c, phi3-medium-14b at full width cut to 4
     layers (40 / 10 heads, head_dim 128, the untied 100,352-id head): one
     2,048-token prefill and 16 decode steps at batch 4 on a 4,096-slot
     cache, launches counted; 10d, ``python -m repro_torch.launch.serve_lm
     --arch qwen3-moe-30b-a3b`` and ``--arch phi3-medium-14b`` in their own
     processes (exit 0);
 11. serve MLA and RWKV: 11a, deepseek-v2-236b at full width (d_model
     5120, 128 heads, kv_lora 512, q_lora 1536, q/k heads 128 + 64, v 128,
     160 routed experts top 6 and 2 shared, vocab 102,400 untied), depth
     cut 60 -> 6 (the dense layer 0 and 5 MoE layers; 42.16 GB of bf16
     weights from seed 0 made one layer slice at a time):
     ``make_decode_step`` at batch 4 on a 32,768-slot latent cache (prompt
     32 teacher-forced, 16 new tokens; flash_decode 6 x 47 launches at D
     192 over the rebuilt heads), one ``make_prefill_step`` call at
     S=32,768, batch 1 (flash_attention 6 launches, all tensor-core, D
     192), a second call the same bits, logits finite, peak memory, the
     dropped share, one profiled prefill call and decode step, and the
     naive step's and the latent floor's bounds; 11b, one full-width MLA
     layer in f32: a 256-token prefill (the CUDA-core route) and 8 decode
     steps on a 64-slot ring that wraps, naive and absorbed, card against
     CPU and naive against absorbed within 2e-3, a second card run the
     same bits; 11c, rwkv6-3b at full width and depth (32 layers, d_model
     2560, 40 heads of 64, d_ff 8960, vocab 65,536 untied; 6.18 GB of
     bf16): ``launch.serve`` at batch 128 (prompt 32, 16 new tokens) and
     one 32,768-token prefill at batch 1, no kernel launched, a second
     prefill the same bits, profiles and peak memory; 11d, one full-width
     RWKV block in f32: 8 decode steps from a zero state equal to its
     256-token prefill at those positions, card against CPU, within 2e-3;
     11e, ``python -m repro_torch.launch.serve_lm --arch deepseek-v2-236b``
     and ``--arch rwkv6-3b`` in their own processes (exit 0);
 12. serve the last three families: 12a, jamba-1.5-large-398b at full
     width (d_model 8192, Mamba of d_inner 16,384 and state 16, 64 / 8
     heads of 128, 16 experts of d_ff 24,576, top 2, vocab 65,536
     untied), depth cut 72 -> 4 (mamba x 3 and attention, the MoE on
     layers 1 and 3; 46.04 GB of bf16 weights from seed 0):
     ``launch.serve --layers 4`` at batch 128 on 32,768 slots (prompt 32
     teacher-forced, 16 new tokens; flash_decode 1 x 47 launches), one
     32,768-token prefill (flash_attention 1 launch, tensor-core, D 128,
     G 8), a second call the same bits, the dropped share, profiles,
     peaks and bounds; 12b, one full-width Mamba layer (a 256-token
     prefill, 8 decode steps from a zero state) and one full-width
     whisper cross-attention block (64 tokens over 1,500 encoder rows, 8
     decode steps) in f32, card against CPU within 1e-4 and the decode
     steps against the prefill within 1e-5; 12c, whisper-medium at full
     width and depth (24 + 24 layers, 16 heads of 64, vocab 51,865 tied):
     ``LM.encode`` over 1,500 stub frames at batch 16 (24 non-causal
     launches), decode at batch 16 on 32,768 slots with that ``enc_out``
     (24 self and 24 cross decode launches a step), one 32,768-token
     prefill at batch 1 with the frames (24 encoder, 24 causal and 24
     cross launches, the cross ones at Sk 1,500), profiles; 12d,
     internvl2-26b at full width and depth (48 layers, 48 / 8 heads of
     128, vocab 92,553): ``launch.serve`` at batch 4 on 32,768 slots (48
     launches a step), one prefill of 256 prefix embeddings and 32,512
     text tokens (48 launches), profiles; 12e, ``python -m
     repro_torch.launch.serve_lm`` for the three archs in their own
     processes (exit 0);
 13. train with the extras at phase 9a's cut (G 2 cohorts x 2 local
     steps x a microbatch of 4 sequences of 4,096 tokens, 2 clusters and
     2 meta steps, split FL on, two rounds, round 1 replayed bit for
     bit): 13a, whisper-medium at full width and depth with 1,500 stub
     frames a sequence (the encoder trained in the local steps, re-encoded
     by the averaged encoder in the meta steps); 13b, internvl2-26b at
     full width, depth cut 48 -> 2 (split layer 1), 256 patch embeddings
     before the 4,096 tokens; each with the attention launches reckoned
     by query x key length (4096x4096, 1500x1500 and 4096x1500; 4352x4352),
     every backward on the tensor cores, the peak and one profiled round;
     13c, a reduced-width f32 round of each with its extra, card against
     CPU within 2e-3;
  5. time each kernel beside its plain version, a library call where one
     computes the same function, and its bound (the attention kernels one
     row a template instance: head dim 64 at phase 6's shapes, 128 at
     phase 10a's and 192 at phase 11a's, each held against its plain
     version there (D 192's prefill in chunks of 256 keys), and one row a
     new path of phase 12: the encoder's non-causal prefill, the cross
     prefill at Sk 1,500, the cross decode over 1,500 valid slots,
     internvl2's D 128 at G 6 for both kernels; the backward one row at
     phase 9a's layer and one each at phase 13's cross, encoder and
     D 128 at G 6 layers, with SDPA's backward as the library call; with its
     route, the decode split count and the registers and spills per
     thread that ptxas reported). ``ms`` is the
     wrapper call's time (CUDA events around back-to-back calls, so the
     host's work between launches counts); for the selection and
     transport kernels ``device_ms`` is the kernels' own device time per
     call (torch.profiler, by kernel name, each launch also alone in
     ``device_ms_by_launch``; quantize at the main path's 20 of 100 valid
     rows and, in ``by_mask``, also at 80, each with its own bound; the
     cohort quantize at the main path's cohort). Then time the phases of
     one client's round (LocalUpdate eager and captured, with the device
     busy share of a captured one) and the client side of a full-width
     round on the cohort engine and on the client-by-client loop.
It prints the kernels line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. It imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores (SXM)
H100_BF16_FLOPS = 989e12         # bf16 tensor cores, dense (SXM)
TOL = 2e-3
ATT_TOL = {"float32": 2e-3, "bfloat16": 2e-2}   # tests/test_kernels.py:156
# the kernels' rows at the main path's shapes: in every block of rows,
# ||got - want||_F / ||want||_F at most this (a limit that scales with the
# values, where ATT_TOL's absolute part does not once they are small)
ROW_REL_TOL = 1e-2

# phase 2b: (b, s, h, kv, d, causal, window, dtype)
FLASH_CASES = [(1, 1024, 32, 8, 64, True, 0, "bfloat16"),
               (1, 1024, 32, 8, 64, True, 0, "float32"),
               (2, 1000, 8, 2, 64, False, 0, "float32"),
               (1, 1024, 32, 8, 64, True, 128, "bfloat16"),
               (2, 512, 8, 1, 64, True, 0, "bfloat16"),
               (1, 2048, 8, 4, 256, True, 1024, "bfloat16"),
               (1, 50, 32, 8, 64, True, 0, "bfloat16"),
               (1, 1000, 14, 2, 64, True, 0, "bfloat16"),
               (1, 1000, 14, 2, 64, True, 0, "float32"),
               (1, 1500, 8, 2, 128, True, 256, "bfloat16"),
               (1, 700, 4, 2, 256, False, 300, "bfloat16"),
               (2, 300, 4, 2, 96, False, 0, "bfloat16"),
               (1, 200, 4, 4, 32, True, 0, "bfloat16"),
               (1, 300, 4, 2, 72, True, 0, "bfloat16"),
               (1, 2048, 32, 4, 128, True, 0, "bfloat16"),
               (1, 2048, 40, 10, 128, True, 0, "bfloat16"),
               (1, 2048, 16, 16, 192, True, 0, "bfloat16"),
               (1, 777, 4, 4, 192, True, 0, "float32")]
# phase 2b, a key length Sk unlike S (whisper's cross-attention: S decoder
# queries over Sk encoder keys, non-causal, no window), on both routes:
# (b, s, sk, h, kv, d, dtype): S = 1, Sk below one key tile, Sk ragged
# (whisper's 1,500 frames), S below and above Sk, D 128 at G 4, f32 on the
# CUDA cores at D 64 and D 96; each case also through the decode kernel
# (its first query over a fully valid memory), and a causal or windowed
# call at Sk != S must raise
CROSS_CASES = [(2, 1, 16, 4, 4, 64, "bfloat16"),
               (2, 1, 1500, 16, 16, 64, "float32"),
               (2, 12, 100, 16, 16, 64, "bfloat16"),
               (1, 300, 1500, 16, 16, 64, "bfloat16"),
               (1, 2000, 1500, 16, 16, 64, "bfloat16"),
               (2, 40, 7, 8, 2, 128, "bfloat16"),
               (1, 300, 1500, 16, 16, 64, "float32"),
               (2, 700, 130, 8, 8, 64, "float32"),
               (2, 77, 50, 8, 2, 96, "float32")]
# phase 2b, the forward's statistics and the backward: llama3.2-1b's heads
# causal at S=1024 in both dtypes, S=1000 non-causal, a window of 128, MQA,
# qwen2-0.5b's G=7, gemma3's D=256 with window 1024, S below one tile,
# D=96 (f32: the CUDA-core forward), D=32, bf16 D=72 (the CUDA-core
# forward route in bf16), phi3's D=128 with a window, G=7 non-causal with
# a window, bf16 D=96 and G=64 (one query a row tile) on the backward's
# tensor-core route, and MLA's bf16 D=192 (the backward's CUDA-core
# route; the forward's tensor-core one). Each backward runs on the route
# bwd_route names; the cases in BWD_TWICE run twice, bit for bit.
BWD_CASES = [(1, 1024, 32, 8, 64, True, 0, "bfloat16"),
             (1, 1024, 32, 8, 64, True, 0, "float32"),
             (2, 1000, 8, 2, 64, False, 0, "float32"),
             (1, 1024, 32, 8, 64, True, 128, "bfloat16"),
             (2, 512, 8, 1, 64, True, 0, "bfloat16"),
             (1, 1000, 14, 2, 64, True, 0, "bfloat16"),
             (1, 2048, 8, 4, 256, True, 1024, "bfloat16"),
             (1, 50, 32, 8, 64, True, 0, "bfloat16"),
             (2, 300, 4, 2, 96, False, 0, "float32"),
             (1, 200, 4, 4, 32, True, 0, "bfloat16"),
             (1, 300, 4, 2, 72, True, 0, "bfloat16"),
             (1, 1500, 8, 2, 128, True, 256, "bfloat16"),
             (2, 777, 14, 2, 64, False, 200, "bfloat16"),
             (1, 300, 4, 2, 96, True, 0, "bfloat16"),
             (1, 130, 64, 1, 64, True, 0, "bfloat16"),
             (1, 600, 4, 4, 192, True, 0, "bfloat16")]
BWD_TWICE = (0, 1, 12)
# phase 2b, the backward at a key length Sk unlike S (the gradient of
# whisper's cross-attention, non-causal, no window): (b, s, sk, h, kv, d,
# dtype): whisper's cross layer in bf16 (the tensor cores) and f32 (the
# CUDA cores), S above Sk, Sk below one key tile, Sk no tile multiple with
# GQA at D 128, D 96 in f32; then whisper's encoder layer (S = Sk = 1,500,
# non-causal, no window) in bf16. Each on the route bwd_route names, held
# by ATT_TOL and ROW_REL_TOL; the BWD_CROSS_TWICE cases (one a route)
# twice, bit for bit; a causal or windowed call at Sk != S must raise.
BWD_CROSS_CASES = [(2, 300, 1500, 16, 16, 64, "bfloat16"),
                   (2, 300, 1500, 16, 16, 64, "float32"),
                   (1, 2000, 1500, 16, 16, 64, "bfloat16"),
                   (2, 130, 7, 8, 2, 64, "bfloat16"),
                   (2, 333, 1000, 16, 4, 128, "bfloat16"),
                   (2, 77, 50, 8, 2, 96, "float32"),
                   (2, 1500, 1500, 16, 16, 64, "bfloat16")]
BWD_CROSS_TWICE = (0, 1)
# (b, s, h, kv, d, valid slots, q dtype, cache dtype, splits): splits 1 and
# 2 are fixed by the shapes; 0 means many (more than 8)
DECODE_CASES = [(2, 32768, 32, 8, 64, 40, "bfloat16", "bfloat16", None),
                (3, 300, 32, 8, 64, 300, "float32", "float32", None),
                (2, 1000, 8, 8, 128, 513, "bfloat16", "bfloat16", None),
                (4, 4096, 32, 8, 64, 4000, "float32", "float32", None),
                (2, 256, 4, 1, 256, 100, "float32", "bfloat16", None),
                (2, 130, 8, 2, 64, 77, "bfloat16", "float32", None),
                (32, 64, 32, 8, 64, 47, "bfloat16", "bfloat16", 1),
                (4, 128, 32, 8, 64, 100, "bfloat16", "bfloat16", 2),
                (1, 32768, 32, 8, 64, 30000, "bfloat16", "bfloat16", 0),
                (2, 5000, 14, 2, 64, 4321, "bfloat16", "bfloat16", None),
                (3, 17, 14, 2, 64, 9, "float32", "bfloat16", None),
                (2, 300, 8, 2, 36, 200, "bfloat16", "bfloat16", None),
                (4, 32768, 32, 4, 128, 47, "bfloat16", "bfloat16", None),
                (4, 4096, 40, 10, 128, 2100, "bfloat16", "bfloat16",
                 None),
                (4, 4096, 16, 16, 192, 2100, "bfloat16", "bfloat16",
                 None)]
# phase 6: INPUT_SHAPES' decode_32k (batch cut 128 -> 32: 128 x 32768 x
# 16 layers of bf16 K/V would be 137 GB) and prefill_32k (batch cut
# 32 -> 1)
SERVE_BATCH, SERVE_CACHE, SERVE_PROMPT, SERVE_TOKENS = 32, 32768, 32, 16
PREFILL_S = 32768
# phase 9a: train_4k's 4,096-token sequences at llama3.2-1b's full width;
# its global batch cut 256 -> 16 (G = 2 cohorts x 2 local steps x one
# microbatch of 4), meta-training 2 clusters a cohort for 2 steps
TRAIN_G, TRAIN_LOCAL, TRAIN_MB, TRAIN_T = 2, 2, 4, 4096
TRAIN_META_CLUSTERS, TRAIN_META_STEPS = 2, 2
# phase 10a: qwen3-moe-30b-a3b at full width and depth, INPUT_SHAPES'
# decode_32k (batch cut 128 -> 4: 12.9 GB of bf16 K/V beside 61.07 GB of
# bf16 weights) and prefill_32k (batch cut 32 -> 1); 10b one of its MoE
# layers on 1,024 tokens; 10c phi3-medium-14b at full width, depth cut
# 40 -> 4
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_BATCH, MOE_CACHE, MOE_PROMPT, MOE_TOKENS = 4, 32768, 32, 16
MOE_PREFILL_S = 32768
MOE_LAYER_TOKENS = 1024
PHI3_LAYERS, PHI3_PREFILL_S, PHI3_BATCH, PHI3_CACHE, PHI3_STEPS = \
    4, 2048, 4, 4096, 16
# phase 11a: deepseek-v2-236b at full width, depth cut 60 -> 6 (the dense
# layer 0 and 5 MoE layers: 42.16 GB of bf16 weights), decode_32k's
# 32,768-slot latent cache at batch 4 (cut from 128) and prefill_32k's
# 32,768 tokens at batch 1 (cut from 32); 11b one full-width MLA layer;
# 11c rwkv6-3b at full width and depth, decode_32k's full batch of 128
# and prefill_32k's length at batch 1; 11d one full-width RWKV block.
# The prefill kernel's D 192 row is held against its plain version in
# chunks of MLA_PLAIN_CHUNK keys (the default 1,024 would hold a 17.2 GB
# f32 score block at H 128)
MLA_ARCH, MLA_LAYERS = "deepseek-v2-236b", 6
MLA_BATCH, MLA_CACHE, MLA_PROMPT, MLA_TOKENS = 4, 32768, 32, 16
MLA_PREFILL_S = 32768
MLA_LAYER_TOKENS, MLA_RING, MLA_STEPS = 256, 64, 8
MLA_PLAIN_CHUNK = 256
RWKV_ARCH = "rwkv6-3b"
RWKV_BATCH, RWKV_CACHE, RWKV_PROMPT, RWKV_TOKENS = 128, 32768, 32, 16
RWKV_PREFILL_S = 32768
RWKV_BLOCK_TOKENS, RWKV_BLOCK_STEPS = 256, 8
# phase 12a: jamba-1.5-large-398b at full width, depth cut 72 -> 4 (its
# 8-layer unit cut to its first half: mamba x 3, attention; the MoE on
# layers 1 and 3: 46.04 GB of bf16 weights), decode_32k's full batch of
# 128 on 32,768 slots (17.2 GB of K/V in the one attention layer) and
# prefill_32k's 32,768 tokens at batch 1 (cut from 32); 12b one
# full-width Mamba layer and one full-width cross-attention block in f32,
# the card against the CPU within CARD_CPU_TOL and the decode steps
# against the prefill within STEP_TOL; 12c whisper-medium at full width
# and depth: the encoder over its 1,500 stub frames at batch 16, decode
# on decode_32k's 32,768 slots at batch 16 (cut from 128: the decoder's
# self-attention K/V at 128 would be 412 GB; at 16 it is 51.5 GB), one
# prefill_32k call at batch 1 with the frames; 12d internvl2-26b at full
# width and depth: decode at batch 4 on 32,768 slots (cut from 128: 25.8
# GB of K/V beside 39.8 GB of weights), one prefill of its 256 prefix
# embeddings and 32,512 text tokens at batch 1
JAMBA_ARCH, JAMBA_LAYERS = "jamba-1.5-large-398b", 4
JAMBA_BATCH, JAMBA_CACHE, JAMBA_PROMPT, JAMBA_TOKENS = 128, 32768, 32, 16
JAMBA_PREFILL_S = 32768
MAMBA_LAYER_TOKENS, MAMBA_STEPS = 256, 8
CROSS_BLOCK_TOKENS, CROSS_STEPS = 64, 8
CARD_CPU_TOL, STEP_TOL = 1e-4, 1e-5
WHISPER_ARCH = "whisper-medium"
WHISPER_BATCH, WHISPER_CACHE, WHISPER_PROMPT, WHISPER_TOKENS = \
    16, 32768, 32, 16
WHISPER_PREFILL_S = 32768
VLM_ARCH = "internvl2-26b"
VLM_BATCH, VLM_CACHE, VLM_PROMPT, VLM_TOKENS = 4, 32768, 32, 16
VLM_PREFILL_S = 32768
# phase 13: training with the extras at phase 9a's cut of train_4k
# (TRAIN_*: G = 2 cohorts x 2 local steps x one microbatch of 4 sequences
# of 4,096 text tokens, meta-training 2 clusters a cohort for 2 steps, two
# rounds):
# 13a whisper-medium at full width and depth with its 1,500 stub frames a
# sequence, 13b internvl2-26b at full width, depth cut 48 -> 2 (a lower
# and an upper layer: split layer 1), its 256 patch embeddings before
# the 4,096 tokens
EXTRAS_VLM_LAYERS = 2
# whisper's decoder holds 448 learned positions (its config's docstring);
# 13a's 4,096 text tokens are 9a's cut, so the cross-attention backward is
# also timed at this query length
WHISPER_DECODER_LEN = 448


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def bound(nbytes: float, flops: float, peak: float = H100_F32_FLOPS):
    """(least ms, "bytes" or "operations") for this work on the card, at
    the peak rate of the operations' type."""
    t_mem, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops
            else "operations")


def rel_check(k_name, got, want, dim, block, what):
    """The error against the values' own size, a block of ``block``
    rows along ``dim`` at a time: the worst block's
    ||got - want||_F / ||want||_F (held to ROW_REL_TOL) and max |got -
    want| over its RMS of ``want``, and the whole tensor's ratio."""
    num = den = worst_rel = worst_max = 0.0
    for g, w in zip(got.split(block, dim), want.split(block, dim)):
        w = w.float()
        e = g.float() - w
        en, wn = float(e.square().sum()), float(w.square().sum())
        num, den = num + en, den + wn
        worst_rel = max(worst_rel, math.sqrt(en / wn))
        worst_max = max(worst_max, float(e.abs().max())
                        / math.sqrt(wn / w.numel()))
    check(worst_rel <= ROW_REL_TOL,
          f"{k_name} {what}: a block of {block} rows is {worst_rel} "
          f"off relative to its values, beyond {ROW_REL_TOL}")
    return {"rel_err": math.sqrt(num / den),
            "worst_block_rel_err": worst_rel,
            "worst_block_max_err_over_rms": worst_max,
            "rel_err_block_rows": block, "rel_err_limit": ROW_REL_TOL}


def events_ms(fn, iters, warmup=1):
    """Mean ms of one call of ``fn`` over ``iters`` back-to-back calls
    after ``warmup`` (CUDA events: the wrapper call's time)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas(source, pattern):
    """Registers and spills per thread that ptxas reported, at phase 1's
    build, for the one instantiation of ``source`` matching ``pattern``
    (None unless exactly one matches)."""
    from repro_torch.kernels import build
    found = [u for fn, u in build.ptxas_usage(
        build.ptxas_logs.get(source, "")).items() if re.search(pattern, fn)]
    return found[0] if len(found) == 1 else None

# the attention backward's three launches on each route (Dd is shared)
BWD_KERNELS = {
    "tensor_core": ("attn_bwd_dot_kernel", "attn_bwd_dkdv_wgmma_kernel",
                    "attn_bwd_dq_wgmma_kernel"),
    "cuda_core": ("attn_bwd_dot_kernel", "attn_bwd_dkdv_kernel",
                  "attn_bwd_dq_kernel")}


def bwd_row(dev, name, shape, causal, launches, what, seed):
    """The kernels line's row of the attention backward at ``shape`` =
    (b, s, sk, h, kv, d) in bf16, inputs drawn from ``seed``: on the
    tensor cores, held against its plain version (2e-2 each element,
    ROW_REL_TOL each block of 1,024 rows), its device ms by launch, call
    ms, plain ms, SDPA's backward ms, its bound and ptxas's registers and
    spills. ``launches`` is the main path's count."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import bwd_route_for
    from repro_torch.obs.device_time import kernel_device_ms

    b_, s_, sk_, h_, kv_, d_ = shape
    gd = torch.Generator(device=dev).manual_seed(seed)

    def drandn(*shp):
        return torch.randn(shp, generator=gd, device=dev).to(torch.bfloat16)

    q, dout = drandn(b_, s_, h_, d_), drandn(b_, s_, h_, d_)
    k, v = drandn(b_, sk_, kv_, d_), drandn(b_, sk_, kv_, d_)
    o, lse = ops.flash_attention(q, k, v, causal=causal, return_stats=True)
    route = bwd_route_for(q, k, v, o, dout)
    check(route == "tensor_core", f"{name} {what}: the {route} route")

    def kern():
        return ops.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal)

    def plain():
        return ref.flash_attention_bwd_ref(q, k, v, o, dout, lse,
                                           torch.ones_like(lse),
                                           causal=causal)
    got, want = kern(), plain()
    errs, rel = [], {}
    for grad_name, x, y in zip(("dq", "dk", "dv"), got, want):
        diff = (x.float() - y.float()).abs()
        errs.append(float(diff.max()))
        check(bool((diff <= 2e-2 + 2e-2 * y.float().abs()).all()),
              f"{name} {grad_name} {what}: max abs err {errs[-1]}")
        rel[grad_name] = rel_check(name, x, y, 1, 1024,
                                   f"{grad_name} {what}")
    del got, want
    by_launch = kernel_device_ms(kern, BWD_KERNELS["tensor_core"], iters=5,
                                 warmup=1)
    ms = events_ms(kern, 5)
    plain_ms = events_ms(plain, 2)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    so = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    sdo = dout.transpose(1, 2)
    library_ms = events_ms(lambda: torch.autograd.grad(
        so, (qt, kt, vt), sdo, retain_graph=True), 5)
    # the least work: five products (S, dP, dV, dK, dQ) over the pairs the
    # mask keeps; q, k, v, out, dout and lse read once, dq, dk, dv written
    # once
    pairs = s_ * (s_ + 1) // 2 if causal else s_ * sk_
    flops = 5 * 2 * b_ * h_ * d_ * pairs
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
    dp = 64 if d_ <= 64 else 128
    stages = 3 if dp == 64 else 2
    del q, k, v, dout, o, lse, qt, kt, vt, so, sdo
    torch.cuda.empty_cache()
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:139",
        "note": "the gradient of flash_attention_kernel "
                "(src/repro/kernels/flash_attention.py:89); the "
                "reference's backward is the jnp custom VJP "
                "_sdpa_flash_bwd, with no Pallas kernel",
        "launches": launches, "max_abs_err": max(errs), "ms": ms,
        "device_ms": sum(by_launch.values()),
        "device_ms_by_launch": by_launch, "plain_ms": plain_ms,
        "plain": "ref.flash_attention_bwd_ref (key chunks of 1024)",
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "library": f"SDPA's backward (autograd of "
                   f"scaled_dot_product_attention, "
                   f"{'causal' if causal else 'non-causal'}, GQA)",
        "max_abs_err_vs_plain_at_this_shape": max(errs),
        "block_rel_err": rel, "kernel_route": f"{route}, three launches",
        "ptxas": {
            "dkdv": ptxas("flash_attention_bwd",
                          rf"attn_bwd_dkdv_wgmma_kernelILi{dp}ELi{stages}E"),
            "dq": ptxas("flash_attention_bwd",
                        rf"attn_bwd_dq_wgmma_kernelILi{dp}ELi64ELi"
                        rf"{stages}E")},
        "causal": causal, "shape": [b_, s_, h_, kv_, d_], "key_len": sk_}


def train_rounds(tag, step, lm, batches, firsts, clusters, tokens):
    """Two rounds of the train step ``step`` for ``len(firsts[0])``
    cohorts, all starting from ``lm``'s weights drawn from seed 0, on
    ``batches`` with the K-means first centres ``firsts``; then round 1
    replayed from the same state, and one round under the profiler.
    Checks that the metrics are finite and each round selects at most
    ``clusters`` rows a cohort, that the cohorts leave each round with
    the same finite weights, that every leaf moved over the two rounds,
    and that the replay gives the same bits. Returns (the numbers: walls,
    tokens/s of ``tokens`` a round, metrics, the peak, the profiled
    round's device busy share, top kernels and attention kernels' device
    ms a launch; the two rounds' launches: counts, the backward's by
    route, forward and backward by query x key length, and each
    selection's Lloyd sweeps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import selection as sel_mod
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import tree_map
    from repro_torch.obs.timing import monotonic
    from repro_torch.optim.optimizers import tree_leaves

    g_ax = len(firsts[0])
    state = tree_map(lambda x: x[None].expand((g_ax,) + tuple(x.shape)),
                     lm.init(torch.Generator(device=batches[0]["tokens"]
                                             .device).manual_seed(0)))
    before = [x[0].cpu() for x in tree_leaves(state)]
    sweeps = []
    real_select = sel_mod.select_metadata

    def recording(*args, **kwargs):
        got = real_select(*args, **kwargs)
        sweeps.append(got.lloyd_iters)
        return got

    sel_mod.select_metadata = recording
    try:
        peak_and_reset()
        ops.reset_launch_counts()
        walls, metrics, states = [], [], []
        for r in range(2):
            t0 = monotonic()
            state, _, m = step(state, (), batches[r], firsts[r])
            metrics.append({k: float(v) for k, v in m.items()})  # syncs
            walls.append(monotonic() - t0)
            states.append(state)
        peak = peak_and_reset()
    finally:
        sel_mod.select_metadata = real_select
    launches = {
        "counts": ops.launch_counts(),
        "bwd_by_route": dict(ops.flash_attention_bwd.launches_by_route),
        "fwd_by_lengths": dict(ops.flash_attention.launches_by_lengths),
        "bwd_by_lengths": dict(ops.flash_attention_bwd.launches_by_lengths),
        "lloyd_sweeps": list(sweeps)}
    last = tree_leaves(states[1])
    check(all(math.isfinite(v) for m in metrics for v in m.values())
          and all(0 < m["selected"] <= g_ax * clusters for m in metrics),
          f"{tag}: metrics {metrics}")
    check(all(torch.equal(x[0], x[g]) for x in last for g in range(g_ax)),
          f"{tag}: the cohorts leave the round with different weights")
    check(all(bool(torch.isfinite(x[0]).all()) for x in last),
          f"{tag}: weights not finite")
    last = [x[0].cpu() for x in last]
    moved = [not torch.equal(x, b) for x, b in zip(last, before)]
    check(all(moved), f"{tag}: {moved.count(False)} of {len(moved)} leaves "
                      f"did not move in two rounds")
    del state, states[1], before
    # round 1 again from the same state: the same bits
    replay, _, m_replay = step(states[0], (), batches[1], firsts[1])
    m_replay = {k: float(v) for k, v in m_replay.items()}
    check(all(torch.equal(x[0].cpu(), y)
              for x, y in zip(tree_leaves(replay), last))
          and m_replay == metrics[1],
          f"{tag}: round 1 replayed from the same state gave other bits")
    del states, last
    # one more round under the profiler: the device busy share, the top
    # kernels, the attention kernels' device ms a launch
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = monotonic()
        float(step(replay, (), batches[0], firsts[0])[2]["loss"])
        torch.cuda.synchronize()
        prof_wall = (monotonic() - t0) * 1e3
    del replay
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:12]
    in_round = {}
    for name in BWD_KERNELS["tensor_core"] + ("flash_fwd_wgmma_kernel",):
        hit = [e for e in evs if f"::{name}" in e.key]
        n = sum(e.count for e in hit)
        in_round[name] = {
            "launches": n, "device_ms_per_launch":
            sum(e.self_device_time_total for e in hit) / 1e3 / max(n, 1)}
    del prof, evs
    peak_and_reset()
    print(f"{tag}: two rounds at full width, walls {walls}, metrics "
          f"{metrics}, peak {peak}")
    return {"tokens_per_round": tokens, "round_wall_s": walls,
            "tokens_per_s": [tokens / w for w in walls],
            "metrics": metrics, "max_memory_allocated": peak,
            "cohorts_bit_equal": True, "every_leaf_moved": True,
            "replay_bit_identical": True,
            "profiled_round": {
                "wall_ms": prof_wall, "device_busy_ms": busy,
                "device_busy_share": busy / prof_wall,
                "top_device_ms": {e.key[:80]: e.self_device_time_total / 1e3
                                  for e in top},
                "attention_kernels": in_round}}, launches


def card_vs_cpu_round(tag, step, p_cpu, batch, firsts, dev, rel_err):
    """One round of the reduced f32 train step ``step`` for
    ``len(firsts)`` cohorts from the weights ``p_cpu``, on the CPU and on
    the card. Holds within TOL the new weights, the metrics, and each
    leaf's update (new - old) against the CPU's update's own size (no leaf
    may stay put); the selections must be equal, the card must launch the
    attention kernels and the CPU none. -> (the numbers, the card's
    backward launches by query x key length)."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim.optimizers import tree_leaves

    runs = {}
    for where in ("cpu", "card"):
        d = "cpu" if where == "cpu" else dev
        cp = tree_map(lambda t: t.to(d)[None].expand(
            (len(firsts),) + tuple(t.shape)), p_cpu)
        ops.reset_launch_counts()
        new, _, m = step(cp, (), {k: v.to(d) for k, v in batch.items()},
                         firsts)
        runs[where] = ([x.cpu() for x in tree_leaves(new)],
                       {k: float(v) for k, v in m.items()},
                       ops.launch_counts(),
                       dict(ops.flash_attention_bwd.launches_by_lengths))
    ops.reset_launch_counts()
    (lc, mc, cc, _), (lg, mg, cg, bl) = runs["cpu"], runs["card"]
    e_w = max(rel_err(x, y) for x, y in zip(lg, lc))
    e_m = max(abs(mg[k] - mc[k]) / (1 + abs(mc[k])) for k in mc)
    e_u = 0.0
    for x, y, old in zip(lg, lc, tree_leaves(p_cpu)):
        size = float((y - old).norm())
        e_u = max(e_u, float((x - y).norm()) / size if size else math.inf)
    check(e_w <= TOL and e_u <= TOL and e_m <= TOL
          and mg["selected"] == mc["selected"],
          f"{tag}: card vs CPU: weights rel err {e_w}, updates rel err "
          f"{e_u}, metrics {mg} vs {mc}")
    check(cg["flash_attention"] > 0 and cg["flash_attention_bwd"] > 0
          and sum(cc.values()) == 0, f"{tag}: launches card {cg}, CPU {cc}")
    print(f"{tag}: reduced f32 train round card vs CPU: weights rel err "
          f"{e_w}, updates rel err {e_u}, metrics rel err {e_m}")
    return {"weights_max_rel_err": e_w, "updates_max_rel_err": e_u,
            "metrics_max_rel_err": e_m, "metrics_card": mg,
            "metrics_cpu": mc, "launches_card": cg,
            "bwd_launches_by_lengths_card": bl}, bl


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")

    from repro_torch.configs import FLConfig, get_wrn_config
    from repro_torch.core import selection as sel_mod
    from repro_torch.core.rounds import (GeneratorDraws, client_round,
                                         local_batches, local_order,
                                         run_cohort, run_round)
    from repro_torch.core import distributed as dist
    from repro_torch.core import fedavg as fa
    from repro_torch.core import meta_training as mt
    from repro_torch.core.compose import evaluate
    from repro_torch.core.split import make_split_wrn
    from repro_torch.data import SyntheticImageDataset, partition_k_shards
    from repro_torch.device import resolve_device
    from repro_torch.fl.comms import CommLedger
    from repro_torch.fl.simulation import FLSimulation
    from repro_torch.fl.transport.channel import Channel
    from repro_torch.fl.transport.codecs import get_codec
    from repro_torch.device import sm_count
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.kmeans import plan_for_rows, plan_rows
    from repro_torch.obs.device_time import kernel_device_ms
    from repro_torch.obs.timing import monotonic, sync

    dev = resolve_device("cuda")          # also turns TF32 off
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # ---- 1. build ------------------------------------------------------
    t0 = monotonic()
    build.load_all(verbose=True)
    print(f"build_s: {monotonic() - t0:.3f}")

    # ---- 2. kernels vs plain versions on the card ----------------------
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def label_mask(n, classes, kk, masked_rows=0, empty_slots=0,
                   present=None):
        # ``present``: the classes the rows are drawn from (default all);
        # a client of partition_k_shards(k_classes=2) holds two, so the
        # slots of the other classes are empty and masked in every row
        if present is None:
            labels = torch.randint(classes, (n,), generator=g)
        else:
            labels = torch.tensor(present)[
                torch.randint(len(present), (n,), generator=g)]
        slot = torch.arange(classes * kk) // kk
        lm = torch.where(labels[:, None] == slot[None, :], 0.0, ref.BIG)
        if masked_rows:
            lm[torch.randperm(n, generator=g)[:masked_rows]] = ref.BIG
        if empty_slots:
            lm[:, torch.randperm(classes * kk, generator=g)[:empty_slots]] = \
                ref.BIG
        return lm.to(torch.float32).to(dev)

    errs = {"kmeans_pairwise_dist": 0.0, "kmeans_lloyd_step": 0.0,
            "quantize_affine": 0.0, "quantize_affine_batched": 0.0,
            "flash_attention": 0.0, "flash_decode": 0.0,
            "flash_attention_stats": 0.0, "flash_attention_bwd": 0.0}

    def rel_err(got, want):
        return float(((got - want).abs() / (1.0 + want.abs())).max())

    def unaligned(*shape):
        # contiguous, but its data 4 bytes past a 16-byte boundary: the
        # K-means kernels take their 4-byte copy route
        t = randn(math.prod(shape) + 1)[1:].view(*shape)
        check(t.data_ptr() % 16 == 4, "unaligned view is aligned")
        return t

    klib = build.library("kmeans")
    # the main path's shapes, ragged ones, then the redesign's edges: a
    # block of one row each below one wave (3, 5), a last block of one row
    # (2113 = 132 x 16 + 1), K x D past the resident budget (panel loop), D
    # wide enough for column chunks, K = 1, and D % 4 != 0 off 16-byte
    # bases
    for n, d, k, odd in [(2500, 200, 10, False), (2500, 200, 100, False),
                         (1037, 61, 7, False), (130, 1, 65, False),
                         (64, 200, 64, False), (3, 200, 10, False),
                         (5, 200, 10, False), (2113, 200, 100, False),
                         (1000, 256, 300, False), (100, 16384, 10, False),
                         (500, 200, 1, False), (1037, 61, 7, True),
                         (2500, 198, 10, True)]:
        x, c = (unaligned(n, d), unaligned(k, d)) if odd else \
            (randn(n, d), randn(k, d))
        got = ops.kmeans_pairwise_dist(x, c)
        want = ref.kmeans_pairwise_dist_ref(x, c)
        e = rel_err(got, want)
        check(e <= TOL, f"pairwise dist {n}x{d}x{k}: rel err {e}")
        errs["kmeans_pairwise_dist"] = max(errs["kmeans_pairwise_dist"],
                                           float((got - want).abs().max()))
    check(plan_rows(1000, 300, 256, sm_count(0)).panels > 1
          and plan_rows(100, 10, 16384, sm_count(0)).chunks > 1,
          "the panel and column-chunk cases no longer take those loops")
    # N = 0: the pairwise wrapper launches nothing, a Lloyd sweep only its
    # sums pass, which writes zeros
    x0, c0 = randn(0, 200), randn(100, 200)
    check(tuple(ops.kmeans_pairwise_dist(x0, c0).shape) == (0, 100),
          "pairwise dist at N = 0: wrong shape")
    a0, md0, s0, cnt0 = ops.kmeans_lloyd_step(
        x0, c0, torch.empty(0, 100, device=dev))
    check(a0.shape[0] == md0.shape[0] == 0 and tuple(s0.shape) == (100, 200)
          and not bool(s0.any()) and not bool(cnt0.any()),
          "Lloyd at N = 0: sums and counts are not zero")

    def ascending_sums(x, a, lm):
        # each cluster's weighted rows added one at a time in ascending row
        # order from 0, in f32 on the CPU, from the kernel's own assign
        xs, an = x.cpu().numpy(), a.cpu().numpy()
        w = (torch.amin(lm, 1) <= 0).cpu().numpy()
        sums = np.zeros((lm.shape[1], xs.shape[1]), np.float32)
        for r in np.nonzero(w)[0]:
            sums[an[r]] += xs[r]
        return sums

    # N below a block's rows (3 < 16) and one past them (17 = 16 + 1): the
    # kernels at a 16-row plan that the planner would not pick for these N
    stream = torch.cuda.current_stream().cuda_stream
    for n in (3, 17):
        x, c = randn(n, 200), randn(100, 200)
        lm = label_mask(n, 10, 10, 1, 0, (3, 7))
        plan = plan_for_rows(n, 100, 200, 16).kernel_args
        out = torch.empty(n, 100, device=dev)
        check(klib.repro_kmeans_pairwise_dist(
            x.data_ptr(), c.data_ptr(), out.data_ptr(), n, 100, 200, *plan,
            stream) == 0, f"pairwise dist, 16-row plan, N={n}: refused")
        e = rel_err(out, ref.kmeans_pairwise_dist_ref(x, c))
        check(e <= TOL, f"pairwise dist, 16-row plan, N={n}: rel err {e}")
        a, md, mem = (torch.empty(n, dtype=torch.int32, device=dev),
                      torch.empty(n, device=dev),
                      torch.empty(n, dtype=torch.int32, device=dev))
        s, cnt = torch.empty(100, 200, device=dev), torch.empty(100,
                                                                device=dev)
        check(klib.repro_kmeans_lloyd(
            x.data_ptr(), c.data_ptr(), lm.data_ptr(), a.data_ptr(),
            md.data_ptr(), mem.data_ptr(), s.data_ptr(), cnt.data_ptr(), n,
            100, 200, *plan, stream) == 0,
            f"Lloyd, 16-row plan, N={n}: refused")
        ra, rmd, _, _ = ref.kmeans_lloyd_ref(x, c, lm)
        dist = ref.kmeans_pairwise_dist_ref(x, c) + lm
        diff = torch.nonzero(a != ra)[:, 0]
        check(not len(diff) or rel_err(dist[diff, a[diff].long()],
                                       dist[diff, ra[diff].long()]) <= TOL,
              f"Lloyd, 16-row plan, N={n}: assignments off, not near-ties")
        check(rel_err(md, rmd) <= TOL, f"Lloyd, 16-row plan, N={n}: mindist")
        check(s.cpu().numpy().tobytes() == ascending_sums(x, a, lm).tobytes(),
              f"Lloyd, 16-row plan, N={n}: sums are not the ascending-row "
              f"f32 sum")

    for n, d, classes, kk, mrows, eslots, present, odd in [
            (2500, 200, 10, 10, 0, 0, None, False),
            (2500, 200, 10, 10, 0, 0, (3, 7), False),
            (777, 45, 7, 10, 20, 5, None, False),
            (100, 3, 2, 33, 10, 3, None, False),
            (3, 200, 10, 10, 0, 0, (3, 7), False),
            (5, 200, 10, 10, 0, 0, (3, 7), False),
            (2113, 200, 10, 10, 0, 0, (3, 7), False),
            (1000, 256, 10, 30, 0, 0, None, False),
            (500, 200, 1, 1, 0, 0, None, False),
            (300, 200, 10, 10, 300, 0, (3, 7), False),
            (1037, 61, 10, 10, 7, 0, (3, 7), True)]:
        x = unaligned(n, d) if odd else randn(n, d)
        c = unaligned(classes * kk, d) if odd else randn(classes * kk, d)
        lm = label_mask(n, classes, kk, mrows, eslots, present)
        a, md, s, cnt = ops.kmeans_lloyd_step(x, c, lm)
        a2, md2, s2, cnt2 = ops.kmeans_lloyd_step(x, c, lm)
        check(all(torch.equal(u, v) for u, v in
                  [(a, a2), (md, md2), (s, s2), (cnt, cnt2)]),
              f"Lloyd {n}x{d}: two sweeps on the same input differ")
        check(s.cpu().numpy().tobytes() == ascending_sums(x, a, lm).tobytes(),
              f"Lloyd {n}x{d}: sums are not the ascending-row f32 sum")
        ra, rmd, rs, rcnt = ref.kmeans_lloyd_ref(x, c, lm)
        dist = ref.kmeans_pairwise_dist_ref(x, c) + lm
        diff = torch.nonzero(a != ra)[:, 0]
        if len(diff):
            dk = dist[diff, a[diff].long()]
            dr = dist[diff, ra[diff].long()]
            gap = float(((dk - dr).abs() / (1.0 + dr.abs())).max())
            check(gap <= TOL, f"Lloyd {n}x{d}: {len(diff)} assignments "
                              f"differ, not at near-ties (gap {gap})")
        print(f"lloyd {n}x{d}x{classes * kk} (classes "
              f"{present or 'all'}): assign mismatches {len(diff)} "
              f"(near-ties)")
        e = rel_err(md, rmd)
        check(e <= TOL, f"Lloyd mindist {n}x{d}: rel err {e}")
        # sums/counts of the kernel's own assignment, in plain PyTorch
        w = (torch.amin(lm, 1) <= 0).float()
        oh = torch.nn.functional.one_hot(a.long(), classes * kk).float() \
            * w[:, None]
        e = rel_err(s, oh.T @ x)
        check(e <= TOL, f"Lloyd sums {n}x{d}: rel err {e}")
        check(torch.equal(cnt, oh.sum(0)), f"Lloyd counts {n}x{d} differ")
        if not len(diff):
            e = rel_err(s, rs)
            check(e <= TOL, f"Lloyd sums vs plain {n}x{d}: rel err {e}")
        errs["kmeans_lloyd_step"] = max(errs["kmeans_lloyd_step"],
                                        float((md - rmd).abs().max()))

    # quantize: the main path's slots at phase 5's mask and at its own (20
    # of 100 valid), ragged, every row masked, constant, NaN / +inf / -inf
    # in a valid row and NaN in a masked one, a zero minimum of both signs
    # (-0.0 below +0.0, as repro's min) and -0.0 only in a masked row, a
    # payload past the resident budget (the L2 route), D % 4 != 0 off a
    # 16-byte base, N = 1, more
    # rows than one step of the mask walk, N = 0 and D = 0; codes
    # and (xmin, scale) equal to the plain version on the card and on the
    # CPU, bit for bit, each call one launch on the planned route
    from repro_torch.kernels.quantize import launch_quantize_affine
    from repro_torch.kernels.quantize import plan_for as quant_plan
    non_finite = {"nan": math.nan, "pos_inf": math.inf,
                  "neg_inf": -math.inf, "masked_nan": math.nan}

    def quant_payload(case, n, d):
        x = randn(n, d)
        m = torch.rand(n, generator=g) < 0.8
        if case == "all_masked":
            m[:] = False
        elif case == "constant":
            x = torch.full((n, d), 0.37, device=dev)
        elif case == "main_path":
            m[:] = False
            m[torch.randperm(n, generator=g)[:20]] = True
        elif case in ("signed_zero", "masked_neg_zero"):
            x = x.abs()
            m[:] = True
            m[1] = False
            x[0, 0] = x[n - 1, d - 1] = 0.0
            x[1 if case == "masked_neg_zero" else 2, 3] = -0.0
        elif case in non_finite:
            m[:] = True
            m[1] = False
            x[1 if case == "masked_nan" else 2, 3] = non_finite[case]
        elif case == "odd":
            x = unaligned(n, d)
        return x, m.to(dev)

    def quant_bytes(q, xmin, scale):
        return (q.cpu().numpy().tobytes(),
                torch.stack([xmin, scale]).cpu().numpy().tobytes())

    for n, d, case, resident in [
            (100, 16384, "slots", True), (100, 16384, "main_path", True),
            (37, 1001, "ragged", True), (64, 300, "all_masked", True),
            (50, 77, "constant", True), (100, 16384, "nan", True),
            (100, 16384, "pos_inf", True), (37, 1001, "neg_inf", True),
            (100, 16384, "masked_nan", True),
            (100, 16384, "signed_zero", True), (37, 1001, "signed_zero", True),
            (100, 16384, "masked_neg_zero", True),
            (2000, 16384, "slots", False),
            (37, 1001, "odd", True), (1, 1, "slots", True),
            (1, 16384, "slots", True), (1037, 61, "ragged", True),
            (0, 16384, "slots", True), (5, 0, "slots", True)]:
        x, m = quant_payload(case, n, d)
        before = ops.quantize_affine.launches
        q, xmin, scale = ops.quantize_affine(x, m)
        got = quant_bytes(q, xmin, scale)
        check(ops.quantize_affine.launches == before + 1
              and ops.quantize_affine.last_plan.resident == resident,
              f"quantize {case} {n}x{d}: not one launch on the "
              f"{'resident' if resident else 'L2'} route")
        if case in ("signed_zero", "masked_neg_zero"):
            check(bool(torch.signbit(xmin)) == (case == "signed_zero"),
                  f"quantize {case} {n}x{d}: the minimum's zero sign")
        check(got == quant_bytes(*ref.quantize_affine_ref(x, m)),
              f"quantize {case} {n}x{d}: not byte-exact against the plain "
              f"version on the card")
        check(got == quant_bytes(*ref.quantize_affine_ref(x.cpu(),
                                                          m.cpu())),
              f"quantize {case} {n}x{d}: not byte-exact against the plain "
              f"version on the CPU")
        if n == 100 and case in ("slots", "main_path") or case == "odd":
            # the other route at the same shape gives the same bytes
            plan = quant_plan(x)._replace(smem_bytes=0, resident=False)
            q2 = torch.empty(x.shape, dtype=torch.int8, device=dev)
            scratch = torch.empty(2 + 2 * plan.grid, device=dev)
            launch_quantize_affine(x, m, q2, scratch, plan)
            check(quant_bytes(q2, scratch[0], scratch[1]) == got,
                  f"quantize {case} {n}x{d}: the two routes differ")
    # the cohort entry: each client's codes and (xmin, scale) against the
    # plain version on the card and on the CPU, one launch a call
    def cohort_payload(case, b, n, d):
        xs, ms = [], []
        for i in range(b):
            c = case if case != "mixed" else {1: "all_masked",
                                              2: "nan"}.get(i, "ragged")
            x, m = quant_payload(c, n, d)
            xs.append(x * (i + 1))
            ms.append(m)
        return torch.stack(xs), torch.stack(ms)

    for b, n, d, case, resident in [
            (4, 100, 16384, "main_path", True), (4, 100, 16384, "mixed", True),
            (1, 100, 16384, "slots", True), (4, 37, 1001, "signed_zero", True),
            (sm_count(0) + 68, 37, 61, "ragged", False)]:
        x, m = cohort_payload(case, b, n, d)
        before = ops.quantize_affine_batched.launches
        got = quant_bytes(*ops.quantize_affine_batched(x, m))
        check(ops.quantize_affine_batched.launches == before + 1
              and ops.quantize_affine_batched.last_plan.resident == resident,
              f"cohort quantize {case} {b}x{n}x{d}: not one launch on the "
              f"{'resident' if resident else 'L2'} route")
        for where, (wx, wm) in (("card", (x, m)), ("CPU", (x.cpu(),
                                                          m.cpu()))):
            check(got == quant_bytes(*ref.quantize_affine_batched_ref(wx,
                                                                      wm)),
                  f"cohort quantize {case} {b}x{n}x{d}: not byte-exact "
                  f"against the plain version on the {where}")
    del x, m
    print("kernel checks: passed")

    # ---- 2b. attention kernels vs plain versions on the card -----------
    def att_check(k_name, got, want, dtype, what):
        tol = ATT_TOL[dtype]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        check(bool((diff <= tol + tol * want.float().abs()).all()),
              f"{k_name} {what}: max abs err {err} beyond {tol}")
        errs[k_name] = max(errs[k_name], err)
        return err

    from repro_torch.kernels.decode_attention import (MAX_G, plan_for,
                                                      tile_slots)
    from repro_torch.kernels.flash_attention import bwd_route, prefill_route
    dlib = build.library("decode_attention")
    check(all(dlib.repro_flash_decode_tile(d) == tile_slots(d)
              for d in (32, 64, 100, 128, 200, 256))
          and dlib.repro_flash_decode_max_g() == MAX_G,
          "decode tile / group limits differ between the kernel and the "
          "host plan")
    att = {}
    for b, s, h, kv, d, causal, window, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        q = randn(b, s, h, d).to(dtype)
        k, v = randn(b, s, kv, d).to(dtype), randn(b, s, kv, d).to(dtype)
        route = prefill_route(dtype, d)
        before = dict(ops.flash_attention.launches_by_route)
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        check(ops.flash_attention.launches_by_route[route]
              == before[route] + 1, f"flash_attention did not launch its "
                                    f"{route} route")
        what = (f"b{b} s{s} h{h} kv{kv} d{d} causal={causal} w{window} {dt} "
                f"{route}")
        att[what] = att_check("flash_attention", got, ref.flash_attention_ref(
            q, k, v, causal=causal, window=window), dt, what)
    for b, s, sk, h, kv, d, dt in CROSS_CASES:
        dtype = getattr(torch, dt)
        q = randn(b, s, h, d).to(dtype)
        k, v = randn(b, sk, kv, d).to(dtype), randn(b, sk, kv, d).to(dtype)
        route = prefill_route(dtype, d)
        before = dict(ops.flash_attention.launches_by_route)
        got = ops.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        check(ops.flash_attention.launches_by_route[route]
              == before[route] + 1, f"flash_attention did not launch its "
                                    f"{route} route")
        what = (f"b{b} s{s} sk{sk} h{h} kv{kv} d{d} causal=False w0 {dt} "
                f"{route}")
        want = ref.flash_attention_ref(q, k, v, causal=False)
        att[what] = att_check("flash_attention", got, want, dt, what)
        valid = torch.ones(b, sk, dtype=torch.bool, device=dev)
        one = ops.flash_decode(q[:, :1].contiguous(), k, v, valid)
        att[f"decode over all {sk} keys {what}"] = att_check(
            "flash_decode", one, want[:, :1], dt, f"decode {what}")
        for mask in ({"causal": True}, {"causal": False, "window": 8}):
            try:
                ops.flash_attention(q, k, v, **mask)
            except ValueError:
                continue
            check(False, f"flash_attention {what} {mask}: a masked call at "
                         f"Sk != S did not raise")
    for b, s, h, kv, d, fill, dt, ct, want_splits in DECODE_CASES:
        dtype, ctype = getattr(torch, dt), getattr(torch, ct)
        q = randn(b, 1, h, d).to(dtype)
        kc, vc = randn(b, s, kv, d).to(ctype), randn(b, s, kv, d).to(ctype)
        valid = (torch.arange(s, device=dev) < fill).expand(b, s).contiguous()
        got = ops.flash_decode(q, kc, vc, valid)
        torch.cuda.synchronize()
        splits = ops.flash_decode.last_splits
        check(splits == plan_for(q, kc)[0], f"decode ran {splits} splits, "
                                            f"the plan says {plan_for(q, kc)}")
        if want_splits is not None:
            check(splits == want_splits if want_splits else splits > 8,
                  f"decode b{b} s{s}: {splits} splits, want "
                  f"{want_splits or 'more than 8'}")
        if want_splits == 0:             # the same bits on a second run
            again = ops.flash_decode(q, kc, vc, valid)
            torch.cuda.synchronize()
            check(torch.equal(got, again), "decode: two runs on the same "
                                           "inputs differ (combine order)")
        what = (f"decode b{b} s{s} h{h} kv{kv} d{d} valid {fill} {dt}/{ct} "
                f"splits {splits}")
        att[what] = att_check("flash_decode", got, ref.flash_decode_ref(
            q, kc, vc, valid), dt, what)
    del q, k, v, kc, vc, valid, got
    # the forward's softmax statistics on the route each case takes (the
    # output bit for bit the same with or without them), and the backward
    # kernels, on the route bwd_route names, against the plain version fed
    # the same q, k, v, out, dout and statistics (the kernel forward's);
    # the BWD_TWICE cases twice, bit for bit
    for i, (b, s, h, kv, d, causal, window, dt) in enumerate(BWD_CASES):
        dtype = getattr(torch, dt)
        q = randn(b, s, h, d).to(dtype)
        k, v = randn(b, s, kv, d).to(dtype), randn(b, s, kv, d).to(dtype)
        dout = randn(b, s, h, d).to(dtype)
        route = prefill_route(dtype, d)
        before = dict(ops.flash_attention.launches_by_route)
        out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                       return_stats=True)
        plain_out = ops.flash_attention(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        check(ops.flash_attention.launches_by_route[route]
              == before[route] + 2, f"stats: flash_attention did not "
                                    f"launch its {route} route")
        what = (f"b{b} s{s} h{h} kv{kv} d{d} causal={causal} w{window} {dt} "
                f"{route}")
        check(torch.equal(out, plain_out), f"stats {what}: asking for the "
                                           f"statistics changed the output")
        att[f"stats {what}"] = att_check(
            "flash_attention_stats", lse, ref.flash_attention_ref(
                q, k, v, causal=causal, window=window,
                return_stats=True)[1], dt, f"stats {what}")
        n_before = ops.flash_attention_bwd.launches
        b_route = bwd_route(dtype, d, True, h // kv)
        by_before = dict(ops.flash_attention_bwd.launches_by_route)
        got = ops.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                      window=window)
        torch.cuda.synchronize()
        check(ops.flash_attention_bwd.launches == n_before + 1,
              f"backward {what}: not one count a call")
        check(ops.flash_attention_bwd.launches_by_route == {
            r: by_before[r] + (r == b_route) for r in by_before},
            f"backward {what}: did not run on the {b_route} route")
        what = f"{what}, backward {b_route}"
        want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                           torch.ones_like(lse),
                                           causal=causal, window=window)
        for grad_name, x, y in zip(("dq", "dk", "dv"), got, want):
            att[f"backward {grad_name} {what}"] = att_check(
                "flash_attention_bwd", x, y, dt,
                f"backward {grad_name} {what}")
        if i in BWD_TWICE:
            again = ops.flash_attention_bwd(q, k, v, out, dout, lse,
                                            causal=causal, window=window)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"backward {what}: two runs on the same inputs differ")
            del again
        del q, k, v, dout, out, lse, plain_out, got, want
    bwd_rel = {}              # each gradient's worst block of 1,024 rows
    for i, (b, s, sk, h, kv, d, dt) in enumerate(BWD_CROSS_CASES):
        dtype = getattr(torch, dt)
        q, dout = randn(b, s, h, d).to(dtype), randn(b, s, h, d).to(dtype)
        k, v = randn(b, sk, kv, d).to(dtype), randn(b, sk, kv, d).to(dtype)
        out, lse = ops.flash_attention(q, k, v, causal=False,
                                       return_stats=True)
        b_route = bwd_route(dtype, d, True, h // kv)
        ops.reset_launch_counts()
        got = ops.flash_attention_bwd(q, k, v, out, dout, lse, causal=False)
        torch.cuda.synchronize()
        what = (f"b{b} s{s} sk{sk} h{h} kv{kv} d{d} causal=False w0 {dt}, "
                f"backward {b_route}")
        check(ops.flash_attention_bwd.launches_by_route[b_route] == 1
              and ops.flash_attention_bwd.launches_by_lengths
              == {f"{s}x{sk}": 1},
              f"backward {what}: launches "
              f"{ops.flash_attention_bwd.launches_by_route}, "
              f"{ops.flash_attention_bwd.launches_by_lengths}")
        want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                           torch.ones_like(lse),
                                           causal=False)
        for grad_name, x, y in zip(("dq", "dk", "dv"), got, want):
            att[f"backward {grad_name} {what}"] = att_check(
                "flash_attention_bwd", x, y, dt,
                f"backward {grad_name} {what}")
            bwd_rel[f"backward {grad_name} {what}"] = rel_check(
                "flash_attention_bwd", x, y, 1, 1024,
                f"backward {grad_name} {what}")["worst_block_rel_err"]
        if i in BWD_CROSS_TWICE:
            again = ops.flash_attention_bwd(q, k, v, out, dout, lse,
                                            causal=False)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"backward {what}: two runs on the same inputs differ")
            del again
        if sk != s:
            for mask in ({"causal": True}, {"causal": False, "window": 8}):
                try:
                    ops.flash_attention_bwd(q, k, v, out, dout, lse, **mask)
                except ValueError:
                    continue
                check(False, f"backward {what} {mask}: a masked call at "
                             f"Sk != S did not raise")
        del q, k, v, dout, out, lse, got, want
    ops.reset_launch_counts()
    print(json.dumps({"attention_checks_max_abs_err": att,
                      "backward_sk_worst_block_rel_err": bwd_rel}))

    # ---- 3. one small round on the card and on the CPU -----------------
    small = get_wrn_config().reduced()
    sm = make_split_wrn(small)
    sds = SyntheticImageDataset(400, image_size=small.image_size,
                                modes_per_class=3, seed=3)
    scl = partition_k_shards(sds, num_clients=2, k_classes=2,
                             samples_per_client=100, seed=3)
    scfg = FLConfig(num_clients=2, clients_per_round=2, local_batch_size=25,
                    pca_components=16, clusters_per_class=4, kmeans_iters=10,
                    meta_epochs=2, meta_batch_size=8, transport_codec="int8")
    outs = {}
    for where in ("cuda", "cpu"):
        gen = torch.Generator().manual_seed(5)
        p = sm.init(gen, torch.device(where))
        led = CommLedger()
        rr = run_round(sm, p, sm.split(p)[1], scl, scfg, GeneratorDraws(gen),
                       ledger=led, num_classes=sds.num_classes)
        outs[where] = (rr, led.summary())
    (rg, lg), (rc, lc) = outs["cuda"], outs["cpu"]
    check(lg == lc, f"small round: ledger differs card {lg} vs cpu {lc}")
    check(rg.metadata_count == rc.metadata_count,
          "small round: metadata count differs")
    for key in rc.global_params:
        e = rel_err(rg.global_params[key].cpu(), rc.global_params[key])
        check(e <= TOL, f"small round: W_G[{key}] rel err {e}")
    print(f"small round card vs cpu: ledger equal "
          f"({lg['total_up']} B up), |D_M|={rg.metadata_count}")

    # ---- 3b. a reduced LM on the card and on the CPU -------------------
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.transformer import LM, tree_map
    lcfg = get_config("llama3.2-1b").reduced()
    lm_small = LM(lcfg)
    p_cpu = lm_small.init(torch.Generator().manual_seed(7))
    p_card = tree_map(lambda t: t.to(dev), p_cpu)
    toks = torch.randint(lcfg.vocab_size, (2, 64), generator=g,
                         dtype=torch.int32)
    prefill32, _ = make_prefill_step(lcfg, dtype=torch.float32)
    before = ops.launch_counts()
    lm_errs = [rel_err(prefill32(p_card, {"tokens": toks.to(dev)}).cpu(),
                       prefill32(p_cpu, {"tokens": toks}))]
    caches = {"cpu": lm_small.init_cache(2, 16, dtype=torch.float32),
              "card": lm_small.init_cache(2, 16, dtype=torch.float32,
                                          device=dev)}
    with torch.no_grad():
        for i in range(8):
            out = {}
            for where, p in (("cpu", p_cpu), ("card", p_card)):
                tk = toks[:, i:i + 1] if where == "cpu" else \
                    toks[:, i:i + 1].to(dev)
                out[where], caches[where], _ = lm_small.apply(
                    p, tk, mode="decode", cache=caches[where])
            lm_errs.append(rel_err(out["card"].cpu(), out["cpu"]))
    after = ops.launch_counts()
    check(max(lm_errs) <= TOL, f"reduced LM card vs cpu: rel errs {lm_errs}")
    check(after["flash_attention"] - before["flash_attention"] == 2
          and after["flash_decode"] - before["flash_decode"] == 16,
          f"reduced LM: attention launches {before} -> {after}")
    print(f"reduced LM card vs cpu: prefill + 8 decode steps, max rel err "
          f"{max(lm_errs)}")

    # ---- 3c. two runs of two small rounds, bit for bit -----------------
    # fresh FLSimulations from one seed in this process (cuDNN pinned to
    # deterministic algorithms by resolve_device): weights, ledger, the
    # decoded selections, accuracies and Lloyd sweeps must be equal
    runs = []
    for _ in range(2):
        dsim = FLSimulation(sm, scl, sds, scfg, seed=0, device=dev)
        picked, upload = [], dsim.channel.upload_knowledge

        def record(*args, _upload=upload, _picked=picked):
            got = _upload(*args)
            _picked.append([t.numpy().tobytes() for t in got])
            return got

        dsim.channel.upload_knowledge = record
        dres = dsim.run(rounds=2)
        runs.append(({k: v.cpu().numpy().tobytes()
                      for k, v in dsim.server.global_params.items()},
                     dres.comm, picked, dres.test_acc, dres.fedavg_acc,
                     dres.metadata_counts, dres.lloyd_iters))
    for what, a, b in zip(("weights", "ledger", "selections", "M_COM",
                           "FedAvg", "|D_M|", "Lloyd sweeps"), *runs):
        check(a == b, f"two runs of two small rounds: {what} differ")
    print(f"two runs of two small rounds: bit-identical "
          f"(Lloyd sweeps {runs[0][6]}, |D_M| {runs[0][5]})")

    # ---- 3d. the cohort engine against the client loop, on the card -----
    # two rounds of the small WRN-10-1, then both again under a fault plan
    # (checksums on): the same bits, the same fault log
    import dataclasses
    from repro_torch.fl.faults import FaultPlan
    scl4 = partition_k_shards(sds, num_clients=4, k_classes=2,
                              samples_per_client=100, seed=3)
    fplan = FaultPlan(drop_rate=0.2, late_crash_rate=0.1, bitflip_rate=0.3,
                      truncate_rate=0.2, duplicate_rate=0.2)
    for fault_plan in (None, fplan):
        runs = []
        for distributed in (False, True):
            cfg3 = dataclasses.replace(
                scfg, num_clients=4, clients_per_round=4,
                distributed_selection=distributed,
                transport_checksum=fault_plan is not None)
            dsim = FLSimulation(sm, scl4, sds, cfg3, seed=0, device=dev,
                                fault_plan=fault_plan, fault_seed=3)
            picked, upload = {}, dsim.channel.upload_knowledge

            def record(cid, *args, _upload=upload, _picked=picked, **kw):
                got = _upload(cid, *args, **kw)
                _picked[cid] = (None if got is None else
                                [t.numpy().tobytes() for t in got])
                return got

            dsim.channel.upload_knowledge = record
            ops.reset_launch_counts()
            log = []
            begin = dsim.channel.begin_round

            def begin_round(t, _begin=begin, _ch=dsim.channel, _log=log):
                _log.extend(getattr(_ch, "log", []))
                _begin(t)

            dsim.channel.begin_round = begin_round
            dres = dsim.run(rounds=2)
            log = sorted((e.round_idx, e.client_id, e.frame, e.kind,
                          e.attempt, e.detail)
                         for e in log + getattr(dsim.channel, "log", []))
            counts = ops.launch_counts()
            # one quantize a knowledge upload on the client loop (a client
            # that crashed before uploading quantizes nothing), one a round
            # on the cohort engine
            uploads = 8 - sum(e[3] == "crash_before_upload" for e in log)
            check(counts["quantize_affine_batched"] == (2 if distributed
                                                        else 0)
                  and counts["quantize_affine"] == (0 if distributed
                                                    else uploads),
                  f"3d: quantize launches {counts}, {uploads} uploads")
            runs.append(({k: v.cpu().numpy().tobytes()
                          for k, v in dsim.server.global_params.items()},
                         dres.comm, picked, dres.test_acc, dres.fedavg_acc,
                         dres.metadata_counts, dres.lloyd_iters, dres.drops,
                         dres.retransmits, log))
        for what, a, b in zip(("weights", "ledger", "selections", "M_COM",
                               "FedAvg", "|D_M|", "Lloyd sweeps", "drops",
                               "retransmits", "fault log"), *runs):
            check(a == b, f"3d: {what} differ between the cohort engine and "
                          f"the client loop "
                          f"({'faulty' if fault_plan else 'perfect'} wire)")
        if fault_plan is not None:
            check(sum(runs[0][7]) + sum(runs[0][8]) > 0,
                  "3d: the fault plan injected nothing")
        print(f"3d: cohort engine = client loop on the "
              f"{'faulty' if fault_plan else 'perfect'} wire, bit for bit "
              f"(drops {runs[0][7]}, retransmits {runs[0][8]}, "
              f"{len(runs[0][9])} fault events)")

    # ---- 4. the main path at full WRN-40-1 width -----------------------
    wcfg = get_wrn_config()
    model = make_split_wrn(wcfg)
    t0 = monotonic()
    train = SyntheticImageDataset(50_000, image_size=wcfg.image_size, seed=0)
    test = SyntheticImageDataset(2_000, image_size=wcfg.image_size, seed=1)
    clients = partition_k_shards(train, num_clients=4, k_classes=2,
                                 samples_per_client=2_500)
    print(f"data_s: {monotonic() - t0:.3f}")
    cfg = FLConfig(num_clients=4, clients_per_round=4, transport_codec="int8")
    sim = FLSimulation(model, clients, test, cfg, seed=0)
    ops.reset_launch_counts()
    res = sim.run(rounds=2, verbose=True)
    launches = ops.launch_counts()
    print(f"launches: {json.dumps(launches)}")
    for k_name in ("kmeans_pairwise_dist", "kmeans_lloyd_step",
                   "quantize_affine"):
        check(launches[k_name] > 0,
              f"{k_name} was never launched on the main path")
    # one int8 upload a client a round, one launch each
    check(launches["quantize_affine"] == 4 * 2
          and launches["quantize_affine_batched"] == 0,
          f"quantize launched {launches['quantize_affine']} times, not 8 "
          f"(cohort {launches['quantize_affine_batched']})")
    for key, t in sim.server.global_params.items():
        check(bool(torch.isfinite(t).all()), f"W_G[{key}] not finite")
    check(all(0 < c <= 4 * 10 * 10 for c in res.metadata_counts),
          f"metadata counts {res.metadata_counts}")
    print(json.dumps({
        "round_wall_s": res.round_wall_s,
        "selected_fraction": res.selected_fraction,
        "metadata_counts": res.metadata_counts,
        "lloyd_iters": res.lloyd_iters,
        "ledger": {"up": res.comm["up"], "down": res.comm["down"]},
        "m_com_acc": res.test_acc, "fedavg_acc": res.fedavg_acc}))

    # ---- 4b. the main path again, on the cohort engine -----------------
    ccfg = dataclasses.replace(cfg, distributed_selection=True)
    csim = FLSimulation(model, clients, test, ccfg, seed=0)
    ops.reset_launch_counts()
    cres = csim.run(rounds=2, verbose=True)
    cohort_launches = ops.launch_counts()
    print(f"cohort launches: {json.dumps(cohort_launches)}")
    for k_name in ("kmeans_pairwise_dist", "kmeans_lloyd_step",
                   "quantize_affine_batched"):
        check(cohort_launches[k_name] > 0,
              f"{k_name} was never launched on the cohort engine's path")
    check(cohort_launches["quantize_affine_batched"] == 2
          and cohort_launches["quantize_affine"] == 0,
          f"4b: quantize launches {cohort_launches}, want the cohort "
          f"kernel twice and the per-client one never")
    check(cohort_launches["kmeans_lloyd_step"]
          == launches["kmeans_lloyd_step"]
          and cohort_launches["kmeans_pairwise_dist"]
          == launches["kmeans_pairwise_dist"],
          f"4b: K-means launches {cohort_launches} differ from phase 4's "
          f"{launches}")
    for what, a, b in [
            ("weights", {k: v.cpu().numpy().tobytes()
                         for k, v in sim.server.global_params.items()},
             {k: v.cpu().numpy().tobytes()
              for k, v in csim.server.global_params.items()}),
            ("ledger", res.comm, cres.comm),
            ("metadata counts", res.metadata_counts, cres.metadata_counts),
            ("Lloyd sweeps", res.lloyd_iters, cres.lloyd_iters),
            ("M_COM", res.test_acc, cres.test_acc),
            ("FedAvg", res.fedavg_acc, cres.fedavg_acc),
            ("client loss", res.client_loss, cres.client_loss)]:
        check(a == b, f"4b: {what} differ from phase 4's")
    print(json.dumps({"cohort_engine": {
        "round_wall_s": cres.round_wall_s,
        "client_loop_round_wall_s": res.round_wall_s,
        "bit_identical_to_phase_4": True,
        "launches": cohort_launches}}))
    # ---- 7. the async service at full width ----------------------------
    # (its own function: the services and their weights are freed on return)
    print(json.dumps({"service": run_service_phase(
        model, clients, test, cfg, sim, res, launches)}))
    # ---- 8. the rest of selection, the checkpoint and paper_repro ------
    # (its own function: its maps and runs are freed on return)
    print(json.dumps({"selection_and_checkpoint": run_selection_phase(
        model, clients, test, cfg, sim, res)}))
    # each run freed its captured LocalUpdate graphs when it returned: what
    # stays on the card for serving is phase 5's data, not the FL runs'
    del csim
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(json.dumps({"memory_allocated_before_serving":
                      torch.cuda.memory_allocated()}))

    # ---- 6. serve llama3.2-1b at full width ----------------------------
    from repro_torch.launch import serve
    full = get_config("llama3.2-1b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    served = serve.main(["--arch", "llama3.2-1b", "--batch",
                         str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT),
                         "--cache-len", str(SERVE_CACHE), "--tokens",
                         str(SERVE_TOKENS)])
    serve_launches = ops.launch_counts()
    serve_mem = torch.cuda.max_memory_allocated()
    want_decode = full.num_layers * (SERVE_PROMPT - 1 + SERVE_TOKENS)
    check(serve_launches["flash_decode"] == want_decode
          and serve_launches["flash_attention"] == 0,
          f"serve launches {serve_launches}, want {want_decode} decodes")
    check(served.tokens.shape == (SERVE_BATCH, SERVE_TOKENS)
          and int(served.tokens.min()) >= 0
          and int(served.tokens.max()) < full.padded_vocab,
          f"served tokens {served.tokens.shape}")

    prefill, lm_full = make_prefill_step(full)           # bf16
    # bf16 weights made one layer slice at a time (as launch.serve)
    pbf = lm_full.init(torch.Generator(device=dev).manual_seed(0),
                       dtype=torch.bfloat16)
    ptoks = torch.from_numpy(np.random.default_rng(1).integers(
        0, full.vocab_size, (1, PREFILL_S), np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = monotonic()
    plogits = prefill(pbf, {"tokens": ptoks})
    torch.cuda.synchronize()
    prefill_s = monotonic() - t0
    prefill_launches = ops.launch_counts()
    prefill_routes = dict(ops.flash_attention.launches_by_route)
    prefill_mem = torch.cuda.max_memory_allocated()
    check(prefill_launches["flash_attention"] == full.num_layers
          and prefill_routes["tensor_core"] == full.num_layers
          and prefill_launches["flash_decode"] == 0,
          f"prefill launches {prefill_launches}, by route {prefill_routes}")
    check(tuple(plogits.shape) == (1, 1, full.padded_vocab)
          and bool(torch.isfinite(plogits).all()),
          "prefill logits not finite or of the wrong shape")
    # where a prefill call's device time goes (profiled again, after the
    # counts are read)
    prefill_profile = device_profile(
        lambda: prefill(pbf, {"tokens": ptoks}))
    # the decode step's logits at the serve shape, and where one decode
    # step's time goes (the counts above are read)
    dcache = lm_full.init_cache(SERVE_BATCH, SERVE_CACHE, device=dev)
    dtoks = ptoks[0, :3 * SERVE_BATCH].reshape(SERVE_BATCH, 3)
    for i in range(2):
        dlogits, dcache, _ = lm_full.apply(pbf, dtoks[:, i:i + 1],
                                           mode="decode", cache=dcache,
                                           dtype=torch.bfloat16)
        check(bool(torch.isfinite(dlogits).all()),
              f"decode logits not finite at step {i}")
    decode_step, _ = make_decode_step(full)
    decode_profile = device_profile(
        lambda: decode_step(pbf, dcache, dtoks[:, 2:3]))
    del pbf, dcache, dlogits, plogits
    ops.reset_launch_counts()
    torch.cuda.empty_cache()
    print(json.dumps({
        "serve": {"model": full.name, "batch": SERVE_BATCH,
                  "cache_len": SERVE_CACHE, "prompt_len": SERVE_PROMPT,
                  "new_tokens": SERVE_TOKENS,
                  "prompt_fed_s": served.prompt_s,
                  "decode_s": served.decode_s,
                  "decode_ms_per_step": served.decode_s / SERVE_TOKENS * 1e3,
                  "tok_per_s": served.tok_per_s,
                  "launches": serve_launches,
                  "max_memory_allocated": serve_mem},
        "prefill": {"batch": 1, "seq_len": PREFILL_S, "prefill_s": prefill_s,
                    "launches": prefill_launches,
                    "flash_attention_launches_by_route": prefill_routes,
                    "max_memory_allocated": prefill_mem},
        "profiled_prefill_call": prefill_profile,
        "profiled_decode_step": decode_profile}))

    # ---- 9. the federated LM training path -----------------------------
    # (its own function: the model, its gradients and the probes are freed
    # on return)
    training, bwd_row = run_training_phase(dev, rel_err)
    print(json.dumps({"training": training}))

    # ---- 10. serving qwen3-moe-30b-a3b and phi3-medium-14b -------------
    # (its own function: the 61 GB model is freed on return)
    moe_serving, moe_launches = run_moe_serving_phase(dev, rel_err)
    print(json.dumps({"moe_serving": moe_serving}))

    # ---- 11. serving deepseek-v2-236b (MLA) and rwkv6-3b ---------------
    # (its own function: the 42 GB model is freed on return)
    mla_rwkv, mla_launches = run_mla_rwkv_phase(dev, rel_err)
    print(json.dumps({"mla_rwkv_serving": mla_rwkv}))

    # ---- 12. serving jamba (Mamba), whisper and internvl2 --------------
    # (its own function: each model is freed before the next)
    last_families, last_launches, last_profiles = run_last_families_phase(
        dev, rel_err)
    print(json.dumps({"last_families_serving": last_families}))

    # ---- 13. training with the extras: whisper and internvl2 -----------
    # (its own function: each model is freed before the next)
    extras_training, extras_rows = run_extras_training_phase(dev, rel_err)
    print(json.dumps({"extras_training": extras_training}))

    # ---- 5. timings ----------------------------------------------------
    def cuda_ms(fn, iters=50, warmup=3):
        """Mean ms of one call over ``iters`` back-to-back calls (CUDA
        events: the wrapper call's time, host work between launches
        included)."""
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # the main path's shapes: a client's 2500 x 200 features
    n, p_, kk, ck = 2500, 200, 10, 100
    x = randn(n, p_)
    c_init, c_all = randn(kk, p_), randn(ck, p_)
    lm = label_mask(n, 10, kk)
    # quantize at the main path's mask (2 of 10 classes: 20 of 100 slots
    # valid) and at phase 5's earlier one (80 of 100)
    qx = randn(100, 16384)
    qmasks = {}
    for valid_rows in (20, 80):
        qm = torch.zeros(100, dtype=torch.bool)
        qm[torch.randperm(100, generator=g)[:valid_rows]] = True
        qmasks[valid_rows] = qm.to(dev)
    qm = qmasks[20]
    # the cohort quantize at the main path's cohort: 4 clients x 100 slots,
    # 20 valid each
    qcx = torch.stack([randn(100, 16384) for _ in range(4)])
    qcm = torch.zeros(4, 100, dtype=torch.bool)
    for i in range(4):
        qcm[i, torch.randperm(100, generator=g)[:20]] = True
    qcm = qcm.to(dev)
    # launches on the main path: phase 4's, and phase 4b's for the cohort
    # kernel
    counting = {**launches, "quantize_affine_batched":
                cohort_launches["quantize_affine_batched"]}
    w_rows = int((torch.amin(lm, 1) <= 0).sum())

    def quant_bound(valid_rows):
        # the valid rows in, the mask in, every code and the params out
        return bound(4 * valid_rows * 16384 + 100 + 100 * 16384 + 8,
                     7 * valid_rows * 16384)

    rows = []
    spec = [
        ("kmeans_pairwise_dist", "src/repro_torch/kernels/csrc/kmeans.cu",
         "src/repro/kernels/kmeans.py:67",
         lambda: ops.kmeans_pairwise_dist(x, c_init),
         lambda: ref.kmeans_pairwise_dist_ref(x, c_init),
         lambda: torch.cdist(x, c_init),
         bound(4 * (n * p_ + kk * p_ + n * kk),
               2 * n * kk * p_ + 2 * (n + kk) * p_ + 3 * n * kk)),
        ("kmeans_lloyd_step", "src/repro_torch/kernels/csrc/kmeans.cu",
         "src/repro/kernels/kmeans.py:127",
         lambda: ops.kmeans_lloyd_step(x, c_all, lm),
         lambda: ref.kmeans_lloyd_ref(x, c_all, lm), None,
         bound(4 * (n * p_ + ck * p_ + n * ck + 2 * n + ck * p_ + ck),
               2 * n * ck * p_ + 2 * (n + ck) * p_ + 4 * n * ck
               + w_rows * p_)),
        ("quantize_affine", "src/repro_torch/kernels/csrc/quantize.cu",
         "src/repro/kernels/quantize.py:81",
         lambda: ops.quantize_affine(qx, qm),
         lambda: ref.quantize_affine_ref(qx, qm), None, quant_bound(20)),
        ("quantize_affine_batched", "src/repro_torch/kernels/csrc/quantize.cu",
         "src/repro/kernels/quantize.py:81",
         lambda: ops.quantize_affine_batched(qcx, qcm),
         lambda: ref.quantize_affine_batched_ref(qcx, qcm), None,
         bound(4 * (4 * 20 * 16384) + 4 * 100 + 4 * 100 * 16384 + 4 * 8,
               7 * 4 * 20 * 16384)),
    ]
    # registers and spills per thread of the timed instantiations, from
    # the -Xptxas -v report of phase 1's build (``ptxas``)
    # the CUDA launches of each wrapper, by kernel name (a Lloyd sweep is
    # two launches)
    launch_names = {
        "kmeans_pairwise_dist": ("kmeans", ("pairwise_dist_kernel",)),
        "kmeans_lloyd_step": ("kmeans", ("lloyd_assign_kernel",
                                         "lloyd_sums_kernel")),
        "quantize_affine": ("quantize", ("quantize_affine_kernel",)),
        "quantize_affine_batched": ("quantize",
                                    ("quantize_affine_cohort_kernel",))}
    # the quantize kernels' two instantiations, one a route
    ptxas_patterns = {"quantize_affine": {
        "resident": r"quantize_affine_kernelILb1E",
        "l2": r"quantize_affine_kernelILb0E"},
        "quantize_affine_batched": {
        "resident": r"quantize_affine_cohort_kernelILb1E",
        "l2": r"quantize_affine_cohort_kernelILb0E"}}
    for k_name, src, tpu, kern, plain, lib, (b_ms, b_by) in spec:
        ms = cuda_ms(kern)
        by_launch = kernel_device_ms(kern, launch_names[k_name][1])
        plain_ms = cuda_ms(plain)
        lib_ms = cuda_ms(lib) if lib is not None else None
        row = {"name": k_name, "route": "cuda", "source": src,
               "replaces": tpu, "launches": counting[k_name],
               "max_abs_err": errs[k_name], "ms": ms,
               "device_ms": sum(by_launch.values()),
               "device_ms_by_launch": by_launch, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "ptxas": {nm: ptxas(launch_names[k_name][0], pattern)
                         for nm, pattern in ptxas_patterns.get(
                             k_name, {nm: nm for nm in
                                      launch_names[k_name][1]}).items()}}
        if k_name == "quantize_affine":
            row["byte_exact"] = True
            row["plan"] = ops.quantize_affine.last_plan._asdict()
            row["by_mask"] = {}
            for valid_rows, qmv in qmasks.items():
                def qcall(qmv=qmv):
                    return ops.quantize_affine(qx, qmv)
                q_ms = kernel_device_ms(qcall, ("quantize_affine_kernel",))
                qb_ms, qb_by = quant_bound(valid_rows)
                row["by_mask"][f"{valid_rows}_of_100_valid"] = {
                    "device_ms": q_ms["quantize_affine_kernel"],
                    "ms": cuda_ms(qcall), "bound_ms": qb_ms,
                    "bound_by": qb_by, "plain_ms": cuda_ms(
                        lambda qmv=qmv: ref.quantize_affine_ref(qx, qmv))}
        else:             # the K-means row plan, or the cohort plan, it ran
            row["plan"] = getattr(ops, k_name).last_plan._asdict()
        if k_name == "quantize_affine_batched":
            row["byte_exact"] = True
            row["shape"] = list(qcx.shape)
        rows.append(row)

    # the attention kernels, one row a template instance the main path
    # runs (bf16): D 64 at phase 6's shapes, one prefill layer (B=1,
    # S=32768, H=32, KV=8, causal) and one decode layer of the serve run's
    # last step (B=32, 32768 slots, 47 of them valid); D 128 at phase
    # 10a's, qwen3-moe-30b-a3b's (B=1, S=32768, H=32, KV=4) and (B=4, 32768
    # slots, 47 valid); phase 10c's phi3 runs the same prefill instance
    # and the decode's G=4 one (held in 2b at its shapes). Each row's
    # kernel is held against the plain version at the row's shape; its
    # device ms is a launch's in the main path's own profile (phase 6's or
    # 10a's): a trace taken here saw none of the prefill kernel's launches.
    gd = torch.Generator(device=dev).manual_seed(2)

    def drandn(*shape):
        return torch.randn(shape, generator=gd, device=dev).to(torch.bfloat16)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    from repro_torch.models import layers as L

    def errs_2b(pattern):
        """The largest error of 2b's cases whose name matches."""
        return max(v for k, v in att.items() if re.fullmatch(pattern, k))

    def path_device_ms(profile, family):
        """The device ms a call of the kernels of ``family`` took in the
        main path's own profile (their launches summed, a launch each)."""
        per = {k: v for k, v in profile["attention_device_ms_a_launch"]
               .items() if family in k}
        check(bool(per), f"the profile holds no {family} launch")
        return {"device_ms": sum(v["device_ms"] for v in per.values()),
                "device_ms_by_launch": per}

    def prefill_row(name, s_, h_, kv_, d_, by_phase, instance, profile,
                    what, plain_chunk=1024, b_=1, sk_=None, causal=True):
        sk_ = sk_ or s_
        qa, ka, va = (drandn(b_, s_, h_, d_), drandn(b_, sk_, kv_, d_),
                      drandn(b_, sk_, kv_, d_))

        def plain():
            return L._sdpa_chunked_raw(qa, ka, va, causal=causal, window=0,
                                       chunk=plain_chunk)

        def kern():
            return ops.flash_attention(qa, ka, va, causal=causal)
        got, want = kern(), plain()
        full_err = att_check("flash_attention", got, want, "bfloat16", what)
        rel = rel_check("flash_attention", got, want, 1, 1024, what)
        del got, want
        a_bytes = 2 * (2 * qa.numel() + ka.numel() + va.numel())
        # causal: half of the 4 B S Sk H D of the full products
        a_flops = (2 if causal else 4) * b_ * s_ * sk_ * h_ * d_
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:89",
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": max(full_err, errs_2b(
                rf"b\d+ s\d+ {'sk' if sk_ != s_ else 'h'}\d+ .*d{d_} .* "
                rf"bfloat16 tensor_core")),
            "ms": cuda_ms(kern, 5, 1),
            **path_device_ms(profile, "::flash_fwd_wgmma_kernel<"),
            "kernel_route": prefill_route(qa.dtype, d_),
            "instance": instance,
            "ptxas": ptxas("flash_attention", instance),
            "plain_ms": cuda_ms(plain, 2, 1),
            "plain": f"layers._sdpa_chunked_raw in chunks of {plain_chunk} "
                     f"keys (flash_attention_ref's S x Sk scores would take "
                     f"{4 * b_ * h_ * s_ * sk_ / 1e9:.1f} GB at S={s_}, "
                     f"Sk={sk_})",
            "causal": causal,
            "max_abs_err_vs_plain_at_this_shape": full_err, **rel,
            **dict(zip(("bound_ms", "bound_by"),
                       bound(a_bytes, a_flops, H100_BF16_FLOPS))),
            "library_ms": cuda_ms(lambda: sdpa(
                qa.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2),
                is_causal=causal, enable_gqa=True), 5, 1),
            "shape": [b_, s_, h_, kv_, d_], "key_len": sk_}
        del qa, ka, va
        torch.cuda.empty_cache()
        return row

    def decode_row(name, b_, s_, n_valid, h_, kv_, d_, by_phase, instances,
                   profile, what):
        qd = drandn(b_, 1, h_, d_)
        kcd, vcd = drandn(b_, s_, kv_, d_), drandn(b_, s_, kv_, d_)
        vmask = (torch.arange(s_, device=dev) < n_valid).expand(
            b_, s_).contiguous()
        got = ops.flash_decode(qd, kcd, vcd, vmask)
        splits = ops.flash_decode.last_splits
        want = ref.flash_decode_ref(qd, kcd, vcd, vmask)
        dec_err = att_check("flash_decode", got, want, "bfloat16", what)
        rel = rel_check("flash_decode", got, want, 0, 1, what)
        del got, want
        d_bytes = 2 * (2 * qd.numel() + kcd.numel() + vcd.numel()) \
            + vmask.numel()
        d_flops = 4 * b_ * h_ * s_ * d_
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:59",
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": max(dec_err, errs_2b(
                rf"decode b\d+ s\d+ h\d+ kv\d+ d{d_} .* "
                rf"bfloat16/bfloat16 splits \d+")),
            "ms": cuda_ms(lambda: ops.flash_decode(qd, kcd, vcd, vmask),
                          20, 2),
            **path_device_ms(profile, "::flash_decode_"),
            "kernel_route": "cuda_core, split S", "splits": splits,
            "ptxas": {g: ptxas("decode_attention", pattern)
                      for g, pattern in instances.items()},
            "plain_ms": cuda_ms(
                lambda: ref.flash_decode_ref(qd, kcd, vcd, vmask), 3, 1),
            "max_abs_err_vs_plain_at_this_shape": dec_err, **rel,
            **dict(zip(("bound_ms", "bound_by"),
                       bound(d_bytes, d_flops, H100_BF16_FLOPS))),
            "library_ms": cuda_ms(lambda: sdpa(
                qd.transpose(1, 2), kcd.transpose(1, 2), vcd.transpose(1, 2),
                attn_mask=vmask[:, None, None, :], enable_gqa=True), 3, 1),
            "shape": [b_, s_, h_, kv_, d_]}
        del qd, kcd, vcd, vmask
        torch.cuda.empty_cache()
        return row

    moe_cfg = get_config(MOE_ARCH)
    mh, mkv, md = moe_cfg.num_heads, moe_cfg.num_kv_heads, moe_cfg.head_dim
    rows.append(prefill_row(
        "flash_attention", PREFILL_S, full.num_heads, full.num_kv_heads,
        full.head_dim, {"6": prefill_launches["flash_attention"]},
        r"flash_fwd_wgmma_kernelILi64ELi128ELi3E", prefill_profile,
        "at phase 6's prefill shape"))
    rows.append(prefill_row(
        "flash_attention_d128", MOE_PREFILL_S, mh, mkv, md,
        {"10a": moe_launches["10a_prefill"],
         "10c": moe_launches["10c_prefill"],
         "12a": last_launches["12a_prefill"]},
        r"flash_fwd_wgmma_kernelILi128ELi128ELi2E",
        moe_serving["10a"]["profiled_prefill_call"],
        "at phase 10a's prefill shape"))
    rows.append(decode_row(
        "flash_decode", SERVE_BATCH, SERVE_CACHE,
        SERVE_PROMPT - 1 + SERVE_TOKENS, full.num_heads, full.num_kv_heads,
        full.head_dim, {"6": serve_launches["flash_decode"]},
        {"g4": r"flash_decode_kernelI13__nv_bfloat16S\d_Li64ELi4E"},
        decode_profile, "at phase 6's decode shape"))
    rows.append(decode_row(
        "flash_decode_d128", MOE_BATCH, MOE_CACHE,
        MOE_PROMPT - 1 + MOE_TOKENS, mh, mkv, md,
        {"10a": moe_launches["10a_decode"],
         "10c": moe_launches["10c_decode"],
         "12a": last_launches["12a_decode"]},
        {"g8": r"flash_decode_kernelI13__nv_bfloat16S\d_Li128ELi8E",
         "g4": r"flash_decode_kernelI13__nv_bfloat16S\d_Li128ELi4E"},
        moe_serving["10a"]["profiled_decode_step"],
        "at phase 10a's decode shape"))
    # MLA's D 192 (deepseek-v2-236b: 128 query heads over 128 rebuilt kv
    # heads, values padded to 192) at phase 11a's shapes: the prefill
    # kernel's <192, 64, 2> instance and the decode kernel's DMAX 256,
    # GMAX 2 one
    mla_cfg = get_config(MLA_ARCH)
    mla_d = mla_cfg.qk_nope_head_dim + mla_cfg.qk_rope_head_dim
    rows.append(prefill_row(
        "flash_attention_d192", MLA_PREFILL_S, mla_cfg.num_heads,
        mla_cfg.num_heads, mla_d, {"11a": mla_launches["11a_prefill"]},
        r"flash_fwd_wgmma_kernelILi192ELi64ELi2E",
        mla_rwkv["11a"]["profiled_prefill_call"],
        "at phase 11a's prefill shape", plain_chunk=MLA_PLAIN_CHUNK))
    rows.append(decode_row(
        "flash_decode_d192", MLA_BATCH, MLA_CACHE,
        MLA_PROMPT - 1 + MLA_TOKENS, mla_cfg.num_heads, mla_cfg.num_heads,
        mla_d, {"11a": mla_launches["11a_decode"]},
        {"g2": r"flash_decode_kernelI13__nv_bfloat16S\d_Li256ELi2E"},
        mla_rwkv["11a"]["profiled_decode_step"],
        "at phase 11a's decode shape"))
    # phase 12's new paths: whisper's encoder (the prefill kernel without a
    # causal mask at S 1,500, no multiple of a key tile, B 16, 16 / 16
    # heads of 64), its decoder's self-attention at G 1 (causal at S
    # 32,768; the decode kernel over 32,768 slots at batch 16) and its
    # cross-attention (32,768 decoder queries over 1,500 encoder keys; the
    # decode kernel over 1,500 valid slots at batch 16), on the D 64
    # instances; internvl2's D 128 at G 6 (48 / 8 heads) on the D 128
    # instances (the decode's GMAX 8 one). Launches: 12c's counts by query
    # and key length. Device ms: the encoder's and internvl2's from 12c's
    # and 12d's own profiles, the decoder's self and cross calls' from one
    # call each profiled in 12c (20 calls, a launch's mean)
    wcfg = get_config(WHISPER_ARCH)
    vcfg = get_config(VLM_ARCH)
    wh, wd = wcfg.num_heads, wcfg.head_dim
    rows.append(prefill_row(
        "flash_attention_enc", wcfg.encoder_seq_len, wh, wh, wd,
        {"12c_encode": last_launches["12c_encode"],
         "12c_prefill": last_launches["12c_prefill_encoder"]},
        r"flash_fwd_wgmma_kernelILi64ELi128ELi3E",
        last_profiles["12c_encode"], "at phase 12c's encoder shape",
        b_=WHISPER_BATCH, causal=False))
    rows.append(prefill_row(
        "flash_attention_g1", WHISPER_PREFILL_S, wh, wh, wd,
        {"12c_prefill": last_launches["12c_prefill_self"]},
        r"flash_fwd_wgmma_kernelILi64ELi128ELi3E",
        last_profiles["12c_self_prefill"],
        "at phase 12c's decoder self-attention prefill shape"))
    rows.append(decode_row(
        "flash_decode_g1", WHISPER_BATCH, WHISPER_CACHE,
        WHISPER_PROMPT - 1 + WHISPER_TOKENS, wh, wh, wd,
        {"12c_decode": last_launches["12c_decode_self"]},
        {"g1": r"flash_decode_kernelI13__nv_bfloat16S\d_Li64ELi2E"},
        last_profiles["12c_self_decode"],
        "at phase 12c's decoder self-attention decode shape"))
    rows.append(prefill_row(
        "flash_attention_cross", WHISPER_PREFILL_S, wh, wh, wd,
        {"12c_prefill": last_launches["12c_prefill_cross"]},
        r"flash_fwd_wgmma_kernelILi64ELi128ELi3E",
        last_profiles["12c_cross_prefill"],
        "at phase 12c's cross-attention prefill shape",
        sk_=wcfg.encoder_seq_len, causal=False))
    rows.append(decode_row(
        "flash_decode_cross", WHISPER_BATCH, wcfg.encoder_seq_len,
        wcfg.encoder_seq_len, wh, wh, wd,
        {"12c_decode": last_launches["12c_decode_cross"]},
        {"g1": r"flash_decode_kernelI13__nv_bfloat16S\d_Li64ELi2E"},
        last_profiles["12c_cross_decode"],
        "at phase 12c's cross-attention decode shape"))
    rows.append(prefill_row(
        "flash_attention_d128_g6", VLM_PREFILL_S, vcfg.num_heads,
        vcfg.num_kv_heads, vcfg.head_dim,
        {"12d": last_launches["12d_prefill"]},
        r"flash_fwd_wgmma_kernelILi128ELi128ELi2E",
        last_profiles["12d_prefill"], "at phase 12d's prefill shape"))
    rows.append(decode_row(
        "flash_decode_d128_g6", VLM_BATCH, VLM_CACHE,
        VLM_PROMPT - 1 + VLM_TOKENS, vcfg.num_heads, vcfg.num_kv_heads,
        vcfg.head_dim, {"12d": last_launches["12d_decode"]},
        {"g6": r"flash_decode_kernelI13__nv_bfloat16S\d_Li128ELi8E"},
        last_profiles["12d_decode"], "at phase 12d's decode shape"))
    # the backward kernels, timed by phase 9 at one training layer's shape,
    # and by phase 13 at whisper's cross and encoder layers and
    # internvl2's layer
    rows.append({**bwd_row, "max_abs_err": errs["flash_attention_bwd"]})
    rows.extend(extras_rows)
    ops.reset_launch_counts()          # timing launches are not the path's

    # where one client's round goes (full width, the last global weights)
    params = sim.server.global_params
    cl = clients[0]
    xs = torch.as_tensor(cl.data.x, device=dev)
    ys = torch.as_tensor(cl.data.y, device=dev)
    draws = GeneratorDraws(torch.Generator().manual_seed(11)).client(
        0, cl, 10, 1)

    def timed(fn, iters=3):
        fn()
        sync(params)
        t = monotonic()
        for _ in range(iters):
            out = fn()
        torch.cuda.synchronize()
        return (monotonic() - t) / iters * 1e3, out

    phases = {}
    with torch.no_grad():
        phases["lower_forward_ms"], acts = timed(
            lambda: model.apply_lower(params, xs))
    flat = acts.reshape(acts.shape[0], -1)
    xc = flat - flat.mean(0)
    gram = (xc @ xc.T) / flat.shape[0]
    phases["pca_gram_ms"], _ = timed(lambda: (xc @ xc.T) / flat.shape[0])
    phases["pca_eigh_ms"], _ = timed(lambda: torch.linalg.eigh(gram))
    phases["pca_total_ms"], feats = timed(
        lambda: sel_mod.fit_features(acts, cfg.pca_components))
    first = draws.first_centres.tolist()
    phases["kmeans_init_ms"], c0 = timed(lambda: torch.cat(
        [sel_mod.kmeans_init(feats, 10, first[k], ys == k)
         for k in range(10)]))
    slot = torch.arange(ck, device=dev) // 10
    lmask = torch.where(ys[:, None] == slot[None, :], 0.0,
                        ref.BIG).to(torch.float32)
    phases["lloyd_loop_ms"], _ = timed(
        lambda: sel_mod.lloyd_iterate(feats, c0, lmask, 25))
    phases["select_total_ms"], sel = timed(lambda: sel_mod.select_metadata(
        acts, ys, draws.first_centres, num_classes=10))
    channel = Channel(CommLedger())
    codec = get_codec(cfg.transport_codec)
    phases["upload_int8_ms"], _ = timed(lambda: channel.upload_knowledge(
        0, acts[sel.indices], ys[sel.indices], sel.valid, codec))
    # phase 5's captured SGD steps (captured in each timing's warm-up call)
    steps = fa.CapturedSteps()
    bx, by = local_batches(xs, ys, draws.local_perms, cfg)
    phases["local_update_ms"], _ = timed(
        lambda: fa.local_update(params, cfg.local_lr, bx, by, model.loss),
        iters=1)
    # the captured SGD step (a CUDA graph replayed once a step), which the
    # rounds run on the card
    order = local_order(xs.shape[0], draws.local_perms, cfg).to(dev)
    phases["local_update_captured_ms"], _ = timed(
        lambda: fa.client_update(params, cfg.local_lr, xs, ys, order,
                                 model.loss, steps))
    # the client side of a full-width round of 4 clients, on the client
    # loop and on the cohort engine, from the same draws
    for key, c in (("client_loop_4_clients_ms", cfg),
                   ("cohort_engine_4_clients_ms", ccfg)):
        phases[key], _ = timed(lambda c=c: run_cohort(
            model, params, clients, c,
            GeneratorDraws(torch.Generator().manual_seed(13)),
            Channel(CommLedger()), 10, steps=steps), iters=1)
    phases["client_round_ms"], _ = timed(lambda: client_round(
        model, params, cl, cfg, draws, channel, 10, steps=steps), iters=1)
    # the server's side: meta-training on 80 maps (this client's selected
    # maps, repeated to the 4-client round's |D_M|) and one evaluation
    picked = sel.indices[sel.valid]
    reps = -(-80 // len(picked))
    meta_x = acts[picked].repeat(reps, 1, 1, 1)[:80]
    meta_y = ys[picked].repeat(reps)[:80]
    upper0 = sim.server.upper_init
    perms = GeneratorDraws(torch.Generator().manual_seed(12)).meta_perms(
        80, cfg.meta_epochs)
    phases["meta_train_80_ms"], _ = timed(lambda: mt.meta_train(
        upper0, model.upper_loss, meta_x, meta_y, perms,
        batch_size=cfg.meta_batch_size, lr=cfg.meta_lr), iters=1)
    phases["evaluate_2000_ms"], _ = timed(lambda: evaluate(
        model, params, sim.test_x, sim.test_y), iters=1)
    # device busy share of one client round, and its kernels by device time
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = monotonic()
        client_round(model, params, cl, cfg, draws, channel, 10, steps=steps)
        torch.cuda.synchronize()
        wall_ms = (monotonic() - t) * 1e3
    # and of one captured LocalUpdate
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as lprof:
        t = monotonic()
        fa.client_update(params, cfg.local_lr, xs, ys, order, model.loss,
                         steps)
        torch.cuda.synchronize()
        lu_wall_ms = (monotonic() - t) * 1e3
    steps.release()
    ops.reset_launch_counts()

    def busy(prof, wall):
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        b_ms = sum(e.self_device_time_total for e in evs) / 1e3
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:10]
        return {"wall_ms": wall, "device_busy_ms": b_ms,
                "device_busy_share": b_ms / wall,
                "top_device_ms": {e.key[:80]: e.self_device_time_total / 1e3
                                  for e in top}}

    print(json.dumps({"phases_ms": phases, "lloyd_sweeps": sel.lloyd_iters,
                      "client_rows": int(xs.shape[0]),
                      "profiled_client_round": busy(prof, wall_ms),
                      "profiled_captured_local_update": busy(lprof,
                                                             lu_wall_ms)}))

    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    check(all(math.isfinite(r["ms"]) for r in rows), "a kernel time is NaN")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def run_service_phase(model, clients, test, cfg, sim, res, launches):
    """Phase 7: ``FLService`` at phase 4's full width, against phase 4's
    ``FLSimulation`` run (``sim``, ``res``, its launch counts
    ``launches``); returns the phase's numbers."""
    import dataclasses
    from collections import Counter

    import torch
    from repro_torch.fl.service import (DegenerateTraffic, FLService,
                                        PoissonTraffic)
    from repro_torch.kernels import ops
    from repro_torch.obs import load_trace, span_paths
    from repro_torch.obs.timing import monotonic

    def weights(params):
        return {k: v.cpu().numpy().tobytes() for k, v in params.items()}

    sim_w = weights(sim.server.global_params)
    sim_comm = {k: v for k, v in res.comm.items() if k != "total_samples"}
    selection = ("kmeans_pairwise_dist", "kmeans_lloyd_step",
                 "quantize_affine", "quantize_affine_batched")

    def degenerate(observability):
        ops.reset_launch_counts()
        svc = FLService(model, clients, test,
                        dataclasses.replace(cfg, observability=observability),
                        seed=0, traffic=DegenerateTraffic(), buffer_size=4)
        t0 = monotonic()
        out = svc.run(ticks=2)
        wall = monotonic() - t0
        counts = ops.launch_counts()
        tag = "7c" if observability else "7a"
        for what, a, b in [
                ("weights", weights(svc.server.global_params), sim_w),
                ("ledger", out.comm, sim_comm),
                ("M_COM", out.test_acc, res.test_acc),
                ("FedAvg", out.fedavg_acc, res.fedavg_acc),
                ("|D_M|", out.metadata_counts, res.metadata_counts),
                ("K-means and quantize launches",
                 {k: counts[k] for k in selection},
                 {k: launches[k] for k in selection})]:
            check(a == b, f"{tag}: {what} differ from phase 4's FLSimulation")
        check(out.mean_staleness == 0.0 and out.flushes == 2,
              f"{tag}: staleness {out.flush_staleness}, {out.flushes} "
              f"flushes")
        return svc, out, wall, counts

    # 7a: the degenerate service is phase 4's simulator, bit for bit
    svc, ares, a_wall, _ = degenerate(False)
    del svc
    out = {"7a_degenerate": {
        "bit_identical_to_phase_4": True, "wall_s": a_wall,
        "tick_wall_s": ares.tick_wall_s,
        "phase_4_round_wall_s": res.round_wall_s,
        "ticks_per_s": ares.ticks / a_wall,
        "bytes_per_s": (ares.comm["total_up"] + ares.comm["total_down"])
        / a_wall}}

    # 7b: asynchronous — Poisson arrivals, uploads delayed up to 2 ticks,
    # a buffer of 2 (traced, to read the flushes' weighting)
    traffic = PoissonTraffic(rate=2.0, seed=0, delay_ticks=2)
    ops.reset_launch_counts()
    svc = FLService(model, clients, test,
                    dataclasses.replace(cfg, observability=True), seed=0,
                    traffic=traffic, buffer_size=2, staleness_alpha=0.5)
    t0 = monotonic()
    bres = svc.run(ticks=4, drain=True)
    b_wall = monotonic() - t0

    class _Everyone:
        def eligible_clients(self, n):
            return list(range(n))

    want = [traffic.arrivals(t, _Everyone(), len(clients), None)
            for t in range(4)]
    spans = {sp.span_id: sp for sp in svc.tracer.spans}

    def tick_of(sp):
        while sp.name != "service.tick":
            sp = spans[sp.parent_id]
        return sp.attrs["tick"]

    got = [[] for _ in range(4)]
    for sp in svc.tracer.spans:
        if sp.name == "client":
            got[tick_of(sp)].append(sp.attrs["client"])
    deferred = [(e["attrs"]["client"], e["attrs"]["due"])
                for e in svc.tracer.events
                if e["name"] == "service.upload_deferred"]
    check(bres.arrivals_per_tick == [len(w) for w in want]
          and got == [[a.client_id for a in w] for w in want]
          and deferred == [(a.client_id, t + a.delay)
                           for t, w in enumerate(want) for a in w
                           if a.delay > 0],
          f"7b: arrivals {got}, deferred {deferred} are not the host "
          f"PoissonTraffic schedule {want}")
    weighted = [sp.attrs["weighted"] for sp in svc.tracer.spans
                if sp.name == "service.buffer_flush"]
    check(bres.mean_staleness > 0 and 1 in weighted,
          f"7b: staleness {bres.flush_staleness}, weighted {weighted}")
    for key, t in svc.server.global_params.items():
        check(bool(torch.isfinite(t).all()), f"7b: W_G[{key}] not finite")
    b_counts = ops.launch_counts()
    check(all(b_counts[k] > 0 for k in selection[:3]),
          f"7b: launches {b_counts}")
    out["7b_async"] = {
        "traced": True, "wall_s": b_wall, "ticks_per_s": bres.ticks / b_wall,
        "bytes_per_s": (bres.comm["total_up"] + bres.comm["total_down"])
        / b_wall,
        "tick_wall_s": bres.tick_wall_s,
        "arrivals_per_tick": bres.arrivals_per_tick,
        "arrivals": [[list(a) for a in w] for w in want],
        "flushes": bres.flushes, "flush_sizes": bres.flush_sizes,
        "flush_staleness": bres.flush_staleness, "weighted": weighted,
        "mean_staleness": bres.mean_staleness,
        "m_com_acc": bres.test_acc, "fedavg_acc": bres.fedavg_acc,
        "launches": b_counts}
    del svc

    # 7c: 7a traced — the same bits, every byte attributed, one kernel.*
    # span a launch
    svc, cres, c_wall, c_counts = degenerate(True)
    tr = svc.tracer
    led = svc.server.ledger
    check(not any(tr.unattributed.values()),
          f"7c: unattributed bytes {dict(tr.unattributed)}")
    ledger_bytes = {**{f"up/{k}": v for k, v in led.up.items()},
                    **{f"down/{k}": v for k, v in led.down.items()}}
    check(tr.attributed_bytes() == ledger_bytes,
          f"7c: attributed {tr.attributed_bytes()} != ledger "
          f"{ledger_bytes}")
    kernel_spans = Counter(sp.name for sp in tr.spans
                           if sp.name.startswith("kernel."))
    check(dict(kernel_spans) == {f"kernel.{k}": v
                                 for k, v in c_counts.items() if v},
          f"7c: kernel spans {dict(kernel_spans)} != launches {c_counts}")
    path = os.path.join(ROOT, "build", "phase7c_trace.jsonl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tr.write_jsonl(path)
    loaded = load_trace(path)
    check(len(loaded["spans"]) == len(tr.spans)
          and loaded["metrics"]["unattributed"] == {},
          "7c: the trace does not load back whole")
    kernel_ms = {}
    for name in kernel_spans:
        ds = [sp.duration * 1e3 for sp in tr.spans if sp.name == name]
        kernel_ms[name] = {"spans": len(ds), "mean_ms": sum(ds) / len(ds),
                           "min_ms": min(ds)}
    out["7c_traced"] = {
        "bit_identical_to_7a": True, "wall_s": c_wall,
        "tick_wall_s": cres.tick_wall_s,
        "tracing_overhead": c_wall / a_wall,
        "trace": os.path.relpath(path, ROOT), "spans": len(tr.spans),
        "events": len(tr.events), "span_paths": span_paths(loaded),
        "kernel_span_ms": kernel_ms}
    del svc, tr, led

    # 7d: the launcher's sync check, on the card, in its own process
    t0 = monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_fl", "--ticks", "2",
         "--sync-check"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ,
                          "PYTHONPATH": os.path.join(ROOT, "src")})
    check(proc.returncode == 0 and "weights=OK ledger=OK" in proc.stdout,
          f"7d: serve_fl --sync-check exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    out["7d_serve_fl"] = {"exit": proc.returncode,
                          "wall_s": monotonic() - t0,
                          "stdout": proc.stdout.strip().splitlines()}
    return out


# examples/paper_repro.py's JSON keys, which the port's twin must write
PAPER_REPRO_KEYS = {"config", "test_acc", "fedavg_acc", "metadata_counts",
                    "selected_fraction", "comm", "wall_time_s"}


def run_selection_phase(model, clients, test, cfg, sim, res):
    """Phase 8 at phase 4's full width: 8a the randomized PCA through
    ``FLSimulation`` and one client's selection on the card against the
    CPU; 8b the all-rows path, the batched entry and the seed oracle on
    phase 4's client maps; 8c the checkpoint and ``paper_repro``. Returns
    the phase's numbers (``sim`` and ``res`` are phase 4's run)."""
    import dataclasses

    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.core import selection as sel
    from repro_torch.core.rounds import GeneratorDraws
    from repro_torch.fl.simulation import FLSimulation
    from repro_torch.kernels import ops, ref
    from repro_torch.models.wrn import params_from_jax, params_to_jax
    from repro_torch.obs.timing import monotonic

    dev = torch.device("cuda")
    kmeans_kernels = ("kmeans_pairwise_dist", "kmeans_lloyd_step")
    out = {}
    t_phase = monotonic()

    def slot_centres(feats, labels, first, kk, iters):
        # the CPU run's slot centres (its per-class K-means, or its
        # all-rows one for no labels)
        if labels is None:
            return sel.kmeans(feats, kk, int(first), iters).centroids
        c0 = torch.cat([sel.kmeans_init(feats, kk, int(first[c]),
                                        labels == c)
                        for c in range(len(first))])
        slot = torch.arange(len(first) * kk) // kk
        lm = torch.where(labels[:, None] == slot[None], 0.0,
                         ref.BIG).float()
        return sel.lloyd_iterate(feats, c0, lm, iters)[0]

    def card_vs_cpu(tag, got, want, labels, first, kk, iters=25):
        # valid equal, >= 99% of the indices equal, each mismatch a
        # near-tie against the CPU run's slot centre
        check(torch.equal(got.valid.cpu(), want.valid),
              f"{tag}: valid differs between the card and the CPU")
        idx, widx = got.indices.cpu(), want.indices
        agree = float((idx == widx).float().mean())
        bad = torch.nonzero(idx != widx)[:, 0]
        rel = 0.0
        if len(bad):
            f = want.features
            c = slot_centres(f, labels, first, kk, iters)
            da = ((f[idx[bad]] - c[bad]) ** 2).sum(1)
            db = ((f[widx[bad]] - c[bad]) ** 2).sum(1)
            rel = float(((da - db).abs() / (1 + da)).max())
        check(agree >= 0.99 and rel <= 1e-3,
              f"{tag}: card vs CPU index agreement {agree}, worst "
              f"mismatch {rel} relative")
        return {"index_agreement": agree, "mismatches": int(len(bad)),
                "worst_mismatch_rel": rel}

    def event_ms(fn, iters=3):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    # 8a: phase 4's configuration with the randomized PCA
    rcfg = dataclasses.replace(cfg, pca_solver="randomized")
    rsim = FLSimulation(model, clients, test, rcfg, seed=0)
    ops.reset_launch_counts()
    rres = rsim.run(rounds=2, verbose=True)
    counts = ops.launch_counts()
    check(all(counts[k] > 0 for k in kmeans_kernels)
          and counts["quantize_affine"] == 8,
          f"8a: launches {counts}, want both K-means kernels and 8 "
          f"quantize launches")
    for key, t in rsim.server.global_params.items():
        check(bool(torch.isfinite(t).all()), f"8a: W_G[{key}] not finite")
    check(all(0 < c <= 4 * 10 * 10 for c in rres.metadata_counts),
          f"8a: metadata counts {rres.metadata_counts}")
    params = sim.server.global_params
    with torch.no_grad():
        maps = [model.apply_lower(params, torch.as_tensor(c.data.x,
                                                          device=dev))
                for c in clients]
    ys = [torch.as_tensor(c.data.y, device=dev) for c in clients]
    acts, y = maps[0], ys[0]
    n = acts.shape[0]
    # both devices take the default test matrix: one CPU draw, so one Ω
    pca_ms = {solver: event_ms(lambda s=solver: sel.fit_features(
        acts, cfg.pca_components, s)) for solver in ("exact", "randomized")}
    first = GeneratorDraws(torch.Generator().manual_seed(11)).client(
        0, clients[0], 10, 1).first_centres
    knobs = dict(num_classes=10, clusters_per_class=10,
                 pca_components=cfg.pca_components, kmeans_iters=25)
    ops.reset_launch_counts()
    rand_card = sel.select_metadata(acts, y, first, pca_solver="randomized",
                                    **knobs)
    rand_counts = ops.launch_counts()
    check(all(rand_counts[k] > 0 for k in kmeans_kernels),
          f"8a: one client's randomized selection launched {rand_counts}")
    rand_cpu = sel.select_metadata(acts.cpu(), y.cpu(), first,
                                   pca_solver="randomized", **knobs)
    exact_card = sel.select_metadata(acts, y, first, **knobs)
    out["8a_randomized"] = {
        "round_wall_s": rres.round_wall_s,
        "exact_round_wall_s_phase_4": res.round_wall_s,
        "metadata_counts": rres.metadata_counts,
        "lloyd_iters": rres.lloyd_iters,
        "m_com_acc": rres.test_acc, "fedavg_acc": rres.fedavg_acc,
        "launches": counts,
        "one_client_pca_ms": pca_ms,
        "client_selection_launches": rand_counts,
        "card_vs_cpu": card_vs_cpu("8a", rand_card, rand_cpu, y.cpu(), first,
                                   10),
        "randomized_vs_exact_on_card_index_agreement": float(
            (rand_card.indices == exact_card.indices).float().mean()),
        "randomized_vs_exact_valid_equal": bool(torch.equal(
            rand_card.valid, exact_card.valid))}
    del rsim, rres, rand_card, rand_cpu

    # 8b: no labels, the batched entry and the seed oracle
    row = int(torch.randint(n, (1,), generator=torch.Generator()
                            .manual_seed(12)))
    ops.reset_launch_counts()
    rows_card = sel.select_metadata(acts, None, row, per_class=False,
                                    **{**knobs, "clusters_per_class": 100})
    rows_counts = ops.launch_counts()
    check(all(rows_counts[k] > 0 for k in kmeans_kernels),
          f"8b: the all-rows path launched {rows_counts}")
    rows_cpu = sel.select_metadata(acts.cpu(), None, row, per_class=False,
                                   **{**knobs, "clusters_per_class": 100})
    firsts = torch.stack([GeneratorDraws(torch.Generator().manual_seed(
        20 + i)).client(i, c, 10, 1).first_centres
        for i, c in enumerate(clients)])
    ops.reset_launch_counts()
    batched = sel.select_metadata_batched(torch.stack(maps),
                                          torch.stack(ys), firsts, **knobs)
    batched_counts = ops.launch_counts()
    check(all(batched_counts[k] > 0 for k in kmeans_kernels),
          f"8b: the batched entry launched {batched_counts}")
    for i in range(len(clients)):
        one = sel.select_metadata(maps[i], ys[i], firsts[i], **knobs)
        check(torch.equal(batched.indices[i], one.indices)
              and torch.equal(batched.valid[i], one.valid)
              and torch.equal(batched.features[i], one.features)
              and batched.lloyd_iters[i] == one.lloyd_iters,
              f"8b: the batched entry differs from client {i}'s own call")
    ops.reset_launch_counts()
    seed_sel = sel.select_metadata_reference(acts, y, first, **knobs)
    seed_counts = ops.launch_counts()
    # the seed path's sweeps are one-hot products: distances only
    check(seed_counts["kmeans_pairwise_dist"] > 0
          and seed_counts["kmeans_lloyd_step"] == 0,
          f"8b: the seed oracle launched {seed_counts}")
    fused = sel.select_metadata(acts, y, first, **knobs)
    seed_agree = float((seed_sel.indices == fused.indices).float().mean())
    check(seed_agree >= 0.99 and torch.equal(seed_sel.valid, fused.valid),
          f"8b: seed oracle vs select_metadata index agreement "
          f"{seed_agree}")
    out["8b_paths"] = {
        "all_rows_k100": {
            "card_vs_cpu": card_vs_cpu("8b all rows", rows_card, rows_cpu,
                                       None, row, 100),
            "index_exact": bool(torch.equal(rows_card.indices.cpu(),
                                            rows_cpu.indices)),
            "valid_clusters": int(rows_card.valid.sum()),
            "lloyd_iters": rows_card.lloyd_iters,
            "launches": rows_counts},
        "batched_4_clients": {"bit_identical_to_single_calls": True,
                              "lloyd_iters": batched.lloyd_iters,
                              "launches": batched_counts},
        "seed_oracle": {"index_agreement_with_select_metadata": seed_agree,
                        "launches": seed_counts}}
    del maps, ys, batched, rows_card, rows_cpu, seed_sel, fused, exact_card

    # 8c: the checkpoint and the paper driver
    # each run starts from empty directories (a step left by an earlier
    # run would be the latest, or prune this run's)
    ck_dir = os.path.join(ROOT, "build", "phase8c_ckpt")
    paper_ck = os.path.join(ROOT, "build", "phase8c_paper_ckpt")
    for path in (ck_dir, paper_ck):
        shutil.rmtree(path, ignore_errors=True)
    mgr = ckpt.CheckpointManager(ck_dir, max_to_keep=1)
    mgr.save(2, params_to_jax(params), {"cfg": str(cfg)})
    tree, meta = mgr.restore(params_to_jax(params))
    back = params_from_jax(tree, device=dev)
    check(meta["step"] == 2 and sorted(back) == sorted(params)
          and all(torch.equal(back[k], v) and back[k].dtype == v.dtype
                  and back[k].device == v.device
                  for k, v in params.items()),
          "8c: W_G did not come back from its checkpoint bit for bit")
    g = torch.Generator().manual_seed(8)
    small = {"bf16": torch.randn(4, 64, generator=g).to(torch.bfloat16)
             .to(dev), "ids": [torch.arange(7, device=dev),
                               torch.tensor([3, -1], dtype=torch.int32,
                                            device=dev)]}
    ckpt.save_checkpoint(ck_dir, 3, small)
    got, _ = ckpt.restore_checkpoint(ck_dir, step=3, target={
        "bf16": torch.zeros_like(small["bf16"]),
        "ids": [torch.zeros_like(t) for t in small["ids"]]})
    check(all(torch.equal(a, b) and a.dtype == b.dtype
              and a.device == b.device
              for a, b in zip([got["bf16"]] + got["ids"],
                              [small["bf16"]] + small["ids"])),
          "8c: the bf16 / int tree did not come back bit for bit")
    paper_out = os.path.join(ROOT, "build", "phase8c_paper_repro.json")
    t0 = monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.paper_repro",
         "--full-wrn", "--rounds", "2", "--clients", "4",
         "--samples-per-client", "2500", "--ckpt-dir", paper_ck, "--out",
         paper_out], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    paper_s = monotonic() - t0
    check(proc.returncode == 0,
          f"8c: paper_repro exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    with open(paper_out) as f:
        written = json.load(f)
    check(set(written) == PAPER_REPRO_KEYS,
          f"8c: paper_repro wrote keys {sorted(written)}")
    wrn40 = params_to_jax(model.init(torch.Generator().manual_seed(0), dev))
    tree, meta = ckpt.restore_checkpoint(paper_ck, wrn40)
    restored = params_from_jax(tree, device=dev)
    check(meta["step"] == 2 and sorted(restored) == sorted(params)
          and all(torch.isfinite(v).all() for v in restored.values()),
          "8c: paper_repro's checkpoint does not restore as WRN-40-1")
    out["8c_checkpoint"] = {
        "w_g_bit_identical": True, "bf16_int_tree_bit_identical": True,
        "w_g_checkpoint_bytes": os.path.getsize(os.path.join(
            ck_dir, "ckpt_00000002.npz")),
        "paper_repro": {"exit": proc.returncode, "wall_s": paper_s,
                        "test_acc": written["test_acc"],
                        "fedavg_acc": written["fedavg_acc"],
                        "metadata_counts": written["metadata_counts"],
                        "selected_fraction": written["selected_fraction"],
                        "stdout": proc.stdout.strip().splitlines()[-3:]}}
    out["wall_s"] = monotonic() - t_phase
    return out


def run_training_phase(dev, rel_err):
    """Phase 9, the federated LM training path. 9a: ``train_rounds`` at
    llama3.2-1b's full width (the train_4k cut in ``TRAIN_*``) with its
    launches reckoned, and the backward kernels at one layer's shape; 9b:
    a reduced-width f32 step on the card and on the CPU; 9c: ``launch.train --smoke`` in its own
    process and its checkpoint; 9d: ``launch.federated_lm`` in its own
    process. Returns (the phase's numbers, the backward kernel's row of
    the kernels line but its max_abs_err)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import bwd_route_for
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import split_stages, stage_layers
    from repro_torch.obs.device_time import kernel_device_ms
    from repro_torch.obs.timing import monotonic
    from repro_torch.optim.optimizers import tree_leaves

    out = {}
    t_phase = monotonic()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 9a: full width, two rounds of G cohorts ----
    full = get_config("llama3.2-1b")
    tcfg = TrainConfig(local_steps=TRAIN_LOCAL, microbatch=TRAIN_MB,
                       meta_clusters=TRAIN_META_CLUSTERS,
                       meta_steps=TRAIN_META_STEPS)
    step, lm = make_train_step(full, tcfg)
    shape = (TRAIN_G, TRAIN_LOCAL, 1, TRAIN_MB, TRAIN_T)
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, full.vocab_size, shape, np.int32)).to(dev)} for _ in range(2)]
    firsts = [rng.integers(0, TRAIN_MB, TRAIN_G).tolist() for _ in range(2)]
    tokens_round = TRAIN_G * TRAIN_LOCAL * TRAIN_MB * TRAIN_T
    rounds, got = train_rounds("9a", step, lm, batches, firsts,
                               TRAIN_META_CLUSTERS, tokens_round)
    del batches
    launches, round_sweeps = got["counts"], got["lloyd_sweeps"]
    # launches reckoned from the shapes: each local step's forward runs
    # twice under remat (forward, recompute) and its backward once; the
    # probe runs the lower layers without grad; each meta step runs the
    # upper layers twice and their backward once; K-means with K clusters
    # launches K-1 init steps and one representatives pass a cohort, and
    # one Lloyd sweep each sweep it ran (below the cap of 8: it converged)
    stages, b_stage = split_stages(full, full.split_layer)
    lower = sum(stage_layers(st) for st in stages[:b_stage])
    upper = full.num_layers - lower
    local = TRAIN_G * TRAIN_LOCAL * 1
    want = {"flash_attention": 2 * (local * 2 * full.num_layers
                                    + TRAIN_G * lower
                                    + TRAIN_META_STEPS * 2 * upper),
            "flash_attention_bwd": 2 * (local * full.num_layers
                                        + TRAIN_META_STEPS * upper),
            "kmeans_pairwise_dist": 2 * TRAIN_G * TRAIN_META_CLUSTERS,
            "kmeans_lloyd_step": sum(round_sweeps),
            "flash_decode": 0, "quantize_affine": 0,
            "quantize_affine_batched": 0}
    check(len(round_sweeps) == 2 * TRAIN_G
          and all(0 < w < 8 for w in round_sweeps),
          f"9a: Lloyd sweeps {round_sweeps}")
    check(launches == want, f"9a: launches {launches}, reckoned {want}")
    # every backward of the bf16 training run on the tensor cores
    check(got["bwd_by_route"] == {"tensor_core": want["flash_attention_bwd"],
                                  "cuda_core": 0},
          f"9a: backward launches by route {got['bwd_by_route']}")
    out["9a"] = {
        "model": full.name, "cohorts": TRAIN_G, "local_steps": TRAIN_LOCAL,
        "microbatch": TRAIN_MB, "n_micro": 1, "seq_len": TRAIN_T,
        "meta_clusters": TRAIN_META_CLUSTERS,
        "meta_steps": TRAIN_META_STEPS, "dtype": tcfg.dtype,
        "remat": tcfg.remat, "launches": launches,
        "flash_attention_bwd_launches_by_route": got["bwd_by_route"],
        "lloyd_sweeps": round_sweeps, **rounds}

    # the backward kernels at one training layer's shape, beside their
    # plain version, SDPA's backward and their bound; then the f32
    # backward at the same shape, which stays on the CUDA cores
    h_, kv_, d_ = full.num_heads, full.num_kv_heads, full.head_dim
    row = bwd_row(dev, "flash_attention_bwd",
                  (TRAIN_MB, TRAIN_T, TRAIN_T, h_, kv_, d_), True,
                  launches["flash_attention_bwd"], "at the training shape",
                  seed=5)
    gd = torch.Generator(device=dev).manual_seed(5)
    q, dout, k, v = (torch.randn(TRAIN_MB, TRAIN_T, n, d_, generator=gd,
                                 device=dev) for n in (h_, h_, kv_, kv_))
    o, lse = ops.flash_attention(q, k, v, return_stats=True)
    route = bwd_route_for(q, k, v, o, dout)
    check(route == "cuda_core", f"f32 backward at the training shape: the "
                                f"{route} route")
    f32_by_launch = kernel_device_ms(
        lambda: ops.flash_attention_bwd(q, k, v, o, dout, lse),
        BWD_KERNELS["cuda_core"], iters=5, warmup=1)
    del q, k, v, dout, o, lse
    torch.cuda.empty_cache()
    row.update({"f32_cuda_core_device_ms": sum(f32_by_launch.values()),
                "f32_cuda_core_device_ms_by_launch": f32_by_launch})

    # ---- 9b: a reduced-width f32 step on the card and on the CPU ----
    # (4 layers: two scan stages, so remat runs. As many clusters as probe
    # rows: a 2-row cluster's centre is equidistant from its rows, so
    # rounding would pick its representative (ROADMAP.md Queue 3's exact
    # ties) and the two devices could meta-train on different rows)
    small = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                                num_layers=4)
    step32, lm32 = make_train_step(small, TrainConfig(
        dtype="float32", microbatch=4, meta_clusters=4))
    stoks = torch.from_numpy(np.random.default_rng(3).integers(
        0, small.vocab_size, (2, 2, 1, 4, 64), np.int32))
    out["9b"], _ = card_vs_cpu_round(
        "9b", step32, lm32.init(torch.Generator().manual_seed(7)),
        {"tokens": stoks}, [1, 2], dev, rel_err)

    # ---- 9c: launch.train in its own process, and its checkpoint ----
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    ck_dir = os.path.join(ROOT, "build", "phase9_ckpt")
    ck_here = os.path.join(ROOT, "build", "phase9_ckpt_here")
    for d in (ck_dir, ck_here):
        shutil.rmtree(d, ignore_errors=True)
    t0 = monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "2", "--ckpt-dir", ck_dir], cwd=ROOT,
        capture_output=True, text=True, timeout=300, env=env)
    train_s = monotonic() - t0
    check(proc.returncode == 0 and proc.stdout.strip().endswith(
        "train: done"), f"9c: train exited {proc.returncode}:\n"
                        f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    # the same run in this process: its checkpoint and the other
    # process's restore to the same bits
    train_mod.main(["--smoke", "--steps", "2", "--ckpt-dir", ck_here])
    smoke = get_config("llama3.2-1b").reduced()
    target = make_train_step(smoke, TrainConfig())[1].init(
        torch.Generator().manual_seed(0))
    (t_a, meta_a), (t_b, _) = (restore_checkpoint(d, target)
                               for d in (ck_dir, ck_here))
    check(meta_a["step"] == 1 and meta_a["arch"] == "llama3.2-1b"
          and all(torch.equal(x, y) for x, y in zip(tree_leaves(t_a),
                                                      tree_leaves(t_b))),
          "9c: the train process's checkpoint does not restore to this "
          "process's bits")
    out["9c"] = {"exit": proc.returncode, "wall_s": train_s,
                 "restored_bit_identical": True,
                 "stdout": proc.stdout.strip().splitlines()}

    # ---- 9d: the federated_lm twin in its own process ----
    t0 = monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.federated_lm",
         "--rounds", "3"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=env)
    check(proc.returncode == 0, f"9d: federated_lm exited "
                                f"{proc.returncode}:\n{proc.stdout[-2000:]}"
                                f"\n{proc.stderr[-2000:]}")
    out["9d"] = {"exit": proc.returncode, "wall_s": monotonic() - t0,
                 "stdout": proc.stdout.strip().splitlines()}
    out["wall_s"] = monotonic() - t_phase
    return out, row



def device_profile(fn):
    """Where one call's device time goes: ``fn()`` under torch.profiler,
    ending in a synchronize -> wall ms, device busy ms and share, each
    attention kernel's share of the device time, the top kernels by
    device time and, where ``fn`` runs an MoE layer, the device time of
    the kernels launched inside each of ``moe_apply``'s ``moe.*`` ranges
    (route, dispatch, experts, combine; the ranges themselves are not
    counted as device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.timing import monotonic
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = monotonic()
        fn()
        torch.cuda.synchronize()
        wall = (monotonic() - t) * 1e3
    avgs = prof.key_averages()
    evs = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith("moe.")]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "device_busy_share": busy / wall,
           # each attention kernel's share of the device time, and its
           # launches and device ms a launch
           "attention_share_of_device_time": {
               e.key[:80]: e.self_device_time_total / 1e3 / busy
               for e in evs if "flash_" in e.key},
           "attention_device_ms_a_launch": {
               e.key[:80]: {"launches": e.count, "device_ms":
                            e.self_device_time_total / 1e3 / e.count}
               for e in evs if "flash_" in e.key},
           "top_device_ms": {e.key[:80]: e.self_device_time_total / 1e3
                             for e in top}}
    moe = {e.key: {"calls": e.count, "device_ms": e.device_time_total / 1e3}
           for e in avgs if e.key.startswith("moe.")
           and e.device_type == torch.autograd.DeviceType.CPU}
    if moe:
        out["moe_ranges"] = moe
    return out


@contextlib.contextmanager
def moe_pairs():
    """While open, each ``layers.moe_apply`` call also routes its tokens
    again with ``layers.moe_route`` and counts the (token, choice) pairs it
    routes and keeps: yields ``{"routed": int, "kept": [device counts]}``.
    The layer's output is ``moe_apply``'s own."""
    from repro_torch.models import layers as L
    apply, counts = L.moe_apply, {"routed": 0, "kept": []}

    def counted(p, x, *, cfg, **kw):
        xn = L.rms_norm(x, p["norm"], cfg.norm_eps).reshape(-1, cfg.d_model)
        keep = L.moe_route(p, xn, cfg=cfg, **kw).keep
        counts["routed"] += keep.numel()
        counts["kept"].append(keep.sum())
        return apply(p, x, cfg=cfg, **kw)

    L.moe_apply = counted
    try:
        yield counts
    finally:
        L.moe_apply = apply


def dropped_share(counts):
    return 1.0 - sum(int(c) for c in counts["kept"]) / counts["routed"]


def run_moe_serving_phase(dev, rel_err):
    """Phase 10: serving the MoE and phi3 at full width. 10a:
    qwen3-moe-30b-a3b at full width and depth (bf16 weights from seed 0
    made one layer slice at a time), ``launch.serve`` at decode_32k's
    cache and ``make_prefill_step`` at prefill_32k's length (``MOE_*``),
    launches reckoned from the shapes, a second prefill call bit for bit,
    a profiled prefill call and decode step, the dropped share of (token,
    choice) pairs; 10b: one full-width MoE layer in f32 on the card
    against the CPU and against itself; 10c: phi3-medium-14b at full width,
    depth cut to ``PHI3_LAYERS``; 10d: ``launch.serve_lm`` in its own
    process for both archs. Returns (the phase's numbers, its prefill and
    decode kernel launches by part)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import layers as L
    from repro_torch.models.registry import count_params
    from repro_torch.obs.timing import monotonic

    out, launches = {}, {}
    t_phase = monotonic()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 10a: qwen3-moe-30b-a3b at full width and depth ----
    cfg = get_config(MOE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    served = serve.main(["--arch", MOE_ARCH, "--batch", str(MOE_BATCH),
                         "--prompt-len", str(MOE_PROMPT), "--cache-len",
                         str(MOE_CACHE), "--tokens", str(MOE_TOKENS)])
    serve_launches = ops.launch_counts()
    steps = MOE_PROMPT - 1 + MOE_TOKENS
    check(serve_launches["flash_decode"] == cfg.num_layers * steps
          and serve_launches["flash_attention"] == 0,
          f"10a: serve launches {serve_launches}, want "
          f"{cfg.num_layers} x {steps} decodes")
    check(served.tokens.shape == (MOE_BATCH, MOE_TOKENS)
          and int(served.tokens.min()) >= 0
          and int(served.tokens.max()) < cfg.padded_vocab,
          f"10a: served tokens {served.tokens.shape}")
    launches["10a_decode"] = serve_launches["flash_decode"]

    prefill, lm = make_prefill_step(cfg)                  # bf16
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    ptoks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, MOE_PREFILL_S), np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = monotonic()
    plogits = prefill(params, {"tokens": ptoks})
    torch.cuda.synchronize()
    prefill_s = monotonic() - t0
    prefill_launches = ops.launch_counts()
    prefill_routes = dict(ops.flash_attention.launches_by_route)
    prefill_mem = torch.cuda.max_memory_allocated()
    check(prefill_launches["flash_attention"] == cfg.num_layers
          and prefill_routes["tensor_core"] == cfg.num_layers
          and prefill_launches["flash_decode"] == 0,
          f"10a: prefill launches {prefill_launches}, by route "
          f"{prefill_routes}")
    check(tuple(plogits.shape) == (1, 1, cfg.padded_vocab)
          and bool(torch.isfinite(plogits).all()),
          "10a: prefill logits not finite or of the wrong shape")
    launches["10a_prefill"] = prefill_launches["flash_attention"]
    with moe_pairs() as pcounts:
        again = prefill(params, {"tokens": ptoks})
    check(torch.equal(plogits, again),
          "10a: two prefill calls on the same tokens differ")
    prefill_profile = device_profile(
        lambda: prefill(params, {"tokens": ptoks}))
    del again
    # decode steps at the serve shape: logits, the dropped share, a profile
    dcache = lm.init_cache(MOE_BATCH, MOE_CACHE, device=dev)
    dtoks = ptoks[0, :9 * MOE_BATCH].reshape(MOE_BATCH, 9)
    with moe_pairs() as dcounts, torch.no_grad():
        for i in range(8):
            dlogits, dcache, _ = lm.apply(params, dtoks[:, i:i + 1],
                                          mode="decode", cache=dcache,
                                          dtype=torch.bfloat16)
            check(bool(torch.isfinite(dlogits).all()),
                  f"10a: decode logits not finite at step {i}")
    decode_step, _ = make_decode_step(cfg)
    decode_profile = device_profile(
        lambda: decode_step(params, dcache, dtoks[:, 8:9]))
    del dcache, dlogits, plogits
    # the least time of the work, from the shapes (bf16 at 989 TFLOP/s,
    # 3.35 TB/s): a decode step reads every weight (the capacity dispatch
    # runs every expert) and the whole cache; a prefill call's products
    s_, d_, e_ = MOE_PREFILL_S, cfg.d_model, cfg.num_experts
    h_, kv_, hd_, f_ = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                        cfg.d_ff)
    weight_bytes = 2 * count_params(cfg)
    kv_bytes = 2 * 2 * MOE_BATCH * MOE_CACHE * cfg.num_layers * kv_ * hd_
    groups = max(s_ // 512, 1)
    cap = max(int((s_ // groups) * cfg.num_experts_per_tok / e_ * 1.25), 1)
    attn_flops = 2 * s_ * s_ * h_ * hd_          # causal: half of 4 S^2 H D
    expert_flops = 6 * e_ * groups * cap * d_ * f_
    proj_flops = 2 * s_ * d_ * (2 * h_ * hd_ + 2 * kv_ * hd_ + e_)
    prefill_flops = cfg.num_layers * (attn_flops + expert_flops
                                      + proj_flops) \
        + 2 * d_ * cfg.padded_vocab
    out["10a"] = {
        "model": cfg.name, "layers": cfg.num_layers,
        "params": count_params(cfg),
        "active_params": count_params(cfg, active_only=True),
        "serve": {"batch": MOE_BATCH, "cache_len": MOE_CACHE,
                  "prompt_len": MOE_PROMPT, "new_tokens": MOE_TOKENS,
                  "prompt_fed_s": served.prompt_s,
                  "decode_s": served.decode_s,
                  "decode_ms_per_step": served.decode_s / MOE_TOKENS * 1e3,
                  "tok_per_s": served.tok_per_s,
                  "launches": serve_launches,
                  "flash_decode_launches_reckoned": cfg.num_layers * steps,
                  "max_memory_allocated": served.peak_bytes,
                  "decode_step_bound_ms": (weight_bytes + kv_bytes)
                  / H100_BYTES_PER_S * 1e3,
                  "weight_bytes": weight_bytes, "kv_cache_bytes": kv_bytes},
        "prefill": {"batch": 1, "seq_len": MOE_PREFILL_S,
                    "prefill_s": prefill_s,
                    "tok_per_s": MOE_PREFILL_S / prefill_s,
                    "launches": prefill_launches,
                    "flash_attention_launches_reckoned": cfg.num_layers,
                    "flash_attention_launches_by_route": prefill_routes,
                    "max_memory_allocated": prefill_mem,
                    "second_call_bit_identical": True,
                    "moe_groups": groups, "moe_capacity": cap,
                    "bound_ms": bound(weight_bytes, prefill_flops,
                                      H100_BF16_FLOPS)[0],
                    "attention_flops_a_layer": attn_flops,
                    "attention_bound_ms_a_layer":
                    attn_flops / H100_BF16_FLOPS * 1e3,
                    "expert_gemm_flops_a_layer": expert_flops,
                    "expert_gemm_bound_ms_a_layer":
                    expert_flops / H100_BF16_FLOPS * 1e3},
        "dropped_share": {
            "prefill": dropped_share(pcounts),
            "decode": dropped_share(dcounts),
            "prefill_pairs": pcounts["routed"],
            "decode_pairs": dcounts["routed"]},
        "profiled_prefill_call": prefill_profile,
        "profiled_decode_step": decode_profile}
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # ---- 10b: one full-width MoE layer in f32, card against CPU ----
    gen = torch.Generator(device=dev).manual_seed(4)
    p = L.moe_init(L.ParamInit(gen, dev), cfg)
    p["norm"] = 1.0 + 0.1 * torch.randn(cfg.d_model, generator=gen,
                                        device=dev)
    x = torch.randn(1, MOE_LAYER_TOKENS, cfg.d_model, generator=gen,
                    device=dev)
    y, aux = L.moe_apply(p, x, cfg=cfg)
    y2, aux2 = L.moe_apply(p, x, cfg=cfg)
    check(torch.equal(y, y2) and torch.equal(aux, aux2),
          "10b: two card runs of one MoE layer differ")

    def route(pp, xx):
        xn = L.rms_norm(xx, pp["norm"], cfg.norm_eps).reshape(-1,
                                                              cfg.d_model)
        return L.moe_route(pp, xn, cfg=cfg)

    p_cpu = {k: v.cpu() for k, v in p.items()}
    y_cpu, aux_cpu = L.moe_apply(p_cpu, x.cpu(), cfg=cfg)
    r, r_cpu = route(p, x), route(p_cpu, x.cpu())
    topi, topi_cpu = r.topi.cpu(), r_cpu.topi
    probs = r_cpu.probs
    worst_gap = 0.0
    for t, j in torch.nonzero(topi != topi_cpu).tolist():
        a, b = probs[t, topi[t, j]], probs[t, topi_cpu[t, j]]
        gap = float((a - b).abs() / torch.maximum(a.abs(), b.abs()))
        worst_gap = max(worst_gap, gap)
        check(gap <= 1e-3, f"10b: token {t} choice {j} routed apart, not "
                           f"at a near-tie (gap {gap})")
    group_of = torch.arange(topi.shape[0]) // r.group_len
    moved = set(group_of[(topi != topi_cpu).any(1)].tolist())
    slots_apart = ((r.pos.cpu() != r_cpu.pos) | (r.keep.cpu()
                                                  != r_cpu.keep)).any(1)
    check(set(group_of[slots_apart].tolist()) <= moved,
          "10b: slots or drops differ in a group routed alike")
    alike = ((topi == topi_cpu) & (r.keep.cpu() == r_cpu.keep)).all(1)
    yg = y.cpu().reshape(-1, cfg.d_model)[:len(alike)][alike]
    yc = y_cpu.reshape(-1, cfg.d_model)[:len(alike)][alike]
    check(bool(((yg - yc).abs() <= TOL + TOL * yc.abs()).all()),
          f"10b: y card vs CPU: max abs err {float((yg - yc).abs().max())}")
    check(abs(float(aux) - float(aux_cpu)) <= TOL + TOL * abs(
        float(aux_cpu)), f"10b: aux card {float(aux)} vs CPU "
                         f"{float(aux_cpu)}")
    out["10b"] = {"tokens": MOE_LAYER_TOKENS, "dtype": "float32",
                  "groups": r.groups, "capacity": r.cap,
                  "routing_mismatches": int((topi != topi_cpu).sum()),
                  "worst_near_tie_gap": worst_gap,
                  "tokens_routed_alike": int(alike.sum()),
                  "dropped_pairs": int((~r.keep).sum()),
                  "y_max_abs_err": float((yg - yc).abs().max()),
                  "y_max_rel_err": rel_err(yg, yc),
                  "aux_card": float(aux), "aux_cpu": float(aux_cpu),
                  "card_repeat_bit_identical": True}
    del p, p_cpu, x, y, y2, r
    torch.cuda.empty_cache()

    # ---- 10c: phi3-medium-14b at full width, depth cut ----
    pcfg = serve.cut_depth(get_config("phi3-medium-14b"), PHI3_LAYERS)
    prefill, lm = make_prefill_step(pcfg)
    decode_step, _ = make_decode_step(pcfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    ptoks = torch.from_numpy(np.random.default_rng(2).integers(
        0, pcfg.vocab_size, (PHI3_BATCH, PHI3_PREFILL_S), np.int32)).to(dev)
    prefill(params, {"tokens": ptoks[:1]})                # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = monotonic()
    plogits = prefill(params, {"tokens": ptoks[:1]})
    torch.cuda.synchronize()
    phi_prefill_s = monotonic() - t0
    phi_prefill = ops.launch_counts()
    phi_routes = dict(ops.flash_attention.launches_by_route)
    check(phi_prefill["flash_attention"] == PHI3_LAYERS
          and phi_routes["tensor_core"] == PHI3_LAYERS
          and tuple(plogits.shape) == (1, 1, pcfg.padded_vocab)
          and bool(torch.isfinite(plogits).all()),
          f"10c: prefill launches {phi_prefill}, by route {phi_routes}, "
          f"logits {tuple(plogits.shape)}")
    cache = lm.init_cache(PHI3_BATCH, PHI3_CACHE, device=dev)
    tok = ptoks[:, :1]
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = monotonic()
    for _ in range(PHI3_STEPS):
        tok, cache = decode_step(params, cache, tok)
    torch.cuda.synchronize()
    phi_decode_s = monotonic() - t0
    phi_decode = ops.launch_counts()
    check(phi_decode["flash_decode"] == PHI3_LAYERS * PHI3_STEPS
          and phi_decode["flash_attention"] == 0
          and 0 <= int(tok.min()) and int(tok.max()) < pcfg.padded_vocab,
          f"10c: decode launches {phi_decode}")
    launches["10c_prefill"] = phi_prefill["flash_attention"]
    launches["10c_decode"] = phi_decode["flash_decode"]
    out["10c"] = {"model": pcfg.name, "layers": PHI3_LAYERS,
                  "heads": [pcfg.num_heads, pcfg.num_kv_heads,
                            pcfg.head_dim],
                  "untied_head": not pcfg.tie_embeddings,
                  "padded_vocab": pcfg.padded_vocab,
                  "prefill": {"seq_len": PHI3_PREFILL_S,
                              "prefill_s": phi_prefill_s,
                              "launches": phi_prefill,
                              "flash_attention_launches_by_route":
                              phi_routes},
                  "decode": {"batch": PHI3_BATCH, "cache_len": PHI3_CACHE,
                             "steps": PHI3_STEPS,
                             "ms_per_step": phi_decode_s / PHI3_STEPS * 1e3,
                             "launches": phi_decode}}
    del params, cache, plogits
    torch.cuda.empty_cache()
    ops.reset_launch_counts()

    # ---- 10d: serve_lm in its own process, for both archs ----
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out["10d"] = {}
    for arch in (MOE_ARCH, "phi3-medium-14b"):
        t0 = monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
             arch], cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=env)
        check(proc.returncode == 0 and proc.stdout.startswith(
            f"arch={arch} (reduced)"), f"10d: serve_lm --arch {arch} "
            f"exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
            f"{proc.stderr[-2000:]}")
        out["10d"][arch] = {"exit": proc.returncode,
                            "wall_s": monotonic() - t0,
                            "stdout": proc.stdout.strip().splitlines()}
    out["wall_s"] = monotonic() - t_phase
    return out, launches


def peak_and_reset():
    """The peak device memory since the last reset, then a new reset."""
    import torch
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return peak


def run_mla_rwkv_phase(dev, rel_err):
    """Phase 11: serving deepseek-v2-236b (MLA) and rwkv6-3b. 11a:
    deepseek at full width, depth cut to ``MLA_LAYERS`` (bf16 weights from
    seed 0 made one layer slice at a time): ``make_decode_step`` at
    decode_32k's latent cache (a teacher-forced prompt, then greedy
    tokens), ``make_prefill_step`` at prefill_32k's length (``MLA_*``),
    launches reckoned from the shapes, a second prefill call bit for bit,
    a profiled prefill call and decode step, the dropped share, peak
    memory and the work's bounds; 11b: one full-width MLA layer in f32 on
    the card against the CPU, naive against absorbed, and against itself;
    11c: rwkv6-3b at full width and depth, ``launch.serve`` at decode_32k's
    full batch and one prefill at prefill_32k's length (``RWKV_*``), no
    attention launch, a second prefill call bit for bit, profiles; 11d:
    one full-width RWKV block in f32, its decode steps against its own
    prefill and the card against the CPU; 11e: ``launch.serve_lm`` in its
    own process for both archs. Returns (the phase's numbers, the
    attention kernels' launches in 11a by part)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import layers as L
    from repro_torch.models.registry import count_params
    from repro_torch.obs.timing import monotonic

    out, launches = {}, {}
    t_phase = monotonic()
    peak_and_reset()

    # ---- 11a: deepseek-v2-236b at full width, depth cut ----
    cfg = serve.cut_depth(get_config(MLA_ARCH), MLA_LAYERS)
    nl = cfg.num_layers
    prefill, lm = make_prefill_step(cfg)                  # bf16
    decode_step, _ = make_decode_step(cfg)
    check([(st.kind, st.repeats) for st in lm.stages]
          == [("unroll", 1), ("scan", nl - 1)],
          f"11a: stages {lm.stages}")
    t0 = monotonic()
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = monotonic() - t0
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MLA_BATCH, MLA_PROMPT), np.int32)).to(dev)
    cache = lm.init_cache(MLA_BATCH, MLA_CACHE, device=dev)
    weights_mem = peak_and_reset()
    # the prompt teacher-forced through decode steps, then greedy tokens
    # (as launch.serve)
    ops.reset_launch_counts()
    with moe_pairs() as dcounts:
        t0 = monotonic()
        tok = prompt[:, :1]
        for i in range(1, MLA_PROMPT):
            _, cache = decode_step(params, cache, tok)
            tok = prompt[:, i:i + 1]
        torch.cuda.synchronize()
        prompt_s = monotonic() - t0
        gen_toks = []
        t0 = monotonic()
        for _ in range(MLA_TOKENS):
            tok, cache = decode_step(params, cache, tok)
            gen_toks.append(tok)
        torch.cuda.synchronize()
        decode_s = monotonic() - t0
    decode_launches = ops.launch_counts()
    decode_mem = peak_and_reset()
    steps = MLA_PROMPT - 1 + MLA_TOKENS
    gen_toks = torch.cat(gen_toks, 1)
    check(decode_launches["flash_decode"] == nl * steps
          and decode_launches["flash_attention"] == 0,
          f"11a: decode launches {decode_launches}, want {nl} x {steps} "
          f"decodes")
    check(int(gen_toks.min()) >= 0
          and int(gen_toks.max()) < cfg.padded_vocab,
          "11a: decoded token ids out of range")
    check(torch.equal(cache["pos"].cpu(), torch.full(
        (MLA_BATCH,), steps, dtype=torch.int32)), "11a: cache positions")
    launches["11a_decode"] = decode_launches["flash_decode"]
    decode_profile = device_profile(
        lambda: decode_step(params, cache, tok))
    del cache
    peak_and_reset()

    ptoks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, MLA_PREFILL_S), np.int32)).to(dev)
    ops.reset_launch_counts()
    t0 = monotonic()
    plogits = prefill(params, {"tokens": ptoks})
    torch.cuda.synchronize()
    prefill_s = monotonic() - t0
    prefill_launches = ops.launch_counts()
    prefill_routes = dict(ops.flash_attention.launches_by_route)
    prefill_mem = peak_and_reset()
    check(prefill_launches["flash_attention"] == nl
          and prefill_routes["tensor_core"] == nl
          and prefill_launches["flash_decode"] == 0,
          f"11a: prefill launches {prefill_launches}, by route "
          f"{prefill_routes}")
    check(tuple(plogits.shape) == (1, 1, cfg.padded_vocab)
          and bool(torch.isfinite(plogits).all()),
          "11a: prefill logits not finite or of the wrong shape")
    launches["11a_prefill"] = prefill_launches["flash_attention"]
    with moe_pairs() as pcounts:
        again = prefill(params, {"tokens": ptoks})
    check(torch.equal(plogits, again),
          "11a: two prefill calls on the same tokens differ")
    del again
    prefill_profile = device_profile(
        lambda: prefill(params, {"tokens": ptoks}))
    del plogits, params
    peak_and_reset()
    # the least time of the work, from the shapes (bf16 at 989 TFLOP/s,
    # 3.35 TB/s). Decode: the naive step rebuilds every head's keys and
    # values from the whole latent cache (2 B S r H (dn + dv) FLOPs a
    # layer) and reads every weight (the capacity dispatch runs every
    # expert); an absorbed step's floor is the weights and the latent
    # cache read once. Prefill: its products.
    h_, r_, qr_ = cfg.num_heads, cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    d_, e_, f_ = cfg.d_model, cfg.num_experts, cfg.d_ff
    weight_bytes = 2 * count_params(cfg)
    latent_bytes = 2 * MLA_BATCH * MLA_CACHE * nl * (r_ + dr)
    rebuild_flops = 2 * MLA_BATCH * MLA_CACHE * r_ * h_ * (dn + dv)
    s_ = MLA_PREFILL_S
    groups = max(s_ // 512, 1)
    cap = max(int((s_ // groups) * cfg.num_experts_per_tok / e_ * 1.25), 1)
    attn_flops = 2 * s_ * s_ * h_ * (dn + dr)    # causal: half of 4 S^2 H D
    proj_flops = 2 * s_ * (d_ * qr_ + qr_ * h_ * (dn + dr) + d_ * r_
                           + r_ * h_ * (dn + dv) + d_ * dr + h_ * dv * d_)
    fs = f_ * cfg.num_shared_experts
    moe_flops = 6 * e_ * groups * cap * d_ * f_ + 6 * s_ * d_ * fs \
        + 2 * s_ * d_ * e_
    dense_flops = 6 * s_ * d_ * f_
    prefill_flops = nl * (attn_flops + proj_flops) + (nl - 1) * moe_flops \
        + dense_flops + 2 * d_ * cfg.padded_vocab
    naive_ms = bound(weight_bytes, nl * rebuild_flops, H100_BF16_FLOPS)
    out["11a"] = {
        "model": cfg.name, "layers": nl, "params": count_params(cfg),
        "active_params": count_params(cfg, active_only=True),
        "weight_bytes": weight_bytes, "init_s": init_s,
        "weights_and_cache_memory_allocated": weights_mem,
        "decode": {"batch": MLA_BATCH, "cache_len": MLA_CACHE,
                   "prompt_len": MLA_PROMPT, "new_tokens": MLA_TOKENS,
                   "prompt_fed_s": prompt_s, "decode_s": decode_s,
                   "decode_ms_per_step": decode_s / MLA_TOKENS * 1e3,
                   "tok_per_s": MLA_BATCH * MLA_TOKENS / decode_s,
                   "launches": decode_launches,
                   "flash_decode_launches_reckoned": nl * steps,
                   "max_memory_allocated": decode_mem,
                   "latent_cache_bytes": latent_bytes,
                   "rebuild_flops_a_layer": rebuild_flops,
                   "naive_step_bound_ms": naive_ms[0],
                   "naive_step_bound_by": naive_ms[1],
                   "latent_floor_ms": (weight_bytes + latent_bytes)
                   / H100_BYTES_PER_S * 1e3},
        "prefill": {"batch": 1, "seq_len": MLA_PREFILL_S,
                    "prefill_s": prefill_s,
                    "tok_per_s": MLA_PREFILL_S / prefill_s,
                    "launches": prefill_launches,
                    "flash_attention_launches_reckoned": nl,
                    "flash_attention_launches_by_route": prefill_routes,
                    "max_memory_allocated": prefill_mem,
                    "second_call_bit_identical": True,
                    "moe_groups": groups, "moe_capacity": cap,
                    "bound_ms": bound(weight_bytes, prefill_flops,
                                      H100_BF16_FLOPS)[0],
                    "attention_flops_a_layer": attn_flops,
                    "attention_bound_ms_a_layer":
                    attn_flops / H100_BF16_FLOPS * 1e3},
        "dropped_share": {
            "prefill": dropped_share(pcounts),
            "decode": dropped_share(dcounts),
            "prefill_pairs": pcounts["routed"],
            "decode_pairs": dcounts["routed"]},
        "profiled_prefill_call": prefill_profile,
        "profiled_decode_step": decode_profile}

    # ---- 11b: one full-width MLA layer in f32, card against CPU ----
    gen = torch.Generator(device=dev).manual_seed(5)
    p = L.mla_init(L.ParamInit(gen, dev), cfg)
    for k in [k for k in p if k.endswith("norm")]:
        p[k] = 1.0 + 0.1 * torch.randn(p[k].shape, generator=gen,
                                       device=dev)
    x = torch.randn(2, MLA_LAYER_TOKENS, d_, generator=gen, device=dev)
    p_cpu = {k: v.cpu() for k, v in p.items()}
    pos0 = torch.tensor([0, MLA_RING - 4], dtype=torch.int32)

    def run_layer(pp, xx, where):
        """Prefill, then MLA_STEPS decode steps (the second row's ring
        wraps) in the naive and the absorbed form."""
        with torch.no_grad():
            y, _ = L.mla_apply(pp, xx, cfg=cfg, mode="full")
            dec = {}
            for absorbed in (False, True):
                c = L.mla_cache_init(cfg, 2, MLA_RING, torch.float32, where)
                dec[absorbed] = torch.cat([L.mla_apply(
                    pp, xx[:, i:i + 1], cfg=cfg, mode="decode", cache=c,
                    pos=(pos0 + i).to(where), absorbed=absorbed)[0]
                    for i in range(MLA_STEPS)], 1)
        return y, dec[False], dec[True]

    ops.reset_launch_counts()
    card = run_layer(p, x, dev)
    layer_launches = ops.launch_counts()
    layer_routes = dict(ops.flash_attention.launches_by_route)
    check(layer_routes["cuda_core"] == 1
          and layer_launches["flash_decode"] == MLA_STEPS,
          f"11b: launches {layer_launches}, by route {layer_routes}")
    again = run_layer(p, x, dev)
    check(all(torch.equal(a, b) for a, b in zip(card, again)),
          "11b: two card runs of one MLA layer differ")
    cpu = run_layer(p_cpu, x.cpu(), "cpu")
    errs_b = {nm: rel_err(a.cpu(), b) for nm, a, b in zip(
        ("prefill", "naive_decode", "absorbed_decode"), card, cpu)}
    errs_b["naive_vs_absorbed_on_the_card"] = rel_err(card[1], card[2])
    check(all(v <= TOL for v in errs_b.values()),
          f"11b: relative errors {errs_b} beyond {TOL}")
    out["11b"] = {"tokens": MLA_LAYER_TOKENS, "dtype": "float32",
                  "ring": MLA_RING, "decode_steps": MLA_STEPS,
                  "launches": layer_launches,
                  "flash_attention_launches_by_route": layer_routes,
                  "max_rel_err": errs_b, "card_repeat_bit_identical": True}
    del p, p_cpu, x, card, again, cpu
    peak_and_reset()

    # ---- 11c: rwkv6-3b at full width and depth ----
    rcfg = get_config(RWKV_ARCH)
    ops.reset_launch_counts()
    served = serve.main(["--arch", RWKV_ARCH, "--batch", str(RWKV_BATCH),
                         "--prompt-len", str(RWKV_PROMPT), "--cache-len",
                         str(RWKV_CACHE), "--tokens", str(RWKV_TOKENS)])
    serve_launches = ops.launch_counts()
    check(not any(serve_launches.values()),
          f"11c: serve launched kernels {serve_launches}")
    check(served.tokens.shape == (RWKV_BATCH, RWKV_TOKENS)
          and int(served.tokens.min()) >= 0
          and int(served.tokens.max()) < rcfg.padded_vocab,
          f"11c: served tokens {served.tokens.shape}")
    peak_and_reset()
    prefill, lm = make_prefill_step(rcfg)
    decode_step, _ = make_decode_step(rcfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    ptoks = torch.from_numpy(np.random.default_rng(4).integers(
        0, rcfg.vocab_size, (1, RWKV_PREFILL_S), np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = monotonic()
    plogits = prefill(params, {"tokens": ptoks})
    torch.cuda.synchronize()
    r_prefill_s = monotonic() - t0
    r_prefill_launches = ops.launch_counts()
    r_prefill_mem = peak_and_reset()
    check(not any(r_prefill_launches.values())
          and tuple(plogits.shape) == (1, 1, rcfg.padded_vocab)
          and bool(torch.isfinite(plogits).all()),
          f"11c: prefill launches {r_prefill_launches}, logits "
          f"{tuple(plogits.shape)}")
    again = prefill(params, {"tokens": ptoks})
    check(torch.equal(plogits, again),
          "11c: two prefill calls on the same tokens differ")
    del again
    r_prefill_profile = device_profile(
        lambda: prefill(params, {"tokens": ptoks}))
    cache = lm.init_cache(RWKV_BATCH, RWKV_CACHE, device=dev)
    dtoks = ptoks[0, :RWKV_BATCH].reshape(RWKV_BATCH, 1)
    for _ in range(2):
        dtoks, cache = decode_step(params, cache, dtoks)
    r_decode_profile = device_profile(
        lambda: decode_step(params, cache, dtoks))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in (cache["stages"][0][0]["mixer"]["state"],
                                cache["stages"][0][0]["mixer"]["x_prev"],
                                cache["stages"][0][0]["ffn_x_prev"]))
    r_weight_bytes = 2 * count_params(rcfg)
    out["11c"] = {
        "model": rcfg.name, "layers": rcfg.num_layers,
        "params": count_params(rcfg), "weight_bytes": r_weight_bytes,
        "serve": {"batch": RWKV_BATCH, "cache_len_ignored": RWKV_CACHE,
                  "prompt_len": RWKV_PROMPT, "new_tokens": RWKV_TOKENS,
                  "prompt_fed_s": served.prompt_s,
                  "decode_s": served.decode_s,
                  "decode_ms_per_step": served.decode_s / RWKV_TOKENS * 1e3,
                  "tok_per_s": served.tok_per_s,
                  "launches": serve_launches,
                  "max_memory_allocated": served.peak_bytes,
                  "state_bytes": state_bytes,
                  # a step reads every weight and reads and writes the
                  # state once
                  "decode_step_bound_ms": (r_weight_bytes + 2 * state_bytes)
                  / H100_BYTES_PER_S * 1e3},
        "prefill": {"batch": 1, "seq_len": RWKV_PREFILL_S,
                    "prefill_s": r_prefill_s,
                    "tok_per_s": RWKV_PREFILL_S / r_prefill_s,
                    "launches": r_prefill_launches,
                    "max_memory_allocated": r_prefill_mem,
                    "second_call_bit_identical": True},
        "profiled_prefill_call": r_prefill_profile,
        "profiled_decode_step": r_decode_profile}
    del params, cache, plogits
    peak_and_reset()

    # ---- 11d: one full-width RWKV block in f32, card against CPU ----
    gen = torch.Generator(device=dev).manual_seed(6)
    init = L.ParamInit(gen, dev)
    tm, cm = L.rwkv_init(init, rcfg), L.rwkv_ffn_init(init, rcfg)
    hd2 = (rcfg.num_heads, rcfg.head_dim)
    tm["bonus"] = 0.5 * torch.randn(hd2, generator=gen, device=dev)
    tm["decay_bias"] = tm["decay_bias"] + torch.randn(
        tm["decay_bias"].shape, generator=gen, device=dev)
    for pp in (tm, cm):
        for k in pp:
            if k.startswith("mu_"):
                pp[k] = pp[k] + 0.2 * torch.randn(pp[k].shape, generator=gen,
                                                  device=dev)
    x = torch.randn(1, RWKV_BLOCK_TOKENS, rcfg.d_model, generator=gen,
                    device=dev)

    def run_block(tm_, cm_, xx, where):
        """The block's prefill, and its first RWKV_BLOCK_STEPS tokens fed
        one at a time through decode from a zero state."""
        with torch.no_grad():
            y, _ = L.rwkv_apply(tm_, xx, cfg=rcfg, mode="full")
            h = xx + y
            full = h + L.rwkv_ffn_apply(cm_, h, cfg=rcfg)[0]
            c = L.rwkv_cache_init(rcfg, 1, device=where)
            fx = torch.zeros(1, rcfg.d_model, device=where)
            dec = []
            for i in range(RWKV_BLOCK_STEPS):
                y, c = L.rwkv_apply(tm_, xx[:, i:i + 1], cfg=rcfg,
                                    mode="decode", cache=c)
                h = xx[:, i:i + 1] + y
                y, last = L.rwkv_ffn_apply(cm_, h, cfg=rcfg, x_prev=fx)
                fx.copy_(last)
                dec.append(h + y)
        return full, torch.cat(dec, 1)

    ops.reset_launch_counts()
    card = run_block(tm, cm, x, dev)
    block_launches = ops.launch_counts()
    cpu = run_block({k: v.cpu() for k, v in tm.items()},
                    {k: v.cpu() for k, v in cm.items()}, x.cpu(), "cpu")
    errs_d = {
        "decode_vs_prefill_on_the_card": rel_err(
            card[1], card[0][:, :RWKV_BLOCK_STEPS]),
        "decode_vs_prefill_on_the_cpu": rel_err(
            cpu[1], cpu[0][:, :RWKV_BLOCK_STEPS]),
        "prefill_card_vs_cpu": rel_err(card[0].cpu(), cpu[0]),
        "decode_card_vs_cpu": rel_err(card[1].cpu(), cpu[1])}
    check(all(v <= TOL for v in errs_d.values())
          and not any(block_launches.values()),
          f"11d: relative errors {errs_d} beyond {TOL}, launches "
          f"{block_launches}")
    out["11d"] = {"tokens": RWKV_BLOCK_TOKENS, "dtype": "float32",
                  "decode_steps": RWKV_BLOCK_STEPS, "max_rel_err": errs_d}
    del tm, cm, x, card, cpu
    peak_and_reset()
    ops.reset_launch_counts()

    # ---- 11e: serve_lm in its own process, for both archs ----
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out["11e"] = {}
    for arch in (MLA_ARCH, RWKV_ARCH):
        t0 = monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
             arch], cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=env)
        check(proc.returncode == 0 and proc.stdout.startswith(
            f"arch={arch} (reduced)"), f"11e: serve_lm --arch {arch} "
            f"exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
            f"{proc.stderr[-2000:]}")
        out["11e"][arch] = {"exit": proc.returncode,
                            "wall_s": monotonic() - t0,
                            "stdout": proc.stdout.strip().splitlines()}
    out["wall_s"] = monotonic() - t_phase
    return out, launches


def run_last_families_phase(dev, rel_err):
    """Phase 12: serving the last three LM families. 12a: jamba at full
    width, depth cut to ``JAMBA_LAYERS`` (mamba x 3 and attention, the MoE
    on layers 1 and 3; bf16 weights from seed 0 made one layer slice at a
    time): ``launch.serve --layers`` at decode_32k's full batch, one
    prefill at prefill_32k's length, launches reckoned from the shapes, a
    second prefill call bit for bit, the dropped share, profiles, peaks
    and bounds; 12b: one full-width Mamba layer and one full-width
    cross-attention block in f32, the card against the CPU, the decode
    steps against the prefill; 12c: whisper-medium at full width and
    depth: ``LM.encode`` over the stub frames, decode on decode_32k's
    slots with that ``enc_out``, one prefill_32k call with the frames,
    launches reckoned, profiles; 12d: internvl2-26b at full width and
    depth: ``launch.serve`` and one prefill of the vision prefix and the
    text, launches reckoned, profiles; 12e: ``launch.serve_lm`` in its own
    process for the three archs. Returns (the phase's numbers, the
    attention kernels' launches by part, the profiles the kernels line
    reads)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import layers as L
    from repro_torch.models.registry import count_params
    from repro_torch.obs.timing import monotonic

    out, launches, profiles = {}, {}, {}
    t_phase = monotonic()
    peak_and_reset()

    def timed_prefill(prefill, params, batch, nl_launches, what):
        """One prefill call timed, its launches (all on the tensor cores,
        ``nl_launches`` of them), finite last-position logits, a second
        call the same bits -> (seconds, launches, routes, launches by
        query and key length, peak)."""
        ops.reset_launch_counts()
        t0 = monotonic()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        secs = monotonic() - t0
        got = ops.launch_counts()
        routes = dict(ops.flash_attention.launches_by_route)
        lengths = dict(ops.flash_attention.launches_by_lengths)
        check(got["flash_attention"] == nl_launches
              and routes["tensor_core"] == nl_launches
              and got["flash_decode"] == 0,
              f"{what}: prefill launches {got}, by route {routes}, want "
              f"{nl_launches}")
        check(bool(torch.isfinite(logits).all()),
              f"{what}: prefill logits not finite")
        again = prefill(params, batch)
        check(torch.equal(logits, again),
              f"{what}: two prefill calls on the same inputs differ")
        return secs, got, routes, lengths, peak_and_reset()

    # ---- 12a: jamba at full width, depth cut ----
    cfg = serve.cut_depth(get_config(JAMBA_ARCH), JAMBA_LAYERS)
    steps = JAMBA_PROMPT - 1 + JAMBA_TOKENS
    n_attn = sum(s.mixer == "attn" for s in make_prefill_step(cfg)[1].specs)
    check(n_attn == 1, f"12a: {n_attn} attention layers in the cut")
    ops.reset_launch_counts()
    served = serve.main(["--arch", JAMBA_ARCH, "--layers", str(JAMBA_LAYERS),
                         "--batch", str(JAMBA_BATCH), "--prompt-len",
                         str(JAMBA_PROMPT), "--cache-len", str(JAMBA_CACHE),
                         "--tokens", str(JAMBA_TOKENS)])
    serve_launches = ops.launch_counts()
    check(serve_launches["flash_decode"] == n_attn * steps
          and serve_launches["flash_attention"] == 0,
          f"12a: serve launches {serve_launches}, want {n_attn} x {steps} "
          f"decodes")
    check(served.tokens.shape == (JAMBA_BATCH, JAMBA_TOKENS)
          and int(served.tokens.min()) >= 0
          and int(served.tokens.max()) < cfg.padded_vocab,
          f"12a: served tokens {served.tokens.shape}")
    launches["12a_decode"] = serve_launches["flash_decode"]
    peak_and_reset()
    prefill, lm = make_prefill_step(cfg)
    decode_step, _ = make_decode_step(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    ptoks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, JAMBA_PREFILL_S), np.int32)).to(dev)
    with moe_pairs() as pcounts:
        prefill_s, prefill_launches, prefill_routes, _, prefill_mem = \
            timed_prefill(prefill, params, {"tokens": ptoks}, n_attn, "12a")
    launches["12a_prefill"] = prefill_launches["flash_attention"]
    prefill_profile = device_profile(
        lambda: prefill(params, {"tokens": ptoks}))
    peak_and_reset()
    cache = lm.init_cache(JAMBA_BATCH, JAMBA_CACHE, device=dev)
    dtoks = ptoks[0, :9 * JAMBA_BATCH].reshape(JAMBA_BATCH, 9)
    with moe_pairs() as dcounts:
        for i in range(8):
            nxt, cache = decode_step(params, cache, dtoks[:, i:i + 1])
    check(0 <= int(nxt.min()) and int(nxt.max()) < cfg.padded_vocab,
          "12a: decoded ids out of range")
    decode_profile = device_profile(
        lambda: decode_step(params, cache, dtoks[:, 8:9]))
    state_bytes = sum(t.numel() * t.element_size()
                      for blk in cache["stages"][0] if "conv" in blk["mixer"]
                      for t in blk["mixer"].values())
    decode_mem = peak_and_reset()
    del cache, params
    peak_and_reset()
    # the least time of the work (bf16 at 989 TFLOP/s, 3.35 TB/s): a decode
    # step reads every weight (the capacity dispatch runs every expert)
    # and the attention layer's cache, and reads and writes the Mamba
    # states; a prefill call's products
    d_, di, st_ = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim
    h_, kv_, hd_, f_, e_ = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                            cfg.d_ff, cfg.num_experts)
    r_ = max(d_ // 16, 1)
    s_ = JAMBA_PREFILL_S
    weight_bytes = 2 * count_params(cfg)
    kv_bytes = 2 * 2 * JAMBA_BATCH * JAMBA_CACHE * n_attn * kv_ * hd_
    groups = max(s_ // 512, 1)
    cap = max(int((s_ // groups) * cfg.num_experts_per_tok / e_ * 1.25), 1)
    n_mamba = sum(s.mixer == "mamba" for s in lm.specs)
    n_moe = sum(s.ffn == "moe" for s in lm.specs)
    mamba_flops = 2 * s_ * (d_ * 2 * di + di * (r_ + 2 * st_) + r_ * di
                            + di * d_)
    attn_flops = 2 * s_ * d_ * (2 * h_ * hd_ + 2 * kv_ * hd_) \
        + 2 * s_ * s_ * h_ * hd_
    prefill_flops = n_mamba * mamba_flops + n_attn * attn_flops \
        + n_moe * (6 * e_ * groups * cap * d_ * f_ + 2 * s_ * d_ * e_) \
        + (len(lm.specs) - n_moe) * 6 * s_ * d_ * f_ \
        + 2 * d_ * cfg.padded_vocab
    out["12a"] = {
        "model": cfg.name, "layers": len(lm.specs),
        "block_pattern": list(cfg.block_pattern),
        "params": count_params(cfg),
        "active_params": count_params(cfg, active_only=True),
        "weight_bytes": weight_bytes,
        "serve": {"batch": JAMBA_BATCH, "cache_len": JAMBA_CACHE,
                  "prompt_len": JAMBA_PROMPT, "new_tokens": JAMBA_TOKENS,
                  "prompt_fed_s": served.prompt_s,
                  "decode_s": served.decode_s,
                  "decode_ms_per_step": served.decode_s / JAMBA_TOKENS * 1e3,
                  "tok_per_s": served.tok_per_s,
                  "launches": serve_launches,
                  "flash_decode_launches_reckoned": n_attn * steps,
                  "max_memory_allocated": served.peak_bytes,
                  "kv_cache_bytes": kv_bytes,
                  "mamba_state_bytes": state_bytes,
                  "decode_step_bound_ms": (weight_bytes + kv_bytes
                                           + 2 * state_bytes)
                  / H100_BYTES_PER_S * 1e3},
        "decode_steps_after_prefill": {"steps": 8,
                                       "max_memory_allocated": decode_mem},
        "prefill": {"batch": 1, "seq_len": JAMBA_PREFILL_S,
                    "prefill_s": prefill_s,
                    "tok_per_s": JAMBA_PREFILL_S / prefill_s,
                    "launches": prefill_launches,
                    "flash_attention_launches_reckoned": n_attn,
                    "flash_attention_launches_by_route": prefill_routes,
                    "max_memory_allocated": prefill_mem,
                    "second_call_bit_identical": True,
                    "moe_groups": groups, "moe_capacity": cap,
                    "bound_ms": bound(weight_bytes, prefill_flops,
                                      H100_BF16_FLOPS)[0],
                    "mamba_gemm_flops_a_layer": mamba_flops},
        "dropped_share": {
            "prefill": dropped_share(pcounts),
            "decode": dropped_share(dcounts),
            "prefill_pairs": pcounts["routed"],
            "decode_pairs": dcounts["routed"]},
        "profiled_prefill_call": prefill_profile,
        "profiled_decode_step": decode_profile}
    profiles["12a_prefill"], profiles["12a_decode"] = (prefill_profile,
                                                       decode_profile)

    # ---- 12b: one Mamba layer and one cross-attention block in f32 ----
    gen = torch.Generator(device=dev).manual_seed(8)
    p = L.mamba_init(L.ParamInit(gen, dev), cfg)
    for k in ("norm", "conv_b", "dt_bias", "D"):
        p[k] = p[k] + 0.1 * torch.randn(p[k].shape, generator=gen,
                                        device=dev)
    x = torch.randn(1, MAMBA_LAYER_TOKENS, d_, generator=gen, device=dev)

    def run_mamba(pp, xx, where):
        """The layer's prefill, and its first MAMBA_STEPS tokens one at a
        time through decode from a zero state."""
        with torch.no_grad():
            y, _ = L.mamba_apply(pp, xx, cfg=cfg, mode="full")
            c = L.mamba_cache_init(cfg, 1, device=where)
            dec = torch.cat([L.mamba_apply(pp, xx[:, i:i + 1], cfg=cfg,
                                           mode="decode", cache=c)[0]
                             for i in range(MAMBA_STEPS)], 1)
        return y, dec, c["ssm"]

    ops.reset_launch_counts()
    card = run_mamba(p, x, dev)
    check(not any(ops.launch_counts().values()),
          "12b: the Mamba layer launched a kernel")
    again = run_mamba(p, x, dev)
    check(all(torch.equal(a, b) for a, b in zip(card, again)),
          "12b: two card runs of one Mamba layer differ")
    cpu = run_mamba({k: v.cpu() for k, v in p.items()}, x.cpu(), "cpu")
    errs_m = {"prefill_card_vs_cpu": rel_err(card[0].cpu(), cpu[0]),
              "decode_card_vs_cpu": rel_err(card[1].cpu(), cpu[1]),
              "ssm_state_card_vs_cpu": rel_err(card[2].cpu(), cpu[2])}
    steps_m = {"decode_vs_prefill_on_the_card": rel_err(
        card[1], card[0][:, :MAMBA_STEPS]),
        "decode_vs_prefill_on_the_cpu": rel_err(
        cpu[1], cpu[0][:, :MAMBA_STEPS])}
    check(all(v <= CARD_CPU_TOL for v in errs_m.values())
          and all(v <= STEP_TOL for v in steps_m.values()),
          f"12b: Mamba errors {errs_m} (limit {CARD_CPU_TOL}), decode vs "
          f"prefill {steps_m} (limit {STEP_TOL})")
    del p, x, card, again, cpu
    wcfg = get_config(WHISPER_ARCH)
    gen = torch.Generator(device=dev).manual_seed(9)
    p = L.attn_init(L.ParamInit(gen, dev), wcfg, cross=True)
    for k in ("norm", "cross_norm"):
        p[k] = p[k] + 0.1 * torch.randn(p[k].shape, generator=gen,
                                        device=dev)
    x = torch.randn(2, CROSS_BLOCK_TOKENS, wcfg.d_model, generator=gen,
                    device=dev)
    enc = torch.randn(2, wcfg.encoder_seq_len, wcfg.d_model, generator=gen,
                      device=dev)

    def run_cross(pp, xx, ee, where):
        """The block in full mode, then CROSS_STEPS decode steps on a
        ring of CROSS_BLOCK_TOKENS slots, the same encoder rows."""
        with torch.no_grad():
            y, _ = L.attn_apply(pp, xx, cfg=wcfg, mode="full", enc_out=ee)
            c = L.attn_cache_init(wcfg, 2, CROSS_BLOCK_TOKENS, 0,
                                  torch.float32, where)
            dec = torch.cat([L.attn_apply(
                pp, xx[:, i:i + 1], cfg=wcfg, mode="decode", cache=c,
                pos=torch.full((2,), i, dtype=torch.int32, device=where),
                enc_out=ee)[0] for i in range(CROSS_STEPS)], 1)
        return y, dec

    ops.reset_launch_counts()
    card = run_cross(p, x, enc, dev)
    block_launches = ops.launch_counts()
    block_routes = dict(ops.flash_attention.launches_by_route)
    check(block_launches["flash_attention"] == 2
          and block_routes["cuda_core"] == 2
          and block_launches["flash_decode"] == 2 * CROSS_STEPS,
          f"12b: cross block launches {block_launches}, by route "
          f"{block_routes}")
    cpu = run_cross({k: v.cpu() for k, v in p.items()}, x.cpu(), enc.cpu(),
                    "cpu")
    errs_c = {"full_card_vs_cpu": rel_err(card[0].cpu(), cpu[0]),
              "decode_card_vs_cpu": rel_err(card[1].cpu(), cpu[1])}
    steps_c = {"decode_vs_full_on_the_card": rel_err(
        card[1], card[0][:, :CROSS_STEPS]),
        "decode_vs_full_on_the_cpu": rel_err(cpu[1],
                                             cpu[0][:, :CROSS_STEPS])}
    check(all(v <= CARD_CPU_TOL for v in errs_c.values())
          and all(v <= STEP_TOL for v in steps_c.values()),
          f"12b: cross block errors {errs_c} (limit {CARD_CPU_TOL}), "
          f"decode vs full {steps_c} (limit {STEP_TOL})")
    out["12b"] = {"dtype": "float32", "card_vs_cpu_limit": CARD_CPU_TOL,
                  "decode_vs_prefill_limit": STEP_TOL,
                  "mamba": {"tokens": MAMBA_LAYER_TOKENS,
                            "decode_steps": MAMBA_STEPS,
                            "d_inner": di, "state": st_,
                            "rel_err": errs_m, "decode_vs_prefill": steps_m,
                            "card_repeat_bit_identical": True},
                  "cross_attention": {
                      "tokens": CROSS_BLOCK_TOKENS,
                      "encoder_rows": wcfg.encoder_seq_len,
                      "decode_steps": CROSS_STEPS,
                      "launches": block_launches,
                      "flash_attention_launches_by_route": block_routes,
                      "rel_err": errs_c, "decode_vs_full": steps_c}}
    del p, x, enc, card, cpu
    peak_and_reset()

    # ---- 12c: whisper-medium at full width and depth ----
    prefill, lm = make_prefill_step(wcfg)
    decode_step, _ = make_decode_step(wcfg)
    nl, ne = wcfg.num_layers, wcfg.encoder_layers
    se = wcfg.encoder_seq_len
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    frames = torch.randn(WHISPER_BATCH, se, wcfg.d_model,
                         generator=torch.Generator(device=dev).manual_seed(
                             10), device=dev).to(torch.bfloat16)
    ops.reset_launch_counts()
    with torch.no_grad():
        lm.encode(params, frames)                         # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = monotonic()
        enc = lm.encode(params, frames)
        torch.cuda.synchronize()
    encode_s = monotonic() - t0
    encode_launches = ops.launch_counts()
    encode_routes = dict(ops.flash_attention.launches_by_route)
    encode_lengths = dict(ops.flash_attention.launches_by_lengths)
    check(encode_launches["flash_attention"] == ne
          and encode_routes["tensor_core"] == ne
          and encode_lengths == {f"{se}x{se}": ne}
          and tuple(enc.shape) == (WHISPER_BATCH, se, wcfg.d_model)
          and bool(torch.isfinite(enc).all()),
          f"12c: encode launches {encode_launches}, by route "
          f"{encode_routes}, by lengths {encode_lengths}")
    launches["12c_encode"] = encode_lengths[f"{se}x{se}"]
    with torch.no_grad():
        encode_profile = device_profile(lambda: lm.encode(params, frames))
    encode_mem = peak_and_reset()
    cache = lm.init_cache(WHISPER_BATCH, WHISPER_CACHE, device=dev)
    cache["enc_out"] = enc
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(
        0, wcfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT),
        np.int32)).to(dev)
    wsteps = WHISPER_PROMPT - 1 + WHISPER_TOKENS
    ops.reset_launch_counts()
    t0 = monotonic()
    tok = prompt[:, :1]
    for i in range(1, WHISPER_PROMPT):
        _, cache = decode_step(params, cache, tok)
        tok = prompt[:, i:i + 1]
    torch.cuda.synchronize()
    w_prompt_s = monotonic() - t0
    gen_toks = []
    t0 = monotonic()
    for _ in range(WHISPER_TOKENS):
        tok, cache = decode_step(params, cache, tok)
        gen_toks.append(tok)
    torch.cuda.synchronize()
    w_decode_s = monotonic() - t0
    w_decode_launches = ops.launch_counts()
    # one query over the cache's slots (self) or over the encoder's rows
    # (cross)
    w_decode_lengths = dict(ops.flash_decode.launches_by_lengths)
    self_key, cross_key = f"1x{WHISPER_CACHE}", f"1x{se}"
    gen_toks = torch.cat(gen_toks, 1)
    check(w_decode_launches["flash_decode"] == 2 * nl * wsteps
          and w_decode_lengths == {self_key: nl * wsteps,
                                   cross_key: nl * wsteps}
          and w_decode_launches["flash_attention"] == 0
          and 0 <= int(gen_toks.min())
          and int(gen_toks.max()) < wcfg.padded_vocab,
          f"12c: decode launches {w_decode_launches}, by lengths "
          f"{w_decode_lengths}, want {nl} x {wsteps} of {self_key} and of "
          f"{cross_key}")
    launches["12c_decode_self"] = w_decode_lengths[self_key]
    launches["12c_decode_cross"] = w_decode_lengths[cross_key]
    w_decode_profile = device_profile(
        lambda: decode_step(params, cache, tok))
    w_decode_mem = peak_and_reset()
    del cache
    peak_and_reset()
    # one self- and one cross-attention call at each mode's shape, each
    # profiled alone (the step's profiles mix them, on the same kernel
    # instance): ``kernel_device_ms``, which profiles again
    # when the profiler drops a lone launch's event (one did, in a run of
    # this phase), in the shape of ``device_profile``'s attention entry
    from repro_torch.obs.device_time import kernel_device_ms

    def launch_profile(fn, names):
        per = kernel_device_ms(fn, names, iters=20)
        return {"attention_device_ms_a_launch": {
            f"::{n}<": {"launches": 1, "device_ms": ms}
            for n, ms in per.items()}}
    gq = torch.Generator(device=dev).manual_seed(12)
    hq, hk, hd = wcfg.num_heads, wcfg.num_kv_heads, wcfg.head_dim

    def brandn(*shape):
        return torch.randn(shape, generator=gq, device=dev).to(
            torch.bfloat16)
    ck, cv = brandn(WHISPER_BATCH, se, hk, hd), brandn(WHISPER_BATCH, se,
                                                       hk, hd)
    cq = brandn(WHISPER_BATCH, 1, hq, hd)
    L._cross_core(cq, ck, cv)
    profiles["12c_cross_decode"] = launch_profile(
        lambda: L._cross_core(cq, ck, cv),
        ("flash_decode_kernel",) + (("flash_decode_combine_kernel",)
                                    if ops.flash_decode.last_splits > 1
                                    else ()))
    cq, ck, cv = (brandn(1, WHISPER_PREFILL_S, hq, hd), ck[:1].contiguous(),
                  cv[:1].contiguous())
    profiles["12c_cross_prefill"] = launch_profile(
        lambda: L._cross_core(cq, ck, cv), ("flash_fwd_wgmma_kernel",))
    # the decoder's causal self-attention at the prefill's shape, and its
    # decode over the cache's slots, as many valid as in the last step
    ck, cv = brandn(1, WHISPER_PREFILL_S, hk, hd), brandn(
        1, WHISPER_PREFILL_S, hk, hd)
    profiles["12c_self_prefill"] = launch_profile(
        lambda: ops.flash_attention(cq, ck, cv, causal=True),
        ("flash_fwd_wgmma_kernel",))
    cq = brandn(WHISPER_BATCH, 1, hq, hd)
    ck, cv = (brandn(WHISPER_BATCH, WHISPER_CACHE, hk, hd),
              brandn(WHISPER_BATCH, WHISPER_CACHE, hk, hd))
    svalid = (torch.arange(WHISPER_CACHE, device=dev) < wsteps).expand(
        WHISPER_BATCH, WHISPER_CACHE).contiguous()
    ops.flash_decode(cq, ck, cv, svalid)
    profiles["12c_self_decode"] = launch_profile(
        lambda: ops.flash_decode(cq, ck, cv, svalid),
        ("flash_decode_kernel",) + (("flash_decode_combine_kernel",)
                                    if ops.flash_decode.last_splits > 1
                                    else ()))
    del cq, ck, cv, svalid
    wtoks = torch.from_numpy(np.random.default_rng(13).integers(
        0, wcfg.vocab_size, (1, WHISPER_PREFILL_S), np.int32)).to(dev)
    wbatch = {"tokens": wtoks, "enc_frames": frames[:1]}
    w_prefill_s, w_prefill_launches, w_prefill_routes, w_prefill_lengths, \
        w_prefill_mem = timed_prefill(prefill, params, wbatch, ne + 2 * nl,
                                      "12c")
    # the encoder's launches (1,500 x 1,500), the causal self-attention's
    # (S x S) and the cross-attention's (S x 1,500), each counted
    by_part = {"encoder": f"{se}x{se}",
               "self": f"{WHISPER_PREFILL_S}x{WHISPER_PREFILL_S}",
               "cross": f"{WHISPER_PREFILL_S}x{se}"}
    check(w_prefill_lengths == {by_part["encoder"]: ne,
                                by_part["self"]: nl, by_part["cross"]: nl},
          f"12c: prefill launches by lengths {w_prefill_lengths}, want "
          f"{ne} encoder, {nl} self, {nl} cross")
    for part, key in by_part.items():
        launches[f"12c_prefill_{part}"] = w_prefill_lengths[key]
    w_prefill_profile = device_profile(lambda: prefill(params, wbatch))
    del params, frames, enc
    peak_and_reset()
    w_weight = 2 * count_params(wcfg)
    w_kv = 2 * 2 * WHISPER_BATCH * WHISPER_CACHE * nl * hk * hd
    # a step re-projects every layer's cross keys and values from enc_out
    # (the reference's way)
    reproj = 2 * 2 * WHISPER_BATCH * se * wcfg.d_model * hk * hd * nl
    out["12c"] = {
        "model": wcfg.name, "decoder_layers": nl, "encoder_layers": ne,
        "params": count_params(wcfg), "weight_bytes": w_weight,
        "encode": {"batch": WHISPER_BATCH, "frames": se,
                   "encode_s": encode_s, "launches": encode_launches,
                   "flash_attention_launches_by_lengths": encode_lengths,
                   "flash_attention_launches_reckoned": ne,
                   "flash_attention_launches_by_route": encode_routes,
                   "max_memory_allocated": encode_mem,
                   "profile": encode_profile},
        "decode": {"batch": WHISPER_BATCH, "cache_len": WHISPER_CACHE,
                   "prompt_len": WHISPER_PROMPT,
                   "new_tokens": WHISPER_TOKENS,
                   "prompt_fed_s": w_prompt_s, "decode_s": w_decode_s,
                   "decode_ms_per_step": w_decode_s / WHISPER_TOKENS * 1e3,
                   "tok_per_s": WHISPER_BATCH * WHISPER_TOKENS / w_decode_s,
                   "launches": w_decode_launches,
                   "flash_decode_launches_by_lengths": w_decode_lengths,
                   "flash_decode_launches_reckoned": 2 * nl * wsteps,
                   "max_memory_allocated": w_decode_mem,
                   "kv_cache_bytes": w_kv,
                   "cross_reprojection_flops": reproj,
                   "decode_step_bound_ms": bound(
                       w_weight + w_kv, reproj, H100_BF16_FLOPS)[0]},
        "prefill": {"batch": 1, "seq_len": WHISPER_PREFILL_S,
                    "encoder_frames": se, "prefill_s": w_prefill_s,
                    "tok_per_s": WHISPER_PREFILL_S / w_prefill_s,
                    "launches": w_prefill_launches,
                    "flash_attention_launches_reckoned": ne + 2 * nl,
                    "flash_attention_launches_by_route": w_prefill_routes,
                    "flash_attention_launches_by_lengths": w_prefill_lengths,
                    "max_memory_allocated": w_prefill_mem,
                    "second_call_bit_identical": True},
        "profiled_prefill_call": w_prefill_profile,
        "profiled_decode_step": w_decode_profile}
    profiles["12c_encode"] = encode_profile

    # ---- 12d: internvl2-26b at full width and depth ----
    vcfg = get_config(VLM_ARCH)
    nv = vcfg.num_layers
    vsteps = VLM_PROMPT - 1 + VLM_TOKENS
    ops.reset_launch_counts()
    vserved = serve.main(["--arch", VLM_ARCH, "--batch", str(VLM_BATCH),
                          "--prompt-len", str(VLM_PROMPT), "--cache-len",
                          str(VLM_CACHE), "--tokens", str(VLM_TOKENS)])
    v_serve_launches = ops.launch_counts()
    check(v_serve_launches["flash_decode"] == nv * vsteps
          and v_serve_launches["flash_attention"] == 0
          and vserved.tokens.shape == (VLM_BATCH, VLM_TOKENS)
          and 0 <= int(vserved.tokens.min())
          and int(vserved.tokens.max()) < vcfg.padded_vocab,
          f"12d: serve launches {v_serve_launches}, want {nv} x {vsteps}")
    launches["12d_decode"] = v_serve_launches["flash_decode"]
    peak_and_reset()
    prefill, lm = make_prefill_step(vcfg)
    decode_step, _ = make_decode_step(vcfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(0), dev,
                     dtype=torch.bfloat16)
    npre = vcfg.num_prefix_tokens
    vbatch = {"tokens": torch.from_numpy(np.random.default_rng(14).integers(
        0, vcfg.vocab_size, (1, VLM_PREFILL_S - npre), np.int32)).to(dev),
        "prefix_embeds": torch.randn(
            1, npre, vcfg.d_model, device=dev,
            generator=torch.Generator(device=dev).manual_seed(15)).to(
                torch.bfloat16)}
    v_prefill_s, v_prefill_launches, v_prefill_routes, _, v_prefill_mem = \
        timed_prefill(prefill, params, vbatch, nv, "12d")
    launches["12d_prefill"] = nv
    v_prefill_profile = device_profile(lambda: prefill(params, vbatch))
    peak_and_reset()
    cache = lm.init_cache(VLM_BATCH, VLM_CACHE, device=dev)
    dtoks = vbatch["tokens"][0, :3 * VLM_BATCH].reshape(VLM_BATCH, 3)
    for i in range(2):
        _, cache = decode_step(params, cache, dtoks[:, i:i + 1])
    v_decode_profile = device_profile(
        lambda: decode_step(params, cache, dtoks[:, 2:3]))
    del cache, params, vbatch
    peak_and_reset()
    v_weight = 2 * count_params(vcfg)
    vh, vkv, vhd, vd, vf = (vcfg.num_heads, vcfg.num_kv_heads,
                            vcfg.head_dim, vcfg.d_model, vcfg.d_ff)
    v_kv = 2 * 2 * VLM_BATCH * VLM_CACHE * nv * vkv * vhd
    sv = VLM_PREFILL_S
    v_gemm = nv * 2 * sv * vd * (2 * vh * vhd + 2 * vkv * vhd + 3 * vf) \
        + 2 * npre * vd * vd + 2 * vd * vcfg.padded_vocab
    v_attn = nv * 2 * sv * sv * vh * vhd
    out["12d"] = {
        "model": vcfg.name, "layers": nv, "params": count_params(vcfg),
        "weight_bytes": v_weight, "heads": [vh, vkv, vhd],
        "serve": {"batch": VLM_BATCH, "cache_len": VLM_CACHE,
                  "prompt_len": VLM_PROMPT, "new_tokens": VLM_TOKENS,
                  "prompt_fed_s": vserved.prompt_s,
                  "decode_s": vserved.decode_s,
                  "decode_ms_per_step": vserved.decode_s / VLM_TOKENS * 1e3,
                  "tok_per_s": vserved.tok_per_s,
                  "launches": v_serve_launches,
                  "flash_decode_launches_reckoned": nv * vsteps,
                  "max_memory_allocated": vserved.peak_bytes,
                  "kv_cache_bytes": v_kv,
                  "decode_step_bound_ms": (v_weight + v_kv)
                  / H100_BYTES_PER_S * 1e3},
        "prefill": {"batch": 1, "prefix_embeddings": npre,
                    "text_tokens": sv - npre, "positions": sv,
                    "prefill_s": v_prefill_s, "tok_per_s": sv / v_prefill_s,
                    "launches": v_prefill_launches,
                    "flash_attention_launches_reckoned": nv,
                    "flash_attention_launches_by_route": v_prefill_routes,
                    "max_memory_allocated": v_prefill_mem,
                    "second_call_bit_identical": True,
                    "gemm_flops": v_gemm, "attention_flops": v_attn,
                    "bound_ms": bound(v_weight, v_gemm + v_attn,
                                      H100_BF16_FLOPS)[0]},
        "profiled_prefill_call": v_prefill_profile,
        "profiled_decode_step": v_decode_profile}
    profiles["12d_prefill"], profiles["12d_decode"] = (v_prefill_profile,
                                                       v_decode_profile)
    ops.reset_launch_counts()

    # ---- 12e: serve_lm in its own process, for the three archs ----
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out["12e"] = {}
    for arch in (JAMBA_ARCH, WHISPER_ARCH, VLM_ARCH):
        t0 = monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
             arch], cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=env)
        check(proc.returncode == 0 and proc.stdout.startswith(
            f"arch={arch} (reduced)"), f"12e: serve_lm --arch {arch} "
            f"exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
            f"{proc.stderr[-2000:]}")
        out["12e"][arch] = {"exit": proc.returncode,
                            "wall_s": monotonic() - t0,
                            "stdout": proc.stdout.strip().splitlines()}
    out["wall_s"] = monotonic() - t_phase
    return out, launches, profiles

def run_extras_training_phase(dev, rel_err):
    """Phase 13, training with the extras. 13a: two rounds of
    ``make_train_step`` at whisper-medium's full width and depth with its
    encoder frames, 13b: at internvl2-26b's full width, depth cut to 2
    layers, with its vision prefix (phase 9a's cut), each through
    ``train_rounds`` with launches reckoned by query and key length and
    every backward on the tensor cores; 13c: a reduced-width f32 round
    with each extra on the card and on the CPU. Returns (the phase's
    numbers, the kernels line's rows of the backward at 13a's cross and
    encoder shapes and 13b's layer)."""
    import numpy as np
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import count_params
    from repro_torch.models.transformer import split_stages, stage_layers
    from repro_torch.obs.timing import monotonic

    out = {}
    t_phase = monotonic()
    peak_and_reset()
    tcfg = TrainConfig(local_steps=TRAIN_LOCAL, microbatch=TRAIN_MB,
                       meta_clusters=TRAIN_META_CLUSTERS,
                       meta_steps=TRAIN_META_STEPS)

    def reckoned(cfg, lm, positions, rounds=2):
        """The attention launches of ``rounds`` rounds by query x key
        length. Under a gradient each layer of a scan stage runs forward
        twice (remat: forward, recompute), of an unroll stage once, and
        backward once: each local microbatch runs every layer so; each
        cohort's probe runs the encoder and the lower layers once without
        a gradient; each meta step the encoder once without a gradient
        and the upper layers so. An encoder-decoder's decoder layer runs
        self-attention (positions x positions) and cross-attention
        (positions x Se); its encoder Se x Se."""
        _, b_stage = split_stages(cfg, cfg.split_layer)

        def runs(stages):
            return sum(stage_layers(st) * (2 if st.kind == "scan"
                                           and tcfg.remat else 1)
                       for st in stages)
        lower = sum(stage_layers(st) for st in lm.stages[:b_stage])
        upper, enc = cfg.num_layers - lower, cfg.encoder_layers
        mbs, g, m = TRAIN_G * TRAIN_LOCAL, TRAIN_G, TRAIN_META_STEPS
        key = f"{positions}x{positions}"
        fwd = {key: rounds * (mbs * runs(lm.stages) + g * lower
                              + m * runs(lm.stages[b_stage:]))}
        bwd = {key: rounds * (mbs * cfg.num_layers + m * upper)}
        if cfg.is_encoder_decoder:
            se = cfg.encoder_seq_len
            fwd[f"{positions}x{se}"] = fwd[key]
            bwd[f"{positions}x{se}"] = bwd[key]
            fwd[f"{se}x{se}"] = rounds * (mbs * runs(lm.enc_stages)
                                          + g * enc + m * enc)
            bwd[f"{se}x{se}"] = rounds * mbs * enc
        return fwd, bwd, lower, upper

    def train_full(tag, cfg, key, extra_len):
        """``train_rounds`` at full width with the extra ``key``
        (extra_len positions a sequence) and its launches reckoned -> the
        tag's numbers and the backward launches by lengths."""
        step, lm = make_train_step(cfg, tcfg)
        shape = (TRAIN_G, TRAIN_LOCAL, 1, TRAIN_MB, TRAIN_T)
        positions = TRAIN_T + (extra_len if key == "prefix_embeds" else 0)
        rng = np.random.default_rng(1)
        gx = torch.Generator(device=dev).manual_seed(3)
        batches = [{"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, shape, np.int32)).to(dev),
            key: torch.randn(shape[:-1] + (extra_len, cfg.d_model),
                             generator=gx, device=dev)} for _ in range(2)]
        firsts = [rng.integers(0, TRAIN_MB, TRAIN_G).tolist()
                  for _ in range(2)]
        tokens = TRAIN_G * TRAIN_LOCAL * TRAIN_MB * TRAIN_T
        rounds, got = train_rounds(tag, step, lm, batches, firsts,
                                   TRAIN_META_CLUSTERS, tokens)
        del batches
        launches, sweeps = got["counts"], got["lloyd_sweeps"]
        fwd_want, bwd_want, lower, upper = reckoned(cfg, lm, positions)
        check(got["fwd_by_lengths"] == fwd_want
              and got["bwd_by_lengths"] == bwd_want,
              f"{tag}: launches by lengths forward {got['fwd_by_lengths']}, "
              f"backward {got['bwd_by_lengths']}; reckoned {fwd_want}, "
              f"{bwd_want}")
        check(got["bwd_by_route"] == {"tensor_core": sum(bwd_want.values()),
                                      "cuda_core": 0},
              f"{tag}: backward launches by route {got['bwd_by_route']}")
        # K-means with K clusters: K-1 init steps and one representatives
        # pass a cohort, one Lloyd sweep each sweep it ran
        check(len(sweeps) == 2 * TRAIN_G
              and launches["kmeans_pairwise_dist"]
              == 2 * TRAIN_G * TRAIN_META_CLUSTERS
              and launches["kmeans_lloyd_step"] == sum(sweeps)
              and launches["flash_decode"] == 0,
              f"{tag}: launches {launches}, Lloyd sweeps {sweeps}")
        return {
            "model": cfg.name, "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers,
            "params": count_params(cfg), "extra": key,
            "extra_positions": extra_len, "cohorts": TRAIN_G,
            "local_steps": TRAIN_LOCAL, "microbatch": TRAIN_MB,
            "n_micro": 1, "text_tokens": TRAIN_T, "positions": positions,
            "split": {"lower_layers": lower, "upper_layers": upper},
            "stages": [[st.kind, stage_layers(st)] for st in lm.stages],
            "meta_clusters": TRAIN_META_CLUSTERS,
            "meta_steps": TRAIN_META_STEPS, "dtype": tcfg.dtype,
            "remat": tcfg.remat, "launches": launches,
            "lloyd_sweeps": sweeps,
            "flash_attention_launches_by_lengths": got["fwd_by_lengths"],
            "flash_attention_bwd_launches_by_lengths": got["bwd_by_lengths"],
            "flash_attention_bwd_launches_by_route": got["bwd_by_route"],
            **rounds}, got["bwd_by_lengths"]

    # ---- 13a: whisper-medium at full width and depth ----
    wcfg = get_config(WHISPER_ARCH)
    out["13a"], w_bwd = train_full("13a", wcfg, "enc_frames",
                                   wcfg.encoder_seq_len)
    # ---- 13b: internvl2-26b at full width, depth cut ----
    vcfg = serve.cut_depth(get_config(VLM_ARCH), EXTRAS_VLM_LAYERS)
    out["13b"], v_bwd = train_full("13b", vcfg, "prefix_embeds",
                                   vcfg.num_prefix_tokens)

    # ---- 13c: a reduced-width f32 round with each extra, card vs CPU ----
    # (as many clusters as probe rows, as 9b)
    out["13c"] = {}
    for arch in (WHISPER_ARCH, VLM_ARCH):
        small = get_config(arch).reduced()
        step32, lm32 = make_train_step(small, TrainConfig(
            dtype="float32", microbatch=4, meta_clusters=4))
        g = torch.Generator().manual_seed(8)
        key, n = (("enc_frames", small.encoder_seq_len)
                  if small.is_encoder_decoder
                  else ("prefix_embeds", small.num_prefix_tokens))
        batch = {"tokens": torch.randint(small.vocab_size, (2, 2, 1, 4, 64),
                                         generator=g),
                 key: torch.randn(2, 2, 1, 4, n, small.d_model, generator=g)}
        out["13c"][arch], bl = card_vs_cpu_round(
            f"13c {arch}", step32, lm32.init(torch.Generator().manual_seed(7)),
            batch, [1, 2], dev, rel_err)
        check(not small.is_encoder_decoder
              or f"64x{small.encoder_seq_len}" in bl,
              f"13c {arch}: no cross-attention backward on the card ({bl})")
    ops.reset_launch_counts()

    # ---- the kernels line's rows: the backward at 13a's cross and
    # encoder shapes and at 13b's layer ----
    wh, wkv, wd, se = (wcfg.num_heads, wcfg.num_kv_heads, wcfg.head_dim,
                       wcfg.encoder_seq_len)
    cross = bwd_row(dev, "flash_attention_bwd_cross",
                    (TRAIN_MB, TRAIN_T, se, wh, wkv, wd), False,
                    w_bwd.get(f"{TRAIN_T}x{se}", 0),
                    "at phase 13a's cross-attention shape", seed=6)
    # 13a's 4,096 text tokens are 9a's cut; whisper's own decoder holds
    # WHISPER_DECODER_LEN positions: the same layer at that query length
    at_len = bwd_row(dev, "flash_attention_bwd_cross",
                     (TRAIN_MB, WHISPER_DECODER_LEN, se, wh, wkv, wd), False,
                     0, "at whisper's decoder length", seed=9)
    cross["at_whisper_decoder_len"] = {
        k: at_len[k] for k in ("shape", "key_len", "max_abs_err",
                               "block_rel_err", "ms", "device_ms",
                               "device_ms_by_launch", "plain_ms",
                               "bound_ms", "bound_by", "library_ms")}
    vpos = TRAIN_T + vcfg.num_prefix_tokens
    rows = [cross,
            bwd_row(dev, "flash_attention_bwd_enc",
                    (TRAIN_MB, se, se, wh, wkv, wd), False,
                    w_bwd.get(f"{se}x{se}", 0),
                    "at phase 13a's encoder shape", seed=7),
            bwd_row(dev, "flash_attention_bwd_d128_g6",
                    (TRAIN_MB, vpos, vpos, vcfg.num_heads, vcfg.num_kv_heads,
                     vcfg.head_dim), True, sum(v_bwd.values()),
                    "at phase 13b's layer shape", seed=8)]
    ops.reset_launch_counts()
    out["wall_s"] = monotonic() - t_phase
    return out, rows


if __name__ == "__main__":
    main()
