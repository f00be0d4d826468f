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
     that fill part of a 64-column panel, bf16 D=72 on the CUDA cores),
     each case counted on the route its dtype and D pick; decode at
     S=32768 with 40 valid slots, at ragged S=300, with G=1, with G=7, at
     D=36 (element-wise loads), with each (q, cache) dtype pair, and with
     1, 2 and many splits of S (the split count checked against the
     plan), one many-split case run twice and compared bit for bit; the
     prefill kernel's softmax statistics (lse, (B,H,S) f32) on the route
     each case takes, against the plain version's, the output unchanged
     bit for bit by asking for them, and the backward kernels (dq, dk, dv)
     against ``ref.flash_attention_bwd_ref`` fed the same inputs and
     statistics (``BWD_CASES``: llama3.2-1b's heads causal at S=1024 in
     bf16 and f32, S=1000 non-causal, a window of 128, MQA, qwen2-0.5b's
     G=7, gemma3's D=256 with window 1024, S below one tile, D=96, D=32,
     bf16 D=72, phi3's D=128 with a window, G=7 non-causal with a window,
     bf16 D=96, G=64), each on the route ``bwd_route`` names (by the
     wrapper's count by route), three cases (two on the tensor cores, one
     on the CUDA cores) twice, bit for bit;
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
  5. time each kernel beside its plain version, a library call where one
     computes the same function, and its bound (the attention kernels at
     phase 6's shapes, with their route, the decode split count and the
     registers and spills per thread that ptxas reported). ``ms`` is the
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
               (1, 300, 4, 2, 72, True, 0, "bfloat16")]
# phase 2b, the forward's statistics and the backward: llama3.2-1b's heads
# causal at S=1024 in both dtypes, S=1000 non-causal, a window of 128, MQA,
# qwen2-0.5b's G=7, gemma3's D=256 with window 1024, S below one tile,
# D=96 (f32: the CUDA-core forward), D=32, bf16 D=72 (the CUDA-core
# forward route in bf16), phi3's D=128 with a window, G=7 non-causal with
# a window, bf16 D=96 and G=64 (one query a row tile) on the backward's
# tensor-core route. Each backward runs on the route bwd_route names; the
# cases in BWD_TWICE run twice, bit for bit.
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
             (1, 130, 64, 1, 64, True, 0, "bfloat16")]
BWD_TWICE = (0, 1, 12)
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
                (2, 300, 8, 2, 36, 200, "bfloat16", "bfloat16", None)]
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
    print(json.dumps({"attention_checks_max_abs_err": att}))

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
    from repro_torch.models.transformer import LM, cast_params, tree_map
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
    params_full = lm_full.init(torch.Generator(device=dev).manual_seed(0))
    ptoks = torch.from_numpy(np.random.default_rng(1).integers(
        0, full.vocab_size, (1, PREFILL_S), np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = monotonic()
    plogits = prefill(params_full, {"tokens": ptoks})
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
    from torch.profiler import ProfilerActivity, profile

    def device_profile(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = monotonic()
            fn()
            torch.cuda.synchronize()
            wall = (monotonic() - t) * 1e3
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in evs) / 1e3
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
        # each attention kernel's share of the device time
        shares = {e.key[:80]: e.self_device_time_total / 1e3 / busy
                  for e in evs if "flash_" in e.key}
        return {"wall_ms": wall, "device_busy_ms": busy,
                "device_busy_share": busy / wall,
                "attention_share_of_device_time": shares,
                "top_device_ms": {e.key[:80]: e.self_device_time_total / 1e3
                                  for e in top}}

    prefill_profile = device_profile(
        lambda: prefill(params_full, {"tokens": ptoks}))
    # the decode step's logits at the serve shape, and where one decode
    # step's time goes (the counts above are read)
    pbf = cast_params(params_full, torch.bfloat16)
    del params_full
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
    # the -Xptxas -v report of phase 1's build
    def ptxas(source, pattern):
        found = [u for fn, u in build.ptxas_usage(
            build.ptxas_logs.get(source, "")).items()
            if re.search(pattern, fn)]
        return found[0] if len(found) == 1 else None

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

    # the attention kernels at phase 6's shapes (bf16): one prefill layer
    # (B=1, S=32768, H=32, KV=8, D=64, causal) and one decode layer of the
    # serve run's last step (B=32, 32768 slots, 47 of them valid)
    gd = torch.Generator(device=dev).manual_seed(2)

    def drandn(*shape):
        return torch.randn(shape, generator=gd, device=dev).to(torch.bfloat16)

    h_, kv_, d_ = full.num_heads, full.num_kv_heads, full.head_dim
    qa, ka, va = (drandn(1, PREFILL_S, h_, d_), drandn(1, PREFILL_S, kv_, d_),
                  drandn(1, PREFILL_S, kv_, d_))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    from repro_torch.models import layers as L
    full_err = att_check(
        "flash_attention", ops.flash_attention(qa, ka, va),
        L._sdpa_chunked_raw(qa, ka, va, causal=True, window=0), "bfloat16",
        "at phase 6's prefill shape")
    a_bytes = 2 * (2 * qa.numel() + ka.numel() + va.numel())
    a_flops = 2 * PREFILL_S ** 2 * h_ * d_
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": prefill_launches["flash_attention"],
        "max_abs_err": errs["flash_attention"],
        "ms": cuda_ms(lambda: ops.flash_attention(qa, ka, va), 5, 1),
        "kernel_route": prefill_route(qa.dtype, d_),
        "ptxas": ptxas("flash_attention",
                       r"flash_fwd_wgmma_kernelILi64ELi128ELi3E"),
        "plain_ms": cuda_ms(lambda: L._sdpa_chunked_raw(
            qa, ka, va, causal=True, window=0), 2, 1),
        "plain": "layers._sdpa_chunked_raw (flash_attention_ref's S x S "
                 "scores would take 137 GB at S=32768)",
        "max_abs_err_vs_plain_at_this_shape": full_err,
        **dict(zip(("bound_ms", "bound_by"),
                   bound(a_bytes, a_flops, H100_BF16_FLOPS))),
        "library_ms": cuda_ms(lambda: sdpa(
            qa.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2),
            is_causal=True, enable_gqa=True), 5, 1),
        "shape": [1, PREFILL_S, h_, kv_, d_]})
    del qa, ka, va
    torch.cuda.empty_cache()
    n_valid = SERVE_PROMPT - 1 + SERVE_TOKENS
    qd = drandn(SERVE_BATCH, 1, h_, d_)
    kcd = drandn(SERVE_BATCH, SERVE_CACHE, kv_, d_)
    vcd = drandn(SERVE_BATCH, SERVE_CACHE, kv_, d_)
    vmask = (torch.arange(SERVE_CACHE, device=dev) < n_valid).expand(
        SERVE_BATCH, SERVE_CACHE).contiguous()
    dec_err = att_check(
        "flash_decode", ops.flash_decode(qd, kcd, vcd, vmask),
        ref.flash_decode_ref(qd, kcd, vcd, vmask), "bfloat16",
        "at phase 6's decode shape")
    d_bytes = 2 * (2 * qd.numel() + kcd.numel() + vcd.numel()) \
        + vmask.numel()
    d_flops = 4 * SERVE_BATCH * h_ * SERVE_CACHE * d_
    rows.append({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:59",
        "launches": serve_launches["flash_decode"],
        "max_abs_err": errs["flash_decode"],
        "ms": cuda_ms(lambda: ops.flash_decode(qd, kcd, vcd, vmask), 20, 2),
        "kernel_route": "cuda_core, split S",
        "splits": ops.flash_decode.last_splits,
        "ptxas": ptxas("decode_attention",
                       r"flash_decode_kernelI13__nv_bfloat16S\d_Li64ELi4E"),
        "plain_ms": cuda_ms(lambda: ref.flash_decode_ref(qd, kcd, vcd, vmask),
                            3, 1),
        "max_abs_err_vs_plain_at_this_shape": dec_err,
        **dict(zip(("bound_ms", "bound_by"),
                   bound(d_bytes, d_flops, H100_BF16_FLOPS))),
        "library_ms": cuda_ms(lambda: sdpa(
            qd.transpose(1, 2), kcd.transpose(1, 2), vcd.transpose(1, 2),
            attn_mask=vmask[:, None, None, :], enable_gqa=True), 3, 1),
        "shape": [SERVE_BATCH, SERVE_CACHE, h_, kv_, d_]})
    del qd, kcd, vcd, vmask
    torch.cuda.empty_cache()
    # the backward kernels, timed by phase 9 at one training layer's shape
    rows.append({**bwd_row, "max_abs_err": errs["flash_attention_bwd"]})
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
    """Phase 9, the federated LM training path. 9a: two rounds of
    ``make_train_step`` at llama3.2-1b's full width (the train_4k cut in
    ``TRAIN_*``), its checks and numbers, one profiled round, and the
    backward kernels at one layer's shape; 9b: a reduced-width f32 step on
    the card and on the CPU; 9c: ``launch.train --smoke`` in its own
    process and its checkpoint; 9d: ``launch.federated_lm`` in its own
    process. Returns (the phase's numbers, the backward kernel's row of
    the kernels line but its max_abs_err)."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import selection as sel_mod
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_attention import bwd_route_for
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import (split_stages, stage_layers,
                                                tree_map)
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
    toks = [torch.from_numpy(rng.integers(0, full.vocab_size, shape,
                                          np.int32)).to(dev)
            for _ in range(2)]
    firsts = [rng.integers(0, TRAIN_MB, TRAIN_G).tolist() for _ in range(2)]
    params0 = lm.init(torch.Generator(device=dev).manual_seed(0))
    before = [t.cpu() for t in tree_leaves(params0)]
    state = tree_map(lambda x: x[None].expand((TRAIN_G,) + tuple(x.shape)),
                     params0)
    del params0
    # each selection's Lloyd sweeps, to reckon the Lloyd launches
    sweeps = []
    real_select = sel_mod.select_metadata

    def recording(*args, **kwargs):
        got = real_select(*args, **kwargs)
        sweeps.append(got.lloyd_iters)
        return got

    sel_mod.select_metadata = recording
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        walls, metrics, states = [], [], []
        for r in range(2):
            t0 = monotonic()
            state, _, m = step(state, (), {"tokens": toks[r]}, firsts[r])
            metrics.append({k: float(v) for k, v in m.items()})  # syncs
            walls.append(monotonic() - t0)
            states.append(state)
        launches = ops.launch_counts()
        bwd_routes = dict(ops.flash_attention_bwd.launches_by_route)
        peak = torch.cuda.max_memory_allocated()
        round_sweeps = list(sweeps)
        # round 1 again from the same state: the same bits
        replay, _, m_replay = step(states[0], (), {"tokens": toks[1]},
                                   firsts[1])
        m_replay = {k: float(v) for k, v in m_replay.items()}
    finally:
        sel_mod.select_metadata = real_select
    last = tree_leaves(states[1])
    check(all(math.isfinite(v) for m in metrics for v in m.values()),
          f"9a: metrics not finite {metrics}")
    check(all(0 < m["selected"] <= TRAIN_G * TRAIN_META_CLUSTERS
              for m in metrics), f"9a: selected {metrics}")
    check(all(torch.equal(x[0], x[g]) for x in last
              for g in range(TRAIN_G)),
          "9a: the cohorts leave the round with different weights")
    check(all(bool(torch.isfinite(x[0]).all()) for x in last),
          "9a: weights not finite")
    moved = [not torch.equal(x[0].cpu(), b) for x, b in zip(last, before)]
    check(all(moved), f"9a: {moved.count(False)} of {len(moved)} leaves "
                      f"did not move in two rounds")
    check(all(torch.equal(x, y) for x, y in zip(tree_leaves(replay), last))
          and m_replay == metrics[1],
          "9a: round 1 replayed from the same state gave other bits")
    del replay, before, states
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
    check(bwd_routes == {"tensor_core": want["flash_attention_bwd"],
                         "cuda_core": 0},
          f"9a: backward launches by route {bwd_routes}")
    tokens_round = TRAIN_G * TRAIN_LOCAL * TRAIN_MB * TRAIN_T
    print(f"9a: two rounds at full width, walls {walls}, metrics "
          f"{metrics}, launches {launches}")
    # one more round under the profiler: device busy share, top kernels,
    # the backward kernels' device ms a launch
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = monotonic()
        _, _, m = step(state, (), {"tokens": toks[0]}, firsts[0])
        float(m["loss"])
        torch.cuda.synchronize()
        prof_wall = (monotonic() - t0) * 1e3
    del state, toks, last, m
    ops.reset_launch_counts()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:12]
    # the backward's three launches on each route (Dd is shared)
    bwd_route_names = {
        "tensor_core": ("attn_bwd_dot_kernel", "attn_bwd_dkdv_wgmma_kernel",
                        "attn_bwd_dq_wgmma_kernel"),
        "cuda_core": ("attn_bwd_dot_kernel", "attn_bwd_dkdv_kernel",
                      "attn_bwd_dq_kernel")}
    bwd_names = bwd_route_names["tensor_core"]
    in_round = {}
    for name in bwd_names + ("flash_fwd_wgmma_kernel",):
        hit = [e for e in evs if f"::{name}" in e.key]
        n = sum(e.count for e in hit)
        in_round[name] = {
            "launches": n, "device_ms_per_launch":
            sum(e.self_device_time_total for e in hit) / 1e3 / max(n, 1)}
    out["9a"] = {
        "model": full.name, "cohorts": TRAIN_G, "local_steps": TRAIN_LOCAL,
        "microbatch": TRAIN_MB, "n_micro": 1, "seq_len": TRAIN_T,
        "meta_clusters": TRAIN_META_CLUSTERS,
        "meta_steps": TRAIN_META_STEPS, "dtype": tcfg.dtype,
        "remat": tcfg.remat, "tokens_per_round": tokens_round,
        "round_wall_s": walls,
        "tokens_per_s": [tokens_round / w for w in walls],
        "metrics": metrics, "launches": launches,
        "flash_attention_bwd_launches_by_route": bwd_routes,
        "lloyd_sweeps": round_sweeps, "max_memory_allocated": peak,
        "cohorts_bit_equal": True, "replay_bit_identical": True,
        "profiled_round": {
            "wall_ms": prof_wall, "device_busy_ms": busy,
            "device_busy_share": busy / prof_wall,
            "top_device_ms": {e.key[:80]: e.self_device_time_total / 1e3
                              for e in top},
            "attention_kernels": in_round}}
    del prof, evs
    torch.cuda.empty_cache()

    # the backward kernels at one training layer's shape, beside their
    # plain version, SDPA's backward and their bound
    b_, s_, h_, kv_, d_ = TRAIN_MB, TRAIN_T, full.num_heads, \
        full.num_kv_heads, full.head_dim
    gd = torch.Generator(device=dev).manual_seed(5)

    def drandn(*shape):
        return torch.randn(shape, generator=gd, device=dev).to(
            torch.bfloat16)

    q, k, v, dout = (drandn(b_, s_, h_, d_), drandn(b_, s_, kv_, d_),
                     drandn(b_, s_, kv_, d_), drandn(b_, s_, h_, d_))
    o, lse = ops.flash_attention(q, k, v, return_stats=True)
    route = bwd_route_for(q, k, v, o, dout)
    check(route == "tensor_core", f"backward at the training shape: the "
                                  f"{route} route")

    def kern():
        return ops.flash_attention_bwd(q, k, v, o, dout, lse)

    def events_ms(fn, iters, warmup=1):
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

    got = kern()
    want_g = ref.flash_attention_bwd_ref(q, k, v, o, dout, lse,
                                         torch.ones_like(lse))
    shape_err = max(float((x.float() - y.float()).abs().max())
                    for x, y in zip(got, want_g))
    check(all(bool(((x.float() - y.float()).abs()
                    <= 2e-2 + 2e-2 * y.float().abs()).all())
              for x, y in zip(got, want_g)),
          f"backward at the training shape: max abs err {shape_err}")
    del got, want_g
    by_launch = kernel_device_ms(kern, bwd_names, iters=5, warmup=1)
    ms = events_ms(kern, 5)
    plain_ms = events_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, dout, lse, torch.ones_like(lse)), 2)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    so = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    sdo = dout.transpose(1, 2)
    library_ms = events_ms(lambda: torch.autograd.grad(
        so, (qt, kt, vt), sdo, retain_graph=True), 5)
    del qt, kt, vt, so, sdo
    # the least work: five products (S, dP, dV, dK, dQ) over the causal
    # pairs; q, k, v, out, dout and lse read once, dq, dk, dv written once
    pairs = s_ * (s_ + 1) // 2
    flops = 5 * 2 * b_ * h_ * d_ * pairs
    nbytes = 2 * (3 * q.numel() + 3 * k.numel() + v.numel()) \
        + 4 * lse.numel()
    b_ms, b_by = bound(nbytes, flops, H100_BF16_FLOPS)
    # the f32 backward at the same shape, which stays on the CUDA cores
    q, k, v, o, dout = (t.float() for t in (q, k, v, o, dout))
    o, lse = ops.flash_attention(q, k, v, return_stats=True)
    f32_by_launch = kernel_device_ms(
        lambda: ops.flash_attention_bwd(q, k, v, o, dout, lse),
        bwd_route_names["cuda_core"], iters=5, warmup=1)
    del q, k, v, dout, o, lse
    torch.cuda.empty_cache()

    def ptxas(pattern):
        found = [u for fn, u in build.ptxas_usage(build.ptxas_logs.get(
            "flash_attention_bwd", "")).items() if re.search(pattern, fn)]
        return found[0] if len(found) == 1 else None

    row = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/models/layers.py:139",
           "note": "the gradient of flash_attention_kernel "
                   "(src/repro/kernels/flash_attention.py:89); the "
                   "reference's backward is the jnp custom VJP "
                   "_sdpa_flash_bwd, with no Pallas kernel",
           "launches": launches["flash_attention_bwd"], "ms": ms,
           "device_ms": sum(by_launch.values()),
           "device_ms_by_launch": by_launch, "plain_ms": plain_ms,
           "plain": "ref.flash_attention_bwd_ref (key chunks of 1024)",
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
           "library": "SDPA's backward (autograd of "
                      "scaled_dot_product_attention, causal, GQA)",
           "max_abs_err_vs_plain_at_this_shape": shape_err,
           "kernel_route": f"{route}, three launches",
           "ptxas": {"dkdv": ptxas(r"attn_bwd_dkdv_wgmma_kernelILi64ELi3E"),
                     "dq": ptxas(
                         r"attn_bwd_dq_wgmma_kernelILi64ELi64ELi3E"),
                     "dkdv_d128": ptxas(
                         r"attn_bwd_dkdv_wgmma_kernelILi128ELi2E"),
                     "dq_d128": ptxas(
                         r"attn_bwd_dq_wgmma_kernelILi128ELi64ELi2E")},
           "f32_cuda_core_device_ms": sum(f32_by_launch.values()),
           "f32_cuda_core_device_ms_by_launch": f32_by_launch,
           "shape": [b_, s_, h_, kv_, d_]}

    # ---- 9b: a reduced-width f32 step on the card and on the CPU ----
    # (4 layers: two scan stages, so remat runs. As many clusters as probe
    # rows: a 2-row cluster's centre is equidistant from its rows, so
    # rounding would pick its representative (ROADMAP.md Queue 3's exact
    # ties) and the two devices could meta-train on different rows)
    small = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                                num_layers=4)
    step32, lm32 = make_train_step(small, TrainConfig(
        dtype="float32", microbatch=4, meta_clusters=4))
    p_cpu = lm32.init(torch.Generator().manual_seed(7))
    stoks = torch.from_numpy(np.random.default_rng(3).integers(
        0, small.vocab_size, (2, 2, 1, 4, 64), np.int32))
    runs = {}
    for where in ("cpu", "card"):
        p = p_cpu if where == "cpu" else tree_map(lambda t: t.to(dev), p_cpu)
        cp = tree_map(lambda x: x[None].expand((2,) + tuple(x.shape)), p)
        ops.reset_launch_counts()
        new, _, m = step32(cp, (), {"tokens": stoks.to(p["embed"].device)},
                           [1, 2])
        runs[where] = (tree_leaves(new), {k: float(v) for k, v in m.items()},
                       ops.launch_counts())
    (lc, mc, cc), (lg, mg, cg) = runs["cpu"], runs["card"]
    e_w = max(rel_err(x.cpu(), y) for x, y in zip(lg, lc))
    e_m = max(abs(mg[key] - mc[key]) / (1 + abs(mc[key])) for key in mc)
    check(e_w <= TOL and e_m <= TOL and mg["selected"] == mc["selected"],
          f"9b: card vs CPU: weights rel err {e_w}, metrics {mg} vs {mc}")
    check(cg["flash_attention"] > 0 and cg["flash_attention_bwd"] > 0
          and sum(cc.values()) == 0,
          f"9b: launches card {cg}, CPU {cc}")
    out["9b"] = {"weights_max_rel_err": e_w, "metrics_max_rel_err": e_m,
                 "metrics_card": mg, "metrics_cpu": mc, "launches_card": cg}
    print(f"9b: reduced f32 train step card vs CPU: weights rel err {e_w}, "
          f"metrics rel err {e_m}")

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


if __name__ == "__main__":
    main()
