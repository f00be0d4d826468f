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
     at one shape;
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
     plan), one many-split case run twice and compared bit for bit;
  3. one round of a small WRN-10-1 on the card and on the CPU from the same
     seed: the ledger and the metadata count must be equal and the new
     weights agree to 2e-3;
 3b. a reduced llama3.2-1b in f32 on the card and on the CPU from the same
     parameters: one prefill of S=64 and 8 teacher-forced decode steps,
     logits within 2e-3;
 3c. two fresh ``FLSimulation`` runs of two rounds of the small WRN-10-1
     from one seed: weights, ledger, decoded selections, accuracies and
     Lloyd sweeps bit-identical;
  4. drive the main path: ``FLSimulation`` for 2 rounds at the full width
     of WRN-40-1 (32x32x3 inputs, split after group 1 -> 16x32x32 maps,
     D = 16384), 4 clients x 2,500 samples of 2 classes, P = 200, 10
     clusters per class, 25 Lloyd iterations, the int8 codec. Launch
     counters are zeroed just before and read just after; every kernel
     must have launched, quantize once per upload (8);
  6. serve llama3.2-1b at full width (16 layers, d_model 2048, 32 heads /
     8 KV, d_ff 8192, vocab 128,256; random weights from seed 0) in bf16:
     ``repro_torch.launch.serve`` decodes batch 32 against a 32,768-slot
     cache (prompt 32 teacher-forced, 16 new tokens), then one
     ``make_prefill_step`` call at S=32,768, batch 1. Launch counters are
     zeroed before and read after each: flash_decode must launch
     16 x (32 - 1 + 16) = 752 times, flash_attention 16; logits finite;
     then one prefill call and one decode step at those shapes under
     torch.profiler (device busy share, top kernels by device time);
  5. time each kernel beside its plain version, a library call where one
     computes the same function, and its bound (the attention kernels at
     phase 6's shapes, with their route, the decode split count and the
     registers and spills per thread that ptxas reported). ``ms`` is the
     wrapper call's time (CUDA events around back-to-back calls, so the
     host's work between launches counts); for the selection and
     transport kernels ``device_ms`` is the kernels' own device time per
     call (torch.profiler, by kernel name, each launch also alone in
     ``device_ms_by_launch``; quantize at the main path's 20 of 100 valid
     rows and, in ``by_mask``, also at 80, each with its own bound). Then
     time the phases of one client's round.
It prints the kernels line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. It imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import re
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
                                         local_batches, run_round)
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
            "quantize_affine": 0.0, "flash_attention": 0.0,
            "flash_decode": 0.0}

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
    from repro_torch.kernels.flash_attention import prefill_route
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
    check(launches["quantize_affine"] == 4 * 2,
          f"quantize launched {launches['quantize_affine']} times, not 8")
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
    counting = dict(launches)
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
        "quantize_affine": ("quantize", ("quantize_affine_kernel",))}
    # the quantize kernel's two instantiations, one a route
    ptxas_patterns = {"quantize_affine": {
        "resident": r"quantize_affine_kernelILb1E",
        "l2": r"quantize_affine_kernelILb0E"}}
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
        else:                            # the K-means row plan it ran
            row["plan"] = getattr(ops, k_name).last_plan._asdict()
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
    bx, by = local_batches(xs, ys, draws.local_perms, cfg)
    phases["local_update_ms"], _ = timed(
        lambda: fa.local_update(params, cfg.local_lr, bx, by, model.loss),
        iters=1)
    phases["client_round_ms"], _ = timed(lambda: client_round(
        model, params, cl, cfg, draws, channel, 10), iters=1)
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
        client_round(model, params, cl, cfg, draws, channel, 10)
        torch.cuda.synchronize()
        wall_ms = (monotonic() - t) * 1e3
    ops.reset_launch_counts()
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:10]
    print(json.dumps({"phases_ms": phases, "lloyd_sweeps": sel.lloyd_iters,
                      "client_rows": int(xs.shape[0]),
                      "profiled_client_round": {
                          "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                          "device_busy_share": busy_ms / wall_ms,
                          "top_device_ms": {e.key[:80]:
                                            e.self_device_time_total / 1e3
                                            for e in top}}}))

    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    check(all(math.isfinite(r["ms"]) for r in rows), "a kernel time is NaN")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
