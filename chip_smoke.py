#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, in parallel) into ``build/repro_torch/``;
  2. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes (Lloyd also with rows of only 2 of the 10
     classes, as a client holds them, so 80 of 100 slots are masked) and
     at ragged ones (quantize byte-exact; Lloyd
     assign equal except at near-ties, sums/mindist/distances within
     2e-3), and check that a Lloyd sweep gives the same bits twice;
  3. one round of a small WRN-10-1 on the card and on the CPU from the same
     seed: the ledger and the metadata count must be equal and the new
     weights agree to 2e-3;
  4. drive the main path: ``FLSimulation`` for 2 rounds at the full width
     of WRN-40-1 (32x32x3 inputs, split after group 1 -> 16x32x32 maps,
     D = 16384), 4 clients x 2,500 samples of 2 classes, P = 200, 10
     clusters per class, 25 Lloyd iterations, the int8 codec. Launch
     counters are zeroed just before and read just after; every kernel
     must have launched;
  5. time each kernel (CUDA events) beside its plain version, a library
     call where one computes the same function, and its bound; time the
     phases of one client's round.
It prints the kernels line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. It imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12           # f32 outside the tensor cores (SXM)
TOL = 2e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def bound(nbytes: float, flops: float):
    t_mem, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops
            else "operations")


def main() -> None:
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
    from repro_torch.kernels import build, ops, ref
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
            "quantize_affine": 0.0}

    def rel_err(got, want):
        return float(((got - want).abs() / (1.0 + want.abs())).max())

    for n, d, k in [(2500, 200, 10), (2500, 200, 100), (1037, 61, 7),
                    (130, 1, 65), (64, 200, 64)]:
        x, c = randn(n, d), randn(k, d)
        got = ops.kmeans_pairwise_dist(x, c)
        want = ref.kmeans_pairwise_dist_ref(x, c)
        e = rel_err(got, want)
        check(e <= TOL, f"pairwise dist {n}x{d}x{k}: rel err {e}")
        errs["kmeans_pairwise_dist"] = max(errs["kmeans_pairwise_dist"],
                                           float((got - want).abs().max()))

    for n, d, classes, kk, mrows, eslots, present in [
            (2500, 200, 10, 10, 0, 0, None), (2500, 200, 10, 10, 0, 0, (3, 7)),
            (777, 45, 7, 10, 20, 5, None), (100, 3, 2, 33, 10, 3, None)]:
        x = randn(n, d)
        c = randn(classes * kk, d)
        lm = label_mask(n, classes, kk, mrows, eslots, present)
        a, md, s, cnt = ops.kmeans_lloyd_step(x, c, lm)
        a2, md2, s2, cnt2 = ops.kmeans_lloyd_step(x, c, lm)
        check(all(torch.equal(u, v) for u, v in
                  [(a, a2), (md, md2), (s, s2), (cnt, cnt2)]),
              f"Lloyd {n}x{d}: two sweeps on the same input differ")
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

    for n, d, case in [(100, 16384, "slots"), (37, 1001, "ragged"),
                       (64, 300, "all-masked"), (50, 77, "constant")]:
        x = randn(n, d)
        m = torch.rand(n, generator=g) < 0.8
        if case == "all-masked":
            m[:] = False
        if case == "constant":
            x = torch.full((n, d), 0.37, device=dev)
        m = m.to(dev)
        q, xmin, scale = ops.quantize_affine(x, m)
        rq, rxmin, rscale = ref.quantize_affine_ref(x, m)
        cq, cxmin, cscale = ref.quantize_affine_ref(x.cpu(), m.cpu())
        check(torch.equal(q, rq) and torch.equal(q.cpu(), cq),
              f"quantize {case} {n}x{d}: int8 codes not byte-exact")
        check(float(xmin) == float(rxmin) == float(cxmin)
              and float(scale) == float(rscale) == float(cscale),
              f"quantize {case}: (xmin, scale) not exact")
    print("kernel checks: passed")

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
    for k_name, cnt in launches.items():
        check(cnt > 0, f"{k_name} was never launched on the main path")
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

    # ---- 5. timings ----------------------------------------------------
    def cuda_ms(fn, iters=50, warmup=3):
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
    qx = randn(100, 16384)
    qm = (torch.rand(100, generator=g) < 0.8).to(dev)
    counting = dict(launches)
    w_rows = int((torch.amin(lm, 1) <= 0).sum())
    vq = int(qm.sum())
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
         lambda: ref.quantize_affine_ref(qx, qm), None,
         bound(4 * vq * 16384 + 100 + 100 * 16384 + 8, 7 * vq * 16384)),
    ]
    for k_name, src, tpu, kern, plain, lib, (b_ms, b_by) in spec:
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
        lib_ms = cuda_ms(lib) if lib is not None else None
        row = {"name": k_name, "route": "cuda", "source": src,
               "replaces": tpu, "launches": counting[k_name],
               "max_abs_err": errs[k_name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        if k_name == "quantize_affine":
            row["byte_exact"] = True
        rows.append(row)
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
