"""Async FL service launcher of the port (the twin of
``repro.launch.serve_fl``): run the event-driven server loop over a seeded
traffic model, optionally under chaos, printing the run's throughput
(ticks/s, bytes/s) and the final composed-model accuracy.

  PYTHONPATH=src python -m repro_torch.launch.serve_fl --ticks 6 \\
      --traffic poisson --rate 2 --buffer-size 2 --delay-ticks 2
  PYTHONPATH=src python -m repro_torch.launch.serve_fl --sync-check
  PYTHONPATH=src python -m repro_torch.launch.serve_fl --device cpu \\
      --trace trace.jsonl    # then: python -m repro_torch.obs summarize ...

The reference's reduced setting: WRN-10-1 at 16x16, 4 clients x 40
synthetic samples of 2 classes, P = 8, 3 clusters per class. It runs on
``cuda`` unless ``--device cpu`` is given, and fails without a CUDA device
otherwise. ``--sync-check`` runs the degenerate configuration
(``DegenerateTraffic``, buffer == cohort) AND the port's ``FLSimulation``
from the same seed, and exits 1 unless their weights and ledgers are
identical (the bit-identity contract). ``--trace`` turns observability on
and writes the span trace as JSONL; tracing synchronizes the card at every
span, so a traced run's throughput is not an untraced one's.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.obs.timing import monotonic


def build_parser() -> argparse.ArgumentParser:
    """The launcher's command line: the reference's flags plus
    ``--device`` and ``--codec``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--traffic", default="degenerate",
                    choices=["degenerate", "poisson", "diurnal"])
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--delay-ticks", type=int, default=0)
    ap.add_argument("--period", type=int, default=24)
    ap.add_argument("--buffer-size", type=int, default=0,
                    help="0 = cohort size (the sync-degenerate buffer)")
    ap.add_argument("--alpha", type=float, default=0.5,
                    help="FedBuff staleness exponent")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--traffic-seed", type=int, default=0)
    ap.add_argument("--drop", type=float, default=0.0,
                    help="client crash rate (chaos wire when > 0)")
    ap.add_argument("--corrupt", type=float, default=0.0,
                    help="frame bit-flip rate (chaos wire when > 0)")
    ap.add_argument("--trace", default="",
                    help="write the span trace JSONL here")
    ap.add_argument("--sync-check", action="store_true",
                    help="degenerate run + FLSimulation; assert bit-identity")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--codec", default="raw_f32",
                    choices=("raw_f32", "f16", "int8"),
                    help="wire codec of the knowledge upload")
    return ap


def main(argv=None) -> int:
    """Run the service (and, with ``--sync-check``, the simulator);
    returns the exit code."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.sync_check and (args.traffic != "degenerate"
                            or args.buffer_size):
        ap.error("--sync-check requires degenerate traffic and the "
                 "default (cohort-sized) buffer")
    from repro_torch.configs import FLConfig, get_wrn_config
    from repro_torch.core.split import make_split_wrn
    from repro_torch.data import SyntheticImageDataset, partition_k_shards
    from repro_torch.fl.faults import FaultPlan
    from repro_torch.fl.service import (DegenerateTraffic, DiurnalTraffic,
                                        FLService, PoissonTraffic)

    wrn = get_wrn_config().reduced()
    model = make_split_wrn(wrn)
    train = SyntheticImageDataset(100 * args.clients,
                                  image_size=wrn.image_size, seed=0)
    test = SyntheticImageDataset(100, image_size=wrn.image_size, seed=1)
    clients = partition_k_shards(train, args.clients, k_classes=2,
                                 samples_per_client=40)
    cfg = FLConfig(num_clients=args.clients, clients_per_round=args.clients,
                   local_batch_size=20, pca_components=8,
                   clusters_per_class=3, kmeans_iters=4, meta_epochs=1,
                   meta_batch_size=10,
                   transport_checksum=bool(args.drop or args.corrupt),
                   transport_codec=args.codec,
                   observability=bool(args.trace))
    plan = None
    if args.drop or args.corrupt:
        plan = FaultPlan(drop_rate=args.drop, bitflip_rate=args.corrupt)

    if args.traffic == "poisson":
        traffic = PoissonTraffic(rate=args.rate, seed=args.traffic_seed,
                                 delay_ticks=args.delay_ticks)
    elif args.traffic == "diurnal":
        traffic = DiurnalTraffic(rate=args.rate, seed=args.traffic_seed,
                                 delay_ticks=args.delay_ticks,
                                 period=args.period)
    else:
        traffic = DegenerateTraffic()

    svc = FLService(model, clients, test, cfg, seed=args.seed,
                    device=args.device, traffic=traffic,
                    buffer_size=args.buffer_size or None,
                    staleness_alpha=args.alpha, fault_plan=plan)
    t0 = monotonic()
    res = svc.run(ticks=args.ticks, drain=(args.traffic != "degenerate"))
    dt = monotonic() - t0
    total_bytes = res.comm.get("total_up", 0) + res.comm.get("total_down", 0)
    acc = res.test_acc[-1] if res.test_acc else float("nan")
    print(f"serve_fl: {svc.device}, {args.ticks} ticks, "
          f"{sum(res.arrivals_per_tick)} arrivals, {res.flushes} flushes in "
          f"{dt:.2f}s ({args.ticks / max(dt, 1e-9):.2f} ticks/s, "
          f"{total_bytes / max(dt, 1e-9):.0f} B/s)")
    print(f"serve_fl: M_COM acc={acc:.4f}  "
          f"mean staleness={res.mean_staleness:.2f}  "
          f"drops={sum(res.drops)}")
    if args.trace and svc.tracer.enabled:
        svc.tracer.write_jsonl(args.trace)
        print(f"serve_fl: trace -> {args.trace}")

    if args.sync_check:
        from repro_torch.fl.simulation import FLSimulation
        sim = FLSimulation(model, clients, test, cfg, seed=args.seed,
                           device=args.device, fault_plan=plan)
        sres = sim.run(rounds=args.ticks, eval_every=args.ticks)
        sp, vp = sim.server.global_params, svc.server.global_params
        same_w = sp.keys() == vp.keys() and all(
            torch.equal(sp[k], vp[k]) for k in sp)
        sim_comm = {k: v for k, v in sres.comm.items()
                    if k != "total_samples"}
        same_l = dict(res.comm) == sim_comm
        print(f"serve_fl: sync-check weights={'OK' if same_w else 'FAIL'} "
              f"ledger={'OK' if same_l else 'FAIL'}")
        if not (same_w and same_l):
            return 1
    print("serve_fl: done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
