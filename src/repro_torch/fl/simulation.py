"""End-to-end FL simulation (the paper's §4 experiment harness) on the port.

Drives the FLServer and its clients for T rounds over a non-IID partition,
evaluating the composed model M_COM(t) and the FedAvg model W_G(t) on the
test set, and charging every frame's exact bytes to the server's ledger.
The counterpart of ``repro.fl.simulation``. ``cfg.distributed_selection``
runs the cohort's client side through the cohort engine
(``core/distributed.py``) instead of the client-by-client loop: the same
bits. A run owns the captured SGD steps of its LocalUpdates on the card
and frees them when it returns.

Fault tolerance: pass ``fault_plan`` (a ``repro_torch.fl.faults.FaultPlan``
with any fault) and every frame crosses a ``FaultyChannel`` instead of the
perfect wire — clients crash, frames corrupt/truncate/duplicate, detected
corruption is retransmitted (bounded, charged under the ledger's
``retransmit`` category), and the server aggregates over exactly the
clients whose update frames decoded (the arrival mask). ``deadline`` drops
clients whose estimated local time (``FLClient.local_time``) exceeds it
from Eq. 2. Clients failing ``quarantine_after`` consecutive rounds sit
out ``quarantine_cooldown`` rounds. With no plan (or an all-zero one) the
rounds, draws and ledger are bit-identical to the fault-free simulator.

Observability: with ``cfg.observability`` (or a ``tracer`` passed in) the
run reports through a ``repro_torch.obs.Tracer`` — ``round`` spans with
``broadcast`` / ``cohort`` / ``aggregate`` / ``eval`` children, the
``fl.quarantined`` and ``fl.stragglers`` gauges, and every ledger charge
attributed to the span that made it (the ledger is the metered twin).
Off, the hooks are no-ops and the run is bit-identical to the
uninstrumented one.

It runs on ``cuda`` unless constructed with ``device="cpu"``, and raises
when there is no CUDA device and the CPU was not asked for.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.core.compose import evaluate
from repro_torch.core.fedavg import CapturedSteps
from repro_torch.core.rounds import GeneratorDraws, run_cohort
from repro_torch.core.split import SplitModel
from repro_torch.data.datasets import Dataset
from repro_torch.data.partition import ClientData
from repro_torch.device import resolve_device
from repro_torch.fl.client import FLClient
from repro_torch.fl.server import FLServer
from repro_torch.fl.transport.channel import Channel
from repro_torch.obs.timing import monotonic, sync


def make_wire(server: FLServer, cfg: FLConfig, fault_plan, fault_seed: int,
              tracer, meta: dict):
    """A run's tracer and the wire its frames cross -> (tracer, channel).
    With ``cfg.observability`` (and no ``tracer`` given) the run owns a
    ``Tracer``, and the server's ledger is swapped for the metered twin
    BEFORE the channel is built, so every wire charge attributes to the
    span that made it. The wire is perfect, or fault-injecting under a
    plan with any fault (its own seed: fault schedules and FL draws are
    independent)."""
    if tracer is None:
        tracer = (obs.Tracer(meta=meta) if cfg.observability
                  else obs.NULL_TRACER)
    if tracer.enabled:
        server.ledger = obs.MeteredLedger(tracer)
    if fault_plan is not None and fault_plan.any_faults:
        from repro_torch.fl.faults import FaultyChannel
        return tracer, FaultyChannel(server.ledger, fault_plan,
                                     seed=fault_seed,
                                     checksum=cfg.transport_checksum)
    return tracer, Channel(server.ledger, checksum=cfg.transport_checksum)


@dataclass
class SimulationResult:
    test_acc: List[float] = field(default_factory=list)      # M_COM(t)
    fedavg_acc: List[float] = field(default_factory=list)    # plain W_G(t)
    metadata_counts: List[int] = field(default_factory=list)
    cohort_samples: List[int] = field(default_factory=list)  # sum_k |D_k|
    client_loss: List[float] = field(default_factory=list)
    lloyd_iters: List[List[int]] = field(default_factory=list)
    straggler_counts: List[int] = field(default_factory=list)  # per round
    round_wall_s: List[float] = field(default_factory=list)  # host clock,
    #   device-synchronized at the round's end (evaluation included)
    comm: dict = field(default_factory=dict)
    wall_time: float = 0.0
    # --- fault-tolerance counters (all zero on the perfect wire) ---
    drops: List[int] = field(default_factory=list)           # updates lost
    corruptions_detected: List[int] = field(default_factory=list)
    retransmits: List[int] = field(default_factory=list)
    quarantined: List[int] = field(default_factory=list)     # held out
    # per round {phase name -> seconds} from the round span's direct
    # children (broadcast / cohort / aggregate / eval); None when
    # observability is off
    phase_wall_s: Optional[List[Dict[str, float]]] = None

    @property
    def selected_fraction(self) -> float:
        """|D_M|/|D_k| of the LAST round over the cohort's samples."""
        if not self.metadata_counts:
            return 0.0
        return self.metadata_counts[-1] / max(self.cohort_samples[-1], 1)


class FLSimulation:
    def __init__(self, model: SplitModel, clients: List[ClientData],
                 test: Dataset, cfg: FLConfig, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 client_speeds: Optional[np.ndarray] = None,
                 deadline: Optional[float] = None,
                 flops_per_sample: float = 1e9,
                 fault_plan=None, fault_seed: int = 0,
                 quarantine_after: int = 0, quarantine_cooldown: int = 5,
                 tracer=None):
        self.device = resolve_device(device)
        self.model, self.cfg = model, cfg
        self.draws = GeneratorDraws(torch.Generator().manual_seed(seed))
        params = model.init(self.draws.generator, self.device)
        _, upper0 = model.split(params)
        self.server = FLServer(model, params, upper0, cfg, deadline=deadline,
                               quarantine_after=quarantine_after,
                               quarantine_cooldown=quarantine_cooldown)
        self.tracer, self.channel = make_wire(
            self.server, cfg, fault_plan, fault_seed, tracer,
            {"seed": seed, "num_clients": len(clients)})
        self.flops_per_sample = flops_per_sample
        speeds = (client_speeds if client_speeds is not None
                  else np.ones(len(clients)))
        self.clients = [FLClient(c, s) for c, s in zip(clients, speeds)]
        self.num_classes = test.num_classes
        self.test_x = torch.as_tensor(test.x, device=self.device)
        self.test_y = torch.as_tensor(test.y, device=self.device)

    def run(self, rounds: int, eval_every: int = 1,
            verbose: bool = False) -> SimulationResult:
        res = SimulationResult()
        tracer = self.tracer
        if tracer.enabled:
            res.phase_wall_s = []
        steps = CapturedSteps()
        t0 = monotonic()
        try:
            with obs.use_tracer(tracer):
                for t in range(rounds):
                    r0 = monotonic()
                    with obs.span("round", round=t) as rsp:
                        self._run_round(t, rounds, eval_every, verbose, res,
                                        steps, rsp)
                    sync(self.server.global_params)
                    res.round_wall_s.append(monotonic() - r0)
                    if tracer.enabled:
                        res.phase_wall_s.append(tracer.child_durations(rsp))
        finally:
            steps.release()
        res.comm = self.server.ledger.summary()
        res.comm["total_samples"] = sum(len(c.client.data)
                                        for c in self.clients)
        res.wall_time = monotonic() - t0
        return res

    def _run_round(self, t: int, rounds: int, eval_every: int,
                   verbose: bool, res: SimulationResult,
                   steps: CapturedSteps, rsp) -> None:
        n_quar = self.server.num_quarantined(len(self.clients))
        res.quarantined.append(n_quar)
        obs.gauge("fl.quarantined", n_quar)
        self.channel.begin_round(t)
        idx = self.server.sample_clients(len(self.clients), self.draws)
        ids = [int(i) for i in idx]
        cohort = [self.clients[i] for i in ids]
        # the formed cohort downloads W_G(t-1) now (round 0 included)
        with obs.span("broadcast", clients=len(cohort)):
            self.server.broadcast_weights(len(cohort), self.channel)
        with obs.span("cohort", clients=len(cohort)) as csp:
            cparams, metas, losses, sweeps = run_cohort(
                self.model, self.server.global_params,
                [c.client for c in cohort], self.cfg, self.draws,
                self.channel, self.num_classes, client_ids=ids, steps=steps)
            csp.sync(cparams)
        # arrival mask: which UpperUpdate frames decoded (the perfect wire
        # says all); where a corrupted frame was silently accepted
        # (checksums off) the server consumes ITS decode
        arrived = np.asarray([self.channel.update_arrived(i) for i in ids])
        for j, i in enumerate(ids):
            dec = self.channel.decoded_update(i)
            if dec is not None:
                cparams[j] = dec
        # deadline policy: who the server stops waiting for
        mask = self.server.straggler_mask(
            [c.local_time(self.cfg, self.flops_per_sample) for c in cohort])
        n_late = 0 if mask is None else int(mask.sum())
        res.straggler_counts.append(n_late)
        obs.gauge("fl.stragglers", n_late)
        rr = self.server.aggregate(cparams, metas, self.draws,
                                   stragglers=mask, arrived=arrived)
        self.server.record_arrivals(ids, arrived)
        stats = self.channel.round_stats()
        res.drops.append(int((~arrived).sum()))
        res.corruptions_detected.append(stats["corruptions_detected"])
        res.retransmits.append(stats["retransmits"])
        res.client_loss.append(sum(losses) / max(len(losses), 1))
        res.metadata_counts.append(rr.metadata_count)
        res.cohort_samples.append(sum(len(c.client.data) for c in cohort))
        res.lloyd_iters.append([s for s in sweeps if s is not None])
        if rsp.enabled:
            rsp.set(clients=len(cohort), drops=res.drops[-1],
                    stragglers=n_late, quarantined=n_quar,
                    metadata_count=rr.metadata_count)
        if (t + 1) % eval_every == 0 or t == rounds - 1:
            with obs.span("eval"):
                acc = evaluate(self.model, rr.composed_params, self.test_x,
                               self.test_y)
                fa_acc = evaluate(self.model, rr.global_params, self.test_x,
                                  self.test_y)
            res.test_acc.append(acc)
            res.fedavg_acc.append(fa_acc)
            if verbose:
                print(f"round {t+1:4d}  M_COM acc={acc:.4f}  "
                      f"FedAvg acc={fa_acc:.4f}  |D_M|={rr.metadata_count}")
