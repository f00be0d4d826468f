"""The event-driven FL service of the port: arrivals in, staleness-weighted
flushes out (the counterpart of ``repro.fl.service.loop``).

Where ``FLSimulation`` is a lock-step for-loop over rounds (form cohort,
wait for everyone, aggregate), :class:`FLService` runs the server as a
CONTINUOUS loop over ticks:

  tick t:  draw arrivals from the traffic model
           each arrival downloads W_G (one WeightBroadcast frame), runs the
             existing client pipeline (``run_cohort`` with one client:
             Extract&Selection + LocalUpdate on the same kernels and
             captured SGD step as the simulator) and uploads knowledge +
             update over the SAME transport channel the simulator uses
             (perfect or fault-injecting)
           uploads land in the buffered aggregator — immediately, or
             ``delay`` ticks later (training latency); once ``buffer_size``
             updates are buffered the flush runs MetaTraining + Eq. 2 with
             the FedBuff staleness discount and bumps the model version

Determinism and the sync oracle: the service takes its draws from one
``core.rounds.Draws`` in the order the simulator does — a tick's cohort
(degenerate traffic only), each arrival's client draws in upload order,
then each flush's meta-training permutations — and tells the draws where
it stands (``Draws.locate``: the tick, its arrival count, the flush's
index in the tick), which draws that follow the reference's per-tick key
chain need. Arrivals are pure functions of ``(traffic seed, tick)``, and
faults stay keyed per ``(fault seed, tick, client)``. Under
``DegenerateTraffic`` with ``buffer_size == clients_per_round`` every
draw, frame and flush aligns with ``FLSimulation`` round for round, and
the captured SGD step is the same graph (one per shape), so the final
weights, CommLedger and accuracies are bit-identical (held by
tests/test_torch_service.py and ``chip_smoke.py`` phase 7a).

It runs on ``cuda`` unless constructed with ``device="cpu"``, and raises
when there is no CUDA device and the CPU was not asked for.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.core.compose import evaluate
from repro_torch.core.fedavg import CapturedSteps
from repro_torch.core.rounds import GeneratorDraws, RoundResult, run_cohort
from repro_torch.core.split import SplitModel
from repro_torch.data.datasets import Dataset
from repro_torch.data.partition import ClientData
from repro_torch.device import resolve_device
from repro_torch.fl.server import FLServer
from repro_torch.fl.service.aggregator import BufferedAggregator, BufferEntry
from repro_torch.fl.service.traffic import DegenerateTraffic, TrafficModel
from repro_torch.fl.simulation import make_wire
from repro_torch.obs.timing import monotonic, sync


@dataclass
class ServiceResult:
    """What a service run reports (the async twin of SimulationResult)."""
    test_acc: List[float] = field(default_factory=list)      # M_COM per eval
    fedavg_acc: List[float] = field(default_factory=list)    # W_G per eval
    client_loss: List[float] = field(default_factory=list)   # per arrival
    metadata_counts: List[int] = field(default_factory=list)  # per flush
    arrivals_per_tick: List[int] = field(default_factory=list)
    flush_sizes: List[int] = field(default_factory=list)
    flush_staleness: List[List[int]] = field(default_factory=list)
    # per-tick fault/quarantine counters (same meaning as SimulationResult)
    drops: List[int] = field(default_factory=list)
    corruptions_detected: List[int] = field(default_factory=list)
    retransmits: List[int] = field(default_factory=list)
    quarantined: List[int] = field(default_factory=list)
    # host clock per tick, synchronized with the card at the tick's end
    # (the service's twin of SimulationResult.round_wall_s)
    tick_wall_s: List[float] = field(default_factory=list)
    comm: dict = field(default_factory=dict)
    ticks: int = 0
    flushes: int = 0
    wall_time: float = 0.0

    @property
    def mean_staleness(self) -> float:
        """Average version lag over every flushed update (0.0 in the
        degenerate/synchronous regime)."""
        flat = [s for fl in self.flush_staleness for s in fl]
        return float(np.mean(flat)) if flat else 0.0


class FLService:
    """A continuously running FL server over the wire format.

    Construction mirrors ``FLSimulation`` draw for draw (model init from
    the seed's generator, server, tracer, perfect-or-faulty channel) so
    the degenerate configuration is bit-identical by construction. The
    differences are all past the cohort: arrivals come from ``traffic``,
    uploads queue in a ``BufferedAggregator`` (``buffer_size`` defaults to
    ``cfg.clients_per_round``), and Eq. 2 weights decay with staleness
    (``staleness_alpha``) instead of a deadline.
    """

    def __init__(self, model: SplitModel, clients: List[ClientData],
                 test: Dataset, cfg: FLConfig, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 traffic: Optional[TrafficModel] = None,
                 buffer_size: Optional[int] = None,
                 staleness_alpha: float = 0.5,
                 fault_plan=None, fault_seed: int = 0,
                 quarantine_after: int = 0, quarantine_cooldown: int = 5,
                 tracer=None):
        self.device = resolve_device(device)
        self.model, self.cfg = model, cfg
        self.draws = GeneratorDraws(torch.Generator().manual_seed(seed))
        params = model.init(self.draws.generator, self.device)
        _, upper0 = model.split(params)
        self.server = FLServer(model, params, upper0, cfg,
                               quarantine_after=quarantine_after,
                               quarantine_cooldown=quarantine_cooldown)
        self.tracer, self.channel = make_wire(
            self.server, cfg, fault_plan, fault_seed, tracer,
            {"seed": seed, "service": True, "num_clients": len(clients)})
        self.traffic = traffic if traffic is not None else DegenerateTraffic()
        self.aggregator = BufferedAggregator(
            self.server,
            buffer_size=(buffer_size if buffer_size is not None
                         else cfg.clients_per_round),
            staleness_alpha=staleness_alpha)
        self.clients = list(clients)
        self.num_classes = test.num_classes
        self.test_x = torch.as_tensor(test.x, device=self.device)
        self.test_y = torch.as_tensor(test.y, device=self.device)
        # delayed uploads: (due_tick, enqueue_seq, BufferEntry) min-heap —
        # delivery order is (due time, upload order), never hash order
        self._pending: list = []
        self._seq = 0

    # ---- per-tick machinery ----
    def _client_pipeline(self, cid: int, tick: int,
                         steps: CapturedSteps) -> BufferEntry:
        """One arrival end to end: broadcast -> select/update -> upload.
        The entry captures the download version and the channel's verdict
        (arrival bit, server-side decode) at upload time — per-tick channel
        state must not be re-read at flush time."""
        version = self.server.round_idx
        with obs.span("broadcast", clients=1):
            self.server.broadcast_weights(1, self.channel)
        with obs.span("cohort", clients=1) as csp:
            cparams, metas, losses, _ = run_cohort(
                self.model, self.server.global_params, [self.clients[cid]],
                self.cfg, self.draws, self.channel, self.num_classes,
                client_ids=[cid], steps=steps)
            csp.sync(cparams)
        arrived = bool(self.channel.update_arrived(cid))
        dec = self.channel.decoded_update(cid)
        params = cparams[0] if dec is None else dec
        self._loss = float(np.mean(losses))
        return BufferEntry(client_id=cid, params=params, metadata=metas[0],
                           version=version, arrived=arrived, tick=tick)

    def _flush(self, tick: int, res: ServiceResult) -> RoundResult:
        """Flush the buffer as the tick's next flush, after telling the
        draws its index (they give its meta-training permutations)."""
        self.draws.locate(tick, self._arrivals, self._flushes_this_tick)
        self._flushes_this_tick += 1
        rr, staleness = self.aggregator.flush(self.draws, tick)
        self._last_rr = rr
        res.flushes += 1
        res.flush_sizes.append(len(staleness))
        res.flush_staleness.append(staleness)
        res.metadata_counts.append(rr.metadata_count)
        return rr

    def _maybe_flush(self, tick: int, res: ServiceResult,
                     eval_every: int) -> None:
        while self.aggregator.ready():
            rr = self._flush(tick, res)
            self._evaled_last = res.flushes % eval_every == 0
            if self._evaled_last:
                self._eval(rr, res)

    def _eval(self, rr: RoundResult, res: ServiceResult) -> None:
        with obs.span("eval"):
            res.test_acc.append(evaluate(self.model, rr.composed_params,
                                         self.test_x, self.test_y))
            res.fedavg_acc.append(evaluate(self.model, rr.global_params,
                                           self.test_x, self.test_y))

    # ---- the loop ----
    def run(self, ticks: int, eval_every: int = 1,
            drain: bool = False) -> ServiceResult:
        """Run the service for ``ticks`` ticks. ``eval_every`` evaluates
        M_COM/W_G every that many FLUSHES (the final flush is always
        evaluated); ``drain`` force-flushes a partial buffer after the last
        tick so short runs still aggregate. The run owns the captured SGD
        steps of its LocalUpdates on the card and frees them when it
        returns."""
        res = ServiceResult()
        self._last_rr = None
        self._evaled_last = True
        self._arrivals = 0
        self._flushes_this_tick = 0
        steps = CapturedSteps()
        t0 = monotonic()
        try:
            with obs.use_tracer(self.tracer):
                for t in range(ticks):
                    k0 = monotonic()
                    with obs.span("service.tick", tick=t) as tsp:
                        self._run_tick(t, res, eval_every, tsp, steps)
                    sync(self.server.global_params)
                    res.tick_wall_s.append(monotonic() - k0)
                if drain and self.aggregator.pending():
                    self._flush(ticks - 1, res)
                    self._evaled_last = False
                if self._last_rr is not None and not self._evaled_last:
                    self._eval(self._last_rr, res)
        finally:
            steps.release()
        res.ticks = ticks
        res.comm = self.server.ledger.summary()
        res.wall_time = monotonic() - t0
        return res

    def _run_tick(self, t: int, res: ServiceResult, eval_every: int,
                  tsp, steps: CapturedSteps) -> None:
        self.draws.locate(t)
        n_quar = self.server.num_quarantined(len(self.clients))
        res.quarantined.append(n_quar)
        obs.gauge("fl.quarantined", n_quar)
        self.channel.begin_round(t)
        arrivals = self.traffic.arrivals(t, self.server, len(self.clients),
                                         self.draws)
        self._arrivals = len(arrivals)
        self._flushes_this_tick = 0
        self.draws.locate(t, self._arrivals)
        # deliveries due this tick (uploads from earlier, slower arrivals)
        while self._pending and self._pending[0][0] <= t:
            _, _, entry = heapq.heappop(self._pending)
            self.aggregator.submit(entry)
            self._maybe_flush(t, res, eval_every)
        n_drop = 0
        for a in arrivals:
            entry = self._client_pipeline(a.client_id, t, steps)
            res.client_loss.append(self._loss)
            n_drop += int(not entry.arrived)
            if a.delay > 0:
                obs.event("service.upload_deferred", client=a.client_id,
                          due=t + a.delay)
                heapq.heappush(self._pending,
                               (t + a.delay, self._seq, entry))
                self._seq += 1
            else:
                self.aggregator.submit(entry)
                self._maybe_flush(t, res, eval_every)
        stats = self.channel.round_stats()
        res.arrivals_per_tick.append(len(arrivals))
        res.drops.append(n_drop)
        res.corruptions_detected.append(stats["corruptions_detected"])
        res.retransmits.append(stats["retransmits"])
        if tsp.enabled:
            tsp.set(arrivals=len(arrivals), drops=n_drop,
                    quarantined=n_quar, buffered=self.aggregator.pending(),
                    flushes=self._flushes_this_tick)
