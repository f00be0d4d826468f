"""FedBuff-style buffered aggregation with staleness-weighted WeightAverage
(the counterpart of ``repro.fl.service.aggregator``).

The synchronous server drops late clients (``FLServer.straggler_mask``:
weight 0 past the deadline). The async service generalizes that hard cutoff
into a CONTINUOUS weight: every buffered update carries the model version
it downloaded, and at flush time its Eq. 2 weight decays polynomially in
the version lag,

    w(s) = (1 + s) ** -alpha,     s = flush_version - download_version,

the FedBuff staleness discount (alpha=0.5 default). A fresh update (s=0)
keeps weight 1; the deadline policy is the alpha -> infinity limit. Weights
compose with the transport arrival mask (a lost frame is weight 0 whatever
its age), and ``fedavg.weight_average`` renormalizes, so the flush is still
Eq. 2 over the updates that count.

Bit-identity contract: when every buffered update is fresh (all staleness
zero) the flush passes ``fedavg_weights=None`` and lets
``FLServer.aggregate`` derive weights from the arrival mask alone — the
EXACT code path the synchronous simulator takes — so the degenerate service
(buffer == cohort, zero delay) reproduces ``FLSimulation`` bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.rounds import Draws, RoundResult
from repro_torch.fl.server import FLServer

Params = Dict[str, torch.Tensor]


class BufferEntry(NamedTuple):
    """One client upload waiting in the server's buffer.

    ``version`` is ``server.round_idx`` at the moment the client downloaded
    the weights it trained on; ``tick`` is the arrival tick (queue-wait
    telemetry). ``arrived``/``metadata`` are captured at upload time —
    channel round state is per-tick, so the flush must not re-ask the wire.
    """
    client_id: int
    params: Params
    metadata: Optional[tuple]
    version: int
    arrived: bool
    tick: int


def staleness_weight(staleness: int, alpha: float = 0.5) -> float:
    """The FedBuff polynomial discount ``(1 + s) ** -alpha``. s=0 -> 1.0;
    alpha=0 recovers the unweighted mean; larger alpha forgets stale
    updates faster (the deadline policy is the limit)."""
    if staleness < 0:
        raise ValueError(f"negative staleness {staleness}")
    return float((1.0 + staleness) ** (-alpha))


@dataclass
class BufferedAggregator:
    """Accumulate uploads; flush a staleness-weighted WeightAverage through
    ``FLServer.aggregate`` once ``buffer_size`` updates are buffered.

    Every flush bumps ``server.round_idx`` — the model version — so
    staleness is measured in FLUSHES survived in the queue, not wall ticks.
    ``record_arrivals`` runs per flush with the flushed clients' arrival
    bits, so quarantine composes with buffering unchanged.
    """
    server: FLServer
    buffer_size: int
    staleness_alpha: float = 0.5
    entries: List[BufferEntry] = field(default_factory=list)
    flushes: int = 0
    # staleness of each entry of the last flush (the loop mirrors it into
    # ServiceResult)
    last_staleness: List[int] = field(default_factory=list)

    def submit(self, entry: BufferEntry) -> bool:
        """Buffer one upload; True when the buffer is full (the loop then
        flushes, after telling its draws where it stands)."""
        self.entries.append(entry)
        return self.ready()

    def ready(self) -> bool:
        """Whether ``buffer_size`` updates are buffered."""
        return len(self.entries) >= self.buffer_size

    def pending(self) -> int:
        """Updates buffered and not yet flushed."""
        return len(self.entries)

    def _weights(self, staleness: List[int],
                 arrived: np.ndarray) -> Optional[List[float]]:
        """Eq. 2 weights for one flush; None when every update is fresh,
        which routes ``FLServer.aggregate`` through the synchronous
        arrival-mask path (the bit-identity contract above)."""
        if not any(staleness):
            return None
        return [float(ok) * staleness_weight(s, self.staleness_alpha)
                for ok, s in zip(arrived, staleness)]

    def flush(self, draws: Draws, tick: int
              ) -> Tuple[RoundResult, List[int]]:
        """Drain the buffer through MetaTraining + staleness-weighted
        Eq. 2. ``draws`` gives the flush's meta-training permutations, as
        the round's draws give ``FLSimulation``'s. Returns the RoundResult
        and the per-entry staleness (the accuracy-vs-staleness
        telemetry)."""
        entries, self.entries = self.entries, []
        fv = self.server.round_idx
        staleness = [fv - e.version for e in entries]
        arrived = np.asarray([e.arrived for e in entries])
        weights = self._weights(staleness, arrived)
        with obs.span("service.buffer_flush", size=len(entries),
                      flush=self.flushes) as fsp:
            for e, s in zip(entries, staleness):
                obs.event("service.queue_wait", client=e.client_id,
                          wait_ticks=tick - e.tick, staleness=s)
            rr = self.server.aggregate(
                [e.params for e in entries],
                [e.metadata for e in entries], draws,
                arrived=arrived, fedavg_weights=weights)
            self.server.record_arrivals(
                [e.client_id for e in entries], arrived)
            if fsp.enabled:
                fsp.set(max_staleness=max(staleness),
                        weighted=int(weights is not None))
        self.flushes += 1
        self.last_staleness = staleness
        return rr, staleness
