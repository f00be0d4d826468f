"""Server role: client sampling, metadata aggregation + MetaTraining +
ModelCompose + WeightAverage, and the deadline and quarantine policies
(the counterpart of ``repro.fl.server``).

``deadline`` is the straggler policy: clients whose estimated local time
(``FLClient.local_time``) exceeds it are masked out of WeightAverage
instead of waited for. The ARRIVAL mask generalizes it: ``aggregate``
zero-weights any client whose UpperUpdate frame did not decode this round,
and Eq. 2 renormalizes over the clients that delivered.
``record_arrivals`` tracks per-client failure streaks; a client that fails
``quarantine_after`` consecutive rounds is held out of ``sample_clients``
for ``quarantine_cooldown`` rounds, then re-admitted. With the policies off
(the default) and every frame arriving, sampling and aggregation are
bit-identical to the perfect-wire path."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.core.rounds import Draws, RoundResult, server_round
from repro_torch.core.split import SplitModel
from repro_torch.fl.comms import CommLedger

Params = Dict[str, torch.Tensor]


@dataclass
class FLServer:
    model: SplitModel
    global_params: Params
    upper_init: Params                      # W_G^u(0), reused every round
    cfg: FLConfig
    round_idx: int = 0
    deadline: Optional[float] = None        # seconds; None = wait for all
    ledger: CommLedger = field(default_factory=CommLedger)
    # --- quarantine policy (0 = off) ---
    quarantine_after: int = 0               # K consecutive failed rounds
    quarantine_cooldown: int = 5            # rounds held out once tripped
    fail_streak: dict = field(default_factory=dict)        # cid -> streak
    quarantined_until: dict = field(default_factory=dict)  # cid -> round

    def eligible_clients(self, num_available: int) -> List[int]:
        """Client ids allowed into a cohort: everyone whose quarantine
        window (if any) has expired."""
        return [i for i in range(num_available)
                if self.quarantined_until.get(i, 0) <= self.round_idx]

    def num_quarantined(self, num_available: int) -> int:
        """Clients held out of sampling this round."""
        return num_available - len(self.eligible_clients(num_available))

    def sample_clients(self, num_available: int, draws: Draws) -> np.ndarray:
        """Uniform cohort of ``min(clients_per_round, eligible)`` over the
        ELIGIBLE clients. When nobody is quarantined this is exactly the
        draw over ``num_available``, so seeded runs without faults keep
        their bits; a fully quarantined population falls back to
        everyone."""
        elig = self.eligible_clients(num_available)
        if len(elig) == num_available:
            m = min(self.cfg.clients_per_round, num_available)
            return draws.cohort(num_available, m)
        if not elig:
            elig = list(range(num_available))
        m = min(self.cfg.clients_per_round, len(elig))
        pos = draws.cohort(len(elig), m)
        return np.asarray(elig, dtype=np.int64)[pos]

    def record_arrivals(self, client_ids: Sequence[int],
                        arrived: Sequence[bool]) -> None:
        """Update per-client failure streaks after a round (call after
        ``aggregate``, so ``round_idx`` already names the NEXT round and
        the cooldown counts from it). A delivered update clears the
        client's streak and any quarantine record."""
        for cid, ok in zip(client_ids, arrived):
            cid = int(cid)
            if ok:
                self.fail_streak.pop(cid, None)
                self.quarantined_until.pop(cid, None)
                continue
            streak = self.fail_streak.get(cid, 0) + 1
            self.fail_streak[cid] = streak
            if self.quarantine_after and streak >= self.quarantine_after:
                self.quarantined_until[cid] = (self.round_idx
                                               + self.quarantine_cooldown)
                self.fail_streak[cid] = 0   # streak restarts post-cooldown

    def broadcast_weights(self, num_clients: int, channel) -> int:
        """server -> cohort: each member downloads W_G(t-1), charged at the
        exact WeightBroadcast frame size; returns the bytes charged."""
        return channel.broadcast_weights(self.global_params, num_clients)

    def straggler_mask(self, local_times: Sequence[float]
                       ) -> Optional[np.ndarray]:
        """Deadline policy: True where a client's estimated local time
        blows ``deadline``. None when the policy is off or nobody
        straggled (the exact unweighted average), and when EVERY client
        straggles (dropping the whole cohort would lose the round)."""
        if self.deadline is None:
            return None
        late = np.asarray([t > self.deadline for t in local_times])
        if not late.any() or late.all():
            return None
        return late

    def aggregate(self, client_params: List[Params], metadatas: List[tuple],
                  draws: Draws, stragglers: Optional[np.ndarray] = None,
                  arrived: Optional[np.ndarray] = None,
                  fedavg_weights: Optional[Sequence[float]] = None
                  ) -> RoundResult:
        """Run the server's half of the round and adopt W_G(t).
        ``stragglers`` and ``arrived`` zero-weight the marked clients in
        Eq. 2 (a straggler's metadata still counts); both None keeps the
        exact unweighted mean. ``fedavg_weights`` overrides the masks with
        explicit per-client weights (the async service's staleness
        discount). A round where no update counts keeps W_G(t-1)."""
        if fedavg_weights is not None:
            weights = [float(w) for w in fedavg_weights]
        elif stragglers is None and (arrived is None
                                     or bool(np.all(arrived))):
            weights = None
        else:
            ok = np.ones(len(client_params), bool)
            if stragglers is not None:
                ok &= ~np.asarray(stragglers, bool)
            if arrived is not None:
                ok &= np.asarray(arrived, bool)
            weights = [1.0 if o else 0.0 for o in ok]
        with obs.span("aggregate", clients=len(client_params)) as asp:
            res = server_round(self.model, self.global_params,
                               self.upper_init, client_params, metadatas,
                               self.cfg, draws, fedavg_weights=weights)
            asp.sync(res.global_params)
            if asp.enabled:
                asp.set(zero_weighted=(0 if weights is None
                                       else weights.count(0.0)),
                        metadata_count=res.metadata_count)
        self.global_params = res.global_params
        self.round_idx += 1
        return res
