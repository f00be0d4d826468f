"""Server role: client sampling and aggregation (metadata aggregation,
MetaTraining, ModelCompose, WeightAverage). The counterpart of
``repro.fl.server`` without the deadline and quarantine policies, which
wait with the fault runtime. The client role (``repro.fl.client``) is
``core.rounds.client_round``: ``FLClient``'s only other content, the
straggler cost model, waits with the deadline policy."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

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
    ledger: CommLedger = field(default_factory=CommLedger)

    def sample_clients(self, num_available: int, draws: Draws) -> np.ndarray:
        """Uniform cohort of ``min(clients_per_round, num_available)``."""
        m = min(self.cfg.clients_per_round, num_available)
        return draws.cohort(num_available, m)

    def broadcast_weights(self, num_clients: int, channel) -> int:
        """server -> cohort: each member downloads W_G(t-1), charged at the
        exact WeightBroadcast frame size; returns the bytes charged."""
        return channel.broadcast_weights(self.global_params, num_clients)

    def aggregate(self, client_params: List[Params], metadatas: List[tuple],
                  draws: Draws) -> RoundResult:
        """Run the server's half of the round and adopt W_G(t)."""
        res = server_round(self.model, self.global_params, self.upper_init,
                           client_params, metadatas, self.cfg, draws)
        self.global_params = res.global_params
        return res
