"""Client role (the counterpart of ``repro.fl.client``): a client's data
and a cost model of its local time. ``local_time`` is what
``FLServer.straggler_mask`` compares against ``FLServer.deadline`` to
drop stragglers from WeightAverage instead of waiting for them. The
client's work itself is ``core.rounds.client_round``."""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import FLConfig
from repro_torch.data.partition import ClientData


@dataclass
class FLClient:
    client: ClientData
    compute_speed: float = 1.0       # relative FLOP/s (heterogeneous hardware)

    def local_time(self, cfg: FLConfig, flops_per_sample: float) -> float:
        """Estimated local round time: epochs * |D_k| * flops / speed.
        Selection adds one lower-forward over |D_k| (still ~3x cheaper than a
        training epoch) — the quantity the paper reduces."""
        n = len(self.client.data)
        train = cfg.local_epochs * n * 3 * flops_per_sample
        select = n * flops_per_sample if cfg.use_selection else 0
        return (train + select) / (self.compute_speed * 1e9)
