"""End-to-end FL simulation (the paper's §4 experiment harness) on the port.

Drives the FLServer and its clients for T rounds over a non-IID partition,
evaluating the composed model M_COM(t) and the FedAvg model W_G(t) on the
test set, and charging every frame's exact bytes to the server's ledger.
The counterpart of ``repro.fl.simulation`` without a fault plan, a tracer
or a deadline (those wait for their ports).

It runs on ``cuda`` unless constructed with ``device="cpu"``, and raises
when there is no CUDA device and the CPU was not asked for.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Union

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.compose import evaluate
from repro_torch.core.rounds import GeneratorDraws, run_cohort
from repro_torch.core.split import SplitModel
from repro_torch.data.datasets import Dataset
from repro_torch.data.partition import ClientData
from repro_torch.device import resolve_device
from repro_torch.fl.server import FLServer
from repro_torch.fl.transport.channel import Channel
from repro_torch.obs.timing import monotonic, sync


@dataclass
class SimulationResult:
    test_acc: List[float] = field(default_factory=list)      # M_COM(t)
    fedavg_acc: List[float] = field(default_factory=list)    # plain W_G(t)
    metadata_counts: List[int] = field(default_factory=list)
    cohort_samples: List[int] = field(default_factory=list)  # sum_k |D_k|
    client_loss: List[float] = field(default_factory=list)
    lloyd_iters: List[List[int]] = field(default_factory=list)
    round_wall_s: List[float] = field(default_factory=list)  # host clock,
    #   device-synchronized at the round's end (evaluation included)
    comm: dict = field(default_factory=dict)
    wall_time: float = 0.0

    @property
    def selected_fraction(self) -> float:
        """|D_M|/|D_k| of the LAST round over the cohort's samples."""
        if not self.metadata_counts:
            return 0.0
        return self.metadata_counts[-1] / max(self.cohort_samples[-1], 1)


class FLSimulation:
    def __init__(self, model: SplitModel, clients: List[ClientData],
                 test: Dataset, cfg: FLConfig, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model, self.cfg = model, cfg
        self.draws = GeneratorDraws(torch.Generator().manual_seed(seed))
        params = model.init(self.draws.generator, self.device)
        _, upper0 = model.split(params)
        self.server = FLServer(model, params, upper0, cfg)
        self.channel = Channel(self.server.ledger,
                               checksum=cfg.transport_checksum)
        self.clients = list(clients)
        self.num_classes = test.num_classes
        self.test_x = torch.as_tensor(test.x, device=self.device)
        self.test_y = torch.as_tensor(test.y, device=self.device)

    def run(self, rounds: int, eval_every: int = 1,
            verbose: bool = False) -> SimulationResult:
        res = SimulationResult()
        t0 = monotonic()
        for t in range(rounds):
            r0 = monotonic()
            self._run_round(t, rounds, eval_every, verbose, res)
            sync(self.server.global_params)
            res.round_wall_s.append(monotonic() - r0)
        res.comm = self.server.ledger.summary()
        res.comm["total_samples"] = sum(len(c.data) for c in self.clients)
        res.wall_time = monotonic() - t0
        return res

    def _run_round(self, t: int, rounds: int, eval_every: int,
                   verbose: bool, res: SimulationResult) -> None:
        idx = self.server.sample_clients(len(self.clients), self.draws)
        cohort = [self.clients[int(i)] for i in idx]
        # the formed cohort downloads W_G(t-1) now (round 0 included)
        self.server.broadcast_weights(len(cohort), self.channel)
        cparams, metas, losses, sweeps = run_cohort(
            self.model, self.server.global_params, cohort, self.cfg,
            self.draws, self.channel,
            self.num_classes, client_ids=[int(i) for i in idx])
        rr = self.server.aggregate(cparams, metas, self.draws)
        res.client_loss.append(sum(losses) / max(len(losses), 1))
        res.metadata_counts.append(rr.metadata_count)
        res.cohort_samples.append(sum(len(c.data) for c in cohort))
        res.lloyd_iters.append([s for s in sweeps if s is not None])
        if (t + 1) % eval_every == 0 or t == rounds - 1:
            acc = evaluate(self.model, rr.composed_params, self.test_x,
                           self.test_y)
            fa_acc = evaluate(self.model, rr.global_params, self.test_x,
                              self.test_y)
            res.test_acc.append(acc)
            res.fedavg_acc.append(fa_acc)
            if verbose:
                print(f"round {t+1:4d}  M_COM acc={acc:.4f}  "
                      f"FedAvg acc={fa_acc:.4f}  |D_M|={rr.metadata_count}")
