"""Deterministic, seeded client-arrival models for the port's async FL
service; a copy of ``repro.fl.service.traffic`` (pure numpy: the
schedules equal the reference's exactly).

The event-driven server (``repro_torch.fl.service.loop``) does not form
cohorts — clients ARRIVE, drawn per tick from one of these traffic models.
Each model is a pure function of ``(seed, tick)``: like
``repro_torch.fl.faults.FaultPlan``, every random decision comes from a
``np.random.SeedSequence`` stream keyed on the tick, never from call
order, so replaying a service run (or resuming it mid-stream) reproduces
the identical arrival schedule.

Three profiles:

  DegenerateTraffic  the sync-equivalence anchor: tick t's arrivals are
                     EXACTLY the cohort the sequential simulator would have
                     sampled (``FLServer.sample_clients`` on the same
                     draws), all with zero upload delay — the configuration
                     under which the service must reproduce ``FLSimulation``
                     bit-for-bit (weights and ledger).
  PoissonTraffic     homogeneous load: arrivals-per-tick ~ Poisson(rate),
                     clients uniform over the server's ELIGIBLE set (so
                     quarantine composes), optional uniform upload delays.
  DiurnalTraffic     Poisson with a sinusoidal day/night rate profile —
                     the "heavy traffic from millions of users" shape where
                     staleness actually accrues.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np

# stream ids for the per-tick SeedSequence (call-order independence, same
# convention as repro_torch.fl.faults)
_STREAM_ARRIVALS = 0


class Arrival(NamedTuple):
    """One client hitting the service this tick.

    ``delay`` is the number of ticks between the client's model download
    (it trains on what it downloaded NOW) and its upload landing in the
    server's buffer — the latency that turns into staleness when other
    flushes bump the model version in between. Zero means the upload is
    buffered within the arrival tick.
    """
    client_id: int
    delay: int = 0


class TrafficModel:
    """Interface: ``arrivals(tick, server, num_clients, draws)`` -> arrival
    list for that tick. ``server`` exposes the quarantine view
    (``eligible_clients``) and, for the degenerate model, the historical
    cohort sampler; ``draws`` is the run's ``core.rounds.Draws`` (used only
    by :class:`DegenerateTraffic` — the stochastic models draw from their
    own numpy streams so their schedules are independent of FL
    randomness)."""

    def arrivals(self, tick: int, server, num_clients: int,
                 draws) -> List[Arrival]:
        """The arrivals of ``tick``."""
        raise NotImplementedError


@dataclass(frozen=True)
class DegenerateTraffic(TrafficModel):
    """The synchronous simulator's cohort, replayed as an arrival burst.

    Tick t yields exactly ``server.sample_clients(num_clients, draws)`` —
    the same cohort draw, in the same order, with zero delay — so a service
    driven by this model consumes the same draws as ``FLSimulation`` round
    t. With ``buffer_size == clients_per_round`` this is the bit-identity
    configuration (see tests/test_torch_service.py).
    """

    def arrivals(self, tick: int, server, num_clients: int,
                 draws) -> List[Arrival]:
        """The cohort ``FLSimulation`` would sample at this round."""
        idx = server.sample_clients(num_clients, draws)
        return [Arrival(int(i), 0) for i in idx]


@dataclass(frozen=True)
class PoissonTraffic(TrafficModel):
    """Homogeneous Poisson arrivals.

    Per tick: ``n ~ Poisson(rate)`` arrivals, each an independent uniform
    draw over the server's eligible clients (WITH replacement — a busy
    client can check in twice a tick), each with a uniform upload delay in
    ``[0, delay_ticks]``. All draws come from the
    ``SeedSequence((seed, tick, stream))`` generator, so the schedule is a
    pure function of ``(seed, tick)``.
    """
    rate: float = 2.0
    seed: int = 0
    delay_ticks: int = 0

    def _rng(self, tick: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            (int(self.seed), int(tick), _STREAM_ARRIVALS)))

    def rate_at(self, tick: int) -> float:
        """Expected arrivals at ``tick`` (constant here; diurnal bends it)."""
        return self.rate

    def arrivals(self, tick: int, server, num_clients: int,
                 draws) -> List[Arrival]:
        """``Poisson(rate_at(tick))`` arrivals over the eligible clients."""
        rng = self._rng(tick)
        n = int(rng.poisson(max(self.rate_at(tick), 0.0)))
        if n == 0:
            return []
        elig = server.eligible_clients(num_clients)
        if not elig:
            elig = list(range(num_clients))
        pos = rng.integers(0, len(elig), size=n)
        delays = (rng.integers(0, self.delay_ticks + 1, size=n)
                  if self.delay_ticks > 0 else np.zeros(n, np.int64))
        return [Arrival(int(elig[p]), int(d)) for p, d in zip(pos, delays)]


@dataclass(frozen=True)
class DiurnalTraffic(PoissonTraffic):
    """Poisson arrivals under a sinusoidal day/night load profile:
    ``rate(t) = base_rate * (1 + amplitude * sin(2*pi*t / period))``,
    floored at zero. ``amplitude=1`` swings between 0 and 2x the base rate
    over one ``period`` of ticks; staleness accrues in the trough, where
    uploads outlive the flushes that age them."""
    amplitude: float = 0.8
    period: int = 24

    def rate_at(self, tick: int) -> float:
        phase = 2.0 * np.pi * (tick % self.period) / max(self.period, 1)
        return max(self.rate * (1.0 + self.amplitude * float(np.sin(phase))),
                   0.0)
