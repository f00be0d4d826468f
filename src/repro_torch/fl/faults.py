"""repro_torch.fl.faults — deterministic fault injection for the FL
runtime; a copy of ``repro.fl.faults`` over the port's transport.

  FaultPlan      the fault model — per-round client crash probabilities
                 (before any upload vs. after the knowledge upload), per-
                 frame bit-flip / truncation / duplicate-delivery
                 probabilities, and the recovery policy (retry budget +
                 exponential backoff).
  FaultyChannel  a ``transport.Channel`` that injects the plan between
                 ``encode`` and ``decode``. Corruption lands on the real
                 wire bytes, so what the server sees is whatever the typed
                 decoder makes of the mangled frame: a ``FrameError``
                 (detected -> bounded retry, each retransmit charged real
                 bytes under the ledger's ``retransmit`` category) or —
                 only possible with checksums off — a silently wrong
                 payload, which is counted.

Determinism: every random decision is drawn from a numpy stream seeded by
``(seed, round, client, stream-kind)`` — not from call order — so the same
plan gives the SAME faults on the client-by-client loop and on the cohort
engine, and the same ones as the reference's ``FaultyChannel`` for frames
of the same lengths. With every rate at zero the channel never perturbs,
never retries, and charges byte-identical ledger entries to the perfect
``Channel``. Each log line is mirrored into the active tracer as a
``fault.<kind>`` event and counter, beside the ``fault.retransmits`` and
``fault.injected_corruptions`` counters (no-ops when observability is
off).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.fl.comms import DUPLICATE, RETRANSMIT, CommLedger
from repro_torch.fl.transport.channel import Channel
from repro_torch.fl.transport.errors import FrameError
from repro_torch.fl.transport.messages import (SelectedKnowledge, UpperUpdate,
                                               unflatten_like)

Params = Any

# client fates for one round (drawn once per (round, client))
FATE_OK = "ok"
FATE_CRASH_BEFORE_UPLOAD = "crash_before_upload"   # nothing arrives
FATE_CRASH_AFTER_SELECT = "crash_after_select"     # knowledge arrives,
                                                   # update doesn't

# per-client RNG stream ids (call-order independent determinism)
_STREAM_FATE = 0
_STREAM_KNOWLEDGE = 1
_STREAM_UPDATE = 2


@dataclass(frozen=True)
class FaultPlan:
    """The fault model plus the recovery policy, in one frozen value.

    Rates are probabilities per round (crashes) or per frame delivery
    (corruption); a frame draws at most ONE corruption event per attempt
    (truncation, else bit-flip). ``max_retries`` bounds how often a
    DETECTED corruption is retransmitted (each retransmit charges real
    bytes); ``backoff_base`` is the virtual exponential-backoff unit the
    round stats accumulate (simulated seconds — nothing sleeps)."""
    drop_rate: float = 0.0          # P[client crashes before any upload]
    late_crash_rate: float = 0.0    # P[crash after the knowledge upload]
    bitflip_rate: float = 0.0       # P[a delivery gets one bit flipped]
    truncate_rate: float = 0.0      # P[a delivery is cut short]
    duplicate_rate: float = 0.0     # P[a delivery is cloned in flight]
    max_retries: int = 2            # retransmit budget per frame
    backoff_base: float = 0.05      # virtual seconds; delay 2x per retry

    @property
    def any_faults(self) -> bool:
        """Whether any rate is non-zero."""
        return any(r > 0 for r in (self.drop_rate, self.late_crash_rate,
                                   self.bitflip_rate, self.truncate_rate,
                                   self.duplicate_rate))


@dataclass
class FaultEvent:
    """One line of the per-round fault log."""
    round_idx: int
    client_id: int
    frame: str                      # "client" | "knowledge" | "update"
    kind: str                       # fate / "corrupt_detected" / ...
    attempt: int
    detail: str = ""


class FaultyChannel(Channel):
    """A ``Channel`` whose wire obeys a :class:`FaultPlan`.

    Delivery of one frame: charge the sender's bytes (attempt 0 under the
    frame's own category, retries under ``retransmit``), perturb per the
    plan, hand the bytes to the real decoder. ``FrameError`` -> detected
    corruption, retry after (virtual) backoff until the budget runs out;
    a perturbed frame that DECODES is a silent corruption (possible only
    without checksums) and is returned as-is. Duplicate deliveries charge
    their clone's bytes under ``duplicate`` and are deduplicated by the
    receiver.

    ``checksum`` defaults to True here (unlike the perfect wire), as in
    the reference."""

    def __init__(self, ledger: CommLedger, plan: FaultPlan, seed: int = 0,
                 checksum: bool = True):
        super().__init__(ledger, checksum=checksum)
        self.plan, self.seed = plan, seed
        self.round_idx = 0
        self.log: List[FaultEvent] = []
        # run-cumulative (never reset): the zero-silent-acceptance audit
        self.total_silent_corruptions = 0
        self.total_injected_corruptions = 0
        self._begin()

    # ---- per-round state ----
    def _begin(self) -> None:
        self._fates: dict = {}
        self._arrived: dict = {}
        self._decoded: dict = {}
        self._stats = {"corruptions_detected": 0, "retransmits": 0,
                       "duplicates": 0, "silent_corruptions": 0,
                       "injected_corruptions": 0, "lost_frames": 0,
                       "backoff_s": 0.0}

    def begin_round(self, round_idx: int) -> None:
        """Start round ``round_idx``: a fresh log, fates and counters."""
        self.round_idx = round_idx
        self.log = []
        self._begin()

    def round_stats(self) -> dict:
        """This round's fault counters."""
        return dict(self._stats)

    def update_arrived(self, client_id: int) -> bool:
        """Whether the client's UpperUpdate frame decoded this round."""
        return self._arrived.get(int(client_id), True)

    def decoded_update(self, client_id: int) -> Optional[Params]:
        """The client's update as the server decoded it — differs from the
        in-memory params only when a corrupted frame was silently accepted
        (checksums off); None when the frame never arrived or arrived
        intact."""
        return self._decoded.get(int(client_id))

    # ---- deterministic draws ----
    def _rng(self, client_id: int, stream: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence(
            (int(self.seed), int(self.round_idx), int(client_id), stream)))

    def client_fate(self, client_id: int) -> str:
        """The client's fate this round, drawn once per (round, client) —
        the same whichever engine asks, in whatever order."""
        cid = int(client_id)
        if cid not in self._fates:
            u = float(self._rng(cid, _STREAM_FATE).random())
            if u < self.plan.drop_rate:
                fate = FATE_CRASH_BEFORE_UPLOAD
            elif u < self.plan.drop_rate + self.plan.late_crash_rate:
                fate = FATE_CRASH_AFTER_SELECT
            else:
                fate = FATE_OK
            self._fates[cid] = fate
            if fate != FATE_OK:
                self._log(cid, "client", fate, 0)
        return self._fates[cid]

    # ---- the wire ----
    def _log(self, client_id: int, frame: str, kind: str, attempt: int,
             detail: str = "") -> None:
        self.log.append(FaultEvent(self.round_idx, int(client_id), frame,
                                   kind, attempt, detail))
        # mirror into the trace: every fault-log line becomes a point event
        # and a counter
        obs.event("fault." + kind, round=self.round_idx,
                  client=int(client_id), frame=frame, attempt=attempt,
                  detail=detail)
        obs.inc("fault." + kind)

    def _perturb(self, wire: bytes,
                 rng: np.random.Generator) -> Tuple[bytes, Optional[str]]:
        """At most one corruption event per delivery attempt."""
        if rng.random() < self.plan.truncate_rate and len(wire) > 0:
            cut = int(rng.integers(0, len(wire)))
            return wire[:cut], "truncate"
        if rng.random() < self.plan.bitflip_rate and len(wire) > 0:
            pos = int(rng.integers(0, len(wire) * 8))
            buf = bytearray(wire)
            buf[pos // 8] ^= 1 << (pos % 8)
            return bytes(buf), "bitflip"
        return wire, None

    def _deliver(self, client_id: int, wire: bytes, category: str,
                 decode: Callable[[bytes], Any], frame: str,
                 stream: int) -> Tuple[Optional[Any], bool]:
        """One frame through the faulty wire with the bounded
        retry-with-backoff budget. Returns (decode, silently_corrupted);
        decode is None once the budget is exhausted (the frame is lost)."""
        rng = self._rng(client_id, stream)
        for attempt in range(self.plan.max_retries + 1):
            cat = category if attempt == 0 else RETRANSMIT
            if attempt:
                self._stats["retransmits"] += 1
                self._stats["backoff_s"] += (self.plan.backoff_base
                                             * 2.0 ** (attempt - 1))
                obs.inc("fault.retransmits")
            self.ledger.upload(cat, len(wire))
            delivered, event = self._perturb(wire, rng)
            if event is not None:
                self._stats["injected_corruptions"] += 1
                self.total_injected_corruptions += 1
                obs.inc("fault.injected_corruptions")
            if rng.random() < self.plan.duplicate_rate:
                # the network clones the delivery; the receiver dedups but
                # the clone's bytes were real traffic
                self.ledger.upload(DUPLICATE, len(delivered))
                self._stats["duplicates"] += 1
                self._log(client_id, frame, "duplicate", attempt)
            try:
                out = decode(delivered)
            except FrameError as e:
                self._stats["corruptions_detected"] += 1
                self._log(client_id, frame, "corrupt_detected", attempt,
                          type(e).__name__)
                continue
            if event is not None:
                # only reachable with checksums off: the mangled frame
                # still decoded — the server now consumes wrong data
                self._stats["silent_corruptions"] += 1
                self.total_silent_corruptions += 1
                self._log(client_id, frame, "silent_corruption", attempt,
                          event)
            return out, event is not None
        self._stats["lost_frames"] += 1
        self._log(client_id, frame, "gave_up", self.plan.max_retries)
        return None, False

    def upload_knowledge(self, client_id, acts, labels, valid, codec,
                         pre=None):
        """client -> server through the faulty wire: None when the client
        crashed before uploading or the frame was lost."""
        if self.client_fate(client_id) == FATE_CRASH_BEFORE_UPLOAD:
            return None
        wire = SelectedKnowledge(acts, labels, valid, codec,
                                 pre=pre).encode(checksum=self.checksum)
        out, _ = self._deliver(client_id, wire, "metadata",
                               SelectedKnowledge.decode, "knowledge",
                               _STREAM_KNOWLEDGE)
        return out

    def upload_update(self, client_id, params):
        """client -> server through the faulty wire; whether it arrived.
        A silently corrupted update is kept, as the server decoded it (on
        the params' devices, in their key order), for ``decoded_update``."""
        cid = int(client_id)
        if self.client_fate(cid) != FATE_OK:
            self._arrived[cid] = False
            return False
        wire = UpperUpdate(params).encode(checksum=self.checksum)
        leaves, silent = self._deliver(cid, wire, "weights",
                                       UpperUpdate.decode, "update",
                                       _STREAM_UPDATE)
        self._arrived[cid] = leaves is not None
        if leaves is not None and silent:
            dec = unflatten_like(params, leaves)
            self._decoded[cid] = {k: dec[k].to(v.device)
                                  for k, v in params.items()}
        return self._arrived[cid]
