"""Byte-true communication ledger — the measurement half of the paper's
efficiency claim. A copy of ``repro.fl.comms`` (the port imports nothing of
``repro``), charged by ``repro_torch.fl.transport``.

The ledger no longer estimates anything: every entry is charged by
the transport layer with the EXACT length of an encoded wire frame
(``len(WeightBroadcast/SelectedKnowledge/UpperUpdate.encode())``), so
``summary()`` is a byte-for-byte account of what a real deployment would
put on the network — framing, validity bitmaps, codec parameters and all.
The old ``size * 4`` accounting miscounted every non-f32 payload (bf16
weights billed at 2x their size) and could not see codec choice at all;
with the transport layer, switching ``FLConfig.transport_codec`` between
``raw_f32``/``f16``/``int8`` moves these numbers exactly the way it moves
real bytes (benchmarks/comm_bench.py -> BENCH_comms.json).

Uploads (client -> server) and downloads (server -> client) are tallied by
category — ``"metadata"`` for SelectedKnowledge frames (the paper's ~1.6%
claim lives here), ``"weights"`` for WeightBroadcast/UpperUpdate — along
with per-category frame counts (one frame = one encoded message), so
bytes-per-frame is recoverable without re-running.

Fault tolerance adds two categories the perfect wire never charges:
``"retransmit"`` for every re-send of a frame whose previous delivery
failed to decode (the recovery overhead the chaos benchmark reports), and
``"duplicate"`` for network-cloned deliveries the receiver deduplicates.
Both are real traffic — they count toward ``total_up`` — but are kept out
of ``"metadata"``/``"weights"`` so the paper's efficiency numbers stay
attributable to first transmissions."""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

# fault-runtime charging categories (repro_torch.fl.faults.FaultyChannel)
RETRANSMIT = "retransmit"
DUPLICATE = "duplicate"


@dataclass
class CommLedger:
    up: dict = field(default_factory=lambda: defaultdict(int))
    down: dict = field(default_factory=lambda: defaultdict(int))
    up_frames: dict = field(default_factory=lambda: defaultdict(int))
    down_frames: dict = field(default_factory=lambda: defaultdict(int))

    def upload(self, category: str, nbytes: int, frames: int = 1):
        self.up[category] += int(nbytes)
        self.up_frames[category] += int(frames)

    def download(self, category: str, nbytes: int, frames: int = 1):
        self.down[category] += int(nbytes)
        self.down_frames[category] += int(frames)

    @property
    def total_up(self) -> int:
        return sum(self.up.values())

    @property
    def total_down(self) -> int:
        return sum(self.down.values())

    def summary(self) -> dict:
        return {"up": dict(self.up), "down": dict(self.down),
                "up_frames": dict(self.up_frames),
                "down_frames": dict(self.down_frames),
                "total_up": self.total_up, "total_down": self.total_down,
                "retransmit_up": self.up.get(RETRANSMIT, 0),
                "duplicate_up": self.up.get(DUPLICATE, 0)}

    def reset(self):
        self.up.clear()
        self.down.clear()
        self.up_frames.clear()
        self.down_frames.clear()
