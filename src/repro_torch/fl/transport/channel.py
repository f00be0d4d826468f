"""The charging surface between the round engine and the wire.

The counterpart of ``repro.fl.transport.channel``, perfect wire only (the
fault-injecting channel is not ported yet). Every method builds (or
arithmetically sizes) the real frame, charges the CommLedger with
``len(wire)`` — the exact bytes — and hands back what the RECEIVER
decodes, so a lossy codec's effect on MetaTraining is end to end.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.fl.comms import CommLedger
from repro_torch.fl.transport.codecs import TensorCodec
from repro_torch.fl.transport.messages import (SelectedKnowledge,
                                               pytree_frame_nbytes)

Params = Any


class Channel:
    """The perfect wire: encode -> charge exact bytes -> decode, every frame
    delivered intact exactly once. ``checksum`` appends the CRC32 trailer
    to every frame (4 bytes/frame in the ledger)."""

    def __init__(self, ledger: CommLedger, checksum: bool = False):
        self.ledger = ledger
        self.checksum = checksum

    def broadcast_weights(self, params: Params, num_clients: int) -> int:
        """server -> cohort: one WeightBroadcast frame per member, charged
        at its exact size, computed from leaf shapes and dtypes (the same
        count for the port's parameter dict as for the reference's tree);
        returns the bytes charged."""
        nbytes = pytree_frame_nbytes(params, checksum=self.checksum)
        self.ledger.download("weights", nbytes * num_clients,
                             frames=num_clients)
        return nbytes * num_clients

    def upload_update(self, client_id: int, params: Params) -> bool:
        """client -> server: the UpperUpdate frame for Eq. 2, charged at its
        exact size. Returns whether it arrived (always, on this wire)."""
        nbytes = pytree_frame_nbytes(params, checksum=self.checksum)
        self.ledger.upload("weights", nbytes)
        return True

    def upload_knowledge(self, client_id: int, acts: torch.Tensor, labels,
                         valid, codec: TensorCodec
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """client -> server: encode the selection triple, charge the exact
        frame bytes, and return what the server DECODES from the wire
        (valid rows only, as CPU tensors)."""
        wire = SelectedKnowledge(acts, labels, valid,
                                 codec).encode(checksum=self.checksum)
        self.ledger.upload("metadata", len(wire))
        return SelectedKnowledge.decode(wire)
