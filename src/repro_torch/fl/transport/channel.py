"""The charging surface between the round engines and the wire.

The counterpart of ``repro.fl.transport.channel``. Every method builds (or
arithmetically sizes) the real frame, charges the CommLedger with
``len(wire)`` — the exact bytes — and hands back what the RECEIVER
decodes, so a lossy codec's effect on MetaTraining is end to end.

``Channel`` is the perfect wire: every frame arrives intact, exactly once.
``repro_torch.fl.faults.FaultyChannel`` subclasses it to inject
deterministic crashes, bit-flips, truncations and duplicates between
``encode`` and ``decode``; the round engines cannot tell the difference.

The module-level helpers (``broadcast_weights``, ``upload_update``,
``upload_knowledge``, ``upload_knowledge_batched``) are the reference's
perfect-wire wrappers over a ``CommLedger``, and ``knowledge_codec`` the
codec an ``FLConfig`` asks for.

``upload_knowledge_batched`` is the stacked cohort's entry: for the int8
codec it runs ONE batched quantize over the gathered
``(sel_acts, sel_y, valid)`` triple (``kernels.ops.quantize_affine_batched``:
the CUDA kernel on the card, its plain version on the CPU), copies the
whole cohort's valid codes and params to the host at once, then frames each
client's bytes; the per-client and batched encodings give identical wire
bytes, which keeps the sequential and cohort engines ledger-equal.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.fl.comms import CommLedger
from repro_torch.fl.transport.codecs import (Int8Codec, Quantized,
                                             TensorCodec, get_codec)
from repro_torch.fl.transport.messages import (SelectedKnowledge,
                                               pytree_frame_nbytes)
from repro_torch.kernels import ops

Params = Any


def _host(t) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class Channel:
    """The perfect wire: encode -> charge exact bytes -> decode, every frame
    delivered intact exactly once. ``checksum`` appends the CRC32 trailer
    to every frame (4 bytes/frame in the ledger).

    The fault-tolerance surface (overridden by ``FaultyChannel``):
    ``begin_round`` resets per-round state, ``update_arrived`` reports
    whether a client's UpperUpdate frame decoded (always True here),
    ``round_stats`` returns the per-round fault counters (all zero here)
    and ``decoded_update`` the update as decoded where it could differ from
    the client's params (never here)."""

    def __init__(self, ledger: CommLedger, checksum: bool = False):
        self.ledger = ledger
        self.checksum = checksum

    # ---- fault surface (no-ops on the perfect wire) ----
    def begin_round(self, round_idx: int) -> None:
        """Reset per-round wire state: a no-op on the perfect wire; fault
        models key their draws and fate tables off ``round_idx``."""

    def update_arrived(self, client_id: int) -> bool:
        """Whether ``client_id``'s UpperUpdate frame decoded this round —
        the per-client bit behind the arrival mask of Eq. 2."""
        return True

    def round_stats(self) -> dict:
        """Per-round fault counters (see ``FaultyChannel``); zeros here."""
        return {"corruptions_detected": 0, "retransmits": 0,
                "duplicates": 0, "silent_corruptions": 0,
                "injected_corruptions": 0, "lost_frames": 0,
                "backoff_s": 0.0}

    def decoded_update(self, client_id: int) -> Optional[Params]:
        """The update as the server decoded it, when that can differ from
        the client's params (None on the perfect wire: the frame is
        lossless and intact)."""
        return None

    # ---- the three frame kinds ----
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
                         valid, codec: TensorCodec,
                         pre: Optional[Quantized] = None
                         ) -> Optional[Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]]:
        """client -> server: encode the selection triple, charge the exact
        frame bytes, and return what the server DECODES from the wire
        (valid rows only, as CPU tensors); None when the frame never
        arrived (faulty channels only). ``pre`` is the client's payload
        from the cohort's batched quantize."""
        with obs.span("encode", frame="knowledge", client=int(client_id)):
            wire = SelectedKnowledge(acts, labels, valid, codec,
                                     pre=pre).encode(checksum=self.checksum)
        self.ledger.upload("metadata", len(wire))
        with obs.span("decode", frame="knowledge", client=int(client_id)):
            return SelectedKnowledge.decode(wire)

    def upload_knowledge_batched(self, client_ids: Sequence[int],
                                 sel_acts: torch.Tensor, sel_ys, valid,
                                 codec: TensorCodec) -> List[Optional[Tuple]]:
        """Stacked-cohort knowledge upload: (B, CK, ...) maps, (B, CK)
        labels and valid mask -> each client's decoded triple (None where a
        frame was lost), every frame charged at its exact bytes. The int8
        codec quantizes the whole stack in one batched kernel launch."""
        labels, mask = _host(sel_ys), _host(valid).astype(bool)
        pres = prequantize_cohort(codec, sel_acts, mask)
        return [self.upload_knowledge(
            int(cid), sel_acts[i], labels[i], mask[i], codec,
            pre=None if pres is None else pres[i])
            for i, cid in enumerate(client_ids)]


def prequantize_cohort(codec: TensorCodec, sel_acts: torch.Tensor,
                       valid: np.ndarray) -> Optional[List[Quantized]]:
    """One batched quantize over a stacked cohort's gathered maps:
    (B, CK, ...) maps + (B, CK) bool numpy mask -> per-client
    ``Quantized``, or None for codecs with no quantize stage. Each client's
    statistics are reductions over its own valid rows, so the result is
    byte-identical to B separate quantizes. The valid rows' codes and every
    client's (xmin, scale) come to the host in one copy."""
    if not isinstance(codec, Int8Codec):
        return None
    b, ck = sel_acts.shape[0], sel_acts.shape[1]
    dev = sel_acts.device
    flat = sel_acts.detach().reshape(b, ck, -1).to(torch.float32).contiguous()
    q, xmin, scale = ops.quantize_affine_batched(
        flat, torch.as_tensor(valid, device=dev))
    rows = torch.as_tensor(np.flatnonzero(valid.reshape(-1)), device=dev)
    params = torch.stack([xmin, scale], 1).reshape(-1).view(torch.int8)
    host = torch.cat([q.reshape(b * ck, -1).index_select(0, rows).reshape(-1),
                      params]).cpu().numpy()
    codes = host[:host.size - 8 * b].reshape(len(rows), flat.shape[2])
    xs = host[host.size - 8 * b:].view(np.float32).reshape(b, 2)
    bounds = np.cumsum([0] + [int(v.sum()) for v in valid])
    return [Quantized(codes[bounds[i]:bounds[i + 1]], float(xs[i, 0]),
                      float(xs[i, 1])) for i in range(b)]


# --------------------------------------------------------------------------
# module-level helpers: the reference's perfect-wire wrappers over a ledger
# --------------------------------------------------------------------------
def broadcast_weights(ledger: CommLedger, params: Params,
                      num_clients: int) -> int:
    """Perfect-wire ``Channel.broadcast_weights``: one WeightBroadcast
    frame a member, each charged to ``ledger`` at its exact size; returns
    the bytes charged."""
    return Channel(ledger).broadcast_weights(params, num_clients)


def upload_update(ledger: CommLedger, params: Params) -> int:
    """client -> server: the UpperUpdate frame for Eq. 2, charged to
    ``ledger`` at its exact size (from leaf shapes and dtypes); returns the
    bytes."""
    nbytes = pytree_frame_nbytes(params)
    ledger.upload("weights", nbytes)
    return nbytes


def upload_knowledge(ledger: CommLedger, acts, labels, valid,
                     codec: TensorCodec,
                     pre: Optional[Quantized] = None) -> Tuple:
    """Perfect-wire ``Channel.upload_knowledge`` for one client (id 0):
    encode, charge the exact frame bytes, return the decoded triple."""
    return Channel(ledger).upload_knowledge(0, acts, labels, valid, codec,
                                            pre=pre)


def upload_knowledge_batched(ledger: CommLedger, sel_acts, sel_ys, valid,
                             codec: TensorCodec) -> List[Tuple]:
    """Perfect-wire ``Channel.upload_knowledge_batched`` over a stacked
    cohort (clients numbered 0..B-1): one batched quantize under the int8
    codec, every frame charged at its exact bytes, each client's decoded
    triple."""
    return Channel(ledger).upload_knowledge_batched(
        range(_host(valid).shape[0]), sel_acts, sel_ys, valid, codec)


def knowledge_codec(cfg) -> TensorCodec:
    """The codec an ``FLConfig`` asks for (its ``transport_codec``). The
    reference also reads ``use_pallas_selection`` here; the port has no
    such knob: int8 quantizes with the CUDA kernel on the card and its
    plain version on the CPU."""
    return get_codec(cfg.transport_codec)
