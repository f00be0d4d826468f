"""Tensor codecs for the wire: how a float payload becomes bytes.

The counterpart of ``repro.fl.transport.codecs``, with the same wire ids
and byte layouts, so a frame encoded by either package decodes under the
other. A codec owns the LOSSY part of the transport layer; ``messages.py``
owns the lossless framing around it. Three codecs:

  raw_f32   4 bytes/element, exact
  f16       2 bytes/element, IEEE half round-to-nearest-even
  int8      1 byte/element + 8 bytes of per-tensor affine params
            (xmin, scale), quantized by ``kernels.ops.quantize_affine``:
            the CUDA kernel for a payload on the card, its plain version
            for one on the CPU — byte-identical either way.

``encode`` consumes the FULL fixed-slot tensor plus the valid mask and
returns the wire bytes of the valid rows plus the codec's parameter bytes.
``decode`` reconstructs those rows as an f32 numpy array.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple, Type

import numpy as np
import torch

from repro_torch.fl.transport.errors import LengthMismatch, UnknownCodec
from repro_torch.kernels import ops


def _check_rows(payload: bytes, nvalid: int, d: int, itemsize: int,
                name: str) -> None:
    """The row payload must be EXACTLY the bytes the declared row count
    implies; anything else is wire corruption (``LengthMismatch``)."""
    want = nvalid * d * itemsize
    if len(payload) != want:
        raise LengthMismatch(
            f"{name} row payload is {len(payload)} bytes, expected "
            f"{want} ({nvalid} rows x {d} x {itemsize}B)")


def _host_rows(x: torch.Tensor, valid: np.ndarray) -> np.ndarray:
    """The valid rows of ``x`` as a host numpy array (only they are
    copied off the card)."""
    rows = x[torch.as_tensor(valid, device=x.device)]
    return rows.detach().cpu().numpy()


class TensorCodec:
    """encode: (x (N, D) f32 tensor, valid (N,) bool numpy) -> (payload
    bytes for the VALID rows, params bytes). decode: inverse ->
    (nvalid, D) f32 numpy."""
    name: str = ""
    code: int = -1

    def encode(self, x: torch.Tensor,
               valid: np.ndarray) -> Tuple[bytes, bytes]:
        """(full slot tensor, valid mask) -> (valid-row payload bytes,
        codec param bytes)."""
        raise NotImplementedError

    def decode(self, payload: bytes, nvalid: int, d: int,
               params: bytes) -> np.ndarray:
        """Inverse of ``encode``: payload + declared (nvalid, d) + param
        bytes -> (nvalid, d) f32. Any size/params mismatch raises
        ``LengthMismatch``."""
        raise NotImplementedError


class RawF32Codec(TensorCodec):
    """Exact 4-bytes/element wire dtype: payload = valid rows as
    little-endian f32, no codec params."""
    name, code = "raw_f32", 0

    def encode(self, x, valid):
        """Valid rows -> contiguous f32 bytes; params are empty."""
        return np.ascontiguousarray(
            _host_rows(x, valid).astype(np.float32)).tobytes(), b""

    def decode(self, payload, nvalid, d, params):
        """f32 bytes -> (nvalid, d) f32 copy; non-empty params are
        corruption (this codec never writes any)."""
        _check_rows(payload, nvalid, d, 4, self.name)
        if params:
            raise LengthMismatch(
                f"{self.name} takes no codec params, got {len(params)}B")
        return np.frombuffer(payload, np.float32).reshape(nvalid, d).copy()


class F16Codec(TensorCodec):
    """IEEE-754 half codec: 2 bytes/element, round-to-nearest-even on
    encode (numpy's cast, as in the reference), exact widening on decode."""
    name, code = "f16", 1

    def encode(self, x, valid):
        """Valid rows cast to f16 -> contiguous bytes; params are empty."""
        return np.ascontiguousarray(
            _host_rows(x, valid).astype(np.float16)).tobytes(), b""

    def decode(self, payload, nvalid, d, params):
        """f16 bytes -> (nvalid, d) widened to f32; non-empty params are
        corruption."""
        _check_rows(payload, nvalid, d, 2, self.name)
        if params:
            raise LengthMismatch(
                f"{self.name} takes no codec params, got {len(params)}B")
        half = np.frombuffer(payload, np.float16).reshape(nvalid, d)
        return half.astype(np.float32)


class Int8Codec(TensorCodec):
    """Per-tensor affine int8: q = clip(rint((x - xmin) * (1/scale)) - 128)
    with (xmin, scale) over the valid rows (``kernels/ref.py`` is the exact
    contract; the CUDA kernel reproduces it byte for byte)."""
    name, code = "int8", 2

    def encode(self, x, valid):
        """Quantize the (N, D) tensor on its own device (the CUDA kernel on
        the card) -> valid rows as int8 levels + 8 param bytes ``<ff``
        (xmin, scale), the f32 bits as the kernel wrote them. The valid
        rows are taken by index (known here, on the host), and codes and
        params come to the host in one copy."""
        x2 = x.detach().to(torch.float32).contiguous()
        rows = torch.as_tensor(np.flatnonzero(valid), device=x2.device)
        m = torch.zeros(x2.shape[0], dtype=torch.bool,
                        device=x2.device).index_fill_(0, rows, True)
        q, xmin, scale = ops.quantize_affine(x2, m)
        params = torch.stack([xmin, scale]).view(torch.int8)
        host = torch.cat([q.index_select(0, rows).reshape(-1),
                          params]).cpu().numpy()
        return host[:-8].tobytes(), host[-8:].tobytes()

    def decode(self, payload, nvalid, d, params):
        """int8 levels + ``<ff`` params -> (nvalid, d) f32,
        x_hat = (q + 128) * scale + xmin in f32; params must be 8 bytes."""
        _check_rows(payload, nvalid, d, 1, self.name)
        if len(params) != 8:
            raise LengthMismatch(
                f"{self.name} needs 8 param bytes (xmin, scale), "
                f"got {len(params)}")
        xmin, scale = struct.unpack("<ff", params)
        q = np.frombuffer(payload, np.int8).reshape(nvalid, d)
        return ((q.astype(np.float32) + np.float32(128.0))
                * np.float32(scale) + np.float32(xmin))


_CODECS: Dict[str, Type[TensorCodec]] = {
    c.name: c for c in (RawF32Codec, F16Codec, Int8Codec)}
_BY_CODE: Dict[int, Type[TensorCodec]] = {
    c.code: c for c in (RawF32Codec, F16Codec, Int8Codec)}


def get_codec(name: str) -> TensorCodec:
    """Codec registry keyed by ``FLConfig.transport_codec``."""
    if name not in _CODECS:
        raise ValueError(
            f"unknown transport codec {name!r} (have {sorted(_CODECS)})")
    return _CODECS[name]()


def codec_by_code(code: int) -> TensorCodec:
    """Wire id -> codec (decode side). A code outside the registry is wire
    corruption: ``UnknownCodec``."""
    if code not in _BY_CODE:
        raise UnknownCodec(f"unknown codec wire id {code}")
    return _BY_CODE[code]()
