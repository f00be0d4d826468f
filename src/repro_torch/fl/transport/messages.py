"""Typed wire messages: the three payloads Algorithm 1 exchanges.

The counterpart of ``repro.fl.transport.messages``. Frames are byte for
byte the reference's, so a frame encoded by either package decodes under
the other:

  WeightBroadcast    server -> client   W_G(t-1)
  SelectedKnowledge  client -> server   the selected activation maps +
                                        labels + per-slot validity
  UpperUpdate        client -> server   the client's updated weights

Frame layout (little-endian), wire VERSION 2:

  0   4  magic  b"FLTP"
  4   1  version (2; version-1 frames still decode — no flags, no trailer)
  5   1  msg type
  6   1  codec wire id (knowledge frames; 0 for weight frames)
  7   1  flags (bit 0 = CRC32 trailer present)
  8   4  payload length (trailer NOT included)
  12  …  payload
  +4     CRC32 of header+payload, only when flags bit 0 is set

Weight payloads are a leaf count followed by array blocks
(dtype u8 | ndim u8 | dims u32* | raw bytes) in the order of
``tree_leaves``, which is ``jax.tree.leaves``' order (dict keys sorted,
lists in order). To carry the reference's layout (HWIO convs, the
reference's names and order), encode the tree of
``models.wrn.params_to_jax``; ``pytree_frame_nbytes`` depends only on
leaf shapes and dtypes, so it gives the same count for the port's own
parameter dict. bf16 (code 2) is written from a ``torch.bfloat16`` tensor's
16-bit view, as the reference writes ml_dtypes' bfloat16.

Knowledge payloads carry the VALID slots only: slot count, valid count, the
per-map shape, a label dtype code, a packed validity bitmap, the codec's
parameter block, the valid labels, then the codec-encoded rows.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.fl.transport.codecs import (Quantized, TensorCodec,
                                             codec_by_code, get_codec)
from repro_torch.fl.transport.errors import (BadMagic, BadVersion,
                                             ChecksumMismatch, LengthMismatch,
                                             TruncatedFrame, UnknownDtype,
                                             WrongMessageType)

MAGIC = b"FLTP"
VERSION = 2
V1 = 1                                         # still decoded (compat)
FLAG_CHECKSUM = 0x01                           # flags bit 0: CRC32 trailer
_KNOWN_FLAGS = FLAG_CHECKSUM
CRC_BYTES = 4

MSG_WEIGHT_BROADCAST = 1
MSG_SELECTED_KNOWLEDGE = 2
MSG_UPPER_UPDATE = 3

_HEADER = struct.Struct("<4sBBBBI")
HEADER_BYTES = _HEADER.size                    # 12

# the wire dtype table: (torch dtype, numpy dtype of the wire bytes)
_DTYPES: List[Tuple[torch.dtype, np.dtype]] = [
    (torch.float32, np.dtype(np.float32)),
    (torch.float16, np.dtype(np.float16)),
    (torch.bfloat16, np.dtype(np.int16)),      # raw 16-bit pattern
    (torch.int8, np.dtype(np.int8)),
    (torch.uint8, np.dtype(np.uint8)),
    (torch.int32, np.dtype(np.int32)),
    (torch.int64, np.dtype(np.int64)),
    (torch.uint32, np.dtype(np.uint32)),
    (torch.bool, np.dtype(np.bool_)),
]
_TORCH_CODE = {t: i for i, (t, _) in enumerate(_DTYPES)}
_NUMPY_CODE = {np.dtype(n): i for i, (t, n) in enumerate(_DTYPES)
               if t is not torch.bfloat16}


def _dtype_code(dt) -> int:
    code = (_TORCH_CODE.get(dt) if isinstance(dt, torch.dtype)
            else _NUMPY_CODE.get(np.dtype(dt)))
    if code is None:
        raise ValueError(f"no wire code for dtype {dt}")
    return code


def _pack_header(msg_type: int, codec_code: int, payload: bytes,
                 checksum: bool = False) -> bytes:
    flags = FLAG_CHECKSUM if checksum else 0
    frame = _HEADER.pack(MAGIC, VERSION, msg_type, codec_code, flags,
                         len(payload)) + payload
    if checksum:
        frame += struct.pack("<I", zlib.crc32(frame) & 0xFFFFFFFF)
    return frame


def _unpack_header(wire: bytes) -> Tuple[int, int, bytes]:
    """Parse + validate a frame down to its payload, raising the typed
    ``FrameError``s (never ``struct.error``); verifies the CRC32 trailer
    when the checksum flag is set."""
    if len(wire) < HEADER_BYTES:
        raise TruncatedFrame(
            f"frame shorter than the {HEADER_BYTES}-byte header: {len(wire)}")
    magic, ver, msg_type, codec_code, flags, plen = _HEADER.unpack_from(
        wire, 0)
    if magic != MAGIC:
        raise BadMagic(f"bad frame magic {magic!r}")
    if ver == V1:
        flags = 0                    # v1's reserved byte carries no meaning
    elif ver == VERSION:
        if flags & ~_KNOWN_FLAGS:
            raise BadVersion(f"unknown v{ver} flag bits 0x{flags:02x}")
    else:
        raise BadVersion(f"unsupported frame version {ver}")
    crc = bool(flags & FLAG_CHECKSUM)
    expect = HEADER_BYTES + plen + (CRC_BYTES if crc else 0)
    if len(wire) < expect:
        raise TruncatedFrame(f"frame length {len(wire)} < expected {expect}")
    if len(wire) != expect:
        raise LengthMismatch(
            f"frame length {len(wire)} != expected {expect}")
    if crc:
        (got,) = struct.unpack_from("<I", wire, HEADER_BYTES + plen)
        want = zlib.crc32(wire[:HEADER_BYTES + plen]) & 0xFFFFFFFF
        if got != want:
            raise ChecksumMismatch(
                f"frame CRC32 0x{got:08x} != computed 0x{want:08x}")
    return msg_type, codec_code, wire[HEADER_BYTES:HEADER_BYTES + plen]


def _need(buf: bytes, off: int, n: int, what: str) -> None:
    if off + n > len(buf):
        raise TruncatedFrame(
            f"payload ends inside {what}: need {n} bytes at offset {off}, "
            f"have {len(buf) - off}")


def _leaf_bytes(a) -> Tuple[int, Tuple[int, ...], bytes]:
    """(dtype code, shape, C-order raw bytes) of a tensor or array."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        code = _dtype_code(t.dtype)
        if t.dtype is torch.bfloat16:
            t = t.view(torch.int16)
        return code, tuple(t.shape), t.numpy().tobytes()
    a = np.asarray(a)
    return _dtype_code(a.dtype), a.shape, a.tobytes()


def _pack_array(a) -> bytes:
    code, shape, raw = _leaf_bytes(a)
    head = struct.pack("<BB", code, len(shape))
    dims = struct.pack(f"<{len(shape)}I", *shape) if shape else b""
    return head + dims + raw


def _unpack_array(buf: bytes, off: int) -> Tuple[torch.Tensor, int]:
    _need(buf, off, 2, "array block head")
    code, ndim = struct.unpack_from("<BB", buf, off)
    off += 2
    if code >= len(_DTYPES):
        raise UnknownDtype(f"array dtype code {code} outside the wire table "
                           f"(0..{len(_DTYPES) - 1})")
    _need(buf, off, 4 * ndim, "array dims")
    shape = struct.unpack_from(f"<{ndim}I", buf, off) if ndim else ()
    off += 4 * ndim
    tdt, ndt = _DTYPES[code]
    n = 1                            # Python ints: corrupt dims can't overflow
    for s in shape:
        n *= int(s)
    _need(buf, off, n * ndt.itemsize, "array data")
    a = np.frombuffer(buf, ndt, count=n, offset=off).reshape(shape).copy()
    t = torch.from_numpy(a)
    if tdt is torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t, off + n * ndt.itemsize


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of a nested dict/list/tuple in ``jax.tree.leaves`` order
    (dict keys sorted, sequences in order; None holds no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def unflatten_like(tree: Any, leaves: List[Any]) -> Any:
    """Rebuild decoded leaves into ``tree``'s structure (the architecture
    is shared out of band; the wire carries numbers only)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out


def _encode_pytree(msg_type: int, tree: Any, checksum: bool = False) -> bytes:
    leaves = tree_leaves(tree)
    payload = struct.pack("<I", len(leaves)) + b"".join(
        _pack_array(a) for a in leaves)
    return _pack_header(msg_type, 0, payload, checksum=checksum)


def _decode_pytree(wire: bytes, expect_type: int) -> List[torch.Tensor]:
    msg_type, _, payload = _unpack_header(wire)
    if msg_type != expect_type:
        raise WrongMessageType(
            f"expected msg type {expect_type}, got {msg_type}")
    _need(payload, 0, 4, "leaf count")
    (n,) = struct.unpack_from("<I", payload, 0)
    off, leaves = 4, []
    for _ in range(n):
        a, off = _unpack_array(payload, off)
        leaves.append(a)
    if off != len(payload):
        raise LengthMismatch(
            f"{len(payload) - off} trailing bytes after the last leaf")
    return leaves


def pytree_frame_nbytes(tree: Any, checksum: bool = False) -> int:
    """Exact byte length of the WeightBroadcast/UpperUpdate frame for
    ``tree`` WITHOUT serializing it: header + leaf count + per-leaf
    dtype/ndim/dims head + raw bytes (+ the 4-byte CRC trailer). Equal to
    ``len(WeightBroadcast(tree).encode(checksum))`` by construction."""
    total = HEADER_BYTES + 4 + (CRC_BYTES if checksum else 0)
    for a in tree_leaves(tree):
        if isinstance(a, torch.Tensor):
            itemsize = a.element_size()
            _dtype_code(a.dtype)
        else:
            a = np.asarray(a)
            itemsize = a.dtype.itemsize
            _dtype_code(a.dtype)
        total += 2 + 4 * a.ndim + int(np.prod(a.shape, dtype=np.int64)) \
            * itemsize
    return total


@dataclass
class WeightBroadcast:
    """server -> client: the global model W_G(t-1) the cohort trains from."""
    params: Any

    MSG_TYPE = MSG_WEIGHT_BROADCAST

    def encode(self, checksum: bool = False) -> bytes:
        """Tree -> wire frame: header + per-leaf (dtype code, ndim, dims,
        native-dtype bytes); ``checksum`` appends the CRC32 trailer."""
        return _encode_pytree(self.MSG_TYPE, self.params, checksum=checksum)

    @classmethod
    def decode(cls, wire: bytes) -> List[torch.Tensor]:
        """Wire frame -> CPU tensor leaves in encode order (see
        ``unflatten_like``). Raises transport errors on malformed bytes."""
        return _decode_pytree(wire, cls.MSG_TYPE)


@dataclass
class UpperUpdate:
    """client -> server: the locally-updated weights entering Eq. 2."""
    params: Any

    MSG_TYPE = MSG_UPPER_UPDATE

    def encode(self, checksum: bool = False) -> bytes:
        """Same layout as ``WeightBroadcast.encode``, under the UpperUpdate
        message type byte."""
        return _encode_pytree(self.MSG_TYPE, self.params, checksum=checksum)

    @classmethod
    def decode(cls, wire: bytes) -> List[torch.Tensor]:
        """Wire frame -> CPU tensor leaves (encode order); transport errors
        on malformed bytes."""
        return _decode_pytree(wire, cls.MSG_TYPE)


@dataclass
class SelectedKnowledge:
    """client -> server: the §3.1 selection output. ``acts`` is the fixed
    ``num_classes*clusters_per_class``-slot tensor (any device), ``valid``
    marks the non-empty slots; only valid rows are encoded. ``pre`` is a
    pre-quantized payload from the cohort's batched quantize (the codec's
    own quantize is then skipped: the same bytes either way)."""
    acts: torch.Tensor                         # (CK, *map_shape)
    labels: Any                                # (CK,) int
    valid: Any                                 # (CK,) bool
    codec: TensorCodec = field(default_factory=lambda: get_codec("raw_f32"))
    pre: Optional[Quantized] = None            # the cohort's batched quantize

    MSG_TYPE = MSG_SELECTED_KNOWLEDGE

    def encode(self, checksum: bool = False) -> bytes:
        """Selection triple -> wire frame. Body after the common header:
        ``<IIB`` (CK, nvalid, ndim of the map shape), the map dims as
        ``<I`` each, one label-dtype code byte, the packed valid bitmask,
        ``<H``-length-prefixed codec params, the valid labels, then the
        codec's row payload."""
        labels = (self.labels.detach().cpu().numpy()
                  if isinstance(self.labels, torch.Tensor)
                  else np.asarray(self.labels))
        valid = (self.valid.detach().cpu().numpy()
                 if isinstance(self.valid, torch.Tensor)
                 else np.asarray(self.valid)).astype(bool)
        shape = tuple(self.acts.shape)
        ck, map_shape = shape[0], shape[1:]
        flat = self.acts.reshape(ck, -1)
        payload_rows, params = self.codec.encode(flat, valid, pre=self.pre)
        head = struct.pack("<IIB", ck, int(valid.sum()), len(map_shape))
        head += struct.pack(f"<{len(map_shape)}I", *map_shape)
        head += struct.pack("<B", _dtype_code(labels.dtype))
        head += np.packbits(valid).tobytes()
        head += struct.pack("<H", len(params)) + params
        head += np.ascontiguousarray(labels[valid]).tobytes()
        return _pack_header(self.MSG_TYPE, self.codec.code,
                            head + payload_rows, checksum=checksum)

    @classmethod
    def decode(cls, wire: bytes):
        """-> (acts (nvalid, *map_shape) f32, labels (nvalid,), valid
        (nvalid,) all-True), as CPU tensors: exactly what the server
        received (the invalid slots never crossed the wire). Every
        malformation raises a ``FrameError`` subclass."""
        msg_type, codec_code, payload = _unpack_header(wire)
        if msg_type != cls.MSG_TYPE:
            raise WrongMessageType(
                f"expected SelectedKnowledge, got {msg_type}")
        codec = codec_by_code(codec_code)
        _need(payload, 0, 9, "knowledge head")
        ck, nvalid, ndim = struct.unpack_from("<IIB", payload, 0)
        off = 9
        _need(payload, off, 4 * ndim, "map shape")
        map_shape = struct.unpack_from(f"<{ndim}I", payload, off)
        off += 4 * ndim
        _need(payload, off, 1, "label dtype code")
        (lab_code,) = struct.unpack_from("<B", payload, off)
        off += 1
        if lab_code >= len(_DTYPES) or _DTYPES[lab_code][0] is torch.bfloat16:
            raise UnknownDtype(f"label dtype code {lab_code} is not an "
                               f"integer code of the wire table")
        nbitmap = (ck + 7) // 8
        _need(payload, off, nbitmap, "validity bitmap")
        valid = np.unpackbits(
            np.frombuffer(payload, np.uint8, nbitmap, off),
            count=ck).astype(bool)
        off += nbitmap
        if int(valid.sum()) != nvalid:
            raise LengthMismatch(
                f"frame bitmap popcount {int(valid.sum())} != {nvalid}")
        _need(payload, off, 2, "codec param length")
        (nparams,) = struct.unpack_from("<H", payload, off)
        off += 2
        _need(payload, off, nparams, "codec params")
        params = payload[off:off + nparams]
        off += nparams
        lab_dt = _DTYPES[lab_code][1]
        _need(payload, off, nvalid * lab_dt.itemsize, "labels")
        labels = np.frombuffer(payload, lab_dt, nvalid, off).copy()
        off += nvalid * lab_dt.itemsize
        d = 1                            # Python ints: no corrupt-dim overflow
        for s in map_shape:
            d *= int(s)
        rows = codec.decode(payload[off:], nvalid, d, params)
        acts = rows.reshape((nvalid,) + tuple(map_shape))
        return (torch.from_numpy(acts), torch.from_numpy(labels),
                torch.ones((nvalid,), dtype=torch.bool))
