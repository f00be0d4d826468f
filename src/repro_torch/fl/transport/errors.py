"""Typed frame errors — the decode side's contract with the runtime.

A copy of ``repro.fl.transport.errors`` (the port imports nothing of
``repro``); the names and the hierarchy are the same on both sides.

Every way a wire buffer can fail to decode maps to ONE exception family,
``FrameError``, so callers (the round engines, the tests, and in the
reference the retry loop of ``repro.fl.faults``) can distinguish "the network mangled this
frame, retransmission may help" from a genuine protocol bug — and never
see a raw ``struct.error`` / ``IndexError`` / numpy ``ValueError`` escape
the decoder (the pre-hierarchy crash modes).

``FrameError`` subclasses ``ValueError`` so existing callers that caught
the decoder's old ad-hoc ``ValueError``s keep working unchanged.

The taxonomy, roughly in the order decode hits them:

  TruncatedFrame    the buffer ends before a field it promises
  BadMagic          the first 4 bytes are not b"FLTP"
  BadVersion        a version (or flag bit) this decoder does not speak
  ChecksumMismatch  the CRC32 trailer disagrees with the received bytes
  WrongMessageType  a valid frame of a different message type
  UnknownCodec      the header names a codec wire id we don't have
  UnknownDtype      an array block names a dtype code off the table
  LengthMismatch    internal lengths disagree (payload vs header length,
                    bitmap popcount vs valid count, codec payload vs the
                    row count it must reconstruct, trailing garbage)

Retriability: every subclass can be caused by in-flight corruption of a
well-formed frame, so the fault runtime treats the whole family as
retriable; distinguishing systematic peer bugs (e.g. persistent
BadVersion) is the caller's policy, via the type.
"""
from __future__ import annotations


class FrameError(ValueError):
    """A wire buffer that is not a decodable frame. Base of the family —
    catch this to mean 'corrupt or foreign bytes', not a programming
    error."""


class TruncatedFrame(FrameError):
    """The buffer is shorter than a length it declares (or than the fixed
    header itself)."""


class BadMagic(FrameError):
    """The frame does not start with the FLTP magic."""


class BadVersion(FrameError):
    """A frame version (or flags bit) this decoder does not implement."""


class ChecksumMismatch(FrameError):
    """The CRC32 trailer does not match the received header+payload."""


class WrongMessageType(FrameError):
    """A structurally valid frame of a different message type than the
    caller asked to decode."""


class UnknownCodec(FrameError):
    """The header's codec wire id is not in the codec registry."""


class UnknownDtype(FrameError):
    """An array block's dtype code is outside the wire dtype table."""


class LengthMismatch(FrameError):
    """Two lengths that must agree do not (header vs payload, bitmap
    popcount vs valid count, codec payload vs expected row bytes,
    trailing garbage after the last field)."""
