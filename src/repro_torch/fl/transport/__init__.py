"""repro_torch.fl.transport — wire frames, codecs and the charging channel
(the counterpart of ``repro.fl.transport``; frames are byte-identical).

  ``messages``  WeightBroadcast / SelectedKnowledge / UpperUpdate frames
  ``codecs``    raw_f32 / f16 / int8 (int8 quantizes with the CUDA kernel
                on the card, its plain version on the CPU)
  ``channel``   the perfect wire that charges every frame's exact bytes
  ``errors``    the typed ``FrameError`` family of the decode side
"""
from repro_torch.fl.transport.channel import Channel
from repro_torch.fl.transport.codecs import (Int8Codec, TensorCodec,
                                             codec_by_code, get_codec)
from repro_torch.fl.transport.errors import (BadMagic, BadVersion,
                                             ChecksumMismatch, FrameError,
                                             LengthMismatch, TruncatedFrame,
                                             UnknownCodec, UnknownDtype,
                                             WrongMessageType)
from repro_torch.fl.transport.messages import (CRC_BYTES, HEADER_BYTES,
                                               SelectedKnowledge, UpperUpdate,
                                               WeightBroadcast,
                                               pytree_frame_nbytes,
                                               tree_leaves, unflatten_like)

__all__ = [
    "BadMagic", "BadVersion", "CRC_BYTES", "Channel", "ChecksumMismatch",
    "FrameError", "HEADER_BYTES", "Int8Codec", "LengthMismatch",
    "SelectedKnowledge", "TensorCodec", "TruncatedFrame", "UnknownCodec",
    "UnknownDtype", "UpperUpdate", "WeightBroadcast", "WrongMessageType",
    "codec_by_code", "get_codec", "pytree_frame_nbytes",
    "tree_leaves", "unflatten_like",
]
