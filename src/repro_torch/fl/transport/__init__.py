"""repro_torch.fl.transport — wire frames, codecs and the charging channel
(the counterpart of ``repro.fl.transport``; frames are byte-identical).

  ``messages``  WeightBroadcast / SelectedKnowledge / UpperUpdate frames
  ``codecs``    raw_f32 / f16 / int8 (int8 quantizes with the CUDA kernel
                on the card, its plain version on the CPU); ``Quantized``
                carries a payload through the cohort's batched quantize
  ``channel``   the perfect wire that charges every frame's exact bytes,
                with the cohort's batched knowledge upload, and the
                reference's module-level helpers over a ledger
  ``errors``    the typed ``FrameError`` family of the decode side
"""
from repro_torch.fl.transport.channel import (Channel, broadcast_weights,
                                              knowledge_codec,
                                              prequantize_cohort,
                                              upload_knowledge,
                                              upload_knowledge_batched,
                                              upload_update)
from repro_torch.fl.transport.codecs import (Int8Codec, Quantized,
                                             TensorCodec, codec_by_code,
                                             get_codec)
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
    "Quantized", "SelectedKnowledge", "TensorCodec", "TruncatedFrame",
    "UnknownCodec", "UnknownDtype", "UpperUpdate", "WeightBroadcast",
    "WrongMessageType", "broadcast_weights", "codec_by_code", "get_codec",
    "knowledge_codec", "prequantize_cohort", "pytree_frame_nbytes",
    "tree_leaves", "unflatten_like", "upload_knowledge",
    "upload_knowledge_batched", "upload_update",
]
