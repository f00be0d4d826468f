"""whisper-medium [audio] — encoder-decoder; mel-spectrogram + conv frontend
STUBBED (input_specs provides precomputed frame embeddings, 1500 frames).
[arXiv:2212.04356; assignment row: 24L d_model=1024 16H (kv=16) d_ff=4096
vocab=51865]

long_500k is SKIPPED for this arch (DESIGN.md §5): the family's decoder
context envelope (448 learned positions; 1500-frame encoder) does not extend
to 524k decode positions. decode_32k exercises the decoder self-attention KV
cache + cross-attention to the stubbed encoder output.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    source="arXiv:2212.04356",
    num_layers=24,                 # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,               # MHA
    d_ff=4096,
    vocab_size=51_865,             # padded to 51968
    is_encoder_decoder=True,
    encoder_seq_len=1500,
    frontend="audio_stub",
    act="gelu",
    rope_theta=0.0,                # whisper uses absolute positions (sinusoidal here)
    tie_embeddings=True,
    long_context_mode="skip",
)
