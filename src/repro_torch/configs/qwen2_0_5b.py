"""qwen2-0.5b [dense] — GQA with QKV bias.
[arXiv:2407.10671; assignment row: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    arch_type="dense",
    source="arXiv:2407.10671",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    long_context_mode="swa",
)
