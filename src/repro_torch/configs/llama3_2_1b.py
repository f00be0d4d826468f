"""llama3.2-1b [dense] — small llama3.
[hf:meta-llama/Llama-3.2-1B; assignment row: 16L d_model=2048 32H (GQA kv=8)
d_ff=8192 vocab=128256]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    arch_type="dense",
    source="hf:meta-llama/Llama-3.2-1B",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    rope_theta=500_000.0,
    tie_embeddings=True,
    long_context_mode="swa",
)
