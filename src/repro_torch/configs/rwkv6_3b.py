"""rwkv6-3b [ssm] — Finch: attention-free linear recurrence with
data-dependent decay. [arXiv:2404.05892; assignment row: 32L d_model=2560
(attn-free) d_ff=8960 vocab=65536]

long_500k RUNS natively (constant-size recurrent state decode)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    arch_type="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=2560,
    num_heads=40,                  # wkv heads, head_dim 64
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    block_pattern=("rwkv",),
    tie_embeddings=False,
    long_context_mode="state",
)
