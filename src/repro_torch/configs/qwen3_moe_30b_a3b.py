"""qwen3-moe-30b-a3b [moe] — 128 experts, top-8 routing, GQA.
[hf:Qwen/Qwen3-30B-A3B; assignment row: 48L d_model=2048 32H (GQA kv=4)
d_ff=768(per expert) vocab=151936, MoE 128e top-8]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                      # per-expert FFN width
    vocab_size=151_936,
    num_experts=128,
    num_experts_per_tok=8,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    long_context_mode="swa",
)
