"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e
top-2. [arXiv:2403.19887; assignment row: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2]

Superblock = 8 layers: 7 mamba + 1 attention (1:7); MoE replaces the dense
FFN every 2nd layer (moe_layer_period=2). long_500k RUNS: mamba layers carry
constant state; the 9 attention layers carry the full KV cache (sequence-
sharded — see DESIGN.md §6)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,                    # per-expert width (and dense-FFN width)
    vocab_size=65_536,
    num_experts=16,
    num_experts_per_tok=2,
    moe_layer_period=2,
    block_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
    rope_theta=0.0,                # jamba: no positional encoding on attn layers
    tie_embeddings=False,
    long_context_mode="native",
)
