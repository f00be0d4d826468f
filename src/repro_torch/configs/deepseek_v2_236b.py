"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared / 160 routed top-6.
[arXiv:2405.04434; assignment row: 60L d_model=5120 128H d_ff=1536(per expert)
vocab=102400, MoE 160e top-6]

long_500k runs in SWA-variant mode for the dry-run: MLA decode over the
compressed (kv_lora+rope)-dim cache is O(T) per token; the cache is sequence-
sharded over the data axis."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,              # MLA: per-head keys reconstructed from latent
    head_dim=192,                  # qk_nope(128)+qk_rope(64)
    d_ff=1536,                     # per routed expert
    vocab_size=102_400,
    attention_kind="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=160,
    num_experts_per_tok=6,
    num_shared_experts=2,
    first_dense_layers=1,
    tie_embeddings=False,
    long_context_mode="swa",
)
