"""gemma3-4b [dense] — 5:1 local:global sliding-window attention, 128k ctx.
[hf:google/gemma-3-1b-pt family card; assignment row: 34L d_model=2560 8H
(GQA kv=4) d_ff=10240 vocab=262144]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262_144,
    sliding_window=1024,
    local_global_pattern=(5, 1),   # 5 local layers then 1 global, repeating
    rope_theta=1_000_000.0,
    act="gelu",
    tie_embeddings=True,
    long_context_mode="native",    # SWA is native -> long_500k runs as-is
)
