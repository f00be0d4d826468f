"""internvl2-26b [vlm] — InternViT vision frontend (STUBBED: input_specs
provides precomputed patch embeddings) + InternLM2 decoder backbone.
[arXiv:2404.16821; assignment row: 48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    source="arXiv:2404.16821",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92_553,             # padded to 92672 for model-axis sharding
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    frontend="vision_stub",
    num_prefix_tokens=256,         # ViT patch tokens prepended to the text seq
    long_context_mode="swa",
)
