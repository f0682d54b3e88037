"""internvl2-1b — InternViT frontend (stub) + Qwen2-0.5B-style backbone.
[arXiv:2404.16821; hf]

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The modality
frontend is a STUB per the assignment: input_specs() provides precomputed
patch embeddings (256 tokens x 1024, InternViT-300M width) which a 2-layer
projector maps into the LM.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655, head_dim=64,
    qkv_bias=True, mlp="swiglu", norm="rmsnorm",
    rope_theta=1e6, tie_embeddings=True,
    frontend="vit_stub", frontend_dim=1024, n_frontend_tokens=256,
)

REDUCED = ModelConfig(
    name="internvl2-1b-smoke", family="vlm",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=192, vocab=512, head_dim=16,
    qkv_bias=True, mlp="swiglu", norm="rmsnorm",
    rope_theta=1e6, tie_embeddings=True,
    frontend="vit_stub", frontend_dim=64, n_frontend_tokens=8,
)
