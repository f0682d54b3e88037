"""starcoder2-7b — dense GQA, RoPE, GELU MLP with biases, LayerNorm.
[arXiv:2402.19173; hf]  32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152, head_dim=128,
    mlp="gelu", mlp_bias=True, norm="layernorm",
    qkv_bias=True, attn_out_bias=True, rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="starcoder2-7b-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=384, vocab=512, head_dim=16,
    mlp="gelu", mlp_bias=True, norm="layernorm",
    qkv_bias=True, attn_out_bias=True, rope_theta=1e6,
)
