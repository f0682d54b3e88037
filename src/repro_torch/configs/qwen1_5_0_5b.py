"""qwen1.5-0.5b — dense MHA with QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]

24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936, head_dim=64,
    qkv_bias=True, mlp="swiglu", norm="rmsnorm",
    rope_theta=1e6, tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="qwen1.5-0.5b-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=6,
    d_ff=192, vocab=512, head_dim=16,
    qkv_bias=True, mlp="swiglu", norm="rmsnorm",
    rope_theta=1e6, tie_embeddings=True,
)
