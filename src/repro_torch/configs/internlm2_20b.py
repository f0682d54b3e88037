"""internlm2-20b — dense GQA.  [arXiv:2403.17297; hf]

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544, head_dim=128,
    mlp="swiglu", norm="rmsnorm", rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="internlm2-20b-smoke", family="dense",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=16,
    mlp="swiglu", norm="rmsnorm", rope_theta=1e6,
)
