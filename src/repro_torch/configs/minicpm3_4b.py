"""minicpm3-4b — dense, MLA (multi-head latent attention).

[hf:openbmb/MiniCPM3-4B; hf]  62L d_model=2560 40H (kv=40) d_ff=6400
vocab=73448.  MLA dims and the mup-style scale_emb/scale_depth follow the
HF config.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448, head_dim=64,
    mla=True, q_lora_rank=768, kv_lora_rank=256,
    qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
    rope_theta=10000.0, tie_embeddings=True,
    scale_emb=12.0, scale_depth=1.4,
)

REDUCED = ModelConfig(
    name="minicpm3-4b-smoke", family="dense",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=320, vocab=512, head_dim=32,
    mla=True, q_lora_rank=48, kv_lora_rank=32,
    qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
    rope_theta=10000.0, tie_embeddings=True,
    scale_emb=12.0, scale_depth=1.4,
)
