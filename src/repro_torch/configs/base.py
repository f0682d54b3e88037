"""Model / runtime configuration dataclasses shared by all architectures."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | vlm | hybrid | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None          # default d_model // n_heads
    qkv_bias: bool = False               # qwen1.5
    attn_out_bias: bool = False
    mlp: str = "swiglu"                  # swiglu | gelu
    mlp_bias: bool = False               # starcoder2
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    qk_norm: bool = False                # qwen3
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    moe_dense_residual: bool = False     # arctic: dense MLP in parallel
    moe_dense_ff: int = 0                # width of that dense MLP
    moe_capacity_factor: float = 1.25
    # --- MLA (minicpm3) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba2 / zamba2) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # --- hybrid (zamba2) ---
    attn_every: int = 0                  # shared attn block every k blocks
    shared_lora_rank: int = 0            # per-site LoRA on the shared block
    # --- enc-dec / frontends ---
    encdec: bool = False
    enc_layers: int = 0
    frontend: str | None = None          # vit_stub | audio_stub
    frontend_dim: int = 0                # stub embedding dim
    n_frontend_tokens: int = 0           # image tokens (vlm)
    # --- scaling tweaks ---
    scale_emb: float = 1.0               # minicpm3 mup-ish embedding scale
    scale_depth: float = 0.0             # residual scale = scale_depth/sqrt(2L)
    # Megatron-style vocab padding: embedding/head rows padded so the vocab
    # axis shards evenly over model x data (ZeRO) axes; padded logits are
    # masked to -inf, labels always < vocab.
    vocab_pad_multiple: int = 256

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def residual_scale(self) -> float:
        if self.scale_depth <= 0:
            return 1.0
        return self.scale_depth / (2.0 * self.n_layers) ** 0.5

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k cells run only for sub-quadratic families."""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Mesh-/shape-dependent runtime knobs (not part of the architecture)."""

    tp: int = 1                 # model-axis size (for head padding/sharding)
    dp: int = 1                 # data-axis size (MoE stripe dispatch)
    remat: str = "block"        # none | block — checkpoint each scanned block
    microbatches: int = 1       # gradient-accumulation steps inside train_step
    attn_chunk: int = 1024      # KV chunk for memory-efficient attention
    seq_shard_decode: bool = False   # flash-decode with seq-sharded cache
    capacity_factor: float | None = None
    # XLA's SPMD partitioner CHECK-crashes on vocab-sharded gathers inside
    # a partially-manual region (cross-pod compressed training); the
    # one-hot-matmul embedding avoids the gather entirely.
    embed_via_matmul: bool = False

    def padded_heads(self, n: int) -> int:
        """Zero-padded head count divisible by tp (exact-math padding: the
        extra heads have zero output-projection rows)."""
        return -(-n // self.tp) * self.tp
