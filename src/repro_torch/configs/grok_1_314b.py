"""Grok-1 (314B) — MoE, 8 experts top-2. [hf:xai-org/grok-1]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    head_dim=128,
    n_experts=8,
    top_k=2,
    moe_every=1,
    mlp_type="gated_silu",
    rope="rope",
    rope_theta=1e4,
    notes="8 experts top-2; experts replicated / d_ff TP-sharded (8 % 16 != 0)",
)
