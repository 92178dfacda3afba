"""Jamba-1.5-Large (398B) — Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    head_dim=128,
    mixer="mamba_pattern",
    attn_every=8,                 # 1 attention layer per 8 (1:7 attn:mamba)
    attn_offset=4,
    n_experts=16,
    top_k=2,
    moe_every=2,                  # MoE on every other layer
    moe_offset=1,
    d_state=16,
    d_conv=4,
    expand=2,
    mlp_type="gated_silu",
    rope="none",                  # jamba uses no positional encoding in attn layers
    notes="Mamba mixer with attention every 8th layer; MoE every 2nd layer",
)
