"""Gemma3-27B — 5:1 local:global sliding-window attention, 128k. [hf:google/gemma-3]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21_504,
    vocab_size=262_144,
    head_dim=128,
    attn_pattern="sliding_global",
    window_size=1024,
    local_global_ratio=5,          # 5 local : 1 global
    mlp_type="gated_silu",
    rope="rope",
    rope_theta=1e4,                # local layers
    rope_theta_global=1e6,         # global layers
    tie_embeddings=True,
    notes="5:1 local:global; local layers keep a 1024-token sliding KV window",
)
