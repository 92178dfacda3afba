"""DBRX (132B) — fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10_752,
    vocab_size=100_352,
    head_dim=128,
    n_experts=16,
    top_k=4,
    moe_every=1,                  # every layer is MoE
    mlp_type="gated_silu",
    rope="rope",
    rope_theta=5e5,
    notes="16 experts top-4, fine-grained",
)
