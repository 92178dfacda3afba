"""Nemotron-4-15B — dense GQA, squared-ReLU MLP. [arXiv:2402.16819]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=256_000,
    head_dim=128,
    mlp_type="squared_relu",
    rope="rope",
    rope_theta=1e4,
    notes="GQA kv=8, squared-ReLU (2-matrix MLP, no gating)",
)
