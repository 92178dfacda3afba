"""Qwen2-72B — dense GQA, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29_568,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    mlp_type="gated_silu",
    rope="rope",
    rope_theta=1e6,
    notes="GQA kv=8, QKV bias",
)
