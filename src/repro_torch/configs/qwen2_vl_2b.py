"""Qwen2-VL-2B — M-RoPE, dynamic resolution; vision frontend STUB.
[arXiv:2409.12191; hf]

The ViT frontend is a stub: ``input_specs()`` provides precomputed patch
embeddings for the first ``vision_prefix`` positions; M-RoPE assigns
(temporal, height, width) position ids over that prefix and ordinary text
positions afterwards.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    rope="mrope",
    rope_theta=1e6,
    vision_prefix=1024,           # stub patch-grid 1x32x32 at the sequence head
    mlp_type="gated_silu",
    notes="M-RoPE (t/h/w section rotary); vision patches stubbed",
)
