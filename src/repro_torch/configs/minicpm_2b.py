"""MiniCPM-2B — dense llama-like, WSD schedule. [arXiv:2404.06395; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,            # GQA kv=36 (== n_heads -> MHA)
    d_ff=5760,
    vocab_size=122_753,
    head_dim=64,
    mlp_type="gated_silu",
    rope="rope",
    rope_theta=1e4,
    tie_embeddings=True,
    lr_schedule="wsd",        # warmup-stable-decay
    notes="llama-like; WSD schedule per the MiniCPM recipe",
)
