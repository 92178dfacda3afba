"""Whisper-medium — encoder-decoder, conv frontend STUB. [arXiv:2212.04356]

The modality frontend (log-mel + conv) is a stub per the assignment:
``input_specs()`` provides precomputed frame embeddings of shape
(batch, enc_len, d_model).  Shape cells split seq_len as enc_len = dec_len =
seq_len // 2 so each cell's total token positions match the LM shapes
(documented in DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,                  # decoder layers
    enc_layers=24,                # encoder layers (true whisper-medium is 24+24)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    head_dim=64,
    mlp_type="gelu",
    rope="none",                  # whisper uses learned/sinusoidal abs positions
    notes="enc-dec; conv frontend stubbed as precomputed frame embeddings",
)
