"""xLSTM-1.3B — sLSTM + mLSTM blocks (7:1). [arXiv:2405.04517]

d_ff = 0: the mLSTM/sLSTM blocks carry their own up/down projections
(pre-up-projection mLSTM, post-up-projection sLSTM per the paper).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    head_dim=512,
    mixer="xlstm_pattern",
    slstm_every=8,                # xLSTM[7:1] -> 1 sLSTM per 8 blocks
    expand=2,
    rope="none",
    notes="mLSTM (chunkwise-parallel linear attention) + sLSTM (recurrent scan)",
)
