"""Architecture + shape configuration system.

Every assigned architecture is expressed as an ``ArchConfig``; every assigned
input shape as a ``ShapeSpec``.  The pair (ArchConfig, ShapeSpec) fully
determines a dry-run cell.  ``reduced()`` produces the CPU-smoke-test variant
of an architecture (same family / block pattern, tiny dims).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # --- attention ---
    attn_pattern: str = "full"     # full | sliding_global
    window_size: int = 0           # sliding window length (gemma3 local layers)
    local_global_ratio: int = 0    # N local : 1 global (gemma3: 5)
    qkv_bias: bool = False
    rope: str = "rope"             # rope | mrope | none
    rope_theta: float = 1e4
    rope_theta_global: float = 0.0 # gemma3 global layers use a larger theta

    # --- mlp ---
    mlp_type: str = "gated_silu"   # gated_silu | squared_relu | gelu

    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1             # MoE on layers where idx % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # --- hybrid / ssm (jamba mamba mixer) ---
    attn_every: int = 0            # 0 = attention everywhere; else attention on
    attn_offset: int = 0           #   layers where idx % attn_every == attn_offset
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    # --- xlstm ---
    slstm_every: int = 0           # sLSTM on layers where idx % slstm_every == 0
    mixer: str = "attn"            # attn | mamba_pattern | xlstm_pattern

    # --- enc-dec (whisper) ---
    enc_layers: int = 0            # >0 -> encoder-decoder; n_layers = decoder layers

    # --- vlm (qwen2-vl) ---
    vision_prefix: int = 0         # number of stub patch-embedding positions

    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    lr_schedule: str = "cosine"    # cosine | wsd
    cache_dtype: str = "bf16"      # bf16 | f32 — KV/recurrent-state storage
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def cache_jdtype(self):
        import torch
        return torch.float32 if self.cache_dtype == "f32" else torch.bfloat16

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 so the vocab dim shards
        cleanly on TP axes (standard practice; logits over pad ids are
        never targets)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        pattern = _pattern_period(self)
        n_layers = max(pattern * 1, 2)
        if self.enc_layers:
            n_layers = 2
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            capacity_factor=8.0,   # no capacity drops at smoke-test scale
            window_size=min(self.window_size, 8) if self.window_size else 0,
            enc_layers=2 if self.enc_layers else 0,
            vision_prefix=4 if self.vision_prefix else 0,
            d_state=8,
            expand=2,
        )


def _pattern_period(cfg: ArchConfig) -> int:
    """Smallest repeating block-pattern unit length."""
    period = 1
    if cfg.mixer == "mamba_pattern" and cfg.attn_every:
        period = _lcm(period, cfg.attn_every)
    if cfg.mixer == "xlstm_pattern" and cfg.slstm_every:
        period = _lcm(period, cfg.slstm_every)
    if cfg.n_experts and cfg.moe_every > 1:
        period = _lcm(period, cfg.moe_every)
    if cfg.local_global_ratio:
        period = _lcm(period, cfg.local_global_ratio + 1)
    return period


def _lcm(a: int, b: int) -> int:
    from math import gcd
    return a * b // gcd(a, b)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_training(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}

# long_500k requires sub-quadratic / windowed / recurrent attention memory.
# Skips recorded in DESIGN.md §Arch-applicability.
LONG_CONTEXT_ARCHS = {"jamba-1.5-large-398b", "xlstm-1.3b", "gemma3-27b"}


def applicable_shapes(arch_name: str) -> list[str]:
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_name in LONG_CONTEXT_ARCHS:
        shapes.append("long_500k")
    return shapes
