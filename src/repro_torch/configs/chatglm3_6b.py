"""chatglm3-6b [dense] — RoPE 2d (half-rotary), GQA. [arXiv:2406.12793; hf]"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65_024,
    attn_kind="gqa",
    rope_fraction=0.5,       # 2d/partial rotary
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    subquadratic=False,
    source="arXiv:2406.12793; hf",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256)
