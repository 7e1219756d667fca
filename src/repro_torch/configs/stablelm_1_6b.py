"""stablelm-1.6b [dense] — MHA, partial RoPE.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,           # full MHA per the assignment (kv=32)
    d_ff=5632,
    vocab=100_352,
    attn_kind="gqa",
    rope_fraction=0.25,      # stablelm-2 partial rotary
    mlp_kind="swiglu",
    norm_kind="layernorm",
    subquadratic=False,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256)
