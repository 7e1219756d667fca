"""starcoder2-3b [dense] — GQA, RoPE. [arXiv:2402.19173; hf]"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49_152,
    attn_kind="gqa",
    mlp_kind="gelu",
    norm_kind="layernorm",
    subquadratic=False,
    source="arXiv:2402.19173; hf",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256)
