"""granite-8b [dense] — llama-arch, code. [arXiv:2405.04324; hf]"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49_152,
    attn_kind="gqa",
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    subquadratic=False,
    source="arXiv:2405.04324; hf",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256)
