"""mixtral-8x22b [moe] — 8 experts top-2, SWA. [arXiv:2401.04088; hf]"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32_768,
    attn_kind="gqa",
    window=4096,             # SWA per the assignment line
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    n_experts=8,
    top_k=2,
    d_ff_expert=16384,
    subquadratic=True,       # SWA bounds the KV cache -> long_500k runs
    source="arXiv:2401.04088; hf",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, d_ff_expert=128, vocab=256, n_experts=4, top_k=2,
        window=32)
