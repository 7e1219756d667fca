"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2 pattern.
[arXiv:2402.19427; hf]"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,             # (rglru, rglru, local) x 8 + 2 rglru
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,            # MQA in the local-attention layers
    d_ff=7680,
    vocab=256_000,
    attn_kind="gqa",
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    pattern=("rglru", "rglru", "local"),
    lru_width=2560,
    local_window=2048,
    conv_width=4,
    subquadratic=True,       # recurrent state + windowed attention
    source="arXiv:2402.19427; hf",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=256, lru_width=64, local_window=32)
