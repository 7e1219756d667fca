"""chameleon-34b [vlm] — early-fusion, VQ image tokens (frontend STUB:
image tokens arrive pre-quantised in the vocab). [arXiv:2405.09818;
unverified]"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65_536,
    attn_kind="gqa",
    qk_norm=True,            # chameleon's QK-norm for stability
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    subquadratic=False,
    source="arXiv:2405.09818; unverified",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256)
