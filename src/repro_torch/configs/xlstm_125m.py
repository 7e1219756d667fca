"""xlstm-125m [ssm] — alternating mLSTM / sLSTM blocks (d_ff=0: the
blocks carry their own projections). [arXiv:2405.04517; unverified]"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50_304,
    attn_kind="none",
    mlp_kind="none",
    norm_kind="layernorm",
    pattern=("mlstm", "slstm"),
    subquadratic=True,       # recurrent state only
    source="arXiv:2405.04517; unverified",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=2, vocab=256)
