"""whisper-tiny [audio] — enc-dec, conv frontend (STUB: precomputed frame
embeddings). [arXiv:2212.04356; unverified]"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,              # decoder layers
    n_encoder_layers=4,
    encoder_len=1500,        # 30 s of audio at 50 Hz after the conv stub
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51_865,
    attn_kind="gqa",
    rope_fraction=0.0,       # learned positional embeddings
    mlp_kind="gelu",
    norm_kind="layernorm",
    subquadratic=False,
    source="arXiv:2212.04356; unverified",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, encoder_len=16,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256)
