"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]"""

import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,              # dense layer-0 FFN width
    d_ff_dense=12288,
    vocab=102_400,
    attn_kind="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    head_dim=192,            # qk_nope + qk_rope
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    d_ff_expert=1536,
    first_dense_layers=1,
    subquadratic=False,      # MLA is full attention -> long_500k skipped
    source="arXiv:2405.04434; hf",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, d_ff_dense=128, vocab=256, kv_lora_rank=32,
        q_lora_rank=48, qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
        head_dim=24, n_experts=8, top_k=2, n_shared_experts=1,
        d_ff_expert=32, first_dense_layers=1)
