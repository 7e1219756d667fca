"""Architecture configuration schema + the assigned input-shape sets."""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "shape_for"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture from the assigned pool (exact public configs)."""

    name: str
    family: str                   # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # --- attention flavour -------------------------------------------------
    attn_kind: str = "gqa"        # gqa | mla | none
    rope_fraction: float = 1.0    # partial rotary (chatglm 0.5, stablelm 0.25)
    window: int | None = None     # sliding-window attention (mixtral)
    qk_norm: bool = False         # chameleon
    head_dim: int | None = None   # override d_model // n_heads

    # --- MLP flavour --------------------------------------------------------
    mlp_kind: str = "swiglu"      # swiglu | gelu | geglu | none
    norm_kind: str = "rmsnorm"    # rmsnorm | layernorm

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0   # deepseek: layer 0 is a dense MLP
    d_ff_dense: int = 0           # ff width of those dense layers

    # --- MLA (deepseek) -----------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- hybrid / recurrent -------------------------------------------------
    #: layer pattern, e.g. ("rglru", "rglru", "local") for recurrentgemma,
    #: ("mlstm", "slstm") for xlstm; empty = all "attn".
    pattern: tuple[str, ...] = ()
    lru_width: int = 0
    local_window: int = 0
    conv_width: int = 4

    # --- encoder-decoder (whisper) -------------------------------------------
    n_encoder_layers: int = 0
    encoder_len: int = 1500       # precomputed audio-frame embeddings (stub)

    # --- misc ----------------------------------------------------------------
    max_seq: int = 524_288
    tie_embeddings: bool = False
    subquadratic: bool = False    # eligible for long_500k
    notes: str = ""
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        hd = self.resolved_head_dim
        for i in range(self.n_layers):
            kind = (self.pattern[i % len(self.pattern)]
                    if self.pattern else "attn")
            if kind in ("attn", "local"):
                if self.attn_kind == "mla":
                    q = (d * self.q_lora_rank + self.q_lora_rank *
                         self.n_heads * (self.qk_nope_dim + self.qk_rope_dim))
                    kv = (d * (self.kv_lora_rank + self.qk_rope_dim)
                          + self.kv_lora_rank * self.n_heads *
                          (self.qk_nope_dim + self.v_head_dim))
                    o = self.n_heads * self.v_head_dim * d
                    total += q + kv + o
                else:
                    total += d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                        + self.n_heads * hd * d
            elif kind == "rglru":
                w = self.lru_width or d
                total += 2 * d * w + w * d + self.conv_width * w + 2 * w
            elif kind in ("mlstm", "slstm"):
                total += 4 * d * d + 2 * d * 2 * d
            # mlp
            if self.n_experts and i >= self.first_dense_layers:
                e_ff = self.d_ff_expert or self.d_ff
                n_e = self.n_experts + self.n_shared_experts
                total += n_e * 3 * d * e_ff + d * self.n_experts
            elif self.mlp_kind != "none":
                ff = (self.d_ff_dense if self.n_experts
                      and i < self.first_dense_layers else self.d_ff)
                mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                total += mult * d * ff
        # encoder (whisper)
        for _ in range(self.n_encoder_layers):
            total += 4 * d * d + 2 * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        e_ff = self.d_ff_expert or self.d_ff
        moe_layers = self.n_layers - self.first_dense_layers
        all_exp = moe_layers * (self.n_experts + self.n_shared_experts) \
            * 3 * d * e_ff
        act_exp = moe_layers * (self.top_k + self.n_shared_experts) \
            * 3 * d * e_ff
        return full - all_exp + act_exp


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_for(name: str) -> ShapeSpec:
    return SHAPES[name]
