"""Analytic roofline terms per (arch x shape): the reference's exact
count of each architecture's einsums (:mod:`repro.roofline.analytic`),
with the constants of one NVIDIA H100.

The counts are the reference's, unchanged: plain arithmetic over
``ArchConfig`` / ``ShapeSpec``, so each function returns the
reference's number exactly.  On the card the port uses
:func:`step_flops`: a train step's FLOPs over its time and
:data:`PEAK_FLOPS` give its share of the fp32 peak (``chip_smoke.py``).

Constants (NVIDIA H100 SXM5 80GB data sheet, dense rates):
    PEAK_FLOPS = 67e12 FLOP/s   fp32 on the CUDA cores, the rate the
                                port's fp32 paths (TF32 off) can reach
    PEAK_FLOPS_BF16 = 989e12    bf16 on the tensor cores: the dry run's
                                cells are bf16 (:func:`roofline_for_cell`)
    HBM_BW     = 3.35e12 B/s    HBM3
    NVLINK_BW  = 450e9 B/s      NVLink 4, one direction (18 links; 900
                                GB/s both ways), the collective term's
                                rate per card

:func:`roofline_for_cell` gives the production mesh's per-card terms
for a cell of the dry run (:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig, ShapeSpec

__all__ = ["fwd_flops", "step_flops", "analytic_hbm_bytes",
           "analytic_collective_bytes", "ctx_enc", "roofline_for_cell",
           "RooflineTerms", "PEAK_FLOPS", "PEAK_FLOPS_BF16", "HBM_BW",
           "NVLINK_BW"]

PEAK_FLOPS = 67e12
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9


# ---------------------------------------------------------------------------
# FLOPs (2mnk per matmul; attention quadratic terms averaged over causal)
# ---------------------------------------------------------------------------

def _attn_flops_per_token(cfg: ArchConfig, kind: str, ctx: float) -> float:
    d, h = cfg.d_model, cfg.n_heads
    hd = cfg.resolved_head_dim
    if cfg.attn_kind == "mla":
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        proj = 2 * (d * cfg.q_lora_rank + cfg.q_lora_rank * h * qk
                    + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                    + cfg.kv_lora_rank * h * (cfg.qk_nope_dim
                                              + cfg.v_head_dim)
                    + h * cfg.v_head_dim * d)
        attn = 2 * ctx * h * (qk + cfg.v_head_dim)
        return proj + attn
    window = cfg.local_window if kind == "local" else cfg.window
    eff_ctx = min(ctx, window) if window else ctx
    proj = 2 * d * hd * (h + 2 * cfg.n_kv_heads) + 2 * h * hd * d
    attn = 2 * eff_ctx * h * hd * 2
    return proj + attn


def _mixer_flops_per_token(cfg: ArchConfig, kind: str, ctx: float) -> float:
    d = cfg.d_model
    if kind in ("attn", "local"):
        return _attn_flops_per_token(cfg, kind, ctx)
    if kind == "rglru":
        w = cfg.lru_width or d
        # wx, wy, conv, gates (2 WxW), recurrence, wo
        return 2 * d * w * 2 + 2 * cfg.conv_width * w \
            + 2 * w * w * 2 + 10 * w + 2 * w * d
    if kind == "mlstm":
        di = 2 * d
        dh = di // cfg.n_heads
        chunk = 256.0
        return (2 * d * 2 * di + 3 * 2 * di * di + 2 * di * d
                + 2 * chunk * di * 2            # intra-chunk attention
                + 4 * cfg.n_heads * dh * dh)    # state update/query
    if kind == "slstm":
        return 2 * d * 4 * d * 2 + 2 * d * 2 * d + 2 * d * d
    raise ValueError(kind)


def _mlp_flops_per_token(cfg: ArchConfig, layer_idx: int) -> float:
    d = cfg.d_model
    if cfg.n_experts and layer_idx >= cfg.first_dense_layers:
        ff = cfg.d_ff_expert or cfg.d_ff
        experts = cfg.top_k + cfg.n_shared_experts
        return experts * 3 * 2 * d * ff + 2 * d * cfg.n_experts
    if cfg.mlp_kind == "none":
        return 0.0
    ff = (cfg.d_ff_dense if cfg.n_experts
          and layer_idx < cfg.first_dense_layers else cfg.d_ff)
    mult = 3 if cfg.mlp_kind in ("swiglu", "geglu") else 2
    return mult * 2 * d * ff


def fwd_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Forward FLOPs for the whole global batch of this shape."""
    pattern = cfg.pattern or ("attn",)
    if shape.kind == "decode":
        n_tok = float(shape.global_batch)       # one new token each
        ctx = float(shape.seq_len)
    else:
        n_tok = float(shape.tokens)
        ctx = shape.seq_len / 2.0               # causal average
    per_tok = 0.0
    for i in range(cfg.n_layers):
        kind = pattern[i % len(pattern)]
        per_tok += _mixer_flops_per_token(cfg, kind, ctx)
        per_tok += _mlp_flops_per_token(cfg, i)
    per_tok += 2 * cfg.d_model * cfg.vocab      # unembed / logits
    total = per_tok * n_tok
    if cfg.family == "audio":
        # encoder runs once per sample over encoder_len frames
        d, ff = cfg.d_model, cfg.d_ff
        enc_tok = (4 * 2 * d * d + 2 * ctx_enc(cfg) * cfg.n_heads
                   * cfg.resolved_head_dim * 2 + 2 * 2 * d * ff)
        total += (enc_tok * cfg.encoder_len * shape.global_batch
                  * cfg.n_encoder_layers)
        # cross attention per decoder token
        cross = (2 * d * d * 2 + 2 * cfg.encoder_len * cfg.n_heads
                 * cfg.resolved_head_dim * 2 + 2 * d * d)
        total += cross * n_tok * cfg.n_layers
    return total


def ctx_enc(cfg: ArchConfig) -> float:
    return cfg.encoder_len / 1.0    # non-causal: full context


def step_flops(cfg: ArchConfig, shape: ShapeSpec, *,
               remat: bool = True) -> float:
    """FLOPs of one step of this cell.

    train  : fwd + bwd (2x fwd) + remat re-forward (1x fwd) = 4x fwd
    prefill/decode: 1x fwd
    """
    f = fwd_flops(cfg, shape)
    if shape.kind == "train":
        return f * (4.0 if remat else 3.0)
    return f


# ---------------------------------------------------------------------------
# HBM traffic (per device, per step)
# ---------------------------------------------------------------------------

def analytic_hbm_bytes(cfg: ArchConfig, shape: ShapeSpec,
                       n_devices: int) -> float:
    """Per-device HBM bytes for one step (weights + states + activations).

    Weights are fully sharded (TP x FSDP); activation traffic counts one
    write + one read of each layer's residual-stream tensors in bf16.
    These are the reference's bf16 production counts: the port's fp32
    steps move more (4-byte weights and activations), so on the card
    only :func:`step_flops` is used.
    """
    params = cfg.param_count()
    p_dev = params / n_devices
    if shape.kind == "train":
        # bf16 reads fwd/bwd/remat + fp32 grad write + adam m,v rw + write
        weight_traffic = p_dev * (2 + 2 + 2 + 4 + 16 + 2)
        tok_dev = shape.tokens / n_devices
        act_traffic = tok_dev * cfg.d_model * cfg.n_layers * 2 * 8
        return weight_traffic + act_traffic
    if shape.kind == "prefill":
        weight_traffic = p_dev * 2
        tok_dev = shape.tokens / n_devices
        act_traffic = tok_dev * cfg.d_model * cfg.n_layers * 2 * 4
        return weight_traffic + act_traffic
    # decode: every active weight read once; cache read + small write
    active_dev = cfg.active_param_count() / n_devices
    cache_bytes = _cache_bytes(cfg, shape) / n_devices
    return active_dev * 2 + cache_bytes * 2


def _cache_bytes(cfg: ArchConfig, shape: ShapeSpec) -> float:
    b, s = shape.global_batch, shape.seq_len
    if cfg.attn_kind == "mla":
        per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim
        return b * s * per_tok * 2.0 * cfg.n_layers
    pattern = cfg.pattern or ("attn",)
    total = 0.0
    hd = cfg.resolved_head_dim
    for i in range(cfg.n_layers):
        kind = pattern[i % len(pattern)]
        if kind == "attn":
            eff = min(s, cfg.window) if cfg.window else s
            total += b * eff * cfg.n_kv_heads * hd * 2 * 2.0
        elif kind == "local":
            total += b * min(s, cfg.local_window) \
                * cfg.n_kv_heads * hd * 2 * 2.0
        elif kind == "rglru":
            total += b * (cfg.lru_width or cfg.d_model) * 4.0
        elif kind == "mlstm":
            di = 2 * cfg.d_model
            dh = di // cfg.n_heads
            total += b * cfg.n_heads * dh * dh * 4.0
        elif kind == "slstm":
            total += b * cfg.d_model * 4.0 * 4
    return total


# ---------------------------------------------------------------------------
# Collective traffic (per device, per step)
# ---------------------------------------------------------------------------

def analytic_collective_bytes(cfg: ArchConfig, shape: ShapeSpec,
                              mesh_shape: dict[str, int]) -> float:
    """Per-chip ICI bytes: TP activation all-reduces + FSDP weight
    gathers + DP gradient reduction + MoE all-to-alls."""
    tp = mesh_shape.get("model", 1)
    dp = 1
    for k, v in mesh_shape.items():
        if k != "model":
            dp *= v
    n_dev = tp * dp
    params = cfg.param_count()
    ring = lambda p: 2 * (p - 1) / p            # all-reduce ring factor
    gat = lambda p: (p - 1) / p                 # (all-)gather factor

    total = 0.0
    if shape.kind == "decode":
        tok_dev = shape.global_batch / dp
    else:
        tok_dev = shape.tokens / n_dev if shape.kind == "train" \
            else shape.tokens / n_dev
    act = tok_dev * cfg.d_model * 2.0           # one residual tensor bf16

    passes = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind]
    # 2 TP all-reduces per layer per pass (attn out, mlp out)
    total += cfg.n_layers * passes * ring(tp) * act

    # FSDP: gather weights fwd + bwd; reduce-scatter grads (train only)
    if shape.kind == "train":
        w_dev = params * 2.0 / tp               # bf16 shard on this tp rank
        total += 2 * gat(dp) * w_dev            # fwd + bwd gathers
        total += ring(dp) * params * 4.0 / tp   # fp32 grad reduction
    elif shape.kind == "prefill":
        total += gat(dp) * params * 2.0 / tp
    else:
        # decode: the reference's compiled HLO keeps FSDP-sharded
        # weights stationary and partial-sums the (tiny) activations over
        # the data axes instead of gathering weights: per layer one
        # extra psum of the ff-slice activations.
        total += cfg.n_layers * passes * ring(dp) * act

    # MoE all-to-all: bucket bytes out + back per MoE layer per pass
    if cfg.n_experts and shape.kind != "decode":
        moe_layers = cfg.n_layers - cfg.first_dense_layers
        cap_factor = 1.25
        bucket = tok_dev * cfg.top_k * cap_factor * cfg.d_model * 2.0
        if cfg.n_experts % tp == 0:
            total += moe_layers * passes / 2 * 2 * gat(tp) * bucket
        else:
            # expert-TP: psum of expert outputs instead
            total += moe_layers * passes / 2 * ring(tp) * bucket
    return total


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    analytic_flops: float
    hlo_flops_per_dev: float
    peak_bytes: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s) + self.collective_s

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / analytic compiled FLOPs (remat/overhead waste)."""
        return self.model_flops / max(self.analytic_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """compute term / total — 1.0 means perfectly compute-bound."""
        return self.compute_s / max(self.total_s, 1e-30)


def roofline_for_cell(cfg: ArchConfig, shape: ShapeSpec, mesh_name: str,
                      record: dict) -> RooflineTerms:
    """The per-card compute, memory and collective terms of one cell on
    the production mesh (256 cards, or 512 for ``"multi"``), with the
    traced FLOPs and peak bytes of its dry-run ``record``
    (:mod:`repro_torch.launch.dryrun`).  The reference's arithmetic,
    with the cells' bf16 rate :data:`PEAK_FLOPS_BF16` as the compute
    term's and :data:`NVLINK_BW` as the collective term's."""
    n_dev = 512 if mesh_name == "multi" else 256
    mesh_shape = ({"pod": 2, "data": 16, "model": 16}
                  if mesh_name == "multi" else {"data": 16, "model": 16})
    flops = step_flops(cfg, shape)
    hbm = analytic_hbm_bytes(cfg, shape, n_dev)
    coll = analytic_collective_bytes(cfg, shape, mesh_shape)
    n_tok = shape.tokens if shape.kind != "decode" else shape.global_batch
    factor = 6 if shape.kind == "train" else 2
    return RooflineTerms(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, n_devices=n_dev,
        compute_s=flops / (n_dev * PEAK_FLOPS_BF16),
        memory_s=hbm / HBM_BW,
        collective_s=coll / NVLINK_BW,
        model_flops=factor * cfg.active_param_count() * n_tok,
        analytic_flops=flops,
        hlo_flops_per_dev=record.get("cost", {}).get(
            "flops_per_device", 0.0),
        peak_bytes=record.get("memory", {}).get("peak_bytes", 0),
    )
