"""Decoder-only LM for every family but the encoder-decoder one: GQA
attention layers (global or local, full or sliding-window KV cache, fp
or int8), MLA layers (latent cache), RG-LRU recurrent blocks
(:mod:`repro_torch.models.recurrent`) and mLSTM / sLSTM blocks
(:mod:`repro_torch.models.xlstm`), each with a dense MLP, an MoE block
or no feed-forward block at all (xLSTM's blocks carry their own).

The reference groups layers into prefix / scanned unit / suffix and
runs the unit under ``jax.lax.scan`` over stacked parameters.  Here the
layers are a plain Python loop over per-layer parameter dicts
(``params["layers"][i]``), in model order;
:func:`repro_torch.convert.params_from_jax` unstacks the reference's
scan parameters into that list.

The same layer-apply code serves train (the loss), prefill (returns
caches) and decode (consumes caches), as in the reference; with a page
table, decode reads and writes per-layer page pools instead
(continuous batching, :mod:`repro_torch.serve.scheduler`).  In training
each layer runs under ``torch.utils.checkpoint`` when ``ctx.remat`` is
set (the reference's ``jax.checkpoint`` on its scanned unit).  MoE
layers choose their path as the reference's ``_moe_apply`` does: the
single-device one without a mesh, the whole batch routed onto each
rank's stored experts in a decode step, else expert or tensor
parallelism on the ctx's torch ``DeviceMesh``.  On a mesh the dense
blocks also run tensor-parallel over 'model' (:func:`dense_mesh_layout`:
the embedding and the loss or logits cut on the vocab, GQA and MLA
attention on whole heads, ⌈H / tp⌉ a rank where tp does not divide H,
the MLP on its FF width), each rank on its shards, with the residual
stream whole on every rank of the axis, as GSPMD partitions the
reference's; a decode step reads the attention caches cut on their
sequence split-KV, and where tp does not divide H it projects on the
attention weights' stored columns.  The RG-LRU computes on its W /
tp channels and the xLSTM blocks' projections on their widths, the
mLSTM's chunked core on its key dims (only the sLSTM recurrence, h @
w_rec, whole in train and prefill); a decode step reads the RG-LRU's state and the mLSTM's matrix memory cut
as the layer computes (:func:`state_slices`).  A recurrent layer's
prefill by-product is its final state, which is already the decode
cache; its decode step returns a new state, where attention layers
write their caches in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import recorder
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import recurrent as REC
from repro_torch.models import xlstm as XL
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamDef, init_params, param_specs

__all__ = ["LM", "build_lm", "Ctx", "LayerSpec", "chunked_cross_entropy",
           "dense_mesh_layout", "dense_weight_key", "state_slices",
           "vocab_rows", "embed_lookup", "vocab_logits"]


# ---------------------------------------------------------------------------
# Layer taxonomy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str      # attn | local | rglru | mlstm | slstm
    mlp: str       # mlp | moe | none
    d_ff: int = 0  # per-layer ff width (deepseek dense layer differs)


def _layer_plan(cfg: ArchConfig) -> list[LayerSpec]:
    plan = []
    pattern = cfg.pattern or ("attn",)
    for i in range(cfg.n_layers):
        kind = pattern[i % len(pattern)]
        if cfg.n_experts and i >= cfg.first_dense_layers:
            mlp = "moe"
            ff = cfg.d_ff_expert or cfg.d_ff
        elif cfg.mlp_kind == "none":
            mlp, ff = "none", 0
        else:
            mlp = "mlp"
            ff = (cfg.d_ff_dense
                  if cfg.n_experts and i < cfg.first_dense_layers
                  else cfg.d_ff)
        plan.append(LayerSpec(kind, mlp, ff))
    return plan


def _segments(plan: list) -> tuple[list, list, int, list]:
    """(prefix, unit, repeats, suffix) with unit = shortest cycle: the
    reference's grouping of its layers, whose ``unit`` runs under
    ``jax.lax.scan`` over parameters stacked across the repeats.  Here
    the layers run one by one; the grouping still decides which tensors
    the reference stacks (the int8 gradient compression's scale groups,
    :func:`repro_torch.train.optim._scale_groups`).  ``plan`` is any
    list of comparable layer descriptions."""
    for start in range(0, min(4, len(plan))):
        tail = plan[start:]
        for clen in (1, 2, 3, 4):
            if clen > len(tail):
                break
            unit = tail[:clen]
            reps = len(tail) // clen
            if reps >= 1 and all(
                    tail[i] == unit[i % clen] for i in range(reps * clen)):
                suffix = tail[reps * clen:]
                return plan[:start], unit, reps, suffix
    return plan, [], 0, []          # fully unrolled fallback


def _attn_spec(cfg: ArchConfig, kind: str) -> L.AttnSpec:
    return L.AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
        rope_fraction=cfg.rope_fraction,
        window=(cfg.local_window if kind == "local" else cfg.window),
        qk_norm=cfg.qk_norm)


def _mla_spec(cfg: ArchConfig) -> MLA.MLASpec:
    return MLA.MLASpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        q_lora_rank=cfg.q_lora_rank, kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim)


def _moe_spec(cfg: ArchConfig) -> MOE.MoESpec:
    return MOE.MoESpec(
        d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
        d_ff=cfg.d_ff_expert or cfg.d_ff, n_shared=cfg.n_shared_experts)


def _rglru_spec(cfg: ArchConfig) -> REC.RGLRUSpec:
    return REC.RGLRUSpec(d_model=cfg.d_model,
                         width=cfg.lru_width or cfg.d_model,
                         conv_width=cfg.conv_width)


def _xlstm_spec(cfg: ArchConfig) -> XL.XLSTMSpec:
    return XL.XLSTMSpec(d_model=cfg.d_model, n_heads=cfg.n_heads)


def _is_attn(spec: LayerSpec) -> bool:
    return spec.kind in ("attn", "local")


def _layer_defs(cfg: ArchConfig, spec: LayerSpec) -> dict:
    d = cfg.d_model
    defs: dict = {"ln1": L.norm_defs(d, cfg.norm_kind)}
    if _is_attn(spec):
        if cfg.attn_kind == "mla":
            defs["mixer"] = MLA.mla_defs(_mla_spec(cfg))
        else:
            defs["mixer"] = L.attention_defs(_attn_spec(cfg, spec.kind))
    elif spec.kind == "rglru":
        defs["mixer"] = REC.rglru_block_defs(_rglru_spec(cfg))
    elif spec.kind == "mlstm":
        defs["mixer"] = XL.mlstm_defs(_xlstm_spec(cfg))
    elif spec.kind == "slstm":
        defs["mixer"] = XL.slstm_defs(_xlstm_spec(cfg))
    else:
        raise ValueError(spec.kind)
    if spec.mlp == "mlp":
        defs["ln2"] = L.norm_defs(d, cfg.norm_kind)
        defs["mlp"] = L.mlp_defs(d, spec.d_ff, cfg.mlp_kind)
    elif spec.mlp == "moe":
        defs["ln2"] = L.norm_defs(d, cfg.norm_kind)
        defs["moe"] = MOE.moe_defs(_moe_spec(cfg))
    return defs


# ---------------------------------------------------------------------------
# Runtime context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ctx:
    mode: str                      # train | prefill | decode
    mesh: Any = None               # torch DeviceMesh of the mesh paths
                                   # (None: one device)
    dp_axes: tuple[str, ...] = ("data",)
    batch_axes: tuple[str, ...] = ()   # a decode step's: the mesh axes
                                       # that cut its batch (the MoE
                                       # gathers its rows over them)
    tp_axis: str = "model"
    tp: Any = None                 # this rank's TPGroup of tp_axis: the
                                   # dense blocks compute on their shards
                                   # (None: whole)
    cache_len: int = 0             # decode capacity
    tuner: Any = None              # AdsalaTuner threaded to every
                                   # routine-aware call site (None = the
                                   # sites still report dispatch events,
                                   # just untuned)
    kv_quantized: bool = False     # int8 KV cache of the GQA layers
                                   # (ADSALA_KV_INT8=1 in make_ctx);
                                   # MLA's latent cache stays float
    remat: bool = True             # recompute each layer in the backward
                                   # pass (train mode)
    backend: str = "auto"          # ops backend of the attention core
                                   # and the MoE experts; the reference
                                   # picks its backend globally, the
                                   # port names it per call ("library"
                                   # in training: no kernel has a
                                   # backward)


def _cache_shape(cfg: ArchConfig, spec: LayerSpec, ctx: Ctx
                 ) -> tuple[L.AttnSpec, int, bool]:
    """(attention spec, capacity, windowed): a sliding-window layer keeps
    a ring of min(cache_len, window) slots."""
    a = _attn_spec(cfg, spec.kind)
    windowed = a.window is not None
    cap = min(ctx.cache_len, a.window) if windowed else ctx.cache_len
    return a, cap, windowed


def _seed_cache(raw: Any, cfg: ArchConfig, spec: LayerSpec,
                ctx: Ctx) -> Any:
    """Convert the mixer's prefill by-product (k/v projections, or MLA's
    latents) into a decode cache; a recurrent state already is one."""
    if not _is_attn(spec):
        return raw
    if cfg.attn_kind == "mla":
        c_kv, k_rope = raw
        return MLA.seed_mla_cache(c_kv, k_rope, ctx.cache_len)
    _, cap, windowed = _cache_shape(cfg, spec, ctx)
    k, v = raw
    return L.seed_kv_cache(k, v, cap, windowed=windowed,
                           quantized=ctx.kv_quantized)


def _init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                      ctx: Ctx, dtype: torch.dtype,
                      device: torch.device | str) -> Any:
    """An empty decode cache: MLA's latent cache, a (ring, int8) KV
    cache, or a recurrent layer's zero state."""
    if spec.kind == "rglru":
        return REC.init_rglru_state(batch, _rglru_spec(cfg), dtype,
                                    device=device)
    if spec.kind == "mlstm":
        return XL.init_mlstm_state(batch, _xlstm_spec(cfg), device=device)
    if spec.kind == "slstm":
        return XL.init_slstm_state(batch, _xlstm_spec(cfg), device=device)
    if cfg.attn_kind == "mla":
        return MLA.init_mla_cache(batch, ctx.cache_len, _mla_spec(cfg),
                                  dtype, device=device)
    a, cap, windowed = _cache_shape(cfg, spec, ctx)
    return L.init_kv_cache(batch, cap, a.n_kv_heads, a.head_dim, dtype,
                           device=device, windowed=windowed,
                           quantized=ctx.kv_quantized)


def _init_layer_paged(cfg: ArchConfig, spec: LayerSpec, n_pages: int,
                      page_size: int, ctx: Ctx, dtype: torch.dtype,
                      device: torch.device | str) -> Any:
    """Paged twin of the contiguous cache: one page pool per attention
    layer.  Sliding-window (ring) and recurrent-state layers have no
    paged representation (the window bounds their memory already;
    recurrent states carry no sequence dim) — continuous batching
    supports the attention-cache families."""
    from repro_torch.serve import kv_cache as KV

    if spec.kind not in ("attn", "local"):
        raise NotImplementedError(
            f"paged decode cache for layer kind {spec.kind!r} "
            "(recurrent states are not paged)")
    if ctx.kv_quantized:
        raise NotImplementedError("paged decode with int8 KV cache")
    if cfg.attn_kind == "mla":
        s = _mla_spec(cfg)
        return KV.init_paged_latent(n_pages, page_size, s.kv_lora_rank,
                                    s.qk_rope_dim, dtype, device=device)
    a = _attn_spec(cfg, spec.kind)
    if a.window is not None:
        raise NotImplementedError(
            "paged decode cache for sliding-window (ring) layers")
    return KV.init_paged_kv(n_pages, page_size, a.n_kv_heads,
                            a.head_dim, dtype, device=device)


def moe_mesh_layout(cfg: ArchConfig, mesh, seq_len: int
                    ) -> tuple[str, dict[str, tuple], tuple]:
    """The MoE's path on ``mesh`` and its layout, as the reference's
    ``shard_map`` in_specs give it: ``("ep" | "tp", weight specs by
    name, x spec)``.

    * E divisible by the tp size and S too -> expert parallelism
      (deepseek): experts ``(tp, None, None)``, x ``(dp, tp, None)``;
    * otherwise -> expert tensor parallelism (mixtral: 8 experts on a
      16-way axis): wi / wg ``(None, None, tp)``, wo ``(None, tp,
      None)``, x ``(dp, None, None)``;
    * the router and the shared experts replicated.
    """
    from repro_torch.dist.collectives import axis_size
    from repro_torch.dist.sharding import TP_AXIS, data_axes

    spec = _moe_spec(cfg)
    tp = axis_size(mesh, TP_AXIS)
    dp = data_axes(mesh)
    dp_entry = dp[0] if len(dp) == 1 else (dp or None)
    ep_mode = spec.n_experts % tp == 0 and seq_len % tp == 0
    names = ["router", "wi", "wg", "wo"]
    if spec.n_shared:
        names += ["shared_wi", "shared_wg", "shared_wo"]
    w_specs: dict[str, tuple] = {}
    for k in names:
        if k not in MOE.EXPERT_WEIGHTS:
            w_specs[k] = ()
        elif ep_mode:
            w_specs[k] = (TP_AXIS, None, None)
        elif k == "wo":
            w_specs[k] = (None, TP_AXIS, None)
        else:
            w_specs[k] = (None, None, TP_AXIS)
    x_spec = (dp_entry, TP_AXIS if ep_mode else None, None)
    return ("ep" if ep_mode else "tp"), w_specs, x_spec


@functools.lru_cache(maxsize=None)
def _dense_cuts(cfg: ArchConfig, size: int) -> dict[str, bool]:
    """Which dense widths a ``size``-way 'model' axis cuts for compute:
    ``vocab`` (the embedding, logits and loss: V divisible),
    ``vocab_range`` (the encoder-decoder's where V is not: each rank
    computes its range of ⌈V / size⌉ rows of the whole stored
    embedding, :func:`~repro_torch.dist.collectives.vocab_range`, none
    empty), ``heads`` (GQA attention
    on the rank's range of whole query heads, ⌈H / size⌉ a rank:
    :func:`~repro_torch.models.layers.head_range`), ``kv_heads`` (and
    whole KV heads, H and Hkv divisible; else each rank picks the KV
    heads its query heads read), ``qkv_cols`` (where size does not divide
    H or Hkv, a decode step's attention on the stored columns of ``wq``,
    ``wk`` and ``wv`` and rows of ``wo``: H x Dh and Hkv x Dh divisible;
    else that decode computes attention whole where H is uneven, on the
    picked KV heads where it is not), ``mla`` (MLA on whole query
    heads, H divisible, the latents whole), ``ff`` (the dense MLPs),
    ``rglru`` (the RG-LRU on its W channels: every RG-LRU layer's W
    divisible), ``xlstm`` (the mLSTM's and sLSTM's projections: D, the
    mLSTM's inner width and its head dim divisible).  The
    encoder-decoder's three attentions and its MLPs take the decoder
    LM's rules (its layer plan is all attention layers with an MLP)."""
    plan = _layer_plan(cfg)
    kinds = {s.kind for s in plan}
    attn = any(_is_attn(s) for s in plan)
    heads = attn and cfg.attn_kind != "mla"
    even = cfg.n_heads % size == 0
    hd = cfg.resolved_head_dim
    ffs = [s.d_ff for s in plan if s.mlp == "mlp"]
    xl = _xlstm_spec(cfg)
    per = -(-cfg.vocab // size)
    return {"vocab": cfg.vocab % size == 0,
            "vocab_range": cfg.family == "audio" and cfg.vocab % size != 0
            and (size - 1) * per < cfg.vocab,
            "heads": heads,
            "kv_heads": heads and even and cfg.n_kv_heads % size == 0,
            "qkv_cols": heads and not (even and cfg.n_kv_heads % size == 0)
            and all(n * hd % size == 0
                    for n in (cfg.n_heads, cfg.n_kv_heads)),
            "mla": attn and cfg.attn_kind == "mla" and even,
            "ff": bool(ffs) and all(f % size == 0 for f in ffs),
            "rglru": "rglru" in kinds
            and _rglru_spec(cfg).width % size == 0,
            "xlstm": bool(kinds & {"mlstm", "slstm"}) and all(
                n % size == 0 for n in (xl.d_model, xl.d_inner,
                                        xl.head_dim))}


def _cut(cfg: ArchConfig, ctx: Ctx, what: str):
    """ctx.tp where the 'model' axis cuts ``what`` (see
    :func:`_dense_cuts`), else None."""
    if ctx.tp is None or not _dense_cuts(cfg, ctx.tp.size)[what]:
        return None
    return ctx.tp


def _attn_cut(cfg: ArchConfig, ctx: Ctx) -> tuple[Any, bool]:
    """(tp, cols) of a GQA layer: ctx.tp where attention computes on its
    heads; ``cols`` in a decode step where the axis does not divide the
    heads or the KV heads and the layer takes its weights' stored
    columns.  A decode step whose stored cut cannot be taken so computes
    attention whole where the axis does not divide the heads, else on
    its heads and the KV heads they read."""
    tp = _cut(cfg, ctx, "heads")
    if tp is None or ctx.mode != "decode":
        return tp, False
    if _dense_cuts(cfg, tp.size)["qkv_cols"]:
        return tp, True
    return (tp if cfg.n_heads % tp.size == 0 else None), False


def _mixer_cut(cfg: ArchConfig, ctx: Ctx, kind: str):
    """ctx.tp where the 'model' axis cuts a recurrent mixer of ``kind``,
    else None."""
    return _cut(cfg, ctx, "rglru" if kind == "rglru" else "xlstm")


def state_slices(cfg: ArchConfig, kind: str, size: int) -> dict[str, int]:
    """The fields of a ``kind`` layer's decode state that a rank of a
    ``size``-way 'model' axis computes on its slice of, by the dim the
    slice cuts: the RG-LRU's ``h`` (B, W) and ``conv`` (B, cw - 1, W) on
    W, the mLSTM's ``c`` (B, H, Dh, Dh) and ``n`` (B, H, Dh) on the key
    dim (dim 2), where the axis cuts the mixer; {} for any other state.
    Rank r's slice is the r-th of ``size`` equal blocks of that dim,
    the block ``cache_specs`` lays out on it."""
    if kind == "rglru" and _dense_cuts(cfg, size)["rglru"]:
        return {"h": 1, "conv": 2}
    if kind == "mlstm" and _dense_cuts(cfg, size)["xlstm"]:
        return {"c": 2, "n": 2}
    return {}


def dense_mesh_layout(cfg: ArchConfig, mesh, *, decode: bool = False
                      ) -> dict[str, tuple]:
    """What a rank of ``mesh``'s 'model' axis computes the dense blocks
    with: ``{weight: (compute spec, partial)}``, the weight by the key
    :func:`dense_weight_key` gives a parameter's path; a weight not in
    the table is computed whole on every rank (gathered where stored
    cut), as are the MoE's router and, in train and prefill, its shared
    experts (:func:`moe_mesh_layout` places the experts; a decode step
    computes the routed and shared experts where they are stored, the
    routed ones on the rank's block of their slot rows,
    :func:`~repro_torch.models.moe.apply_moe_decode`).

    * ``embed`` (V, D) and ``unembed`` (D, V): cut on V when V % tp
      == 0 (the vocab-parallel lookup, logits and CE); else the vocab
      stays whole on every rank, but for the encoder-decoder's ``embed``
      (whisper's odd 51 865), whole and each rank taking its range of
      ⌈V / tp⌉ rows for the lookup, the logits and the CE (a partial
      gradient);
    * ``attn.wq`` / ``attn.wo``: columns / rows cut at whole heads when
      H % tp == 0; else whole, each rank taking the columns and rows of
      its range of ⌈H / tp⌉ heads (none past the last head); in a
      decode step (``decode``) where tp does not divide H or Hkv, where
      they are stored: columns / rows cut in tp equal blocks, which may
      end inside a head (where H x Dh and Hkv x Dh divide; else that
      decode computes attention whole where H is uneven, and on its
      heads and picked KV heads where it is not);
    * ``attn.wk`` / ``attn.wv``: columns cut at whole KV heads when H %
      tp == 0 and Hkv % tp == 0; else whole, each rank taking the columns
      of the KV heads its query heads read; in a decode step where tp
      does not divide H or Hkv, their stored columns, as ``wq``'s: a
      rank projects its block of Hkv x Dh and gathers k and v, and no
      weight moves;
    * ``attn.q_norm`` / ``attn.k_norm``: whole, applied to the rank's
      heads;
    * ``mla.wq_b`` / ``mla.wk_b`` / ``mla.wv_b`` / ``mla.wo``: columns /
      rows cut at whole heads when H % tp == 0 (each is head-major, so a
      rank's heads are one contiguous range); MLA's latent weights
      (``wq_a``, ``q_norm``, ``wkv_a``, ``kv_norm``, ``wk_rope``) are
      not in the table: whole, as the reference stores them;
    * ``mlp.wi`` / ``mlp.wg`` / ``mlp.wo``: columns / rows cut when
      every dense MLP's F % tp == 0;
    * ``rglru.*`` when every RG-LRU's W % tp == 0: ``wx``, ``wy``,
      ``conv_w`` columns and ``conv_b``, ``lam``, ``b_input_gate``,
      ``b_rec_gate`` on the rank's W / tp channels; ``w_input_gate``,
      ``w_rec_gate`` and ``wo`` rows (the gates' partial products
      reduce-scattered over 'model' onto the rank's channels, its bias
      slices added after);
    * ``mlstm.*`` / ``slstm.*`` when D, the mLSTM's inner width Di and
      its head dim divide: ``mlstm.w_up``, ``slstm.w_up`` and
      ``slstm.w_in`` columns (the product gathered over 'model'),
      ``mlstm.wq`` / ``wk`` / ``wv`` / ``w_igate`` / ``w_fgate`` /
      ``w_down`` and ``slstm.w_down`` rows; the mLSTM's chunked core on
      the rank's Dh / tp key dims of every head (its partial (num, den)
      summed over 'model'); the biases and norms whole; the sLSTM's
      ``w_rec`` and ``b`` whole in train and prefill (its recurrence,
      ``h @ w_rec``, runs whole on the gathered input product), and
      with ``decode`` on their 4D columns: a decode step computes the
      rank's columns of the pre-activations and gathers them.

    ``partial`` marks a gradient that is a partial sum over 'model'
    (each rank's term from its own heads or vocab range): the picked KV
    columns, the qk norms, an uneven head range's ``wq`` and ``wo`` and
    a ranged ``embed``; the train
    step sums it into the stored layout.  Every
    other gradient of a cut or whole weight is the whole one already
    (the collectives' replicated-loss convention).  The stored layout
    (the reference's specs) is not this; where the two differ the
    weight is moved (:func:`~repro_torch.dist.collectives.local_at`).
    """
    from repro_torch.dist.collectives import axis_size
    from repro_torch.dist.sharding import TP_AXIS

    m = TP_AXIS
    cuts = _dense_cuts(cfg, axis_size(mesh, m))
    cols, rows, chans = ((None, m), False), ((m, None), False), ((m,), False)
    out: dict[str, tuple] = {}
    if cuts["vocab"]:
        out["embed"] = rows
        out["unembed"] = cols
    if cuts["vocab_range"]:
        out["embed"] = ((), True)
    even = cfg.n_heads % axis_size(mesh, m) == 0
    picked = ((), True)
    if decode and cuts["qkv_cols"]:
        out.update({"attn.wq": cols, "attn.wk": cols, "attn.wv": cols,
                    "attn.wo": rows})
    elif cuts["heads"] and (even or not decode):
        kv = cols if cuts["kv_heads"] else picked
        out.update({"attn.wq": cols if even else picked,
                    "attn.wo": rows if even else picked,
                    "attn.wk": kv, "attn.wv": kv,
                    "attn.q_norm": picked, "attn.k_norm": picked})
    if cuts["mla"]:
        out.update({"mla.wq_b": cols, "mla.wk_b": cols, "mla.wv_b": cols,
                    "mla.wo": rows})
    if cuts["ff"]:
        out.update({"mlp.wi": cols, "mlp.wg": cols, "mlp.wo": rows})
    if cuts["rglru"]:
        out.update({"rglru.wx": cols, "rglru.wy": cols,
                    "rglru.conv_w": cols, "rglru.conv_b": chans,
                    "rglru.lam": chans, "rglru.w_input_gate": rows,
                    "rglru.w_rec_gate": rows, "rglru.b_input_gate": chans,
                    "rglru.b_rec_gate": chans, "rglru.wo": rows})
    if cuts["xlstm"]:
        out.update({f"mlstm.{n}": rows for n in (
            "wq", "wk", "wv", "w_igate", "w_fgate", "w_down")})
        out.update({"mlstm.w_up": cols, "slstm.w_up": cols,
                    "slstm.w_down": rows, "slstm.w_in": cols})
        if decode:
            out.update({"slstm.w_rec": cols, "slstm.b": chans})
    return out


def dense_weight_key(model, path: tuple) -> str | None:
    """The :func:`dense_mesh_layout` key of the parameter at ``path``
    (``embed``, ``unembed``, ``attn.<name>`` of a GQA mixer — or of the
    encoder-decoder's encoder ``attn``, decoder ``self_attn`` and
    ``cross_attn`` —, ``mla.<name>`` of an MLA mixer, ``rglru.<name>`` /
    ``mlstm.<name>`` / ``slstm.<name>`` of a recurrent mixer,
    ``mlp.<name>`` of a dense MLP), or None."""
    if path in (("embed",), ("unembed",)):
        return path[0]
    if len(path) == 4 and path[0] in ("encoder", "decoder"):
        _, _, block, name = path
        if block in ("attn", "self_attn", "cross_attn"):
            return f"attn.{name}"
        return f"mlp.{name}" if block == "mlp" else None
    plan = getattr(model, "plan", None)
    if plan is None or len(path) != 4 or path[0] != "layers":
        return None
    _, i, block, name = path
    if block == "mixer" and _is_attn(plan[i]):
        kind = "mla" if model.cfg.attn_kind == "mla" else "attn"
        return f"{kind}.{name}"
    if block == "mixer":
        return f"{plan[i].kind}.{name}"
    if block == "mlp":
        return f"mlp.{name}"
    return None


def _moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig, ctx: Ctx
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE dispatch-path selection.

    * no mesh                -> the single-device path,
    * a decode step          -> :func:`~repro_torch.models.moe.
                                apply_moe_decode`: the whole batch
                                routed, each rank's stored experts on
                                its block of their slot rows,
    * E divisible by tp size -> expert parallelism (deepseek),
    * otherwise              -> expert tensor parallelism (mixtral).

    On a mesh, ``x`` is this rank's (B_loc, S, D) rows, replicated over
    the tp axis; the weights are DTensors (their stored layout) or whole
    tensors.  In train and prefill each is moved to the layout of
    :func:`moe_mesh_layout`, the path runs on the local pieces, and the
    output is rebuilt as the rank's whole rows; the aux loss is averaged
    over every mesh axis.  A decode step's batch is cut over
    ``ctx.batch_axes``.
    """
    spec = _moe_spec(cfg)
    if ctx.mesh is None:
        return MOE.apply_moe(p, x, spec, tuner=ctx.tuner,
                             backend=ctx.backend)
    if ctx.mode == "decode":
        return MOE.apply_moe_decode(p, x, spec, tuner=ctx.tuner,
                                    mesh=ctx.mesh, row_axes=ctx.batch_axes,
                                    backend=ctx.backend)
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import to_placements

    mesh, tp = ctx.mesh, ctx.tp_axis
    path, w_specs, x_spec = moe_mesh_layout(cfg, mesh, x.shape[1])
    spec = dataclasses.replace(spec, ep_axis=tp)
    tp_group = mesh.get_group(tp)
    p_local = {k: C.local_at(w, mesh, to_placements(w_specs[k], mesh))
               for k, w in p.items()}
    # the rank's rows: sharded over the data axes, whole over tp
    rows = to_placements((x_spec[0], None, None), mesh)
    x_at = to_placements(x_spec, mesh)
    if path == "ep":
        # the router and the shared experts see this rank's sequence
        # shard only: their gradients sum over tp
        for k in p_local:
            if k not in MOE.EXPERT_WEIGHTS:
                p_local[k] = C.copy_to(p_local[k], tp_group)
        x_in = C.local_at(DTensor.from_local(x, mesh, rows,
                                             run_check=False), mesh, x_at)
        out, aux = MOE.apply_moe_ep(p_local, x_in, spec, tuner=ctx.tuner,
                                    mesh=mesh, backend=ctx.backend)
        out = C.local_at(DTensor.from_local(out, mesh, x_at,
                                            run_check=False), mesh, rows)
    else:
        out, aux = MOE.apply_moe_tp(p_local, x, spec, tuner=ctx.tuner,
                                    mesh=mesh, backend=ctx.backend)
    for axis in (*ctx.dp_axes, tp):
        aux = C.pmean(aux, mesh.get_group(axis))
    return out, aux


def _apply_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig,
               spec: LayerSpec, ctx: Ctx
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The layer's MLP or MoE block on the residual stream x: returns
    (x + block(ln2(x)), the MoE's auxiliary loss or None); a layer
    without one (``mlp="none"``) returns (x, None)."""
    if spec.mlp == "none":
        return x, None
    h = L.apply_norm(p["ln2"], x, cfg.norm_kind)
    if spec.mlp == "moe":
        out, aux = _moe_apply(p["moe"], h, cfg, ctx)
        return x + out, aux
    return x + L.apply_mlp(p["mlp"], h, cfg.mlp_kind, tuner=ctx.tuner,
                           tp=_cut(cfg, ctx, "ff")), None


def _apply_layer_train(p: dict, x: torch.Tensor, cfg: ArchConfig,
                       spec: LayerSpec, ctx: Ctx
                       ) -> tuple[torch.Tensor, torch.Tensor | None, Any]:
    """Full-sequence layer application.  Returns (x, aux_loss, cache):
    aux_loss is None for an MLP layer, cache is decode-format when
    ctx.mode == 'prefill', else None."""
    h = L.apply_norm(p["ln1"], x, cfg.norm_kind)
    if spec.kind == "rglru":
        tp = _mixer_cut(cfg, ctx, spec.kind)
        mix, raw = REC.rglru_block_train(p["mixer"], h, tp=tp)
        if tp is not None and ctx.mode == "prefill":
            raw = REC.state_whole(raw, tp)
    elif spec.kind == "mlstm":
        tp = _mixer_cut(cfg, ctx, spec.kind)
        mix, raw = XL.mlstm_train(p["mixer"], h, _xlstm_spec(cfg), tp=tp)
        if tp is not None and ctx.mode == "prefill":
            raw = XL.mlstm_state_whole(raw, tp)
    elif spec.kind == "slstm":
        mix, raw = XL.slstm_train(p["mixer"], h, _xlstm_spec(cfg),
                                  tp=_mixer_cut(cfg, ctx, spec.kind))
    elif cfg.attn_kind == "mla":
        mix, raw = MLA.mla_train(p["mixer"], h, _mla_spec(cfg),
                                 tuner=ctx.tuner, tp=_cut(cfg, ctx, "mla"))
    else:
        a, (tp, _) = _attn_spec(cfg, spec.kind), _attn_cut(cfg, ctx)
        mix, raw = L.attention_train(p["mixer"], h, a, tuner=ctx.tuner,
                                     backend=ctx.backend, tp=tp)
        if tp is not None and ctx.mode == "prefill":
            raw = tuple(L.kv_heads_whole(t, a, tp) for t in raw)
    cache = _seed_cache(raw, cfg, spec, ctx) if ctx.mode == "prefill" \
        else None
    x, aux = _apply_ffn(p, x + mix, cfg, spec, ctx)
    return x, aux, cache


def _apply_layer_decode(p: dict, x: torch.Tensor, cache: Any,
                        pos: Any, cfg: ArchConfig, spec: LayerSpec,
                        ctx: Ctx, page_table: torch.Tensor | None = None,
                        plan: Any = None) -> tuple[torch.Tensor, Any]:
    """``page_table`` switches the attention mixer onto the paged read
    path (the cache is a PagedKV or PagedLatent pool, ``pos`` is (B,)
    per-sequence positions, ``plan`` the step's page plan) — the
    continuous-batching decode.  On a mesh an attention layer's cache
    may be a :class:`~repro_torch.models.layers.SplitKV` (read
    split-KV), its pool a :class:`~repro_torch.serve.kv_cache.
    PagedSplit` (read split-KV over its pages)."""
    h = L.apply_norm(p["ln1"], x, cfg.norm_kind)
    if spec.kind == "rglru":
        mix, cache = REC.rglru_block_decode(
            p["mixer"], h, cache, tp=_mixer_cut(cfg, ctx, spec.kind))
    elif spec.kind in ("mlstm", "slstm"):
        step = XL.mlstm_decode if spec.kind == "mlstm" else XL.slstm_decode
        mix, cache = step(p["mixer"], h, _xlstm_spec(cfg), cache,
                          tp=_mixer_cut(cfg, ctx, spec.kind))
    elif cfg.attn_kind == "mla":
        tp = _cut(cfg, ctx, "mla")
        if page_table is not None:
            mix, cache = MLA.mla_decode_paged(
                p["mixer"], h, _mla_spec(cfg), cache, page_table, pos,
                tuner=ctx.tuner, plan=plan, tp=tp)
        else:
            mix, cache = MLA.mla_decode(p["mixer"], h, _mla_spec(cfg),
                                        cache, pos, tuner=ctx.tuner, tp=tp)
    elif page_table is not None:
        tp, cols = _attn_cut(cfg, ctx)
        mix, cache = L.attention_decode_paged(
            p["mixer"], h, _attn_spec(cfg, spec.kind), cache, page_table,
            pos, tuner=ctx.tuner, plan=plan, tp=tp, cols=cols)
    else:
        tp, cols = _attn_cut(cfg, ctx)
        mix, cache = L.attention_decode(p["mixer"], h,
                                        _attn_spec(cfg, spec.kind), cache,
                                        pos, tuner=ctx.tuner, tp=tp,
                                        cols=cols)
    x, _ = _apply_ffn(p, x + mix, cfg, spec, ctx)
    return x, cache


def _remat_contexts():
    """(forward, recomputation) contexts of a checkpointed layer: the
    recomputation replays the layer's dispatches, which the forward run
    already recorded."""
    return contextlib.nullcontext(), recorder.suppressed()


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def chunked_cross_entropy(x: torch.Tensor, w_unemb: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512,
                          tp=None, lo: int | None = None) -> torch.Tensor:
    """Mean CE over (B, S) without materialising (B, S, V) at once: the
    logits exist one (B, chunk, V) block at a time.  Labels < 0 are
    ignored.

    With ``tp`` the CE is vocab-parallel: ``w_unemb`` is this rank's
    columns (V / tp of them, or with ``lo`` its range of the vocabulary
    from ``lo``: :func:`vocab_rows`), a chunk's logits are the rank's
    (B, chunk, n), the log-partition takes its max and sum over the
    group and the label's logit comes from the rank that holds it;
    every rank gets the same loss."""
    from repro_torch.dist import collectives as C

    s = x.shape[1]
    tot = x.new_zeros((), dtype=torch.float32)
    n_valid = x.new_zeros((), dtype=torch.float32)
    if tp is not None:
        x = C.copy_to(x, tp.group)
    for i0 in range(0, s, chunk):
        li = labels[:, i0:i0 + chunk].long()
        logits = (x[:, i0:i0 + chunk] @ w_unemb).float()
        if tp is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                li.clamp(min=0)[..., None])[..., 0]
        else:
            logz = C.vocab_logz(logits, tp.group)
            gold = C.vocab_gold(logits, li, tp, lo)
        valid = (li >= 0).float()
        tot = tot + ((logz - gold) * valid).sum()
        n_valid = n_valid + valid.sum()
    return tot / torch.clamp(n_valid, min=1.0)


def vocab_rows(cfg: ArchConfig, ctx: Ctx, embed: torch.Tensor
               ) -> tuple[torch.Tensor, Any, int | None]:
    """(the rows of ``embed`` this rank computes the lookup and the
    logits with, the group they are cut over or None, the first id of a
    range or None): the rows as given where the 'model' axis cuts V
    (the stored cut), this rank's range of the whole embedding where it
    takes one (:func:`_dense_cuts`' ``vocab_range``), else the whole
    embedding and no group."""
    from repro_torch.dist.collectives import vocab_range

    tp = _cut(cfg, ctx, "vocab")
    if tp is not None:
        return embed, tp, None
    tp = _cut(cfg, ctx, "vocab_range")
    if tp is None:
        return embed, None, None
    lo, hi = vocab_range(cfg.vocab, tp.size, tp.rank)
    return embed[lo:hi], tp, lo


def embed_lookup(w: torch.Tensor, ids: torch.Tensor, tp=None,
                 lo: int | None = None) -> torch.Tensor:
    """The embedding of ``ids`` from :func:`vocab_rows`' rows: a plain
    lookup without a group, else the vocab-parallel one (each rank its
    ids, summed over the group)."""
    if tp is None:
        return w[ids.long()]
    from repro_torch.dist.collectives import vocab_embed
    return vocab_embed(w, ids, tp, lo)


def vocab_logits(x: torch.Tensor, w_unemb: torch.Tensor, vocab: int,
                 tp=None) -> torch.Tensor:
    """The logits (..., V) of ``x`` (..., D) over ``w_unemb`` (D, n): with
    ``tp`` this rank's n columns of a vocab-parallel unembedding
    (V / tp, or a range of ⌈V / tp⌉, the last maybe shorter), padded to
    ⌈V / tp⌉, gathered over the group and trimmed to V."""
    logits = x @ w_unemb
    if tp is None:
        return logits
    from repro_torch.dist.collectives import all_gather

    per = -(-vocab // tp.size)
    if logits.shape[-1] < per:
        logits = torch.nn.functional.pad(logits,
                                         (0, per - logits.shape[-1]))
    logits = all_gather(logits, tp.group, dim=-1)
    return logits if logits.shape[-1] == vocab else logits[..., :vocab]


# ---------------------------------------------------------------------------
# The model object
# ---------------------------------------------------------------------------

class LM:
    """Decoder-only LM over a per-layer parameter list."""

    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.plan = _layer_plan(cfg)
        self.defs = self._build_defs()

    def _build_defs(self) -> dict:
        cfg = self.cfg
        defs: dict = {
            "embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                              scale=1.0),
            "ln_f": L.norm_defs(cfg.d_model, cfg.norm_kind),
        }
        if not cfg.tie_embeddings:
            defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab),
                                       ("embed", "vocab"))
        defs["layers"] = [_layer_defs(cfg, s) for s in self.plan]
        return defs

    def init(self, gen: torch.Generator,
             dtype: torch.dtype = torch.float32) -> dict:
        """Random weights drawn from ``gen`` on ``gen``'s device."""
        return init_params(self.defs, gen, dtype)

    def param_partition_specs(self, rules: dict) -> dict:
        """One spec per parameter from a logical-axis rule table
        (:func:`repro_torch.dist.sharding.param_rules`)."""
        return param_specs(self.defs, rules)

    # -- forward --------------------------------------------------------------
    def _unembed_weight(self, params: dict) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["unembed"]

    def forward(self, params: dict, tokens: torch.Tensor, ctx: Ctx
                ) -> tuple[torch.Tensor, torch.Tensor,
                           list | None]:
        """(B, S) tokens -> (hidden (B, S, D), total aux loss of the MoE
        layers (fp32 scalar), caches|None)."""
        cfg = self.cfg
        w, tp, lo = vocab_rows(cfg, ctx, params["embed"])
        x = embed_lookup(w, tokens, tp, lo)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        remat = ctx.remat and ctx.mode == "train" and torch.is_grad_enabled()
        for p, s in zip(params["layers"], self.plan):
            if remat:
                x, aux, c = checkpoint(_apply_layer_train, p, x, cfg, s, ctx,
                                       use_reentrant=False,
                                       context_fn=_remat_contexts)
            else:
                x, aux, c = _apply_layer_train(p, x, cfg, s, ctx)
            if aux is not None:
                aux_total = aux_total + aux
            caches.append(c)
        x = L.apply_norm(params["ln_f"], x, cfg.norm_kind)
        return x, aux_total, caches if ctx.mode == "prefill" else None

    def loss(self, params: dict, batch: dict, ctx: Ctx | None = None
             ) -> torch.Tensor:
        """Mean next-token CE of ``batch`` (``tokens``, ``labels``: (B,
        S) ints) plus 0.01 x the MoE layers' auxiliary loss.  The
        default ctx trains on the ``library`` backend; on a mesh the CE
        is vocab-parallel where :func:`dense_mesh_layout` cuts the
        vocab."""
        ctx = ctx or Ctx(mode="train", backend="library")
        x, aux, _ = self.forward(params, batch["tokens"], ctx)
        ce = chunked_cross_entropy(x, self._unembed_weight(params),
                                   batch["labels"],
                                   tp=_cut(self.cfg, ctx, "vocab"))
        return ce + 0.01 * aux

    def logits_last(self, params: dict, x: torch.Tensor,
                    ctx: Ctx | None = None) -> torch.Tensor:
        """The last position's logits (B, V): with a vocab-parallel ctx
        each rank's columns, gathered over the group."""
        tp = None if ctx is None else _cut(self.cfg, ctx, "vocab")
        return vocab_logits(x[:, -1], self._unembed_weight(params),
                            self.cfg.vocab, tp)

    def init_cache(self, batch: int, ctx: Ctx,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cpu") -> list:
        return [_init_layer_cache(self.cfg, s, batch, ctx, dtype, device)
                for s in self.plan]

    def init_paged_cache(self, n_pages: int, page_size: int, ctx: Ctx,
                         dtype: torch.dtype = torch.float32,
                         device: torch.device | str = "cpu") -> list:
        """One :class:`~repro_torch.serve.kv_cache.PagedKV` (or, for MLA,
        :class:`~repro_torch.serve.kv_cache.PagedLatent`) pool per
        layer, in model order — page pools instead of per-batch
        contiguous caches.  All layers share one page table (they see
        the same token positions), so the scheduler allocates once and
        every layer's pool is indexed by the same physical page ids."""
        return [_init_layer_paged(self.cfg, s, n_pages, page_size, ctx,
                                  dtype, device) for s in self.plan]

    def prefill(self, params: dict, tokens: torch.Tensor, ctx: Ctx
                ) -> tuple[torch.Tensor, list]:
        """Run the full prompt; return (last-token logits, decode caches)."""
        x, _, caches = self.forward(params, tokens, ctx)
        return self.logits_last(params, x, ctx), caches

    def decode_step(self, params: dict, token: torch.Tensor,
                    cache: list, pos: Any, ctx: Ctx,
                    page_table: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, list]:
        """token (B, 1) int64 -> (logits (B, V), cache).  The caches are
        updated in place (see :func:`layers.attention_decode`).

        With ``page_table`` (B, P) the cache list holds page pools and
        ``pos`` is (B,) per-sequence positions (-1 = inactive slot) —
        the continuous-batching paged decode (repro_torch.serve.scheduler).

        With ``ctx.tp`` the dense blocks compute on the rank's shards, as
        in :meth:`forward`, and the logits are vocab-parallel, gathered
        over the group; the caches of the attention layers come as
        :class:`~repro_torch.models.layers.SplitKV` where they are cut on
        their sequence (:func:`repro_torch.serve.step.build_decode`), the
        page pools as :class:`~repro_torch.serve.kv_cache.PagedSplit`
        (:func:`repro_torch.serve.step.build_decode_paged`), and the MoE
        routes the rows of ``ctx.batch_axes`` as one batch.
        """
        cfg = self.cfg
        w, tp, lo = vocab_rows(cfg, ctx, params["embed"])
        x = embed_lookup(w, token, tp, lo)
        plan = None
        if page_table is not None:
            # one page plan serves every layer's pools this step
            from repro_torch.serve.kv_cache import plan_step
            plan = plan_step(cache[0], page_table, pos)
        new = []
        for p, s, c in zip(params["layers"], self.plan, cache):
            x, c2 = _apply_layer_decode(p, x, c, pos, cfg, s, ctx,
                                        page_table, plan)
            new.append(c2)
        x = L.apply_norm(params["ln_f"], x, cfg.norm_kind)
        return self.logits_last(params, x, ctx), new


def build_lm(cfg: ArchConfig) -> LM:
    return LM(cfg)
