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
layers take the reference's single-device path (its ``_moe_apply``
without a mesh).  A recurrent layer's prefill by-product is its final
state, which is already the decode cache; its decode step returns a new
state, where attention layers write their caches in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from repro_torch.models.params import ParamDef, init_params

__all__ = ["LM", "build_lm", "Ctx", "LayerSpec", "chunked_cross_entropy"]


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
        out, aux = MOE.apply_moe(p["moe"], h, _moe_spec(cfg),
                                 tuner=ctx.tuner, backend=ctx.backend)
        return x + out, aux
    return x + L.apply_mlp(p["mlp"], h, cfg.mlp_kind, tuner=ctx.tuner), None


def _apply_layer_train(p: dict, x: torch.Tensor, cfg: ArchConfig,
                       spec: LayerSpec, ctx: Ctx
                       ) -> tuple[torch.Tensor, torch.Tensor | None, Any]:
    """Full-sequence layer application.  Returns (x, aux_loss, cache):
    aux_loss is None for an MLP layer, cache is decode-format when
    ctx.mode == 'prefill', else None."""
    h = L.apply_norm(p["ln1"], x, cfg.norm_kind)
    if spec.kind == "rglru":
        mix, raw = REC.rglru_block_train(p["mixer"], h)
    elif spec.kind == "mlstm":
        mix, raw = XL.mlstm_train(p["mixer"], h, _xlstm_spec(cfg))
    elif spec.kind == "slstm":
        mix, raw = XL.slstm_train(p["mixer"], h, _xlstm_spec(cfg))
    elif cfg.attn_kind == "mla":
        mix, raw = MLA.mla_train(p["mixer"], h, _mla_spec(cfg),
                                 tuner=ctx.tuner)
    else:
        mix, raw = L.attention_train(p["mixer"], h,
                                     _attn_spec(cfg, spec.kind),
                                     tuner=ctx.tuner, backend=ctx.backend)
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
    continuous-batching decode."""
    h = L.apply_norm(p["ln1"], x, cfg.norm_kind)
    if spec.kind == "rglru":
        mix, cache = REC.rglru_block_decode(p["mixer"], h, cache)
    elif spec.kind == "mlstm":
        mix, cache = XL.mlstm_decode(p["mixer"], h, _xlstm_spec(cfg), cache)
    elif spec.kind == "slstm":
        mix, cache = XL.slstm_decode(p["mixer"], h, _xlstm_spec(cfg), cache)
    elif cfg.attn_kind == "mla":
        if page_table is not None:
            mix, cache = MLA.mla_decode_paged(
                p["mixer"], h, _mla_spec(cfg), cache, page_table, pos,
                tuner=ctx.tuner, plan=plan)
        else:
            mix, cache = MLA.mla_decode(p["mixer"], h, _mla_spec(cfg),
                                        cache, pos, tuner=ctx.tuner)
    elif page_table is not None:
        mix, cache = L.attention_decode_paged(
            p["mixer"], h, _attn_spec(cfg, spec.kind), cache, page_table,
            pos, tuner=ctx.tuner, plan=plan)
    else:
        mix, cache = L.attention_decode(p["mixer"], h,
                                        _attn_spec(cfg, spec.kind), cache,
                                        pos, tuner=ctx.tuner)
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
                          labels: torch.Tensor, *, chunk: int = 512
                          ) -> torch.Tensor:
    """Mean CE over (B, S) without materialising (B, S, V) at once: the
    logits exist one (B, chunk, V) block at a time.  Labels < 0 are
    ignored."""
    s = x.shape[1]
    tot = x.new_zeros((), dtype=torch.float32)
    n_valid = x.new_zeros((), dtype=torch.float32)
    for i0 in range(0, s, chunk):
        li = labels[:, i0:i0 + chunk].long()
        logits = (x[:, i0:i0 + chunk] @ w_unemb).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li.clamp(min=0)[..., None])[..., 0]
        valid = (li >= 0).float()
        tot = tot + ((logz - gold) * valid).sum()
        n_valid = n_valid + valid.sum()
    return tot / torch.clamp(n_valid, min=1.0)


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
        x = params["embed"][tokens.long()]
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
        default ctx trains on the ``library`` backend."""
        ctx = ctx or Ctx(mode="train", backend="library")
        x, aux, _ = self.forward(params, batch["tokens"], ctx)
        ce = chunked_cross_entropy(x, self._unembed_weight(params),
                                   batch["labels"])
        return ce + 0.01 * aux

    def logits_last(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return x[:, -1] @ self._unembed_weight(params)

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
        return self.logits_last(params, x), caches

    def decode_step(self, params: dict, token: torch.Tensor,
                    cache: list, pos: Any, ctx: Ctx,
                    page_table: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, list]:
        """token (B, 1) int64 -> (logits (B, V), cache).  The caches are
        updated in place (see :func:`layers.attention_decode`).

        With ``page_table`` (B, P) the cache list holds page pools and
        ``pos`` is (B,) per-sequence positions (-1 = inactive slot) —
        the continuous-batching paged decode (repro_torch.serve.scheduler).
        """
        cfg = self.cfg
        x = params["embed"][token]
        plan = None
        if page_table is not None:
            # one page plan serves every layer's pools this step
            from repro_torch.serve.kv_cache import plan_pages
            plan = plan_pages(page_table, pos, pos >= 0,
                              cache[0].n_pages, cache[0].page_size)
        new = []
        for p, s, c in zip(params["layers"], self.plan, cache):
            x, c2 = _apply_layer_decode(p, x, c, pos, cfg, s, ctx,
                                        page_table, plan)
            new.append(c2)
        x = L.apply_norm(params["ln_f"], x, cfg.norm_kind)
        return self.logits_last(params, x), new


def build_lm(cfg: ArchConfig) -> LM:
    return LM(cfg)
