"""Decoder-only LM, dense slice: attention + MLP layers.

The reference groups layers into prefix / scanned unit / suffix and
runs the unit under ``jax.lax.scan`` over stacked parameters.  Here the
layers are a plain Python loop over per-layer parameter dicts
(``params["layers"][i]``), in model order;
:func:`repro_torch.convert.params_from_jax` unstacks the reference's
scan parameters into that list.

The same layer-apply code serves prefill (returns caches) and decode
(consumes caches), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamDef, init_params

__all__ = ["LM", "build_lm", "Ctx", "LayerSpec"]


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


def _attn_spec(cfg: ArchConfig, kind: str) -> L.AttnSpec:
    return L.AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
        rope_fraction=cfg.rope_fraction,
        window=(cfg.local_window if kind == "local" else cfg.window),
        qk_norm=cfg.qk_norm)


def _check_dense(cfg: ArchConfig, spec: LayerSpec) -> None:
    if spec.kind != "attn" or cfg.attn_kind != "gqa" \
            or spec.mlp != "mlp":
        raise NotImplementedError(
            f"{cfg.name}: layer kind={spec.kind!r} attn={cfg.attn_kind!r} "
            f"mlp={spec.mlp!r} is not ported yet (attn + mlp layers only)")


def _layer_defs(cfg: ArchConfig, spec: LayerSpec) -> dict:
    _check_dense(cfg, spec)
    d = cfg.d_model
    return {"ln1": L.norm_defs(d, cfg.norm_kind),
            "mixer": L.attention_defs(_attn_spec(cfg, spec.kind)),
            "ln2": L.norm_defs(d, cfg.norm_kind),
            "mlp": L.mlp_defs(d, spec.d_ff, cfg.mlp_kind)}


# ---------------------------------------------------------------------------
# Runtime context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Ctx:
    mode: str                      # prefill | decode
    cache_len: int = 0             # decode capacity
    tuner: Any = None              # AdsalaTuner threaded to every
                                   # routine-aware call site (None = the
                                   # sites still report dispatch events,
                                   # just untuned)


def _seed_cache(raw: Any, cfg: ArchConfig, spec: LayerSpec,
                ctx: Ctx) -> L.KVCache:
    """Convert the attention's prefill projections into a decode cache."""
    a = _attn_spec(cfg, spec.kind)
    k, v = raw
    return L.seed_kv_cache(k, v, ctx.cache_len,
                           windowed=a.window is not None)


def _apply_layer_train(p: dict, x: torch.Tensor, cfg: ArchConfig,
                       spec: LayerSpec, ctx: Ctx
                       ) -> tuple[torch.Tensor, L.KVCache | None]:
    """Full-sequence layer application.  Returns (x, cache) — cache is
    decode-format when ctx.mode == 'prefill', else None."""
    h = L.apply_norm(p["ln1"], x, cfg.norm_kind)
    mix, raw = L.attention_train(p["mixer"], h, _attn_spec(cfg, spec.kind),
                                 tuner=ctx.tuner)
    cache = _seed_cache(raw, cfg, spec, ctx) if ctx.mode == "prefill" \
        else None
    x = x + mix
    x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x, cfg.norm_kind),
                        cfg.mlp_kind, tuner=ctx.tuner)
    return x, cache


def _apply_layer_decode(p: dict, x: torch.Tensor, cache: L.KVCache,
                        pos: int, cfg: ArchConfig, spec: LayerSpec,
                        ctx: Ctx) -> tuple[torch.Tensor, L.KVCache]:
    h = L.apply_norm(p["ln1"], x, cfg.norm_kind)
    mix, cache = L.attention_decode(p["mixer"], h,
                                    _attn_spec(cfg, spec.kind), cache, pos,
                                    tuner=ctx.tuner)
    x = x + mix
    x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x, cfg.norm_kind),
                        cfg.mlp_kind, tuner=ctx.tuner)
    return x, cache


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
                ) -> tuple[torch.Tensor, list[L.KVCache] | None]:
        """(B, S) tokens -> (hidden (B, S, D), caches|None).  Dense layers
        carry no auxiliary loss, so the reference's aux term is absent."""
        cfg = self.cfg
        x = params["embed"][tokens]
        caches = []
        for p, s in zip(params["layers"], self.plan):
            x, c = _apply_layer_train(p, x, cfg, s, ctx)
            caches.append(c)
        x = L.apply_norm(params["ln_f"], x, cfg.norm_kind)
        return x, caches if ctx.mode == "prefill" else None

    def logits_last(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return x[:, -1] @ self._unembed_weight(params)

    def init_cache(self, batch: int, ctx: Ctx,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cpu") -> list[L.KVCache]:
        cfg = self.cfg
        caches = []
        for s in self.plan:
            a = _attn_spec(cfg, s.kind)
            caches.append(L.init_kv_cache(
                batch, ctx.cache_len, a.n_kv_heads, a.head_dim, dtype,
                device=device, windowed=a.window is not None))
        return caches

    def prefill(self, params: dict, tokens: torch.Tensor, ctx: Ctx
                ) -> tuple[torch.Tensor, list[L.KVCache]]:
        """Run the full prompt; return (last-token logits, decode caches)."""
        x, caches = self.forward(params, tokens, ctx)
        return self.logits_last(params, x), caches

    def decode_step(self, params: dict, token: torch.Tensor,
                    cache: list[L.KVCache], pos: int, ctx: Ctx
                    ) -> tuple[torch.Tensor, list[L.KVCache]]:
        """token (B, 1) int64 -> (logits (B, V), cache).  The caches are
        updated in place (see :func:`layers.attention_decode`)."""
        cfg = self.cfg
        x = params["embed"][token]
        new = []
        for p, s, c in zip(params["layers"], self.plan, cache):
            x, c2 = _apply_layer_decode(p, x, c, pos, cfg, s, ctx)
            new.append(c2)
        x = L.apply_norm(params["ln_f"], x, cfg.norm_kind)
        return self.logits_last(params, x), new


def build_lm(cfg: ArchConfig) -> LM:
    return LM(cfg)
