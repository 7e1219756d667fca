"""Encoder-decoder LM (whisper-tiny backbone), as in
:mod:`repro.models.encdec`.

The conv/mel frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``audio_emb`` (B, encoder_len, D).  The
transformer backbone is the reference's: non-causal encoder
self-attention, causal decoder self-attention + cross-attention, learned
positional embeddings, LayerNorm + GELU MLPs.

Both self-attentions go through :func:`layers.attention_train`, so on
the card they run the flash kernel (the encoder's unmasked, at
Sq = Skv = encoder_len).  Cross-attention is the reference's einsum and
softmax (no Pallas kernel there): ``torch.einsum`` here, recorded as the
reference's ``attn.cross_qk`` event.  Encoder-decoder serving is fixed
batch: the model has no paged cache, so the continuous-batching
scheduler refuses it.  :meth:`EncDecLM.loss` trains it, as the
reference's does, without remat.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamDef, init_params
from repro_torch.models.transformer import Ctx, chunked_cross_entropy

__all__ = ["EncDecLM", "build_encdec"]


def _attn_spec(cfg: ArchConfig, causal: bool) -> L.AttnSpec:
    return L.AttnSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                      n_kv_heads=cfg.n_kv_heads,
                      head_dim=cfg.resolved_head_dim,
                      rope_fraction=0.0, causal=causal)


def _enc_layer_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {"ln1": L.norm_defs(d, cfg.norm_kind),
            "attn": L.attention_defs(_attn_spec(cfg, causal=False)),
            "ln2": L.norm_defs(d, cfg.norm_kind),
            "mlp": L.mlp_defs(d, cfg.d_ff, cfg.mlp_kind)}


def _dec_layer_defs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    return {"ln1": L.norm_defs(d, cfg.norm_kind),
            "self_attn": L.attention_defs(_attn_spec(cfg, causal=True)),
            "ln_x": L.norm_defs(d, cfg.norm_kind),
            "cross_attn": L.attention_defs(_attn_spec(cfg, causal=False)),
            "ln2": L.norm_defs(d, cfg.norm_kind),
            "mlp": L.mlp_defs(d, cfg.d_ff, cfg.mlp_kind)}


def _cross_attention(p: dict, x: torch.Tensor, enc_k: torch.Tensor,
                     enc_v: torch.Tensor, s: L.AttnSpec,
                     tuner=None) -> torch.Tensor:
    """Query from x, K/V precomputed from the encoder output."""
    b, sq, _ = x.shape
    # cross-attention scores are rectangular (decoder x encoder): a
    # plain GEMM, never SYRK-eligible — tagged so the recorded mix
    # distinguishes it from causal self-attention
    ops.observe(sq, s.head_dim, enc_k.shape[1], tuner,
                site="attn.cross_qk", count=b * s.n_heads)
    q = L.linear(x, p["wq"]).reshape(b, sq, s.n_heads, s.head_dim)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          enc_k.float()) * (s.head_dim ** -0.5)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs,
                       enc_v.float()).to(x.dtype)
    return L.linear(out.reshape(b, sq, s.n_heads * s.head_dim), p["wo"])


def _project_enc_kv(p: dict, enc: torch.Tensor, s: L.AttnSpec
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    b, sk, _ = enc.shape
    k = L.linear(enc, p["wk"]).reshape(b, sk, s.n_kv_heads, s.head_dim)
    v = L.linear(enc, p["wv"]).reshape(b, sk, s.n_kv_heads, s.head_dim)
    return L._repeat_kv(k, s.n_heads), L._repeat_kv(v, s.n_heads)


class EncDecLM:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        d = cfg.d_model
        self.defs = {
            "embed": ParamDef((cfg.vocab, d), ("vocab", "embed"), scale=1.0),
            "pos_dec": ParamDef((32_768, d), (None, "embed"), scale=0.02),
            "pos_enc": ParamDef((cfg.encoder_len, d), (None, "embed"),
                                scale=0.02),
            "encoder": [_enc_layer_defs(cfg)
                        for _ in range(cfg.n_encoder_layers)],
            "ln_enc": L.norm_defs(d, cfg.norm_kind),
            "decoder": [_dec_layer_defs(cfg) for _ in range(cfg.n_layers)],
            "ln_f": L.norm_defs(d, cfg.norm_kind),
        }

    def init(self, gen: torch.Generator,
             dtype: torch.dtype = torch.float32) -> dict:
        """Random weights drawn from ``gen`` on ``gen``'s device."""
        return init_params(self.defs, gen, dtype)

    # -- encoder -----------------------------------------------------------
    def encode(self, params: dict, audio_emb: torch.Tensor, tuner=None,
               backend: str = "auto") -> torch.Tensor:
        cfg = self.cfg
        x = audio_emb + params["pos_enc"][None, : audio_emb.shape[1]]
        spec = _attn_spec(cfg, causal=False)
        for p in params["encoder"]:
            h, _ = L.attention_train(
                p["attn"], L.apply_norm(p["ln1"], x, cfg.norm_kind), spec,
                tuner=tuner, backend=backend)
            x = x + h
            x = x + L.apply_mlp(
                p["mlp"], L.apply_norm(p["ln2"], x, cfg.norm_kind),
                cfg.mlp_kind, tuner=tuner)
        return L.apply_norm(params["ln_enc"], x, cfg.norm_kind)

    # -- decoder full-sequence ----------------------------------------------
    def _decode_seq(self, params: dict, tokens: torch.Tensor,
                    enc: torch.Tensor, ctx: Ctx
                    ) -> tuple[torch.Tensor, list]:
        cfg = self.cfg
        want_cache = ctx.mode == "prefill"
        x = params["embed"][tokens.long()] \
            + params["pos_dec"][None, : tokens.shape[1]]
        sa = _attn_spec(cfg, causal=True)
        ca = _attn_spec(cfg, causal=False)
        caches = []
        for p in params["decoder"]:
            h, kv = L.attention_train(
                p["self_attn"], L.apply_norm(p["ln1"], x, cfg.norm_kind),
                sa, tuner=ctx.tuner, backend=ctx.backend)
            x = x + h
            ek, ev = _project_enc_kv(p["cross_attn"], enc, ca)
            x = x + _cross_attention(
                p["cross_attn"], L.apply_norm(p["ln_x"], x, cfg.norm_kind),
                ek, ev, ca, tuner=ctx.tuner)
            x = x + L.apply_mlp(
                p["mlp"], L.apply_norm(p["ln2"], x, cfg.norm_kind),
                cfg.mlp_kind, tuner=ctx.tuner)
            if want_cache:
                caches.append({
                    "self": L.seed_kv_cache(kv[0], kv[1], ctx.cache_len,
                                            windowed=False),
                    "cross_k": ek, "cross_v": ev})
        return L.apply_norm(params["ln_f"], x, cfg.norm_kind), caches

    # -- public API -----------------------------------------------------------
    def loss(self, params: dict, batch: dict, ctx: Ctx | None = None
             ) -> torch.Tensor:
        """Mean next-token CE of ``batch`` (``tokens``, ``labels``: (B,
        S) ints; ``audio_emb`` (B, encoder_len, D)) over the tied
        unembedding.  The default ctx trains on the ``library`` backend.
        No layer is recomputed in the backward pass: the reference's
        encoder-decoder has no remat."""
        ctx = ctx or Ctx(mode="train", backend="library")
        enc = self.encode(params, batch["audio_emb"], tuner=ctx.tuner,
                          backend=ctx.backend)
        x, _ = self._decode_seq(params, batch["tokens"], enc, ctx)
        return chunked_cross_entropy(x, params["embed"].T, batch["labels"])

    def prefill(self, params: dict, batch: dict, ctx: Ctx
                ) -> tuple[torch.Tensor, list]:
        """``batch``: ``tokens`` (B, S) ints and ``audio_emb`` (B,
        encoder_len, D).  Returns (last-token logits, decode caches)."""
        enc = self.encode(params, batch["audio_emb"], tuner=ctx.tuner,
                          backend=ctx.backend)
        x, caches = self._decode_seq(params, batch["tokens"], enc, ctx)
        return x[:, -1] @ params["embed"].T, caches

    def init_cache(self, batch: int, ctx: Ctx,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cpu") -> list:
        cfg = self.cfg
        sa = _attn_spec(cfg, causal=True)
        cross = (batch, cfg.encoder_len, cfg.n_heads, sa.head_dim)
        return [{
            "self": L.init_kv_cache(batch, ctx.cache_len, sa.n_kv_heads,
                                    sa.head_dim, dtype, device=device),
            "cross_k": torch.zeros(cross, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross, dtype=dtype, device=device),
        } for _ in range(cfg.n_layers)]

    def decode_step(self, params: dict, token: torch.Tensor, cache: list,
                    pos: int, ctx: Ctx) -> tuple[torch.Tensor, list]:
        """token (B, 1) ints -> (logits (B, V), cache).  The self-attention
        caches are updated in place (see :func:`layers.attention_decode`)."""
        cfg = self.cfg
        pos = int(pos)
        x = params["embed"][token.long()] \
            + params["pos_dec"][pos:pos + 1][None]
        sa = _attn_spec(cfg, causal=True)
        ca = _attn_spec(cfg, causal=False)
        new_cache = []
        for p, c in zip(params["decoder"], cache):
            h, self_c = L.attention_decode(
                p["self_attn"], L.apply_norm(p["ln1"], x, cfg.norm_kind),
                sa, c["self"], pos, tuner=ctx.tuner)
            x = x + h
            x = x + _cross_attention(
                p["cross_attn"], L.apply_norm(p["ln_x"], x, cfg.norm_kind),
                c["cross_k"], c["cross_v"], ca, tuner=ctx.tuner)
            x = x + L.apply_mlp(
                p["mlp"], L.apply_norm(p["ln2"], x, cfg.norm_kind),
                cfg.mlp_kind, tuner=ctx.tuner)
            new_cache.append({"self": self_c, "cross_k": c["cross_k"],
                              "cross_v": c["cross_v"]})
        x = L.apply_norm(params["ln_f"], x, cfg.norm_kind)
        return x[:, -1] @ params["embed"].T, new_cache


def build_encdec(cfg: ArchConfig) -> EncDecLM:
    return EncDecLM(cfg)
