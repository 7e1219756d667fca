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

On a mesh (``ctx.tp``) the three attentions compute on the rank's whole
heads (:func:`layers.head_range`: ⌈H / tp⌉ a rank, none past the last:
whisper's 6 heads on 16 ranks, one on ranks 0–5) and the MLPs on their
FF slice, the embedding, the logits and the loss on the rank's vocab
rows (a range of the whole stored embedding where the axis does not
divide V, :func:`~repro_torch.models.transformer.vocab_rows`), as
:func:`~repro_torch.models.transformer.dense_mesh_layout` lays them
out; a prefill returns its caches whole.  A mesh decode step projects
on the stored columns of the attention weights and reads its caches
where they are stored: the self-attention cache split-KV
(:class:`layers.SplitKV`), the encoder's K/V as a :class:`CrossKV` cut
on the frames (split-KV) or on the head dim (partial scores summed over
the group).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.dist import collectives as C
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamDef, init_params, param_specs
from repro_torch.models.transformer import Ctx, _attn_cut, _cut, \
    chunked_cross_entropy, embed_lookup, vocab_logits, vocab_rows

__all__ = ["EncDecLM", "build_encdec", "CrossKV"]


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


@dataclasses.dataclass
class CrossKV:
    """The encoder's K/V (B, Sk, H, Dh) as a mesh decode step reads them
    in place: ``k`` and ``v`` are this rank's pieces of a cut over
    ``tp``'s group on ``dim``, 1 (the frames: each rank attends over its
    own, the partial softmaxes combined) or 3 (the head dim: each rank's
    partial q·k scores of every head summed over the group, its slice
    of probs·v gathered)."""
    k: torch.Tensor
    v: torch.Tensor
    dim: int
    tp: Any


def _cross_core(q: torch.Tensor, enc_k: torch.Tensor,
                enc_v: torch.Tensor, head_dim: int) -> torch.Tensor:
    """softmax(q·k / sqrt(Dh))·v in fp32 of q (B, Sq, h, Dh) over the
    encoder's k, v (B, Sk, h, Dh) -> (B, Sq, h, Dh) fp32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          enc_k.float()) * (head_dim ** -0.5)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, enc_v.float())


def _cross_attention(p: dict, x: torch.Tensor, enc_k: torch.Tensor,
                     enc_v: torch.Tensor, s: L.AttnSpec,
                     tuner=None, tp=None) -> torch.Tensor:
    """Query from x, K/V precomputed from the encoder output.  With
    ``tp`` the rank's heads (:func:`layers.tp_heads`): ``enc_k`` /
    ``enc_v`` are theirs (:func:`_project_enc_kv`), q comes from their
    ``wq`` columns and the output leaves through their ``wo`` rows,
    summed over the group; a rank with no head adds zeros."""
    b, sq, _ = x.shape
    # cross-attention scores are rectangular (decoder x encoder): a
    # plain GEMM, never SYRK-eligible — tagged so the recorded mix
    # distinguishes it from causal self-attention
    ops.observe(sq, s.head_dim, enc_k.shape[1], tuner,
                site="attn.cross_qk", count=b * s.n_heads)
    local = s
    if tp is not None:
        local = L.tp_heads(s, tp)[0]
        p = L._rank_weights(p, s, tp)
        x = C.copy_to(x, tp.group)
    q = L.linear(x, p["wq"]).reshape(b, sq, local.n_heads, s.head_dim)
    out = _cross_core(q, enc_k, enc_v, s.head_dim).to(x.dtype)
    out = L.linear(out.reshape(b, sq, local.n_heads * s.head_dim), p["wo"])
    return out if tp is None else C.reduce_from(out, tp.group)


def _project_enc_kv(p: dict, enc: torch.Tensor, s: L.AttnSpec, tp=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K and V (B, Sk, H, Dh) for every query head;
    with ``tp`` for the rank's (from the columns of the KV heads they
    read; ``enc`` has been through ``copy_to`` once for every layer)."""
    b, sk, _ = enc.shape
    local, index = s, None
    if tp is not None:
        local, _, _, index = L.tp_heads(s, tp)
        p = L._rank_weights(p, s, tp)
    k = L.linear(enc, p["wk"]).reshape(b, sk, local.n_kv_heads, s.head_dim)
    v = L.linear(enc, p["wv"]).reshape(b, sk, local.n_kv_heads, s.head_dim)
    return (L._repeat_kv(k, local.n_heads, index),
            L._repeat_kv(v, local.n_heads, index))


def _cross_decode(p: dict, x: torch.Tensor, cross, s: L.AttnSpec,
                  tuner=None, tp=None) -> torch.Tensor:
    """A decode step's cross-attention of x (B, 1, D) over the encoder's
    K/V: the (k, v) whole (on one device :func:`_cross_attention`'s
    arithmetic), or on a mesh a :class:`CrossKV` read in place.
    With ``tp`` ``p`` holds the rank's stored block of ``wq``'s columns
    and ``wo``'s rows (H x Dh / tp of each, which may end inside a
    head): q is projected on it and gathered, and the output leaves
    through it, summed over the group; else the weights are whole."""
    b = x.shape[0]
    hd = s.head_dim
    k, v = (cross.k, cross.v) if isinstance(cross, CrossKV) else cross
    frames = k.shape[1] * (cross.tp.size if isinstance(cross, CrossKV)
                           and cross.dim == 1 else 1)
    ops.observe(1, hd, frames, tuner, site="attn.cross_qk",
                count=b * s.n_heads)
    q = L.linear(x, p["wq"])
    if tp is not None:
        q = C.all_gather(q, tp.group, dim=-1).contiguous()
    q = q.reshape(b, 1, s.n_heads, hd)
    if not isinstance(cross, CrossKV):
        out = _cross_core(q, k, v, hd)[:, 0]
    elif cross.dim == 1:
        valid = torch.ones((1, k.shape[1]), dtype=torch.bool,
                           device=x.device)
        out = C.softmax_combine(*L.decode_partial(q, k, v, valid),
                                cross.tp.group)
    else:
        # the head dim cut: partial scores of every head summed over the
        # group, the softmax whole, the rank's slice of probs·v gathered
        n, r = k.shape[3], cross.tp.rank
        part = torch.einsum("bohd,bkhd->bhk",
                            q[..., r * n:(r + 1) * n].float(), k.float())
        scores = C.reduce_from(part, cross.tp.group) * (hd ** -0.5)
        probs = torch.softmax(scores, dim=-1)
        out = C.all_gather(torch.einsum("bhk,bkhd->bhd", probs,
                                        v.float()), cross.tp.group, dim=-1)
    out = out.reshape(b, s.n_heads * hd)
    if tp is not None:
        rows = p["wo"].shape[0]
        out = out[:, tp.rank * rows:(tp.rank + 1) * rows]
    y = L.linear(out.reshape(b, 1, -1).to(x.dtype), p["wo"])
    return y if tp is None else C.reduce_from(y, tp.group)


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

    def param_partition_specs(self, rules: dict) -> dict:
        """One spec per parameter from a logical-axis rule table
        (:func:`repro_torch.dist.sharding.param_rules`)."""
        return param_specs(self.defs, rules)

    # -- encoder -----------------------------------------------------------
    def encode(self, params: dict, audio_emb: torch.Tensor, tuner=None,
               backend: str = "auto", ctx: Ctx | None = None
               ) -> torch.Tensor:
        """The encoder's output (B, encoder_len, D); with ``ctx`` on a
        mesh its attention on the rank's heads and its MLPs on their FF
        slice (``tuner`` and ``backend`` then come from ``ctx``)."""
        cfg = self.cfg
        ctx = ctx or Ctx(mode="prefill", tuner=tuner, backend=backend)
        atp, _ = _attn_cut(cfg, ctx)
        ftp = _cut(cfg, ctx, "ff")
        x = audio_emb + params["pos_enc"][None, : audio_emb.shape[1]]
        spec = _attn_spec(cfg, causal=False)
        for p in params["encoder"]:
            h, _ = L.attention_train(
                p["attn"], L.apply_norm(p["ln1"], x, cfg.norm_kind), spec,
                tuner=ctx.tuner, backend=ctx.backend, tp=atp)
            x = x + h
            x = x + L.apply_mlp(
                p["mlp"], L.apply_norm(p["ln2"], x, cfg.norm_kind),
                cfg.mlp_kind, tuner=ctx.tuner, tp=ftp)
        return L.apply_norm(params["ln_enc"], x, cfg.norm_kind)

    # -- decoder full-sequence ----------------------------------------------
    def _decode_seq(self, params: dict, tokens: torch.Tensor,
                    enc: torch.Tensor, ctx: Ctx, embed: tuple
                    ) -> tuple[torch.Tensor, list]:
        """The decoder over ``tokens`` (``embed``: :func:`vocab_rows`'
        rows, group and offset) -> (its normed output, the prefill's
        caches, whole)."""
        cfg = self.cfg
        want_cache = ctx.mode == "prefill"
        atp, _ = _attn_cut(cfg, ctx)
        ftp = _cut(cfg, ctx, "ff")
        x = embed_lookup(embed[0], tokens, *embed[1:]) \
            + params["pos_dec"][None, : tokens.shape[1]]
        sa = _attn_spec(cfg, causal=True)
        ca = _attn_spec(cfg, causal=False)
        if atp is not None:
            # each rank projects its heads' K/V from the whole encoder
            # output: its gradient summed over the group once, and
            # accumulated over the layers as on one device
            enc = C.copy_to(enc, atp.group)
        caches = []
        for p in params["decoder"]:
            h, kv = L.attention_train(
                p["self_attn"], L.apply_norm(p["ln1"], x, cfg.norm_kind),
                sa, tuner=ctx.tuner, backend=ctx.backend, tp=atp)
            x = x + h
            ek, ev = _project_enc_kv(p["cross_attn"], enc, ca, atp)
            x = x + _cross_attention(
                p["cross_attn"], L.apply_norm(p["ln_x"], x, cfg.norm_kind),
                ek, ev, ca, tuner=ctx.tuner, tp=atp)
            x = x + L.apply_mlp(
                p["mlp"], L.apply_norm(p["ln2"], x, cfg.norm_kind),
                cfg.mlp_kind, tuner=ctx.tuner, tp=ftp)
            if want_cache:
                if atp is not None:
                    # the rank's heads joined: every head of the query
                    # (the cross K/V hold one a query head)
                    kv = tuple(L.kv_heads_whole(t, sa, atp) for t in kv)
                    every = dataclasses.replace(ca, n_kv_heads=ca.n_heads)
                    ek, ev = (L.kv_heads_whole(t, every, atp)
                              for t in (ek, ev))
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
        encoder-decoder has no remat.  On a mesh the CE is
        vocab-parallel over the rank's vocab rows."""
        ctx = ctx or Ctx(mode="train", backend="library")
        embed = vocab_rows(self.cfg, ctx, params["embed"])
        enc = self.encode(params, batch["audio_emb"], ctx=ctx)
        x, _ = self._decode_seq(params, batch["tokens"], enc, ctx, embed)
        w, tp, lo = embed
        return chunked_cross_entropy(x, w.T, batch["labels"], tp=tp, lo=lo)

    def prefill(self, params: dict, batch: dict, ctx: Ctx
                ) -> tuple[torch.Tensor, list]:
        """``batch``: ``tokens`` (B, S) ints and ``audio_emb`` (B,
        encoder_len, D).  Returns (last-token logits, decode caches)."""
        embed = vocab_rows(self.cfg, ctx, params["embed"])
        enc = self.encode(params, batch["audio_emb"], ctx=ctx)
        x, caches = self._decode_seq(params, batch["tokens"], enc, ctx,
                                     embed)
        w, tp, _ = embed
        return vocab_logits(x[:, -1], w.T, self.cfg.vocab, tp), caches

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
        caches are updated in place (see :func:`layers.attention_decode`).

        On a mesh (``ctx.tp``) a layer's cache is ``{"self": a KVCache
        or a SplitKV, "cross": a CrossKV}`` as
        :func:`repro_torch.serve.step.build_decode` reads it (or the
        cross K/V whole under ``cross_k`` / ``cross_v``); the self- and
        cross-attention project on the stored columns of their weights
        (or on whole heads where the axis divides them), the MLP on its
        FF slice, the lookup and the logits on the rank's vocab rows,
        gathered."""
        cfg = self.cfg
        pos = int(pos)
        w, vtp, lo = vocab_rows(cfg, ctx, params["embed"])
        x = embed_lookup(w, token, vtp, lo) \
            + params["pos_dec"][pos:pos + 1][None]
        sa = _attn_spec(cfg, causal=True)
        ca = _attn_spec(cfg, causal=False)
        tp, cols = _attn_cut(cfg, ctx)
        ftp = _cut(cfg, ctx, "ff")
        new_cache = []
        for p, c in zip(params["decoder"], cache):
            h, self_c = L.attention_decode(
                p["self_attn"], L.apply_norm(p["ln1"], x, cfg.norm_kind),
                sa, c["self"], pos, tuner=ctx.tuner, tp=tp, cols=cols)
            x = x + h
            hx = L.apply_norm(p["ln_x"], x, cfg.norm_kind)
            cross = c["cross"] if "cross" in c else (c["cross_k"],
                                                     c["cross_v"])
            x = x + _cross_decode(p["cross_attn"], hx, cross, ca,
                                  tuner=ctx.tuner, tp=tp)
            x = x + L.apply_mlp(
                p["mlp"], L.apply_norm(p["ln2"], x, cfg.norm_kind),
                cfg.mlp_kind, tuner=ctx.tuner, tp=ftp)
            new_cache.append({**c, "self": self_c})
        x = L.apply_norm(params["ln_f"], x, cfg.norm_kind)
        return vocab_logits(x[:, -1], w.T, cfg.vocab, vtp), new_cache


def build_encdec(cfg: ArchConfig) -> EncDecLM:
    return EncDecLM(cfg)
