"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Queries and keys/values are projected through low-rank latents; the
decode cache stores only the compressed latent c_kv (kv_lora_rank) plus
the decoupled RoPE key (qk_rope_dim) per token — the memory saving that
defines MLA.  Shapes follow the paper: per head the query/key split into
a non-positional part (qk_nope_dim) and a shared rotary part
(qk_rope_dim); values have their own head dim.

The port of :mod:`repro.models.mla`: plain functions on tensor dicts,
the same recorder sites in the same order.  Prefill attention is the
reference's chunked XLA path (:func:`layers.chunked_attention_xla`):
q/k have qk_nope + qk_rope dims and v has v_head_dim, which the flash
kernel does not take.  Unlike the reference, whose
``dynamic_update_slice`` returns new arrays, :func:`mla_decode` writes
the new latent row into the cache in place and returns the same cache,
as :func:`layers.attention_decode` does; on a mesh it reads a latent
cache cut on its sequence split-KV, as that function does, and
:func:`mla_decode_paged` a latent pool cut on its pages.  With ``tp``
(a :class:`~repro_torch.dist.collectives.TPGroup` of the 'model' axis)
every function computes the latents whole and the rank's whole query
heads through its columns of ``wq_b``, ``wk_b`` and ``wv_b`` and its
rows of ``wo``, as GSPMD partitions the reference's on 'heads'; a
split-KV decode gathers the small absorbed query of every head, never
the cache or a weight.  The recorder's events keep the global widths.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import collectives as C
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    softmax_parts,
    chunked_attention_xla,
    linear,
    rmsnorm,
    rope_angles,
)
from repro_torch.models.params import ParamDef

__all__ = ["MLASpec", "mla_defs", "mla_train", "mla_decode",
           "mla_decode_paged", "MLACache", "init_mla_cache",
           "seed_mla_cache"]

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class MLASpec:
    d_model: int
    n_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


def mla_defs(s: MLASpec) -> dict:
    h = s.n_heads
    return {
        # query path: d -> q_lora -> heads * (nope + rope)
        "wq_a": ParamDef((s.d_model, s.q_lora_rank), ("embed", "lora")),
        "q_norm": ParamDef((s.q_lora_rank,), (None,), init="ones"),
        "wq_b": ParamDef((s.q_lora_rank, h * s.qk_head_dim),
                         ("lora", "heads")),
        # kv path: d -> kv_lora (+ shared rope key direct from d)
        "wkv_a": ParamDef((s.d_model, s.kv_lora_rank), ("embed", "lora")),
        "kv_norm": ParamDef((s.kv_lora_rank,), (None,), init="ones"),
        "wk_rope": ParamDef((s.d_model, s.qk_rope_dim), ("embed", None)),
        "wk_b": ParamDef((s.kv_lora_rank, h * s.qk_nope_dim),
                         ("lora", "heads")),
        "wv_b": ParamDef((s.kv_lora_rank, h * s.v_head_dim),
                         ("lora", "heads")),
        "wo": ParamDef((h * s.v_head_dim, s.d_model), ("heads", "embed")),
    }


def _rope_1head(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotate a (B, S, R) shared rope key / (B, S, H, R) query rope part.

    ``positions`` is (S,) — or (B, S) when every sequence in the batch
    sits at its own position (the paged continuous-batching decode)."""
    r = x.shape[-1]
    sin, cos = rope_angles(positions, r)
    x1, x2 = x[..., : r // 2], x[..., r // 2:]
    if positions.dim() == 2:  # per-sequence: sin/cos already (B, S, r/2)
        if x.dim() == 4:
            sin = sin[:, :, None, :]
            cos = cos[:, :, None, :]
    elif x.dim() == 4:
        sin = sin[None, :, None, :]
        cos = cos[None, :, None, :]
    else:
        sin = sin[None, :, :]
        cos = cos[None, :, :]
    x1f, x2f = x1.float(), x2.float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def _heads(s: MLASpec, tp) -> int:
    """How many query heads a rank computes: every head, or with ``tp``
    its H / size whole heads."""
    return s.n_heads if tp is None else s.n_heads // tp.size


def _latents(p: dict, x: torch.Tensor, s: MLASpec, positions: torch.Tensor,
             tuner=None, tp=None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B,S,H',qk_head_dim) of the heads the rank computes, c_kv
    (B,S,R_kv), k_rope (B,S,R_rope).

    The latents are whole on every rank.  With ``tp`` the rank's heads
    are its columns of ``wq_b`` (head-major, so one contiguous range),
    and the latents pass ``copy_to`` where they fork into the heads: the
    gradient of each is summed over the group there, so it and the
    latent weights' gradients are whole on every rank (nothing partial
    to sum in the train step)."""
    b, sq, _ = x.shape
    # latent down-projections (d -> lora rank) are the skinny GEMMs MLA
    # trades cache memory for; tag them so the tuner prices that shape
    ops.observe(b * sq, s.d_model,
                s.q_lora_rank + s.kv_lora_rank + s.qk_rope_dim, tuner,
                site="mla.down_proj")
    ops.observe(b * sq, s.q_lora_rank, s.n_heads * s.qk_head_dim,
                tuner, site="mla.up_proj_q")
    q_lat = rmsnorm(linear(x, p["wq_a"]), p["q_norm"])
    c_kv = rmsnorm(linear(x, p["wkv_a"]), p["kv_norm"])
    k_rope = _rope_1head(linear(x, p["wk_rope"]), positions)
    if tp is not None:
        q_lat, c_kv, k_rope = (C.copy_to(t, tp.group)
                               for t in (q_lat, c_kv, k_rope))
    q = linear(q_lat, p["wq_b"]).reshape(b, sq, _heads(s, tp),
                                         s.qk_head_dim)
    q_nope, q_rope = q[..., : s.qk_nope_dim], q[..., s.qk_nope_dim:]
    q = torch.cat([q_nope, _rope_1head(q_rope, positions)], dim=-1)
    return q, c_kv, k_rope


def _expand_kv(p: dict, c_kv: torch.Tensor, k_rope: torch.Tensor,
               s: MLASpec, h: int, tuner=None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompress latents to K (nope+rope) and V of ``h`` heads (the
    columns of wk_b / wv_b given); the recorder sees every head."""
    b, sk, _ = c_kv.shape
    # latent up-projection (kv lora rank -> per-head K/V)
    ops.observe(b * sk, s.kv_lora_rank,
                s.n_heads * (s.qk_nope_dim + s.v_head_dim), tuner,
                site="mla.up_proj_kv")
    k_nope = linear(c_kv, p["wk_b"]).reshape(b, sk, h, s.qk_nope_dim)
    v = linear(c_kv, p["wv_b"]).reshape(b, sk, h, s.v_head_dim)
    k_rope_h = k_rope[:, :, None, :].expand(b, sk, h, s.qk_rope_dim)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    return k, v


def mla_train(p: dict, x: torch.Tensor, s: MLASpec, tuner=None, tp=None
              ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns (out, (c_kv, k_rope)) — the latents seed the decode cache.

    With ``tp`` (H divisible by its size) the rank computes the latents
    whole and its whole query heads on them: q, k_nope and v through its
    columns of ``wq_b``, ``wk_b`` and ``wv_b``, the shared rope key
    broadcast to its heads, the attention core on them and the output
    through its rows of ``wo``, summed over the group.  The latents
    returned are whole; the recorder sees every head."""
    b, sq, _ = x.shape
    h = _heads(s, tp)
    positions = torch.arange(sq, device=x.device)
    q, c_kv, k_rope = _latents(p, x, s, positions, tuner, tp)
    k, v = _expand_kv(p, c_kv, k_rope, s, h, tuner)
    # causal scores: SYRK-shaped like GQA attention (triangular output)
    ops.observe(sq, s.qk_head_dim, sq, tuner, routine="syrk",
                site="mla.qk", count=b * s.n_heads)
    out = chunked_attention_xla(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=None, chunk=min(512, sq))
    del q, k, v
    out = linear(out.transpose(1, 2).reshape(b, sq, h * s.v_head_dim),
                 p["wo"])
    if tp is not None:
        out = C.reduce_from(out, tp.group)
    return out, (c_kv, k_rope)


@dataclasses.dataclass
class MLACache:
    """Compressed latent cache: (B, cap, kv_lora_rank) + (B, cap, rope)."""
    c_kv: torch.Tensor
    k_rope: torch.Tensor


def init_mla_cache(batch: int, capacity: int, s: MLASpec,
                   dtype: torch.dtype, *,
                   device: torch.device | str = "cpu") -> MLACache:
    return MLACache(
        torch.zeros((batch, capacity, s.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, capacity, s.qk_rope_dim), dtype=dtype,
                    device=device))


def seed_mla_cache(c_kv: torch.Tensor, k_rope: torch.Tensor,
                   capacity: int) -> MLACache:
    """The decode cache from prefill latents: the first S slots filled,
    the rest zero."""
    b, sq, r = c_kv.shape
    if capacity < sq:
        raise ValueError(f"prompt {sq} exceeds cache {capacity}")
    cache = MLACache(
        c_kv.new_zeros((b, capacity, r)),
        k_rope.new_zeros((b, capacity, k_rope.shape[-1])))
    cache.c_kv[:, :sq] = c_kv
    cache.k_rope[:, :sq] = k_rope
    return cache


def _absorb(p: dict, s: MLASpec, q: torch.Tensor) -> torch.Tensor:
    """The absorbed query (B, H', R_kv + R_rope) fp32 of the H' heads of
    q (B, 1, H', qk_head_dim): q_nope through those heads' columns of
    wk_b (the absorbed-projection trick: the cache is never decompressed
    to per-head K), then q_rope, in one tensor (one collective moves
    both)."""
    h = q.shape[2]
    wk_b = p["wk_b"].reshape(s.kv_lora_rank, h, s.qk_nope_dim)
    q_lat = torch.einsum("bohd,rhd->bhr", q[..., : s.qk_nope_dim].float(),
                         wk_b.float())
    return torch.cat([q_lat, q[:, 0, :, s.qk_nope_dim:].float()], dim=-1)


def _absorbed_scores(s: MLASpec, qa: torch.Tensor, c_kv32: torch.Tensor,
                     k_rope: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """fp32 scores (B, H', n) of the absorbed query ``qa``
    (:func:`_absorb`) over the latent slots c_kv32 (B, n, R_kv, fp32) and
    k_rope (B, n, R_rope), masked to -1e30 where ``valid`` (1 or B, n) is
    false."""
    r = s.kv_lora_rank
    s_lat = torch.einsum("bhr,bkr->bhk", qa[..., :r], c_kv32)
    s_rope = torch.einsum("bhd,bkd->bhk", qa[..., r:], k_rope.float())
    scores = (s_lat + s_rope) * (s.qk_head_dim ** -0.5)
    return torch.where(valid[:, None, :], scores, _NEG_INF)


def _every_head(qa: torch.Tensor, tp) -> torch.Tensor:
    """The absorbed query of every head from each rank's heads, gathered
    over ``tp``'s group (unchanged without ``tp``): a split-KV read
    scores every head over the rank's own slots."""
    return qa if tp is None else C.all_gather(qa, tp.group, dim=1)


def _own_heads(o_lat: torch.Tensor, tp) -> torch.Tensor:
    """This rank's heads of o_lat (B, H, R_kv) (all of them without
    ``tp``)."""
    if tp is None:
        return o_lat
    n = o_lat.shape[1] // tp.size
    return o_lat[:, tp.rank * n:(tp.rank + 1) * n]


def _absorbed_out(p: dict, x: torch.Tensor, s: MLASpec,
                  o_lat: torch.Tensor, tp=None) -> torch.Tensor:
    """The attention output in latent space o_lat (B, H', R_kv) of the
    heads the rank computes out through their columns of wv_b, then
    their rows of the output projection (with ``tp`` summed over the
    group)."""
    b, h = x.shape[0], o_lat.shape[1]
    wv_b = p["wv_b"].reshape(s.kv_lora_rank, h, s.v_head_dim)
    out = torch.einsum("bhr,rhd->bhd", o_lat, wv_b.float())
    out = linear(out.reshape(b, 1, h * s.v_head_dim).to(x.dtype), p["wo"])
    return out if tp is None else C.reduce_from(out, tp.group)


def _absorbed_attend(p: dict, x: torch.Tensor, s: MLASpec,
                     q: torch.Tensor, c_kv: torch.Tensor,
                     k_rope: torch.Tensor, valid: torch.Tensor,
                     tp=None) -> torch.Tensor:
    """The one-token attention both decode paths share over a whole
    (uncut) cache, in latent space: q (B, 1, H', qk_head_dim) of the
    heads the rank computes over c_kv (B, cap, R_kv) and k_rope (B, cap,
    R_rope) with ``valid`` (1 or B, cap) masking the slots it may read,
    then the output projection (:func:`_absorbed_out`)."""
    c_kv32 = c_kv.float()
    probs = torch.softmax(_absorbed_scores(s, _absorb(p, s, q), c_kv32,
                                           k_rope, valid), dim=-1)
    o_lat = torch.einsum("bhk,bkr->bhr", probs, c_kv32)
    return _absorbed_out(p, x, s, o_lat, tp)


def mla_decode(p: dict, x: torch.Tensor, s: MLASpec, cache,
               pos: int, tuner=None, tp=None):
    """One-token decode against the latent cache: x (B, 1, D); ``pos`` =
    tokens so far.  The new latent row is written into ``cache`` in
    place (slot ``min(pos, cap - 1)``, where the reference's
    ``dynamic_update_slice`` clamps), and the same cache is returned.

    With ``tp`` the rank computes the latents whole and its whole query
    heads (as :func:`mla_train`): it absorbs their q_nope through its
    columns of wk_b, decompresses their o_lat through its columns of
    wv_b and leaves through its rows of wo, summed over the group.

    A :class:`~repro_torch.models.layers.SplitKV` cache (the latent
    cache cut on its sequence over 'model') is read split-KV: the rank
    that holds the slot writes the row; the absorbed query of every head
    is gathered over the group (small: B x H x R_kv); each rank's
    absorbed scores and latent output over its own slots are a partial
    softmax, merged by
    :func:`~repro_torch.dist.collectives.softmax_combine`; the rank
    keeps its heads.  An uncut cache is read whole on the rank's heads,
    with no gather."""
    from repro_torch.dist.collectives import softmax_combine
    from repro_torch.models.layers import SplitKV, cache_slots

    b = x.shape[0]
    positions = torch.full((1,), pos, device=x.device)
    q, c_kv_new, k_rope_new = _latents(p, x, s, positions, tuner, tp)
    lat, slots = cache_slots(cache)
    # latent cache update: sequential append + triangular-prefix read,
    # TRSM-adjacent exactly like the GQA KV cache update
    ops.observe(slots.cap, s.kv_lora_rank, b * s.n_heads,
                tuner, routine="trsm", site="mla.cache_update")
    here = slots.local(min(int(pos), slots.cap - 1))
    if here is not None:
        lat.c_kv[:, here] = c_kv_new[:, 0]
        lat.k_rope[:, here] = k_rope_new[:, 0]
    valid = (slots.ids(x.device) <= pos)[None, :]
    if not isinstance(cache, SplitKV):
        return _absorbed_attend(p, x, s, q, lat.c_kv, lat.k_rope,
                                valid, tp), cache
    c_kv32 = lat.c_kv.float()
    qa = _every_head(_absorb(p, s, q), tp)
    e, m, l = softmax_parts(_absorbed_scores(s, qa, c_kv32, lat.k_rope,
                                             valid))
    o_lat = softmax_combine(torch.einsum("bhk,bkr->bhr", e, c_kv32), m, l,
                            cache.tp.group)
    return _absorbed_out(p, x, s, _own_heads(o_lat, tp), tp), cache


def _absorbed_pages(p: dict, s: MLASpec, view, plan, q: torch.Tensor,
                    c_kv_new: torch.Tensor, k_rope_new: torch.Tensor,
                    tp=None) -> torch.Tensor:
    """The paged latent decode's attention on a mesh, over a
    :class:`~repro_torch.serve.kv_cache.PagedSplit` latent pool: q
    (B_loc, 1, H', qk_head_dim) of the heads the rank computes (with
    ``tp`` its own; their absorbed query is gathered over the group to
    every head) and the new latent rows of this rank's rows.  The rows
    of every slot are gathered; the rank writes its columns of the new
    rows of the slots whose pages it stores, and attends every slot over
    its pages on its columns of ``kv_lora_rank`` and ``qk_rope_dim``
    (partial absorbed scores, summed over 'model' for a cut field); the
    partial softmaxes are merged over the page axes, the rank keeps its
    rows, its columns of o_lat are joined over 'model' and it keeps its
    heads.  Returns o_lat (B_loc, H', R_kv) fp32, normalised."""
    from repro_torch.dist.collectives import softmax_combine
    from repro_torch.models.layers import page_mask, page_parts
    from repro_torch.serve.kv_cache import append_token, gather_pages

    if any(c not in (None, 2) for c in view.cuts.values()):
        raise NotImplementedError(
            f"paged decode of a latent pool cut on dims {view.cuts} over "
            "'model'")
    pool = view.pool
    r = s.kv_lora_rank
    qa = view.gather(_every_head(_absorb(p, s, q), tp))
    new = view.gather(torch.cat([c_kv_new, k_rope_new], dim=-1))
    c_kv_new, k_rope_new = new[..., :r], new[..., r:]
    active = plan.pos >= 0
    append_token(pool.c_kv, plan.table, plan.pos,
                 view.piece(c_kv_new[:, 0], "c_kv"), active, plan)
    append_token(pool.k_rope, plan.table, plan.pos,
                 view.piece(k_rope_new[:, 0], "k_rope"), active, plan)
    c_kv32 = gather_pages(pool.c_kv, plan.table, plan).float()
    k_rope = gather_pages(pool.k_rope, plan.table, plan)
    s_lat = torch.einsum("bhr,bkr->bhk", view.piece(qa[..., :r], "c_kv"),
                         c_kv32)
    s_rope = torch.einsum("bhd,bkd->bhk", view.piece(qa[..., r:], "k_rope"),
                          k_rope.float())
    scores = view.scores([(s_lat, "c_kv"), (s_rope, "k_rope")]) \
        * (s.qk_head_dim ** -0.5)
    e, m, l = page_parts(scores, *page_mask(plan, plan.pos,
                                            c_kv32.shape[1],
                                            pool.page_size))
    o_lat = softmax_combine(torch.einsum("bhk,bkr->bhr", e, c_kv32), m, l,
                            view.pages)
    return _own_heads(view.join(view.keep(o_lat), "c_kv"), tp)


def mla_decode_paged(p: dict, x: torch.Tensor, s: MLASpec, pool,
                     page_table: torch.Tensor, pos: torch.Tensor,
                     tuner=None, plan=None, tp=None):
    """One-token decode against a paged latent pool (continuous batching).

    The paged twin of :func:`mla_decode`: ``pos`` is (B,) int per-
    sequence positions (-1 = inactive slot), ``page_table`` (B, P) maps
    logical pages to physical pages of the
    :class:`repro_torch.serve.kv_cache.PagedLatent` pool.  Same absorbed
    attention (:func:`_absorbed_attend`) on the page-gathered latent
    view; the latent cache update keeps its TRSM-site recorder tag.  The
    new rows are written into the pool in place and the same pool is
    returned; an inactive slot writes nothing, with no host sync.
    ``plan`` is the step's
    :func:`~repro_torch.serve.kv_cache.plan_step` for this table and
    these positions, computed once for all layers (else here).  A
    :class:`~repro_torch.serve.kv_cache.PagedSplit` pool (on a mesh) is
    read split-KV over its pages (:func:`_absorbed_pages`).  With ``tp``
    the rank computes its whole query heads, as :func:`mla_decode`.
    """
    from repro_torch.serve.kv_cache import (PagedSplit, append_token,
                                            gather_pages, plan_step)

    b = x.shape[0]
    q, c_kv_new, k_rope_new = _latents(p, x, s, pos[:, None], tuner, tp)
    cap = page_table.shape[1] * pool.page_size
    ops.observe(cap, s.kv_lora_rank, b * s.n_heads,
                tuner, routine="trsm", site="mla.cache_update")
    if plan is None:
        plan = plan_step(pool, page_table, pos)
    if isinstance(pool, PagedSplit):
        o_lat = _absorbed_pages(p, s, pool, plan, q, c_kv_new, k_rope_new,
                                tp)
        return _absorbed_out(p, x, s, o_lat, tp), pool
    active = pos >= 0
    append_token(pool.c_kv, page_table, pos, c_kv_new[:, 0], active, plan)
    append_token(pool.k_rope, page_table, pos, k_rope_new[:, 0], active,
                 plan)
    c_kv = gather_pages(pool.c_kv, page_table, plan)       # (B, cap, R_kv)
    k_rope = gather_pages(pool.k_rope, page_table, plan)   # (B, cap, R_rope)
    valid = (torch.arange(cap, device=x.device)[None, :]
             <= pos[:, None])
    return _absorbed_attend(p, x, s, q, c_kv, k_rope, valid, tp), pool
