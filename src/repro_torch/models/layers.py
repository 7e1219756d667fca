"""Shared layer library, dense subset: norms, MLPs, RoPE, GQA attention
(train/prefill through ``ops.flash_attention`` — the flash kernel, or
the reference's XLA paths on the ``library`` backend — chunked-softmax
attention for long sequences, one-token decode over a full or ring KV
cache, fp or int8, or over a paged KV pool for continuous batching).

Plain functions on tensors; parameters arrive as dicts built from the
ParamDef trees, as in :mod:`repro.models.layers`.  Activations are
(B, S, D).  The projections are ``torch.matmul`` (the reference leaves
them to XLA); the attention core of prefill is one
:func:`repro_torch.kernels.ops.flash_attention` dispatch.

Tensor parallelism (``tp``, a :class:`~repro_torch.dist.collectives.
TPGroup` of the 'model' axis): :func:`attention_train` and
:func:`apply_mlp` then run on this rank's shard of the weights, the
whole heads of its range (:func:`head_range`: ⌈H / tp⌉ a rank, none
past the last head) and its slice of the FF width, between ``copy_to``
on the block's input and ``reduce_from`` on its output (Megatron's f
and g), as GSPMD partitions the reference's; :func:`attention_decode`
too, or, where the axis does not divide the heads, on the weights'
stored columns (a cut that may end inside a head), and it reads a cache
cut on its sequence (:class:`SplitKV`) as a split softmax.  The
recorder's events keep the global widths.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as C
from repro_torch.kernels import ops
from repro_torch.models.params import ParamDef

__all__ = [
    "rmsnorm", "layernorm", "norm_defs", "apply_norm",
    "linear", "mlp_defs", "apply_mlp",
    "rope_angles", "apply_rope",
    "attention_defs", "attention_train", "attention_decode",
    "chunked_attention_xla", "head_range", "kv_range", "tp_heads",
    "kv_heads_whole",
    "attention_decode_paged", "decode_partial", "softmax_parts",
    "page_mask", "page_parts",
    "AttnSpec", "KVCache", "SplitKV", "CacheSlots", "cache_slots",
    "init_kv_cache", "seed_kv_cache",
]

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def norm_defs(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamDef((d,), ("embed",), init="ones")}
    return {"scale": ParamDef((d,), ("embed",), init="ones"),
            "bias": ParamDef((d,), ("embed",), init="zeros")}


def apply_norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# Linear / MLP
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., in) @ (in, out) keeping leading dims."""
    return torch.matmul(x, w)


def mlp_defs(d: int, ff: int, kind: str) -> dict:
    if kind in ("swiglu", "geglu"):
        return {"wi": ParamDef((d, ff), ("embed", "ff")),
                "wg": ParamDef((d, ff), ("embed", "ff")),
                "wo": ParamDef((ff, d), ("ff", "embed"))}
    return {"wi": ParamDef((d, ff), ("embed", "ff")),
            "wo": ParamDef((ff, d), ("ff", "embed"))}


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(p: dict, x: torch.Tensor, kind: str,
              tuner=None, tp=None) -> torch.Tensor:
    """The MLP on x; with ``tp`` the weights are this rank's FF slice
    (wi / wg columns, wo rows) and the partial output is summed over
    the group."""
    m = 1
    for dim in x.shape[:-1]:
        m *= dim
    d, ff = p["wi"].shape[-2], p["wi"].shape[-1]
    if tp is not None:
        ff *= tp.size
        x = C.copy_to(x, tp.group)
    n_in = 2 * ff if kind in ("swiglu", "geglu") else ff
    ops.observe(m, d, n_in, tuner, site="mlp.in_proj")
    ops.observe(m, ff, d, tuner, site="mlp.out_proj")
    if kind == "swiglu":
        out = linear(F.silu(linear(x, p["wg"])) * linear(x, p["wi"]),
                     p["wo"])
    elif kind == "geglu":
        out = linear(_gelu(linear(x, p["wg"])) * linear(x, p["wi"]),
                     p["wo"])
    else:
        out = linear(_gelu(linear(x, p["wi"])), p["wo"])
    return out if tp is None else C.reduce_from(out, tp.group)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, dim: int,
                base: float = 10_000.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape (..., dim/2) for integer positions."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv_freq = 1.0 / torch.pow(base, exps)
    ang = positions.float()[..., None] * inv_freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               fraction: float = 1.0) -> torch.Tensor:
    """Rotate the first ``fraction`` of the head dim; x: (B, S, H, Dh),
    sin/cos: (S, rot/2) — or (B, S, rot/2) when every sequence in the
    batch sits at its own position (the continuous-batching paged
    decode path, where positions are (B, S))."""
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2].float(), xr[..., rot // 2:].float()
    if sin.dim() == 3:    # per-sequence positions: (B, S, rot/2)
        sin_ = sin[:, :, None, : rot // 2].float()
        cos_ = cos[:, :, None, : rot // 2].float()
    else:
        sin_ = sin[None, :, None, : rot // 2].float()
        cos_ = cos[None, :, None, : rot // 2].float()
    out = torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_fraction: float = 1.0
    window: int | None = None
    qk_norm: bool = False
    causal: bool = True


def attention_defs(s: AttnSpec) -> dict:
    d, h, hk, hd = s.d_model, s.n_heads, s.n_kv_heads, s.head_dim
    defs = {"wq": ParamDef((d, h * hd), ("embed", "heads")),
            "wk": ParamDef((d, hk * hd), ("embed", "kv_heads")),
            "wv": ParamDef((d, hk * hd), ("embed", "kv_heads")),
            "wo": ParamDef((h * hd, d), ("heads", "embed"))}
    if s.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="ones")
        defs["k_norm"] = ParamDef((hd,), (None,), init="ones")
    return defs


def _project_qkv(p: dict, x: torch.Tensor, s: AttnSpec,
                 positions: torch.Tensor, tuner=None,
                 local: AttnSpec | None = None, gather=None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, heads, Dh) of ``local``'s heads (default all of
    ``s``'s); the recorder sees ``s``'s whole projection.  With
    ``gather`` (a TPGroup) ``p`` holds the rank's stored columns of
    ``wq``, ``wk`` and ``wv``: each projection is gathered over the
    group to every head before the qk norms and RoPE, which a column
    cut ending inside a head would split."""
    b, sq, d = x.shape
    # the q/k/v projections are plain GEMMs; tag them so the recorded
    # routine mix carries the dense dispatch volume
    ops.observe(b * sq, d,
                (s.n_heads + 2 * s.n_kv_heads) * s.head_dim, tuner,
                site="attn.qkv_proj")
    q, k, v = (linear(x, p[w]) for w in ("wq", "wk", "wv"))
    if gather is not None:
        # contiguous: a gathered last dim is a strided view
        q, k, v = (C.all_gather(t, gather.group, dim=-1).contiguous()
                   for t in (q, k, v))
    s = local or s
    q = q.reshape(b, sq, s.n_heads, s.head_dim)
    k = k.reshape(b, sq, s.n_kv_heads, s.head_dim)
    v = v.reshape(b, sq, s.n_kv_heads, s.head_dim)
    if s.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if s.rope_fraction > 0:
        sin, cos = rope_angles(positions, int(s.head_dim * s.rope_fraction))
        frac = 1.0 if s.rope_fraction == 1.0 else s.rope_fraction
        q = apply_rope(q, sin, cos, frac)
        k = apply_rope(k, sin, cos, frac)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_heads: int,
               index: list[int] | None = None) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, H, D) by repeating each KV head, or, with
    ``index``, query head j reading KV head ``index[j]``."""
    if index is not None:
        return k.index_select(2, torch.tensor(index, device=k.device))
    hk = k.shape[2]
    if hk == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // hk, dim=2)


def head_range(s: AttnSpec, size: int, rank: int) -> tuple[int, int]:
    """[lo, hi) of the whole query heads rank ``rank`` of a ``size``-way
    cut computes: ⌈H / size⌉ a rank in rank order, the rest on the last
    rank that has any, none past it (H / size each where size divides
    H)."""
    per = -(-s.n_heads // size)
    lo = min(rank * per, s.n_heads)
    return lo, min(lo + per, s.n_heads)


def kv_range(s: AttnSpec, size: int, rank: int) -> tuple[int, int]:
    """[lo, hi) of the KV heads that rank ``rank`` of a ``size``-way cut
    of the query heads reads (query head h reads KV head h // (H /
    Hkv)); empty where the rank has no query head."""
    lo, hi = head_range(s, size, rank)
    group = s.n_heads // s.n_kv_heads
    if lo == hi:
        return lo // group, lo // group
    return lo // group, (hi - 1) // group + 1


def tp_heads(s: AttnSpec, tp) -> tuple[AttnSpec, int, int,
                                       list[int] | None]:
    """(local spec, KV lo, KV hi, KV index or None) of this rank's whole
    query heads (:func:`head_range`; maybe none): the local spec counts
    its query heads and the KV heads they read; the index maps each
    local query head to its local KV head where that is not a plain
    repeat."""
    q_lo, q_hi = head_range(s, tp.size, tp.rank)
    lo, hi = kv_range(s, tp.size, tp.rank)
    n, n_kv = q_hi - q_lo, hi - lo
    group = s.n_heads // s.n_kv_heads
    index = [(q_lo + j) // group - lo for j in range(n)]
    if not n or (n % n_kv == 0 and index == [j // (n // n_kv)
                                             for j in range(n)]):
        index = None
    return dataclasses.replace(s, n_heads=n, n_kv_heads=n_kv), lo, hi, \
        index


def _rank_weights(p: dict, s: AttnSpec, tp) -> dict:
    """The weights of this rank's heads from those the layout gives it:
    where the axis does not divide H (the weights whole) ``wq``'s
    columns and ``wo``'s rows of its query heads, and where it does not
    divide Hkv ``wk``'s and ``wv``'s columns of the KV heads they read;
    cuts of whole heads pass as they are."""
    hd = s.head_dim
    if s.n_heads % tp.size:
        lo, hi = head_range(s, tp.size, tp.rank)
        p = {**p, "wq": p["wq"][:, lo * hd:hi * hd],
             "wo": p["wo"][lo * hd:hi * hd]}
    if s.n_kv_heads % tp.size:
        lo, hi = kv_range(s, tp.size, tp.rank)
        p = {**p, "wk": p["wk"][:, lo * hd:hi * hd],
             "wv": p["wv"][:, lo * hd:hi * hd]}
    return p


def kv_heads_whole(k: torch.Tensor, s: AttnSpec, tp) -> torch.Tensor:
    """Each rank's (B, S, KV heads of its range, Dh) -> the whole (B, S,
    Hkv, Dh), the same on every rank: the pieces gathered over the group
    (padded to the widest range), each KV head taken from the first rank
    that holds it."""
    ranges = [kv_range(s, tp.size, r) for r in range(tp.size)]
    width = max(hi - lo for lo, hi in ranges)
    if k.shape[2] < width:
        k = F.pad(k, (0, 0, 0, width - k.shape[2]))
    whole = C.all_gather(k, tp.group, dim=2)
    index = []
    for h in range(s.n_kv_heads):
        r = next(r for r, (lo, hi) in enumerate(ranges) if lo <= h < hi)
        index.append(r * width + h - ranges[r][0])
    if index == list(range(whole.shape[2])):
        return whole
    return whole.index_select(2, torch.tensor(index, device=k.device))


def chunked_attention_xla(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool,
                          window: int | None, q_offset: int = 0,
                          chunk: int = 512) -> torch.Tensor:
    """Softmax attention over query chunks (the reference's XLA path).

    Never materialises the full (Sq, Skv) score matrix: per chunk the
    live score block is (B, H, chunk, Skv).  q/k: (B, H, S, Dh), v:
    (B, H, Skv, Dv) — Dv may differ from Dh; query i sits at position
    ``q_offset + i``.  Scaled by Dh^-0.5.
    """
    b, h, sq, dh = q.shape
    skv, dv = k.shape[2], v.shape[3]
    out = ops.chunked_attention(
        q.reshape(b * h, sq, dh), k.reshape(b * h, skv, dh),
        v.reshape(b * h, skv, dv), causal=causal, window=window,
        sm_scale=dh ** -0.5, chunk=chunk, q_offset=q_offset)
    return out.reshape(b, h, sq, dv)


def attention_train(p: dict, x: torch.Tensor, s: AttnSpec, tuner=None,
                    backend: str = "auto", tp=None
                    ) -> tuple[torch.Tensor,
                               tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence self-attention (training / prefill internals).

    Returns (out, (k, v)) — the pre-repeat (B, S, Hkv, Dh) projections so
    prefill can seed the decode cache without recomputation.  The
    attention core is one :func:`ops.flash_attention` dispatch on the
    flattened (B*H, Sq, Dh) heads, on ``backend``: causal layers
    dispatch as routine="attn" and the tuner resolves the flash blocks
    and the dense vs block-sparse triangular KV walk, and — on the
    ``library`` backend, the one training takes — whether the SYRK
    score-materialisation path wins for this shape.

    With ``tp`` the rank computes its whole query heads
    (:func:`head_range`): ``wq``'s columns and ``wo``'s rows of them,
    which it is given where the axis divides H and takes from the whole
    weights where it does not, and ``wk`` / ``wv`` its columns where Hkv
    is divisible too, else the columns of the KV heads its query heads
    read, taken from the whole weights (:func:`tp_heads`,
    :func:`_rank_weights`; a gradient of a whole weight is then a
    partial sum over the group).  A rank past the last head launches no
    attention and adds zeros to the sum, through the same collectives.
    (k, v) are the local KV heads (:func:`kv_heads_whole` joins them);
    the flash dispatch records the group's B x H heads.
    """
    b, sq, _ = x.shape
    local, index = s, None
    if tp is not None:
        local, _, _, index = tp_heads(s, tp)
        p = _rank_weights(p, s, tp)
        x = C.copy_to(x, tp.group)
    positions = torch.arange(sq, device=x.device)
    q, k, v = _project_qkv(p, x, s, positions, tuner, local)
    if local.n_heads:
        kr = _repeat_kv(k, local.n_heads, index)
        vr = _repeat_kv(v, local.n_heads, index)
        flat = (b * local.n_heads, sq, s.head_dim)
        out = ops.flash_attention(
            q.transpose(1, 2).reshape(flat).contiguous(),
            kr.transpose(1, 2).reshape(flat).contiguous(),
            vr.transpose(1, 2).reshape(flat).contiguous(),
            causal=s.causal, window=s.window, tuner=tuner, site="attn.core",
            backend=backend, count=b * s.n_heads)
        out = out.reshape(b, local.n_heads, sq, s.head_dim).transpose(1, 2)
    else:
        # no head here: the empty q, k and v stand for the attention's
        # output, so that every weight's (zero) gradient and x's (through
        # copy_to's sum) still pass
        out = q + k + v
    ops.observe(b * sq, s.n_heads * s.head_dim, x.shape[-1], tuner,
                site="attn.out_proj")
    out = linear(out.reshape(b, sq, local.n_heads * s.head_dim), p["wo"])
    if tp is not None:
        out = C.reduce_from(out, tp.group)
    return out, (k, v)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Either a full cache (capacity = max seq) or a ring buffer
    (capacity = window) for sliding-window layers.

    Optionally int8-quantised, as the reference's: k/v stored int8 with
    a per-(batch, slot, head) fp16 scale."""
    k: torch.Tensor            # (B, cap, Hkv, Dh) — float or int8
    v: torch.Tensor
    windowed: bool = False
    k_scale: torch.Tensor | None = None    # (B, cap, Hkv) when quantised
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_cache(batch: int, capacity: int, n_kv_heads: int,
                  head_dim: int, dtype: torch.dtype, *,
                  device: torch.device | str = "cpu",
                  windowed: bool = False,
                  quantized: bool = False) -> KVCache:
    shape = (batch, capacity, n_kv_heads, head_dim)
    if quantized:
        sshape = (batch, capacity, n_kv_heads)
        return KVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device), windowed,
            torch.ones(sshape, dtype=torch.float16, device=device),
            torch.ones(sshape, dtype=torch.float16, device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   windowed)


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) -> int8 values + per-(B, S, H) fp16 scales: max |x|
    over D / 127 (at least 1e-8) in fp32, round half to even, clip to
    ±127 — the reference's arithmetic, so payload and scales are equal
    bit for bit."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def seed_kv_cache(k: torch.Tensor, v: torch.Tensor, capacity: int, *,
                  windowed: bool, quantized: bool = False) -> KVCache:
    """Build the decode cache from prefill projections k/v (B, S, Hkv, D).

    Full cache: the first S slots filled, the rest zero.  Ring cache: the
    last ``capacity`` positions land at slot = pos % capacity (a cyclic
    roll), or, for a prompt shorter than the ring, the first S slots.
    ``quantized`` quantises the whole seeded cache, empty slots included
    (as the reference quantises its padded cache: their scale is 1e-8
    in fp16, i.e. 0).
    """
    b, sq, hk, hd = k.shape
    if windowed and sq >= capacity:
        shift = sq % capacity
        cache = KVCache(torch.roll(k[:, -capacity:], shift, dims=1),
                        torch.roll(v[:, -capacity:], shift, dims=1), True)
    else:
        if capacity < sq:
            raise ValueError(f"prompt {sq} exceeds cache {capacity}")
        cache = init_kv_cache(b, capacity, hk, hd, k.dtype,
                              device=k.device, windowed=windowed)
        cache.k[:, :sq] = k
        cache.v[:, :sq] = v
    if quantized:
        kq, ks = _quantize_kv(cache.k)
        vq, vs = _quantize_kv(cache.v)
        return KVCache(kq, vq, windowed, ks, vs)
    return cache


def _decode_scores(q: torch.Tensor, k: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """fp32 scores (B, H, n) of one query a head, q (B, 1, H, Dh), over
    slots k (B, n, Hkv, Dh), scaled by Dh^-0.5 and masked to -1e30 where
    ``valid`` (1 or B, n) is false."""
    kk = _repeat_kv(k, q.shape[2])
    scores = torch.einsum("bohd,bkhd->bhk", q.float(),
                          kk.float()) * (q.shape[-1] ** -0.5)
    return torch.where(valid[:, None, :], scores, _NEG_INF)


def softmax_parts(scores: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(exp(scores - m), m, l) of scores (..., n): the row max m and the
    row sum l of the exponentials, for a split softmax."""
    m = scores.amax(dim=-1)
    e = torch.exp(scores - m[..., None])
    return e, m, e.sum(dim=-1)


def decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One query a head over a chunk of the cache's slots, as a partial
    softmax: q (B, 1, H, Dh), k / v (B, n, Hkv, Dh), ``valid`` (1 or B,
    n) -> (o (B, H, Dh) fp32, not normalised; m (B, H) the max score;
    l (B, H) the sum of exponentials), for
    :func:`~repro_torch.dist.collectives.softmax_combine`.  The scores
    are the single-device decode's (:func:`_decode_scores`)."""
    e, m, l = softmax_parts(_decode_scores(q, k, valid))
    o = torch.einsum("bhk,bkhd->bhd", e, _repeat_kv(v, q.shape[2]).float())
    return o, m, l


def _decode_out(p: dict, x: torch.Tensor, s: AttnSpec, out: torch.Tensor,
                tuner, tp=None, cols: bool = False) -> torch.Tensor:
    """The output projection of the attention ``out`` (B, H, Dh) of every
    head; with ``tp`` the rank's heads through its rows of ``wo`` (with
    ``cols`` its stored rows: its block of the H x Dh columns of ``out``),
    summed over the group."""
    b = x.shape[0]
    ops.observe(b, s.n_heads * s.head_dim, x.shape[-1], tuner,
                site="attn.out_proj")
    if tp is not None and cols:
        n = p["wo"].shape[0]
        out = out.reshape(b, -1)[:, tp.rank * n:(tp.rank + 1) * n]
    elif tp is not None:
        out = out[:, slice(*head_range(s, tp.size, tp.rank))]
    y = linear(out.reshape(b, 1, -1).to(x.dtype), p["wo"])
    return y if tp is None else C.reduce_from(y, tp.group)


def _decode_attend(p: dict, x: torch.Tensor, s: AttnSpec, q: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                   tuner, tp=None, cols: bool = False) -> torch.Tensor:
    """The one-token attention both decode paths share: q (B, 1, H, Dh)
    over k, v (B, cap, Hkv, Dh) with ``valid`` (1 or B, cap) masking the
    slots it may read, then the output projection."""
    probs = torch.softmax(_decode_scores(q, k, valid), dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs,
                       _repeat_kv(v, s.n_heads).float())
    return _decode_out(p, x, s, out, tuner, tp, cols)


@dataclasses.dataclass
class SplitKV:
    """A decode cache cut on its sequence (dim 1 of each of its tensors)
    over ``tp``'s group: ``cache`` (a :class:`KVCache` or an MLA latent
    cache) holds this rank's slots ``[tp.rank * n, (tp.rank + 1) * n)``
    of ``tp.size * n``.  The decode reads it split-KV: each rank attends
    over its own slots and the partial softmaxes are combined."""
    cache: Any
    tp: Any


@dataclasses.dataclass(frozen=True)
class CacheSlots:
    """Where a decode cache's slots lie: this rank holds the global slots
    ``[lo, lo + n)`` of ``cap``."""
    lo: int
    n: int
    cap: int

    def local(self, slot: int) -> int | None:
        """The local index of global ``slot``, or None where another rank
        holds it (this rank then writes nothing)."""
        here = slot - self.lo
        return here if 0 <= here < self.n else None

    def ids(self, device) -> torch.Tensor:
        """The global ids of this rank's slots, on which the masks are
        computed."""
        return self.lo + torch.arange(self.n, device=device)


def cache_slots(cache) -> tuple[Any, CacheSlots]:
    """(the cache a decode step reads and writes, its slots): a
    :class:`SplitKV`'s local piece and its place in the whole cache, or
    any other cache (a :class:`KVCache`, an MLA latent cache) with every
    slot."""
    local = cache.cache if isinstance(cache, SplitKV) else cache
    n = getattr(local, dataclasses.fields(local)[0].name).shape[1]
    if isinstance(cache, SplitKV):
        return local, CacheSlots(cache.tp.rank * n, n, cache.tp.size * n)
    return local, CacheSlots(0, n, n)


def _decode_qkv(p: dict, x: torch.Tensor, s: AttnSpec,
                positions: torch.Tensor, tuner, tp, cols: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, 1, H, Dh) and the new k, v (B, 1, Hkv, Dh) of every head;
    with ``tp`` projected on the rank's heads (as :func:`attention_train`
    does, ``p`` being :func:`_rank_weights`') and gathered over the
    group, or with ``cols`` projected on the rank's stored columns and
    gathered before the qk norms and RoPE."""
    if tp is None or cols:
        return _project_qkv(p, x, s, positions, tuner,
                            gather=tp if cols else None)
    local, _, _, _ = tp_heads(s, tp)
    q, k, v = _project_qkv(p, x, s, positions, tuner, local)
    return (C.all_gather(q, tp.group, dim=2), kv_heads_whole(k, s, tp),
            kv_heads_whole(v, s, tp))


def attention_decode(p: dict, x: torch.Tensor, s: AttnSpec, cache,
                     pos: int, tuner=None, tp=None, cols: bool = False):
    """One-token decode: x (B, 1, D); ``pos`` = tokens so far.

    The cache update is tagged routine="trsm" as in the reference (a
    sequential append + triangular-prefix read).  A ring cache writes
    slot ``pos % cap`` and reads the last ``min(pos + 1, cap)`` writes.
    Unlike the reference, whose ``dynamic_update_slice`` returns a new
    array, the new row is written into ``cache`` in place, and the same
    cache is returned; an int8 cache takes the quantised row and its
    scales in place too, and attends over the dequantised cache.

    On a mesh: with ``tp`` q, k and v are projected on the rank's heads
    and gathered, and the output leaves through the rank's rows of
    ``wo`` (Megatron's g); with ``cols`` too (where the axis does not
    divide the heads or the KV heads) ``p`` holds the weights as
    stored, the rank's columns of ``wq``, ``wk`` and ``wv`` and rows of
    ``wo``, which a decode step takes with no move: the projections are
    gathered and the qk norms and RoPE applied to every head after the
    gather, and the output leaves through the stored rows.  A
    :class:`SplitKV` cache is read split-KV: the rank that holds the
    written slot writes it, each rank attends every head over its own
    slots (the mask on global slot ids), and
    :func:`~repro_torch.dist.collectives.softmax_combine` merges them.
    """
    b = x.shape[0]
    if tp is not None and not cols:
        p = _rank_weights(p, s, tp)
    positions = torch.full((1,), pos, device=x.device)
    q, k_new, v_new = _decode_qkv(p, x, s, positions, tuner, tp, cols)
    kv, slots = cache_slots(cache)
    cap = slots.cap
    ops.observe(cap, s.head_dim, b * s.n_heads, tuner,
                routine="trsm", site="attn.cache_update")
    slot = int(pos) % cap if kv.windowed else min(int(pos), cap - 1)
    here = slots.local(slot)
    if kv.quantized:
        if here is not None:
            kq, ks = _quantize_kv(k_new)
            vq, vs = _quantize_kv(v_new)
            kv.k[:, here] = kq[:, 0]
            kv.v[:, here] = vq[:, 0]
            kv.k_scale[:, here] = ks[:, 0]
            kv.v_scale[:, here] = vs[:, 0]
        k = _dequantize_kv(kv.k, kv.k_scale, x.dtype)
        v = _dequantize_kv(kv.v, kv.v_scale, x.dtype)
    else:
        if here is not None:
            kv.k[:, here] = k_new[:, 0]
            kv.v[:, here] = v_new[:, 0]
        k, v = kv.k, kv.v

    kv_ids = slots.ids(x.device)
    if kv.windowed:
        # ring buffer: valid slots are the last min(pos+1, cap) writes
        valid = (slot - kv_ids) % cap < min(int(pos) + 1, cap)
    else:
        valid = kv_ids <= pos
    if not isinstance(cache, SplitKV):
        return _decode_attend(p, x, s, q, k, v, valid[None, :], tuner,
                              tp, cols), cache
    out = C.softmax_combine(*decode_partial(q, k, v, valid[None, :]),
                            cache.tp.group)
    return _decode_out(p, x, s, out, tuner, tp, cols), cache


def page_mask(plan, pos: torch.Tensor, cap: int, page: int
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(valid (B, cap): the slots a sequence may read, ``<= pos``; here
    (B, cap) or None: the slots of pages this rank stores, from a mesh
    plan's :attr:`~repro_torch.serve.kv_cache.PagePlan.here`)."""
    valid = torch.arange(cap, device=pos.device)[None, :] <= pos[:, None]
    if plan.here is None:
        return valid, None
    return valid, plan.here.repeat_interleave(page, dim=1)


def page_parts(scores: torch.Tensor, valid: torch.Tensor,
               here: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`softmax_parts` of fp32 scores (B, H, n) over a gathered
    view of a rank's pages: masked to -1e30 where not ``valid``, as on
    one device, and left out (weight 0) where another rank stores the
    page, so that the combine over the ranks weighs every slot of the
    whole view once — an inactive slot too, whose every score is -1e30
    (one device's uniform average over the view).  A sequence none of
    whose pages lie here has m = -1e30 and l = 0."""
    scores = torch.where(valid[:, None, :], scores, _NEG_INF)
    scores = torch.where(here[:, None, :], scores, float("-inf"))
    m = scores.amax(dim=-1)
    m = torch.where(m == float("-inf"), _NEG_INF, m)
    e = torch.exp(scores - m[..., None])
    return e, m, e.sum(dim=-1)


def _attend_pages(s: AttnSpec, view, plan, q: torch.Tensor,
                  k_new: torch.Tensor, v_new: torch.Tensor
                  ) -> torch.Tensor:
    """The paged decode's attention on a mesh: q (B_loc, 1, H, Dh) and
    the new k, v (B_loc, 1, Hkv, Dh) of every head, over a
    :class:`~repro_torch.serve.kv_cache.PagedSplit` pool.  The rows of
    every slot are gathered; the rank writes its piece of the new rows
    of the slots whose pages it stores and attends every slot over its
    pages (its columns of the head dim, whose scores are summed over
    'model', or its KV heads and their query heads); the partial
    softmaxes are merged over the page axes, the rank keeps its rows
    and their pieces are joined over 'model'.  Returns (B_loc, H, Dh)
    fp32, normalised."""
    from repro_torch.serve.kv_cache import append_token, gather_pages

    cut = view.cuts["k"]
    if cut != view.cuts["v"] or cut not in (None, 2, 3):
        raise NotImplementedError(
            f"paged decode of a pool cut on dims {view.cuts} over 'model'")
    pool = view.pool
    q, k_new, v_new = (view.gather(t) for t in (q, k_new, v_new))
    active = plan.pos >= 0
    append_token(pool.k, plan.table, plan.pos, view.piece(k_new[:, 0], "k"),
                 active, plan)
    append_token(pool.v, plan.table, plan.pos, view.piece(v_new[:, 0], "v"),
                 active, plan)
    k = gather_pages(pool.k, plan.table, plan)   # (B, cap, Hkv', Dh')
    v = gather_pages(pool.v, plan.table, plan)
    q = view.piece(q, "k")                       # (B, 1, H', Dh')
    raw = torch.einsum("bohd,bkhd->bhk", q.float(),
                       _repeat_kv(k, q.shape[2]).float())
    scores = view.scores([(raw, "k")]) * (s.head_dim ** -0.5)
    e, m, l = page_parts(scores, *page_mask(plan, plan.pos, k.shape[1],
                                            pool.page_size))
    o = torch.einsum("bhk,bkhd->bhd", e, _repeat_kv(v, q.shape[2]).float())
    out = view.keep(C.softmax_combine(o, m, l, view.pages))
    return view.join(out, "v")


def attention_decode_paged(p: dict, x: torch.Tensor, s: AttnSpec, pool,
                           page_table: torch.Tensor, pos: torch.Tensor,
                           tuner=None, plan=None, tp=None,
                           cols: bool = False):
    """One-token decode against a paged KV pool (continuous batching).

    x (B, 1, D); ``pos`` is (B,) int — every sequence in the batch sits
    at its own position (ragged admission), with -1 marking an inactive
    batch slot; ``page_table`` (B, P) int maps each sequence's logical
    pages to physical pages of ``pool``
    (:class:`repro_torch.serve.kv_cache.PagedKV`), -1 marking holes.

    The compute is the fixed-batch :func:`attention_decode`'s, through
    the same :func:`_decode_attend`: the page gather materialises the
    same (B, cap, Hkv, Dh) view the contiguous cache holds (holes land
    beyond the ``kv_ids <= pos`` valid prefix, where the mask erases
    them).
    The cache update keeps its TRSM-site recorder tag.  As in
    :func:`attention_decode`, the new rows are written into the pool in
    place and the same pool is returned; an inactive slot writes
    nothing.  ``plan`` is the step's
    :func:`~repro_torch.serve.kv_cache.plan_step` for this table and
    these positions, computed once for all layers (else here).

    On a mesh: with ``tp`` q, k and v are projected on the rank's heads
    (with ``cols`` on its stored columns) and gathered, the output leaves
    through the rank's rows of ``wo`` (as :func:`attention_decode`); a
    :class:`~repro_torch.serve.kv_cache.PagedSplit` pool is read
    split-KV over its pages (:func:`_attend_pages`).
    """
    from repro_torch.serve.kv_cache import (PagedSplit, append_token,
                                            gather_pages, plan_step)

    if s.window is not None:
        raise NotImplementedError(
            "paged decode does not support sliding-window (ring) caches")
    b = x.shape[0]
    if tp is not None and not cols:
        p = _rank_weights(p, s, tp)
    q, k_new, v_new = _decode_qkv(p, x, s, pos[:, None], tuner, tp, cols)
    cap = page_table.shape[1] * pool.page_size
    ops.observe(cap, s.head_dim, b * s.n_heads, tuner,
                routine="trsm", site="attn.cache_update")
    if plan is None:
        plan = plan_step(pool, page_table, pos)
    if isinstance(pool, PagedSplit):
        out = _attend_pages(s, pool, plan, q, k_new, v_new)
        return _decode_out(p, x, s, out, tuner, tp, cols), pool
    active = pos >= 0
    append_token(pool.k, page_table, pos, k_new[:, 0], active, plan)
    append_token(pool.v, page_table, pos, v_new[:, 0], active, plan)
    k = gather_pages(pool.k, page_table, plan)     # (B, cap, Hkv, Dh)
    v = gather_pages(pool.v, page_table, plan)
    valid = (torch.arange(cap, device=x.device)[None, :]
             <= pos[:, None])
    return _decode_attend(p, x, s, q, k, v, valid, tuner), pool
