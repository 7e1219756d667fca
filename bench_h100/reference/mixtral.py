"""A Mixtral-style decoder (grouped-query attention with RoPE, RMSNorm,
a top-k softmax router over SwiGLU experts) in plain PyTorch, float32.

It reads the configuration's published keys and the weights the
benchmark made, laid out as :func:`weight_specs` says.  The router keeps
the configuration's capacity rule: in a forward call of T tokens each
expert takes at most ``capacity(T)`` (token, choice) pairs, the first in
token-major order, and a pair past it contributes nothing.  A served
request is a prompt processed as one call, then one token a call, each
decode call holding at most as many tokens as a capacity can never cut
(the serving driver refuses any other batch); so the reference caps the
prompt's pairs by ``capacity(prompt length)`` and routes every decoded
position without a cap.  ``mm`` is the product everything is built from
(``reference.mm_fp32``, or ``mm_tf32`` for the control)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import mm_fp32

#: query rows of one attention block
ATTN_ROWS = 256
#: router logits closer than this are a tie that fp32 rounding may
#: break either way: 100x the rounding differences of two fp32 paths
#: (~1e-6 of logits of about 1.6), 10x below a TF32 path's (~1e-3)
TIE = 1e-4
#: tied routings a request tries the other way
MAX_TIES = 8


def _dims(cfg: dict) -> tuple[int, int, int, int, int, int, int, int]:
    d = cfg["hidden_size"]
    h = cfg["num_attention_heads"]
    hk = cfg["num_key_value_heads"]
    dh = cfg.get("head_dim") or d // h
    return (d, h, hk, dh, cfg["intermediate_size"],
            cfg["num_local_experts"], cfg["vocab_size"],
            cfg["num_hidden_layers"])


def weight_specs(cfg: dict) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, init, scale) of every weight, in the order they are
    drawn: ``normal`` leaves are N(0, 1) x scale, ``ones`` are ones."""
    d, h, hk, dh, ff, e, v, n_layers = _dims(cfg)
    specs = [(("embed",), (v, d), "normal", 1.0),
             (("ln_f", "scale"), (d,), "ones", 1.0),
             (("unembed",), (d, v), "normal", d ** -0.5)]
    for i in range(n_layers):
        p = ("layers", i)
        specs += [
            (p + ("ln1", "scale"), (d,), "ones", 1.0),
            (p + ("mixer", "wq"), (d, h * dh), "normal", d ** -0.5),
            (p + ("mixer", "wk"), (d, hk * dh), "normal", d ** -0.5),
            (p + ("mixer", "wv"), (d, hk * dh), "normal", d ** -0.5),
            (p + ("mixer", "wo"), (h * dh, d), "normal", (h * dh) ** -0.5),
            (p + ("ln2", "scale"), (d,), "ones", 1.0),
            (p + ("moe", "router"), (d, e), "normal", 0.02),
            (p + ("moe", "wi"), (e, d, ff), "normal", d ** -0.5),
            (p + ("moe", "wg"), (e, d, ff), "normal", d ** -0.5),
            (p + ("moe", "wo"), (e, ff, d), "normal", ff ** -0.5)]
    return specs


def make_weights(cfg: dict, seed: int, device: str) -> dict:
    """Every weight from ``seed``, on the device, in float32: one draw
    for all the normal leaves, each leaf a scaled view of it."""
    specs = weight_specs(cfg)
    total = sum(math.prod(s) for _, s, init, _ in specs if init == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    pool = torch.randn(total, generator=gen, device=device)
    tree: dict = {"layers": [{} for _ in range(cfg["num_hidden_layers"])]}
    off = 0
    for path, shape, init, scale in specs:
        if init == "normal":
            n = math.prod(shape)
            leaf = pool[off:off + n].view(shape).mul_(scale)
            off += n
        else:
            leaf = torch.ones(shape, device=device)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {}) if isinstance(key, str) \
                else node[key]
        node[path[-1]] = leaf
    return tree


def capacity(cfg: dict, n_tokens: int) -> int:
    """Pairs an expert keeps in a forward call of ``n_tokens`` tokens."""
    c = cfg["moe_capacity"]
    cap = int(c["factor"] * n_tokens * cfg["num_experts_per_tok"]
              / cfg["num_local_experts"])
    mult = c["multiple"]
    return max(c["min"], -(-cap // mult) * mult)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (S, heads, Dh) at positions 0..S-1: the first and second
    halves of the head dim as the pair."""
    s, _, dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device,
                                       dtype=torch.float32) / dh)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
        * inv
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mm) -> torch.Tensor:
    """Causal softmax attention, (S, H, Dh) each (k, v already repeated
    to H heads), in blocks of ATTN_ROWS query rows."""
    s, h, dh = q.shape
    qh, kh, vh = q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)
    out = torch.empty_like(qh)
    for i0 in range(0, s, ATTN_ROWS):
        i1 = min(i0 + ATTN_ROWS, s)
        scores = mm(qh[:, i0:i1], kh[:, :i1].transpose(1, 2)) * dh ** -0.5
        rows = torch.arange(i0, i1, device=q.device)[:, None]
        cols = torch.arange(i1, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        out[:, i0:i1] = mm(torch.softmax(scores, dim=-1), vh[:, :i1])
    return out.transpose(0, 1)


def moe(p: dict, x: torch.Tensor, cfg: dict, n_prompt: int, mm,
        swap=(), ties=None):
    """The routed experts on (S, D); rows before ``n_prompt`` are one
    prefill call under its capacity, the rest decoded rows.  A row in
    ``swap`` takes the (k+1)-th expert in place of its k-th; a row whose
    k-th and (k+1)-th router logits lie within TIE of each other is
    appended to ``ties``."""
    e, top = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    logits = mm(x, p["router"])
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(probs, top + 1, dim=-1)
    if ties is not None:
        lo = torch.topk(logits, top + 1, dim=-1).values
        ties.extend(torch.nonzero(lo[:, top - 1] - lo[:, top] < TIE)[:, 0]
                    .tolist())
    for row in swap:
        vals[row, top - 1], idx[row, top - 1] = vals[row, top], idx[row, top]
    vals, idx = vals[:, :top], idx[:, :top]
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    keep = torch.ones_like(idx, dtype=torch.bool)
    flat = idx[:n_prompt].reshape(-1)
    rank = torch.cumsum(F.one_hot(flat, e), dim=0).gather(
        1, flat[:, None])[:, 0] - 1
    keep[:n_prompt] = (rank < capacity(cfg, n_prompt)).view(n_prompt, top)
    out = torch.zeros_like(x)
    for j in range(e):
        rows, slot = torch.nonzero((idx == j) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        y = mm(F.silu(mm(xe, p["wg"][j])) * mm(xe, p["wi"][j]), p["wo"][j])
        out.index_add_(0, rows, y * vals[rows, slot][:, None])
    return out


def served_logits(w: dict, cfg: dict, prompt: list[int], served: list[int],
                  mm=mm_fp32, swap: dict | None = None,
                  ties: list | None = None) -> torch.Tensor:
    """The logits (T, V) from which the T served tokens were chosen: the
    prompt's last position and each served position but the last.
    ``swap`` maps a layer to the rows whose routing takes the next expert
    (:func:`moe`); ``ties`` collects (layer, row) of near-tied routings."""
    d, h, hk, dh, _, _, _, _ = _dims(cfg)
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    dev = w["embed"].device
    ids = torch.tensor(list(prompt) + list(served[:-1]), device=dev)
    n = len(prompt)
    x = w["embed"][ids]
    s = x.shape[0]
    for i, p in enumerate(w["layers"]):
        a = rmsnorm(x, p["ln1"]["scale"], eps)
        m = p["mixer"]
        q = rope(mm(a, m["wq"]).view(s, h, dh), theta)
        k = rope(mm(a, m["wk"]).view(s, hk, dh), theta)
        v = mm(a, m["wv"]).view(s, hk, dh)
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
        x = x + mm(attention(q, k, v, mm).reshape(s, h * dh), m["wo"])
        found = [] if ties is not None else None
        x = x + moe(p["moe"], rmsnorm(x, p["ln2"]["scale"], eps), cfg, n, mm,
                    swap=(swap or {}).get(i, ()), ties=found)
        if ties is not None:
            ties.extend((i, row) for row in found)
    x = rmsnorm(x[n - 1:], w["ln_f"]["scale"], eps)
    return mm(x, w["unembed"])


def gaps(logits: torch.Tensor, chosen: list[int]) -> torch.Tensor:
    """How far each chosen token's logit lies below its row's best."""
    t = torch.tensor(chosen, device=logits.device)
    return logits.max(dim=1).values - logits.gather(1, t[:, None])[:, 0]


def widest_gap(w: dict, cfg: dict, prompt: list[int], served: list[int],
               chosen: list[int] | None = None, mm=mm_fp32) -> float:
    """The widest gap by which a chosen token (default: the served ones)
    lies below the reference's best, when the prompt and the served
    tokens run through the reference.  Routing is discontinuous: where a
    row's k-th and (k+1)-th router logits lie within TIE, rounding alone
    may pick either, so each position takes its smallest gap over the
    reference as computed and with each such routing taken the other
    way (at most MAX_TIES of them)."""
    chosen = list(served) if chosen is None else chosen
    ties: list = []
    best = gaps(served_logits(w, cfg, prompt, served, mm, ties=ties), chosen)
    for layer, row in ties[:MAX_TIES]:
        other = served_logits(w, cfg, prompt, served, mm,
                              swap={layer: (row,)})
        best = torch.minimum(best, gaps(other, chosen))
    return float(best.max())
