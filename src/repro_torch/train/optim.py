"""Optimizer: AdamW with global-norm clipping, cosine schedule, and
optional int8 gradient compression with error feedback.

The reference's state layout ``{"params", "m", "v", "step"[, "ef"]}``,
each of ``params`` / ``m`` / ``v`` / ``ef`` a tree (dicts and lists) of
tensors mirroring the parameters.  Unlike the reference, whose arrays
are immutable, :func:`adamw_update` updates the state's tensors in
place (one step at full width would otherwise hold two copies of the
parameters and both moments); the schedule, the clipping and the update
are the reference's arithmetic, in fp32.

The int8 compression is per tensor, as in the reference, where a
tensor of the scanned unit holds one parameter of the layers at one
position of the unit, stacked across its repeats: so here those layers
share one scale per name, and the layers before and after the unit keep
their own (:func:`_scale_groups`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.params import tree_leaves, tree_map, tree_paths
from repro_torch.models.transformer import _segments

__all__ = ["AdamWConfig", "STATE_MOMENTS", "init_state", "adamw_update",
           "cosine_lr", "clip_by_global_norm", "compress_int8",
           "decompress_int8", "compressed_grads"]

#: moment keys of the AdamW state dict
STATE_MOMENTS = ("m", "v")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    #: int8 + error-feedback gradient compression (cross-replica traffic
    #: reduction; the residual stays in the optimizer state)
    compress: bool = False


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor | int) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to 0 at
    ``total_steps`` (fp32 scalar tensor on ``step``'s device)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def init_state(params: Any, cfg: AdamWConfig | None = None) -> dict:
    """Zero fp32 moments (and error-feedback residual when ``cfg``
    compresses) beside ``params``; ``step`` an int32 scalar on the
    parameters' device."""
    def zeros() -> Any:
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    state: dict = {"params": params}
    for key in STATE_MOMENTS:
        state[key] = zeros()
    device = tree_leaves(params)[0].device
    state["step"] = torch.zeros((), dtype=torch.int32, device=device)
    if cfg is not None and cfg.compress:
        state["ef"] = zeros()
    return state


def _global_norm(grads: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """(grads scaled to global norm <= ``max_norm``, the global norm)."""
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantisation; returns (q, scale)."""
    xf = x.float()
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _scale_groups(tree: Any) -> list[list[int]]:
    """Leaf indices that share one int8 scale: the reference's tensors.

    Every leaf is alone, except under ``layers``, where the reference's
    grouping (:func:`~repro_torch.models.transformer._segments`) stacks
    the unit's layers across its repeats: ``layers[i][...]`` joins the
    same name in the layers at i's position of the unit.  The grouping
    is found from the layers' parameter names and shapes, which tell
    every two layer kinds of a model apart but global and local
    attention; no arch has both in one pattern."""
    paths = tree_paths(tree)
    shapes = [tuple(t.shape) for t in tree_leaves(tree)]
    sigs: dict[int, list] = {}
    for path, shape in zip(paths, shapes):
        if path[:1] == ("layers",):
            sigs.setdefault(path[1], []).append((path[2:], shape))
    pre, unit, reps, _ = _segments([tuple(sigs[i]) for i in sorted(sigs)])
    first, n_unit = len(pre), len(unit)

    def owner(path: tuple) -> tuple:
        if path[:1] == ("layers",) and \
                first <= path[1] < first + n_unit * reps:
            return ("scan", (path[1] - first) % n_unit) + path[2:]
        return path

    groups: dict[tuple, list[int]] = {}
    for i, path in enumerate(paths):
        groups.setdefault(owner(path), []).append(i)
    return list(groups.values())


def _compress_group(gs: list[torch.Tensor], es: list[torch.Tensor]
                    ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(g', ef') per leaf of one scale group: the group's tensors
    quantised as one, like :func:`compress_int8` on their stack."""
    tots = [g.float() + e for g, e in zip(gs, es)]
    scale = torch.stack([torch.max(torch.abs(t)) for t in tots]).max() \
        / 127.0 + 1e-30
    out = []
    for g, tot in zip(gs, tots):
        q = torch.clamp(torch.round(tot / scale), -127, 127).to(torch.int8)
        deq = decompress_int8(q, scale)
        out.append((deq.to(g.dtype), tot - deq))
    return out


def compressed_grads(grads: Any, ef: Any) -> tuple[Any, Any]:
    """Quantise grads with error feedback: g' = Q(g + ef); ef' = g+ef-g'.
    Returns new trees (neither input is changed)."""
    g, e = tree_leaves(grads), tree_leaves(ef)
    out: list = [None] * len(g)
    for group in _scale_groups(grads):
        for i, pair in zip(group, _compress_group([g[i] for i in group],
                                                  [e[i] for i in group])):
            out[i] = pair
    new_g = iter([p[0] for p in out])
    new_ef = iter([p[1] for p in out])
    return (tree_map(lambda _: next(new_g), grads),
            tree_map(lambda _: next(new_ef), grads))


@torch.no_grad()
def adamw_update(state: dict, grads: Any, cfg: AdamWConfig
                 ) -> tuple[dict, dict]:
    """One AdamW step; returns (new_state, metrics).

    ``params``, ``m``, ``v`` (and ``ef`` when compressing) are updated in
    place, tensor by tensor, and the returned state holds those same
    trees with a new ``step``; ``grads`` is left as it is.  Metrics
    ``grad_norm`` (before clipping) and ``lr`` are scalar tensors on
    the state's device.
    """
    step = state["step"] + 1
    gn = _global_norm(grads)
    scale = _clip_scale(gn, cfg.clip_norm)
    compress = cfg.compress and "ef" in state
    lr = cosine_lr(cfg, step)
    stepf = step.float()
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    params, g_all = tree_leaves(state["params"]), tree_leaves(grads)
    ms, vs = tree_leaves(state["m"]), tree_leaves(state["v"])
    ef = tree_leaves(state["ef"]) if compress else None
    for group in _scale_groups(grads):
        gs = [g_all[i] * scale for i in group]
        if compress:
            pairs = _compress_group(gs, [ef[i] for i in group])
            gs = [g for g, _ in pairs]
            for i, (_, new_e) in zip(group, pairs):
                ef[i].copy_(new_e)
            del pairs
        for i, g in zip(group, gs):
            p, m, v = params[i], ms[i], vs[i]
            gf = g.float()
            m.mul_(cfg.b1).add_((1 - cfg.b1) * gf)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.sub_((lr * delta).to(p.dtype))
    new_state = {"params": state["params"], "m": state["m"],
                 "v": state["v"], "step": step}
    if "ef" in state:
        new_state["ef"] = state["ef"]
    return new_state, {"grad_norm": gn, "lr": lr}
