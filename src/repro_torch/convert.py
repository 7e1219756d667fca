"""Carry the reference's parameters into the port's layout.

    params_np = jax.tree.map(np.asarray, lm.init(jax.random.PRNGKey(0)))
    state = params_from_jax(params_np, device="cuda")

A reference train state (``init_train_state``: params, AdamW moments,
step) goes through :func:`state_from_jax` the same way.

The reference's decoder-only LM keeps its layers as ``prefix`` /
``scan`` / ``suffix``, the ``scan`` unit's parameters stacked along a
leading layer dimension.  The port keeps one parameter dict per layer in
``state["layers"]``, in model order: prefix, then the scanned unit
unstacked repeat by repeat (recurrentgemma's unit is rglru, rglru,
local), then suffix.  Every other name maps one to one, and so does the
whole encoder-decoder tree (its ``encoder`` and ``decoder`` are already
per-layer lists).  Takes numpy arrays, so it needs no jax.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, tree_map

__all__ = ["params_from_jax", "state_from_jax"]


def params_from_jax(tree: dict, device: torch.device | str = "cpu",
                    dtype: torch.dtype | None = None) -> dict:
    """Reference parameter tree of numpy arrays -> port state dict.

    ``dtype`` casts every tensor (default: keep each array's dtype)."""
    def leaf(a: Any) -> torch.Tensor:
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)

    if not any(k in tree for k in ("prefix", "scan", "suffix")):
        return tree_map(leaf, tree)
    layers = list(tree.get("prefix", []))
    unit = tree.get("scan", [])
    if unit:
        repeats = {int(np.shape(a)[0]) for u in unit
                   for a in tree_leaves(u)}
        if len(repeats) != 1:
            raise ValueError(f"scan params disagree on the layer count "
                             f"{sorted(repeats)}")
        for r in range(repeats.pop()):
            layers += [tree_map(lambda a, r=r: a[r], u) for u in unit]
    layers += list(tree.get("suffix", []))
    state = {k: v for k, v in tree.items()
             if k not in ("prefix", "scan", "suffix")}
    state["layers"] = layers
    return tree_map(leaf, state)


def state_from_jax(state: dict, device: torch.device | str = "cpu",
                   dtype: torch.dtype | None = None) -> dict:
    """Reference train state of numpy arrays (``params``, ``m``, ``v``,
    ``step``, optionally ``ef``) -> the port's train state.

    Every parameter-shaped tree goes through :func:`params_from_jax`
    (``dtype`` casts the parameters only; the moments stay fp32, as the
    reference keeps them); ``step`` becomes an int32 scalar tensor."""
    out = {"params": params_from_jax(state["params"], device, dtype)}
    for key in ("m", "v", "ef"):
        if key in state:
            out[key] = params_from_jax(state[key], device)
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=device)
    return out
