"""Sharding subsystem: logical-axis rule tables + spec derivation, and
the step from a spec to DTensor placements.

The models declare parameters with *logical* axes ("vocab", "ff",
"heads", …, see :mod:`repro_torch.models.params`); this module decides
which *physical* mesh axes carry each of them for a given (arch x mesh)
cell — the reference's rule tables and derivation, unchanged.

Rule-table design
-----------------
Logical axes fall into three groups:

* ``MODEL_AXIS_RULES`` — weight dims that tensor-parallelism splits
  (vocab, ff, heads, kv_heads, expert_ff).  Candidate: the ``"model"``
  mesh axis.
* ``DATA_AXIS_RULES`` — dims carried by the data-parallel axes
  (``experts``: expert parallelism over ("pod", "data")).
* everything else (``embed``, ``lora``, unnamed) — always replicated.

Every candidate is *divisibility-checked* against all dims that carry
the logical axis in the arch's actual ParamDef tree: a non-dividing
assignment is demoted (outermost axis dropped first, e.g.
``("pod", "data")`` -> ``("data",)``) or dropped to ``None``.  mixtral's
8 experts on a 16-way data axis demote to ``None`` (its experts are
split over the FF dim instead — ``expert_ff``), and whisper's odd
51865-token vocab stays replicated.

Specs and meshes
----------------
A spec is a plain tuple of per-dimension entries, each ``None``, an axis
name or a tuple of axis names: ``tuple()`` of the reference's
``PartitionSpec``.  A mesh is read only through ``.shape`` (axis name ->
size) and ``.axis_names``, so specs are derived with no devices: pass a
:class:`MeshShape` (the production meshes on a laptop), or a torch
``DeviceMesh``, which :func:`mesh_view` reads through its dim names.
:func:`to_placements` turns a spec into the DTensor placements of one
``DeviceMesh`` (the reference's ``named_shardings``).

The port lays its layers out one dict per layer (``params["layers"]``)
where the reference stacks its scanned unit, so the reference's
``"layers"`` logical axis (always replicated) has no dim here: a layer's
spec is the reference's stacked spec without its leading ``None``.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Sequence

from repro_torch.models.params import ParamDef, is_spec, param_specs, \
    tree_leaves

__all__ = [
    "TP_AXIS", "MODEL_AXIS_RULES", "DATA_AXIS_RULES", "MeshShape",
    "mesh_view", "auto_spec", "batch_specs", "data_axes",
    "divisible_axes", "is_partition_spec", "logical_axis_dims",
    "paged_spec", "param_rules", "partition_params", "state_specs",
    "to_placements",
]

#: the tensor-parallel mesh axis name (repro_torch.launch.mesh convention)
TP_AXIS = "model"

#: logical axes whose dims tensor-parallelism splits
MODEL_AXIS_RULES = ("vocab", "ff", "heads", "kv_heads", "expert_ff")

#: logical axes carried by the data-parallel axes (expert parallelism)
DATA_AXIS_RULES = ("experts",)

#: leaf test for spec trees (a spec is a tuple of entries)
is_partition_spec = is_spec


class MeshShape:
    """Device-free mesh stand-in from an ``{axis: size}`` dict: spec
    derivation for 256- and 512-chip production meshes on one host."""

    def __init__(self, shape: dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def mesh_view(mesh) -> Any:
    """``mesh`` as the ``.shape`` dict / ``.axis_names`` interface the
    rules read: a torch ``DeviceMesh`` through its dim names and sizes,
    anything else (a :class:`MeshShape`) as it is."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and not isinstance(mesh.shape, dict):
        return MeshShape(dict(zip(names, mesh.shape)))
    return mesh


def data_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (everything except 'model')."""
    return tuple(a for a in mesh_view(mesh).axis_names if a != TP_AXIS)


def _axes_size(axes: Sequence[str], mesh) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def divisible_axes(dims: int | Iterable[int], axes: Sequence[str], mesh
                   ) -> str | tuple[str, ...] | None:
    """Largest demotion of ``axes`` whose size divides every dim.

    Drops axes outermost-first (``("pod", "data")`` -> ``("data",)``)
    until the remaining product divides all of ``dims``; returns a bare
    axis name for a single survivor, a tuple for several, or ``None``
    when nothing divides — i.e. an entry ready to drop into a spec.
    """
    mesh = mesh_view(mesh)
    if isinstance(dims, int):
        dims = (dims,)
    dims = tuple(dims)
    axes = tuple(axes)
    while axes and any(d % _axes_size(axes, mesh) for d in dims):
        axes = axes[1:]
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def logical_axis_dims(defs: Any) -> dict[str, set[int]]:
    """Map each logical axis name to every dim size it tags in ``defs``."""
    out: dict[str, set[int]] = {}
    for d in tree_leaves(defs):
        if not isinstance(d, ParamDef):
            continue
        for dim, axis in zip(d.shape, d.axes):
            if axis is not None:
                out.setdefault(axis, set()).add(dim)
    return out


def param_rules(cfg, mesh, defs: Any = None) -> dict[str, Any]:
    """Logical-axis -> mesh-axis rule table for one (arch x mesh) cell.

    Divisibility-aware: every assignment is checked against all dims the
    axis tags in the arch's ParamDef tree and demoted/dropped so the
    resulting specs divide on any mesh shape.  ``defs`` may be supplied
    (e.g. ``model.defs``) to skip rebuilding the model.
    """
    mesh = mesh_view(mesh)
    if defs is None:
        from repro_torch.configs import build_model
        defs = build_model(cfg).defs
    dims = logical_axis_dims(defs)
    dp = data_axes(mesh)
    rules: dict[str, Any] = {}
    for name, sizes in dims.items():
        if name in MODEL_AXIS_RULES and TP_AXIS in mesh.axis_names:
            rules[name] = divisible_axes(sizes, (TP_AXIS,), mesh)
        elif name in DATA_AXIS_RULES:
            rules[name] = divisible_axes(sizes, dp, mesh)
        else:
            rules[name] = None
    return rules


def partition_params(model, cfg, mesh) -> Any:
    """Spec tree for a model's parameters on ``mesh``."""
    return param_specs(model.defs, param_rules(cfg, mesh, model.defs))


def _tp_entries(entries: list, shape: Sequence[int], mesh,
                skip: tuple[int, ...]) -> tuple:
    """``entries`` with 'model' on the largest dim outside ``skip`` that
    the 'model' axis divides (none when the axis is absent or size 1)."""
    if TP_AXIS in mesh.axis_names:
        tp = mesh.shape[TP_AXIS]
        best = -1
        for i, d in enumerate(shape):
            if i in skip or tp < 2 or d % tp:
                continue
            if best < 0 or d > shape[best]:
                best = i
        if best >= 0:
            entries[best] = TP_AXIS
    return tuple(entries)


def auto_spec(shape: Sequence[int], mesh, batch_dim: int = 0) -> tuple:
    """Heuristic spec for an activation/cache array.

    The batch dim goes to the data-parallel axes (demoted until they
    divide, ``None`` if nothing does); the largest remaining dim
    divisible by the 'model' axis carries tensor parallelism; everything
    else is replicated.
    """
    mesh = mesh_view(mesh)
    entries: list[Any] = [None] * len(shape)
    entries[batch_dim] = divisible_axes(shape[batch_dim], data_axes(mesh),
                                        mesh)
    return _tp_entries(entries, shape, mesh, (batch_dim,))


def paged_spec(shape: Sequence[int], mesh, page_dim: int = 0) -> tuple:
    """Spec for a paged KV pool — 2D (data x model) on one array.

    Page pools (:mod:`repro_torch.serve.kv_cache`) carry no batch dim:
    the *page* dim is the parallel one, so it takes the data axes
    (demoted until they divide).  Tensor parallelism goes to the largest
    remaining dim divisible by 'model' — excluding the page-offset dim
    at ``page_dim + 1``: token slots within a page must stay whole on
    every shard or the page-table gather/scatter stops being local.
    Scan-stacked pools pass ``page_dim=1`` (dim 0 is the repeat dim).
    """
    mesh = mesh_view(mesh)
    entries: list[Any] = [None] * len(shape)
    entries[page_dim] = divisible_axes(shape[page_dim], data_axes(mesh),
                                       mesh)
    return _tp_entries(entries, shape, mesh, (page_dim, page_dim + 1))


def batch_specs(cfg, shape, mesh) -> dict[str, tuple]:
    """Specs for one global batch (mirrors ``train_batch_sds`` /
    ``prefill_batch_sds`` key-for-key): batch over data axes, audio
    frame embeddings additionally over 'model' where divisible."""
    mesh = mesh_view(mesh)
    batch_entry = divisible_axes(shape.global_batch, data_axes(mesh), mesh)
    tok = (batch_entry, None)
    specs = {"tokens": tok}
    if shape.kind == "train":
        specs["labels"] = tok
    if cfg.family == "audio":
        specs["audio_emb"] = auto_spec(
            (shape.global_batch, cfg.encoder_len, cfg.d_model), mesh,
            batch_dim=0)
    return specs


def state_specs(p_specs: Any, *, compress: bool = False) -> dict[str, Any]:
    """AdamW state specs derived mechanically from the param specs: the
    moments (and the error-feedback residual when gradient compression
    is on) mirror the parameter tree leaf-for-leaf, the step counter is
    replicated.  Layout keys come from :mod:`repro_torch.train.optim` so
    the two can never drift."""
    from repro_torch.train.optim import STATE_MOMENTS
    specs: dict[str, Any] = {"params": p_specs}
    for key in STATE_MOMENTS:
        specs[key] = p_specs
    specs["step"] = ()
    if compress:
        specs["ef"] = p_specs
    return specs


def to_placements(spec: tuple, mesh) -> tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    one per mesh dim, ``Shard(d)`` where that mesh axis appears in
    tensor dim ``d``'s entry, ``Replicate()`` elsewhere.

    A tuple entry puts several mesh dims on one tensor dim; DTensor
    splits such a dim in mesh-dim order, the first mesh dim outermost,
    which is the reference's major-to-minor order when the entry lists
    its axes in mesh order (as :func:`divisible_axes` always does).
    Another order would need a strided shard, and is refused.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        if [names.index(a) for a in axes] != sorted(
                names.index(a) for a in axes):
            raise ValueError(f"spec entry {entry!r} lists its axes out of "
                             f"the mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"mesh axis {a!r} used twice in {spec}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)
