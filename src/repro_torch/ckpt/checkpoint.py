"""Atomic checkpointing of a train state, single device.

The reference's on-disk protocol, per step:
    <dir>/step_<n>.tmp/          (written)
    <dir>/step_<n>/              (atomic rename on completion)
        meta.json                (tree structure, shapes, dtypes, step)
        arrays.npz               (flattened path -> host array)
        COMMIT                   (sentinel written last)

A state is a tree of dicts and lists of tensors.  Leaves are keyed by
their path in the reference's format (``['params']//['layers']//[0]//
...``).  Restore fills a template tree (the live state, or tensors on
the ``meta`` device) and places every leaf on its device, or, given a
mesh and a spec tree, lays each leaf out on the mesh as a DTensor (the
reference's elastic restore: arrays are saved whole, so any mesh can
take them).  bfloat16 leaves are stored as their 16-bit patterns (numpy
has no bfloat16) and ``meta.json`` names their dtype.

A state of DTensors is gathered whole before it is written: in a
process group every rank calls :func:`save_checkpoint` (the gather is a
collective), one leaf at a time, and only rank 0 keeps a host copy and
writes; a caller that restores right after synchronises the ranks first.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, tree_map, tree_paths

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]

_SEP = "//"


def _keys(tree: Any) -> list[str]:
    """Every leaf's path key, in :func:`tree_leaves` order."""
    return [_SEP.join(f"[{p!r}]" if isinstance(p, str) else f"[{p}]"
                      for p in path) for path in tree_paths(tree)]


def _whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself, or a DTensor gathered whole (a collective)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _writes() -> bool:
    """Does this process write?  Rank 0 of a process group, or a process
    outside one."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _host(t: Any, copy: bool) -> Any:
    """A whole leaf on the host; with ``copy``, one that later in-place
    updates of ``t`` do not reach."""
    if isinstance(t, torch.Tensor):
        return t.to("cpu", copy=True) if copy else t.cpu()
    return np.array(t, copy=True) if copy else t


def _host_leaves(state: Any, copy: bool) -> list | None:
    """Every leaf of ``state`` whole on the host, in :func:`tree_leaves`
    order, on the process that writes; ``None`` on the others.  Every
    rank takes part in each DTensor's gather (a collective), and a rank
    that does not write drops each gathered leaf at once: only the
    writer ever holds the state on the host."""
    writes = _writes()
    out = [] if writes else None
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            leaf = _whole(leaf.detach())
        if writes:
            out.append(_host(leaf, copy))
    return out


def _to_numpy(t: Any) -> tuple[np.ndarray, str]:
    if not isinstance(t, torch.Tensor):
        a = np.asarray(t)
        return a, str(a.dtype)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Write ``state`` as committed step ``step`` under ``directory``;
    returns the step's directory."""
    return _write(directory, step, _keys(state),
                  _host_leaves(state, copy=False))


def _write(directory: str, step: int, keys: list[str],
           leaves: list | None) -> str:
    """Commit host ``leaves`` (keyed by ``keys``) as step ``step``; a
    process that does not write (``leaves`` is ``None``) only returns the
    step's directory."""
    final = os.path.join(directory, f"step_{step:08d}")
    if leaves is None:
        return final
    arrays, dtypes = {}, {}
    for key, leaf in zip(keys, leaves):
        arrays[key], dtypes[key] = _to_numpy(leaf)
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(arrays),
                   "shapes": {k: list(a.shape) for k, a in arrays.items()},
                   "dtypes": dtypes}, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "COMMIT")):
            s = int(m.group(1))
            best = s if best is None or s > best else best
    return best


def restore_checkpoint(directory: str, step: int, like: Any, *,
                       device: torch.device | str | None = None,
                       dtype: torch.dtype | None = None, mesh=None,
                       specs: Any = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, for
    instance on the ``meta`` device).

    Each leaf takes its template's dtype (``dtype``, when given, for
    every floating-point leaf) and lands on ``device``, else on its
    template's device (the CPU for a ``meta`` template, the mesh's
    device type for a DTensor template).  With ``mesh`` and ``specs``
    (a spec tree mirroring ``like``) each leaf is laid out on the mesh
    as a DTensor by its spec — the elastic path: the saved arrays are
    mesh-agnostic.
    """
    from torch.distributed.tensor import DTensor

    from repro_torch.models.params import is_spec

    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "meta.json")) as f:
        saved_dtypes = json.load(f)["dtypes"]
    spec_leaves = (tree_leaves(specs, is_leaf=is_spec)
                   if mesh is not None and specs is not None
                   else [None] * len(tree_leaves(like)))
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for key, tmpl, spec in zip(_keys(like), tree_leaves(like),
                                   spec_leaves):
            t = torch.from_numpy(z[key])
            if saved_dtypes[key] == "bfloat16":
                t = t.view(torch.bfloat16)
            want = tmpl.dtype
            if dtype is not None and want.is_floating_point:
                want = dtype
            if device is not None:
                dev = device
            elif isinstance(tmpl, DTensor):
                dev = tmpl.device_mesh.device_type
            elif mesh is not None:
                dev = mesh.device_type
            else:
                dev = "cpu" if tmpl.device.type == "meta" else tmpl.device
            t = t.to(device=dev, dtype=want)
            if spec is not None:
                from repro_torch.dist.collectives import distribute
                t = distribute(t, mesh, spec)
            leaves.append(t)
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


class AsyncCheckpointer:
    """Checkpoint writes on a background thread, so the step loop never
    blocks on disk (one in flight at a time).  :meth:`save` takes its
    host copy before it returns: the port's train state is updated in
    place, and the next step must not reach the file."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_saved: int | None = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        keys = _keys(state)
        leaves = _host_leaves(state, copy=True)         # snapshot now
        if leaves is None:      # not the writer: its part was the gathers
            self.last_saved = step
            return

        def work():
            try:
                _write(self.directory, step, keys, leaves)
                self.last_saved = step
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; re-raise its failure here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
