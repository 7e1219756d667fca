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
the ``meta`` device) and places every leaf on its device.  bfloat16
leaves are stored as their 16-bit patterns (numpy has no bfloat16) and
``meta.json`` names their dtype.  The reference's elastic restore onto
another mesh waits for the port of ``dist/``.
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


def _host_copy(t: Any) -> Any:
    """A host copy: later in-place updates of ``t`` do not reach it."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True)
    return np.array(t, copy=True)


def _to_numpy(t: Any) -> tuple[np.ndarray, str]:
    if not isinstance(t, torch.Tensor):
        a = np.asarray(t)
        return a, str(a.dtype)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Write ``state`` as committed step ``step`` under ``directory``;
    returns the step's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for key, leaf in zip(_keys(state), tree_leaves(state)):
        arrays[key], dtypes[key] = _to_numpy(leaf)
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
                       dtype: torch.dtype | None = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, for
    instance on the ``meta`` device).

    Each leaf takes its template's dtype (``dtype``, when given, for
    every floating-point leaf) and lands on ``device``, else on its
    template's device (the CPU for a ``meta`` template).
    """
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMIT")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "meta.json")) as f:
        saved_dtypes = json.load(f)["dtypes"]
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for key, tmpl in zip(_keys(like), tree_leaves(like)):
            t = torch.from_numpy(z[key])
            if saved_dtypes[key] == "bfloat16":
                t = t.view(torch.bfloat16)
            want = tmpl.dtype
            if dtype is not None and want.is_floating_point:
                want = dtype
            dev = device if device is not None else (
                "cpu" if tmpl.device.type == "meta" else tmpl.device)
            leaves.append(t.to(device=dev, dtype=want))
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
        host_state = tree_map(_host_copy, state)        # snapshot now

        def work():
            try:
                save_checkpoint(self.directory, step, host_state)
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
