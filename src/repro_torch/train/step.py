"""Train-step builder (loss -> grad -> AdamW) and the runtime context.

``build_train_step`` returns ``(step_fn, None, None)``, as the
reference's does without a mesh: the port has no sharded path yet, so
there are no state or batch partition specs to return.
"""

from __future__ import annotations

import os

import torch

from repro_torch.kernels import recorder
from repro_torch.kernels.ops import BACKENDS
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import Ctx
from repro_torch.train.optim import AdamWConfig, adamw_update, init_state

__all__ = ["make_ctx", "build_train_step", "init_train_state"]


def make_ctx(mode: str, *, cache_len: int = 0, remat: bool = True,
             tuner=None, backend: str = "auto") -> Ctx:
    """Ctx for ``mode`` (train | prefill | decode) on a single device.

    Training runs on the ``library`` backend on any device, whatever
    ``backend`` says: no CUDA kernel has a backward.
    ``ADSALA_KV_INT8=1`` switches the serving caches (prefill and
    decode) to int8, as in the reference.
    """
    kv_q = (os.environ.get("ADSALA_KV_INT8") == "1"
            and mode in ("prefill", "decode"))
    if mode == "train":
        backend = "library"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    return Ctx(mode=mode, cache_len=cache_len, remat=remat, tuner=tuner,
               kv_quantized=kv_q, backend=backend)


def build_train_step(model, cfg: ArchConfig,
                     opt_cfg: AdamWConfig | None = None, tuner=None):
    """Returns ``(train_step, None, None)``.

    ``train_step(state, batch) -> (state, metrics)``: the loss on
    ``batch`` (``tokens`` / ``labels`` (B, S) int tensors on the state's
    device), its gradients by autograd, then one in-place
    :func:`~repro_torch.train.optim.adamw_update`.  Metrics: ``loss``,
    ``grad_norm``, ``lr`` (scalar tensors).

    ``tuner`` is threaded to every routine-aware call site via the Ctx;
    the step also tags the backward-pass contractions: for each forward
    event the recorder collected during the loss, the two transposed
    gemm shapes (dX, dW) are recorded, so a recorded train step shows
    forward *and* backward dispatch volume.  Each layer is recomputed
    in the backward pass (remat), and the recomputation records nothing
    (see :func:`~repro_torch.kernels.recorder.suppressed`).
    """
    opt_cfg = opt_cfg or AdamWConfig()
    ctx = make_ctx("train", tuner=tuner)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        # fresh leaves that share the state's storage: the state's own
        # tensors never require grad, so the in-place update needs no
        # bookkeeping
        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          state["params"])
        n0 = recorder.active_event_count()
        loss = model.loss(params, batch, ctx)
        leaves = tree_leaves(params)
        grad_leaves = torch.autograd.grad(loss, leaves)
        del params, leaves
        recorder.record_backward(since=n0, tuner=tuner)
        it = iter(grad_leaves)
        grads = tree_map(lambda _: next(it), state["params"])
        new_state, metrics = adamw_update(state, grads, opt_cfg)
        metrics["loss"] = loss.detach()
        return new_state, metrics

    return train_step, None, None


def init_train_state(model, cfg: ArchConfig, opt_cfg: AdamWConfig,
                     gen: torch.Generator,
                     dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters from ``gen`` (on ``gen``'s device) and zero
    AdamW moments."""
    return init_state(model.init(gen, dtype), opt_cfg)
