"""RecurrentGemma blocks: RG-LRU recurrence + temporal conv (Griffin,
arXiv:2402.19427), as in :mod:`repro.models.recurrent`.

The RG-LRU is a real-valued gated linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    a_t = exp(-c * softplus(Λ) * sigmoid(r_t))

Prefill scans it over the sequence with the reference's ``combine``
in the reference's order: :func:`_associative_scan` is the odd/even
recursion of ``jax.lax.associative_scan`` written out in torch (log
depth: about 2 log2 S levels of elementwise ops on strided halves), so
each h_t is summed and multiplied in the same association as the
reference's and agrees with it to fp32 rounding (the CPU tests hold
it to 1e-5).  Decode carries one (B, W) fp32 state.  The recurrent
block is conv1d(4) -> RG-LRU in a gated (GeGLU-style) wrapper, as in
Griffin.  No Pallas kernel: every op is a torch op.

On a mesh (``tp``, the rank's :class:`~repro_torch.dist.collectives.
TPGroup` of 'model') the block computes on the rank's W / tp channels,
as GSPMD partitions the reference's: its columns of ``wx``, ``wy`` and
the conv, its ``lam`` and gates' biases, its rows of both gates' (W, W)
products and of ``wo``.  The gates' partial products are packed and
reduce-scattered over the group (one collective), each rank receiving
the sums of its channels' gates, and the scan and the conv are local;
the output's partial product is summed.  A decode step carries the
rank's slice of the state and gathers nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.dist import collectives as C
from repro_torch.models.layers import _gelu, linear
from repro_torch.models.params import ParamDef

__all__ = ["RGLRUSpec", "rglru_block_defs", "rglru_block_train",
           "rglru_block_decode", "RGLRUState", "init_rglru_state",
           "state_whole"]

_C = 8.0  # Griffin's fixed recurrence sharpness


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    d_model: int
    width: int            # lru_width
    conv_width: int = 4


def rglru_block_defs(s: RGLRUSpec) -> dict:
    d, w = s.d_model, s.width
    return {
        "wx": ParamDef((d, w), ("embed", "ff")),        # recurrent branch
        "wy": ParamDef((d, w), ("embed", "ff")),        # gate branch
        "conv_w": ParamDef((s.conv_width, w), (None, "ff"), scale=0.5),
        "conv_b": ParamDef((w,), ("ff",), init="zeros"),
        "lam": ParamDef((w,), ("ff",), init="normal", scale=0.5),
        "w_input_gate": ParamDef((w, w), ("ff", None), scale=0.01),
        "b_input_gate": ParamDef((w,), (None,), init="zeros"),
        "w_rec_gate": ParamDef((w, w), ("ff", None), scale=0.01),
        "b_rec_gate": ParamDef((w,), (None,), init="zeros"),
        "wo": ParamDef((w, d), ("ff", "embed")),
    }


def _gates(p: dict, x: torch.Tensor, tp=None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """log(a_t) and input gate i_t, both (..., W) in fp32.

    With ``tp``, ``x`` is the rank's (..., W / tp) channels, the gates'
    weights its rows and their biases its W / tp channels: both partial
    (..., W) products are packed so that block r holds rank r's
    channels of each, (tp, 2, ..., W / tp), and reduce-scattered over the
    group (the sum GSPMD makes of a product cut on its contracted dim
    whose consumer is cut on channels); the rank adds its slices of the
    biases.  The scatter's backward all-gathers the blocks' gradients,
    so each rank's rows get the whole gradient; each bias slice's is the
    rank's, assembled into the stored whole by the train step."""
    xf = x.float()
    if tp is None:
        r = torch.sigmoid(xf @ p["w_rec_gate"].float()
                          + p["b_rec_gate"].float())
        i = torch.sigmoid(xf @ p["w_input_gate"].float()
                          + p["b_input_gate"].float())
    else:
        n = x.shape[-1]
        packed = torch.stack(
            [(xf @ p[k].float()).unflatten(-1, (tp.size, n)).movedim(-2, 0)
             for k in ("w_rec_gate", "w_input_gate")], dim=1)
        rec, inp = C.reduce_scatter(packed, tp.group, dim=0)[0]
        r = torch.sigmoid(rec + p["b_rec_gate"].float())
        i = torch.sigmoid(inp + p["b_input_gate"].float())
    log_a = -_C * F.softplus(p["lam"].float()) * r
    return log_a, i


def _conv1d(p: dict, x: torch.Tensor, state: torch.Tensor | None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv along seq; x (B, S, W).

    Returns (out, new_state) where state holds the last (conv_width - 1)
    inputs for decode continuation (a copy: it does not keep ``x``
    alive)."""
    cw = p["conv_w"].shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xx = torch.cat([state, x], dim=1)
    out = sum(xx[:, i:i + x.shape[1]] * p["conv_w"][i][None, None]
              for i in range(cw))
    return out + p["conv_b"], xx[:, -(cw - 1):].clone()


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a at the even, b at the odd positions of dim 1 (len(a) is len(b)
    or one more)."""
    out = a.new_empty((a.shape[0], a.shape[1] + b.shape[1]) + a.shape[2:])
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _associative_scan(combine: Callable, elems: list[torch.Tensor]
                      ) -> list[torch.Tensor]:
    """Inclusive scan of ``elems`` along dim 1 by ``combine``, in the
    order of ``jax.lax.associative_scan``: combine adjacent pairs, scan
    the pairs recursively (the odd positions), then combine each even
    position with the scanned prefix before it."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = combine([e[:, 0:-1:2] for e in elems],
                      [e[:, 1::2] for e in elems])
    odd = _associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def _rglru_scan(log_a: torch.Tensor, gx: torch.Tensor,
                h0: torch.Tensor | None) -> torch.Tensor:
    """Scan of h_t = a_t h_{t-1} + b_t over dim 1 (seq)."""
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gx
    if h0 is not None:
        b = b.clone()
        b[:, 0] += torch.exp(log_a[:, 0]) * h0

    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return [a1 * a2, a2 * b1 + b2]

    _, h = _associative_scan(combine, [a, b])
    return h


def rglru_block_train(p: dict, x: torch.Tensor, tp=None
                      ) -> tuple[torch.Tensor, "RGLRUState"]:
    """Full-sequence recurrent block: x (B, S, D) -> (out, final state).
    With ``tp`` the weights are the rank's (see the module) and the
    state is its W / tp channels (:func:`state_whole` gathers them)."""
    if tp is not None:
        x = C.copy_to(x, tp.group)
    gate = _gelu(linear(x, p["wy"]))
    u = linear(x, p["wx"])
    u, conv_state = _conv1d(p, u, None)
    log_a, i_gate = _gates(p, u, tp)
    h = _rglru_scan(log_a, i_gate * u.float(), None)
    out = linear(h.to(x.dtype) * gate, p["wo"])
    if tp is not None:
        out = C.reduce_from(out, tp.group)
    return out, RGLRUState(h[:, -1].clone(), conv_state)


@dataclasses.dataclass
class RGLRUState:
    h: torch.Tensor       # (B, W) recurrence state, fp32
    conv: torch.Tensor    # (B, conv_width - 1, W)


def init_rglru_state(batch: int, s: RGLRUSpec, dtype: torch.dtype,
                     device: torch.device | str = "cpu") -> RGLRUState:
    return RGLRUState(
        torch.zeros((batch, s.width), dtype=torch.float32, device=device),
        torch.zeros((batch, s.conv_width - 1, s.width), dtype=dtype,
                    device=device))


def state_whole(state: "RGLRUState", tp) -> "RGLRUState":
    """The whole state from each rank's W / tp channels of it, gathered
    over ``tp``'s group (a prefill returns its caches whole)."""
    return RGLRUState(
        C.all_gather(state.h, tp.group, dim=-1).contiguous(),
        C.all_gather(state.conv, tp.group, dim=-1).contiguous())


def rglru_block_decode(p: dict, x: torch.Tensor, state: RGLRUState, tp=None
                       ) -> tuple[torch.Tensor, RGLRUState]:
    """One-token step: x (B, 1, D).  Returns a new state (``state`` is
    not written).  With ``tp`` the weights are the rank's and ``state``
    its (B, W / tp) and (B, cw - 1, W / tp) slices; the new state is its
    slice too: the step's collectives are the gates' sum and the
    output's."""
    gate = _gelu(linear(x, p["wy"]))
    u = linear(x, p["wx"])
    u, conv_state = _conv1d(p, u, state.conv)
    log_a, i_gate = _gates(p, u[:, 0], tp)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i_gate * u[:, 0].float())
    h = a * state.h + b
    out = linear(h[:, None].to(x.dtype) * gate, p["wo"])
    if tp is not None:
        out = C.reduce_from(out, tp.group)
    return out, RGLRUState(h, conv_state)
