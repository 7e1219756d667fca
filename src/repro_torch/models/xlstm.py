"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory with exponential gating), as in :mod:`repro.models.xlstm`.

  * mLSTM — the reference's chunked linear-attention form: the
    inter-chunk state (B, H, Dh, Dh) is carried by a Python loop over
    sequence chunks (the reference's ``lax.scan``), the intra-chunk work
    is batched einsums, with the same max-stabiliser
    ``m_pos = max(m_0, cummax(ig - cum)) + cum``.  Prefill follows the
    reference's arithmetic chunk for chunk; decode is the step
    recurrence.
  * sLSTM — the input product x @ w_in over the whole sequence at
    once, then a loop over time (the recurrence is non-associative
    because of the max-stabiliser state), vector ops and one small
    product (h @ w_rec) a step.  The loop runs inside one torch op,
    ``repro_torch::slstm_scan`` (the reference's one ``lax.scan``
    body), with a hand-written backward op, so that a trace meets it
    once a layer; the plain loop ``slstm_train_loop`` is its yardstick.

Neither is a Pallas kernel in the reference, and neither is a kernel
here: both run torch ops on whatever device their tensors are on.  Both
carry exact recurrent state for decode.

On a mesh (``tp``, the rank's :class:`~repro_torch.dist.collectives.
TPGroup` of 'model') the projections compute on their widths, the
weights cut as the reference stores them: an up-projection on the
rank's columns, gathered over the group (one all-gather), each rank
taking its slices of both halves; the row-cut products summed over the
group (the mLSTM's q, k, v and gates packed in one all-reduce; each
down-projection's output).  The mLSTM's chunked core runs on the
rank's key dims of q, k and its matrix memory, its partial (num, den)
summed over the group before the division, in train, prefill and
decode alike.  The sLSTM's input product x @ w_in is hoisted out of its
recurrence and computed on the rank's columns of ``w_in``, then
gathered; in train and prefill the recurrence itself (h @ w_rec) runs
whole on every rank, while a decode step takes the rank's columns of
``w_rec`` and ``b`` too and gathers the pre-activations, so that no
weight is gathered.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.dist import collectives as C
from repro_torch.models.layers import _gelu, linear, rmsnorm
from repro_torch.models.params import ParamDef

__all__ = [
    "XLSTMSpec", "mlstm_defs", "mlstm_train", "mlstm_decode",
    "slstm_defs", "slstm_train", "slstm_train_loop", "slstm_decode",
    "slstm_scan", "slstm_scan_flops", "slstm_scan_backward_flops",
    "MLSTMState", "SLSTMState", "init_mlstm_state", "init_slstm_state",
    "mlstm_state_whole",
]


@dataclasses.dataclass(frozen=True)
class XLSTMSpec:
    d_model: int
    n_heads: int
    proj_factor: float = 2.0      # mLSTM up-projection
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_defs(s: XLSTMSpec) -> dict:
    d, di = s.d_model, s.d_inner
    return {
        "w_up": ParamDef((d, 2 * di), ("embed", "ff")),
        "wq": ParamDef((di, di), ("ff", None)),
        "wk": ParamDef((di, di), ("ff", None)),
        "wv": ParamDef((di, di), ("ff", None)),
        "w_igate": ParamDef((di, s.n_heads), ("ff", None), scale=0.01),
        "b_igate": ParamDef((s.n_heads,), (None,), init="zeros"),
        "w_fgate": ParamDef((di, s.n_heads), ("ff", None), scale=0.01),
        "b_fgate": ParamDef((s.n_heads,), (None,), init="ones"),
        "norm": ParamDef((di,), (None,), init="ones"),
        "w_down": ParamDef((di, d), ("ff", "embed")),
    }


@dataclasses.dataclass
class MLSTMState:
    c: torch.Tensor    # (B, H, Dh, Dh) matrix memory, fp32
    n: torch.Tensor    # (B, H, Dh) normaliser
    m: torch.Tensor    # (B, H) max-stabiliser (log space)


def init_mlstm_state(batch: int, s: XLSTMSpec,
                     device: torch.device | str = "cpu") -> MLSTMState:
    return _zero_mlstm(batch, s.n_heads, s.head_dim, s.head_dim, device)


def _zero_mlstm(batch: int, h: int, dk: int, dh: int,
                device: torch.device | str) -> MLSTMState:
    """The initial state on ``dk`` key dims of each head's memory."""
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(torch.zeros((batch, h, dk, dh), **f32),
                      torch.zeros((batch, h, dk), **f32),
                      torch.full((batch, h), -1e30, **f32))


def _halves(y: torch.Tensor, tp) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank's slices of both halves of a product cut on its columns
    over ``tp`` (``y``: the rank's (..., 2n / tp) columns of (..., 2n)):
    the columns gathered over the group, each rank taking its n / tp of
    each half.  The gradient is summed over the group (``copy_to``)
    before it returns to the rank's columns."""
    whole = C.copy_to(C.all_gather(y, tp.group, dim=-1).contiguous(),
                      tp.group)
    half = whole.shape[-1] // 2
    n = half // tp.size
    lo = tp.rank * n
    return whole[..., lo:lo + n], whole[..., half + lo:half + lo + n]


def _mlstm_qkv(p: dict, x: torch.Tensor, s: XLSTMSpec, tp=None):
    """x (B, S, D) -> q/k/v (B, S, H, Dh), gates (B, S, H), gate z.

    With ``tp`` (the rank's columns of ``w_up``, rows of ``wq``, ``wk``,
    ``wv``, ``w_igate`` and ``w_fgate``): the rank's Di / tp slices of u
    and z (:func:`_halves`), and q, k, v and the gates whole, their
    partial products packed and summed over the group; z is the rank's
    (B, S, Di / tp).  The core reads the rank's key dims of q and k
    beside the whole v and gates, so their gradients are the rank's
    partials: summed over the group (``copy_to`` on the packed sum, and
    on the gates' biases, added after it)."""
    b, sl, _ = x.shape
    hd = (b, sl, s.n_heads, s.head_dim)
    if tp is None:
        up = linear(x, p["w_up"])
        u, z = torch.chunk(up, 2, dim=-1)
        q = linear(u, p["wq"])
        k = linear(u, p["wk"])
        v = linear(u, p["wv"])
        ig = torch.einsum("bsd,dh->bsh", u, p["w_igate"])
        fg = torch.einsum("bsd,dh->bsh", u, p["w_fgate"])
    else:
        u, z = _halves(linear(C.copy_to(x, tp.group), p["w_up"]), tp)
        di, h = s.d_inner, s.n_heads
        both = C.reduce_from(torch.cat(
            [linear(u, p["wq"]), linear(u, p["wk"]), linear(u, p["wv"]),
             torch.einsum("bsd,dh->bsh", u, p["w_igate"]),
             torch.einsum("bsd,dh->bsh", u, p["w_fgate"])], dim=-1),
            tp.group)
        # contiguous, as one device's: the chunked core's products
        # would otherwise copy strided views chunk by chunk
        q, k, v, ig, fg = (t.contiguous() for t in C.copy_to(
            both, tp.group).split([di, di, di, h, h], dim=-1))
    b_i, b_f = p["b_igate"], p["b_fgate"]
    if tp is not None:
        b_i, b_f = C.copy_to(torch.stack([b_i, b_f]), tp.group)
    q = q.reshape(hd)
    k = k.reshape(hd) * (s.head_dim ** -0.5)
    v = v.reshape(hd)
    ig = (ig + b_i).float()
    fg = (fg + b_f).float()
    return q, k, v, ig, fg, z


def _mlstm_out(p: dict, out: torch.Tensor, z: torch.Tensor, tp
               ) -> torch.Tensor:
    """The block's output from the core's (B, S, Di), normalised whole:
    gated by z and projected down; with ``tp``, the rank's slice of it
    by its z slice through its rows of ``w_down``, summed over the
    group."""
    out = rmsnorm(out, p["norm"])
    if tp is None:
        return linear(out * F.silu(z), p["w_down"])
    n = z.shape[-1]
    out = C.copy_to(out, tp.group)[..., tp.rank * n:(tp.rank + 1) * n]
    return C.reduce_from(linear(out * F.silu(z), p["w_down"]), tp.group)


def _mlstm_chunk(state: MLSTMState, qi, ki, vi, igi, fgi
                 ) -> tuple[MLSTMState, torch.Tensor, torch.Tensor]:
    """One chunk of the parallel form: inputs (B, ch, H, ...) in fp32;
    returns the state at the chunk's end and the output's numerator
    (B, ch, H, Dh) and signed denominator (B, ch, H) before the
    division.  ``qi``, ``ki`` and ``state.c`` / ``state.n`` may hold a
    slice of the key dims (dim 3, dim 2): then the numerator, the
    denominator and the state are that slice's terms, linear in it
    (the sum of every slice's is the whole's), and ``m`` is whole."""
    ch = qi.shape[1]
    logf = F.logsigmoid(fgi)                 # (B, ch, H)
    cum = torch.cumsum(logf, dim=1)          # inclusive prefix of log-forgets
    total = cum[:, -1]                       # (B, H)
    # per-position stabiliser, matching the step recurrence
    #   m_t = max(m_{t-1} + logf_t, ig_t)  =>  m_t = u_t + cum_t with
    #   u_t = max(m_0, cummax_{t'<=t}(ig_{t'} - cum_{t'}))
    u = torch.maximum(state.m[:, None],
                      torch.cummax(igi - cum, dim=1).values)  # (B, ch, H)
    m_pos = u + cum
    m_last = m_pos[:, -1]
    # intra-chunk decay: D[t, t'] = exp(cum_t - cum_t' + ig_t' - m_t)
    logd = (cum[:, :, None] - cum[:, None, :]
            + igi[:, None, :])               # (B, t, t', H)
    t_ids = torch.arange(ch, device=qi.device)
    causal = t_ids[:, None] >= t_ids[None, :]
    logd = torch.where(causal[None, :, :, None], logd, -torch.inf)
    d = torch.exp(logd - m_pos[:, :, None])
    sim = torch.einsum("bthd,bshd->btsh", qi, ki)
    w = sim * d
    intra = torch.einsum("btsh,bshd->bthd", w, vi)
    norm_intra = torch.sum(w, dim=2)                     # (B, t, H)
    # inter-chunk contribution: q_t against C_0, decayed to position t
    qdec = torch.exp(cum + state.m[:, None] - m_pos)     # (B, ch, H)
    inter = torch.einsum("bthd,bhde,bth->bthe", qi, state.c, qdec)
    norm_inter = torch.einsum("bthd,bhd,bth->bth", qi, state.n, qdec)
    num = intra + inter
    den = norm_intra + norm_inter
    # state update to the chunk end (stabilised by m_last)
    decay = torch.exp(state.m + total - m_last)          # (B, H)
    kdec = torch.exp(igi + total[:, None] - cum - m_last[:, None])
    c_new = state.c * decay[..., None, None] + torch.einsum(
        "bthd,bthe,bth->bhde", ki, vi, kdec)
    n_new = state.n * decay[..., None] + torch.einsum(
        "bthd,bth->bhd", ki, kdec)
    return MLSTMState(c_new, n_new, m_last), num, den


def _mlstm_divide(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """The output from the summed numerator and signed denominator."""
    return num / torch.clamp(torch.abs(den), min=1.0)[..., None]


def mlstm_state_whole(state: MLSTMState, tp) -> MLSTMState:
    """The whole state from each rank's key dims of ``c`` and ``n``
    (dim 2), gathered over ``tp``'s group (a prefill returns its caches
    whole); ``m`` is whole already."""
    return MLSTMState(C.all_gather(state.c, tp.group, dim=2).contiguous(),
                      C.all_gather(state.n, tp.group, dim=2).contiguous(),
                      state.m)


def mlstm_train(p: dict, x: torch.Tensor, s: XLSTMSpec, tp=None
                ) -> tuple[torch.Tensor, MLSTMState]:
    """Chunked parallel mLSTM over the full sequence.

    Returns (out, final state) — the state seeds decode.  The sequence
    is zero-padded to whole chunks, as in the reference (a padded
    position still moves the final state).  With ``tp`` the
    projections compute on the rank's widths and the chunked core on
    the rank's Dh / tp key dims of q and k in every head (v and the
    gates whole; the 'model' axis cuts an xLSTM only where it divides
    Dh, ``transformer._dense_cuts``, else the mixer runs whole): its
    scores, inter-chunk products and state are the slice's, the
    intra-chunk product of its partial scores with v runs on each rank,
    and the packed partial (num, den) of every chunk is summed over the
    group once, before the division.  The state is the rank's key dims
    of ``c`` and ``n`` (:func:`mlstm_state_whole` gathers them)."""
    b, sl, _ = x.shape
    q, k, v, ig, fg, z = _mlstm_qkv(p, x, s, tp)
    dk = s.head_dim
    if tp is not None:
        dk //= tp.size
        q, k = (t[..., tp.rank * dk:(tp.rank + 1) * dk] for t in (q, k))
    ch = min(s.chunk, sl)
    nc = -(-sl // ch)
    pad = nc * ch - sl

    def pad_t(t):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
        return t

    q, k, v, ig, fg = (pad_t(t) for t in (q, k, v, ig, fg))
    state = _zero_mlstm(b, s.n_heads, dk, s.head_dim, x.device)
    nums, dens = [], []
    for c in range(nc):
        sl_c = slice(c * ch, (c + 1) * ch)
        state, num, den = _mlstm_chunk(state, q[:, sl_c], k[:, sl_c],
                                       v[:, sl_c], ig[:, sl_c], fg[:, sl_c])
        nums.append(num)
        dens.append(den)
    num, den = torch.cat(nums, dim=1), torch.cat(dens, dim=1)
    if tp is not None:
        both = C.reduce_from(torch.cat([num, den[..., None]], dim=-1),
                             tp.group)
        num, den = both[..., :-1], both[..., -1]
    out = _mlstm_divide(num, den).reshape(b, nc * ch, s.d_inner)
    out = out[:, :sl].to(x.dtype)
    return _mlstm_out(p, out, z, tp), state


def mlstm_decode(p: dict, x: torch.Tensor, s: XLSTMSpec, state: MLSTMState,
                 tp=None) -> tuple[torch.Tensor, MLSTMState]:
    """One-token mLSTM step; x (B, 1, D).  Returns a new state.

    With ``tp`` the projections compute on the rank's widths and
    ``state.c`` (B, H, Dh / tp, Dh) and ``state.n`` (B, H, Dh / tp)
    hold the rank's key dims (``m`` (B, H) whole): the rank updates them
    with its slice of k, and the partial (num, den) of its slice of q,
    packed, are summed over the group before the division.  The new
    state is in the same layout."""
    b = x.shape[0]
    q, k, v, ig, fg, z = _mlstm_qkv(p, x, s, tp)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]      # (B, H, Dh)
    ig, fg = ig[:, 0], fg[:, 0]              # (B, H)
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(state.m + logf, ig)
    decay = torch.exp(state.m + logf - m_new)
    inject = torch.exp(ig - m_new)
    kf, vf, qf = (t.float() for t in (k, v, q))
    if tp is not None:
        n = state.c.shape[2]
        kf, qf = (t[..., tp.rank * n:(tp.rank + 1) * n] for t in (kf, qf))
    c_new = state.c * decay[..., None, None] \
        + inject[..., None, None] * kf[..., :, None] * vf[..., None, :]
    n_new = state.n * decay[..., None] + inject[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, c_new)
    den = torch.einsum("bhd,bhd->bh", qf, n_new)
    if tp is not None:
        both = C.reduce_from(torch.cat([num, den[..., None]], dim=-1),
                             tp.group)
        num, den = both[..., :-1], both[..., -1]
    out = _mlstm_divide(num, den).reshape(b, 1, s.d_inner)
    return _mlstm_out(p, out.to(x.dtype), z, tp), \
        MLSTMState(c_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_defs(s: XLSTMSpec) -> dict:
    d = s.d_model
    return {
        # z, i, f, o projections (input + recurrent)
        "w_in": ParamDef((d, 4 * d), ("embed", "ff")),
        "w_rec": ParamDef((d, 4 * d), ("embed", "ff"), scale=0.01),
        "b": ParamDef((4 * d,), ("ff",), init="zeros"),
        "norm": ParamDef((d,), (None,), init="ones"),
        "w_up": ParamDef((d, 2 * d), ("embed", "ff")),
        "w_down": ParamDef((d, d), ("ff", "embed")),
    }


@dataclasses.dataclass
class SLSTMState:
    c: torch.Tensor    # (B, D) cell
    n: torch.Tensor    # (B, D) normaliser
    h: torch.Tensor    # (B, D) hidden
    m: torch.Tensor    # (B, D) stabiliser


def init_slstm_state(batch: int, s: XLSTMSpec,
                     device: torch.device | str = "cpu") -> SLSTMState:
    return _zero_state(batch, s.d_model, device)


def _zero_state(batch: int, d: int, device: torch.device | str
                ) -> SLSTMState:
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z, torch.full((batch, d), -1e30,
                                          dtype=torch.float32, device=device))


def _slstm_step(xw_t: torch.Tensor, w_rec: torch.Tensor, b: torch.Tensor,
                st: SLSTMState) -> tuple[SLSTMState, torch.Tensor]:
    """One sLSTM step on fp32 operands from the input part of its
    pre-activations, xw_t = x_t @ w_in (B, 4D), in the reference's order
    (x_t @ w_in + h @ w_rec, then b).  Returns the new state and the
    pre-activations (B, 4D)."""
    pre = xw_t + st.h @ w_rec + b
    return _slstm_gates(pre, st), pre


def _slstm_gates(pre: torch.Tensor, st: SLSTMState) -> SLSTMState:
    """The state after a step from its pre-activations (B, 4D)."""
    z, i, f, o = torch.chunk(pre, 4, dim=-1)
    logf = F.logsigmoid(f)
    m_new = torch.maximum(logf + st.m, i)
    i_s = torch.exp(i - m_new)
    f_s = torch.exp(logf + st.m - m_new)
    c = f_s * st.c + i_s * torch.tanh(z)
    n = f_s * st.n + i_s
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
    return SLSTMState(c, n, h, m_new)


def _slstm_cell(p: dict, xt: torch.Tensor, st: SLSTMState
                ) -> tuple[SLSTMState, torch.Tensor]:
    """One sLSTM step; xt (B, D) fp32."""
    st, _ = _slstm_step(xt @ p["w_in"].float(), p["w_rec"].float(),
                        p["b"].float(), st)
    return st, st.h


def _slstm_xw(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The input part of every step's pre-activations, x @ w_in
    (B, S, 4D) in fp32, hoisted out of the recurrence as one product;
    with ``tp`` the rank's 4D / tp columns of it (``w_in``'s stored
    columns; ``x``'s gradient summed over the group) gathered over the
    group, one all-gather a layer."""
    if tp is None:
        return x.float() @ p["w_in"].float()
    xw = C.copy_to(x, tp.group).float() @ p["w_in"].float()
    # contiguous, as one device's: the step reads it a column at a time
    return C.all_gather(xw, tp.group, dim=-1).contiguous()


def _slstm_out(p: dict, h: torch.Tensor, tp=None) -> torch.Tensor:
    """The block's output from its hidden states: normalised, a GeGLU
    up-projection, down; with ``tp`` on the rank's columns of ``w_up``
    (:func:`_halves`) and rows of ``w_down``, summed over the group."""
    h = rmsnorm(h, p["norm"])
    if tp is None:
        a, g = torch.chunk(linear(h, p["w_up"]), 2, dim=-1)
        return linear(a * _gelu(g), p["w_down"])
    a, g = _halves(linear(C.copy_to(h, tp.group), p["w_up"]), tp)
    return C.reduce_from(linear(a * _gelu(g), p["w_down"]), tp.group)


def slstm_train(p: dict, x: torch.Tensor, s: XLSTMSpec, tp=None
                ) -> tuple[torch.Tensor, SLSTMState]:
    """The sLSTM over the whole sequence: the input product x @ w_in
    hoisted out of the recurrence (:func:`_slstm_xw`), then one
    ``repro_torch::slstm_scan`` op (:func:`slstm_scan`) over it.  With
    ``tp`` the input product computes on the rank's columns of ``w_in``
    and is gathered; the recurrence (``h @ w_rec``, ``w_rec`` and ``b``
    whole) runs whole on every rank, and the output projections on the
    rank's widths."""
    hs, st = slstm_scan(_slstm_xw(p, x, tp), p["w_rec"].float(),
                        p["b"].float())
    return _slstm_out(p, hs.to(x.dtype), tp), st


def slstm_train_loop(p: dict, x: torch.Tensor, s: XLSTMSpec, tp=None
                     ) -> tuple[torch.Tensor, SLSTMState]:
    """The plain version of :func:`slstm_train`: the same hoisted input
    product, then a Python loop over time (the recurrence is
    non-associative), differentiated by autograd.  The tests'
    yardstick; no model path calls it."""
    b, sl, _ = x.shape
    xw = _slstm_xw(p, x, tp)
    w_rec, bias = p["w_rec"].float(), p["b"].float()
    st = init_slstm_state(b, s, x.device)
    hs = []
    for t in range(sl):
        st, _ = _slstm_step(xw[:, t], w_rec, bias, st)
        hs.append(st.h)
    return _slstm_out(p, torch.stack(hs, dim=1).to(x.dtype), tp), st


# ---------------------------------------------------------------------------
# The sLSTM recurrence as one torch op, with a hand-written backward
# ---------------------------------------------------------------------------

def slstm_scan(xw: torch.Tensor, w_rec: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, SLSTMState]:
    """``(hs (B, S, D), final state)`` of the sLSTM from
    :func:`init_slstm_state` over the input part of its pre-activations
    ``xw (B, S, 4D)`` (x @ w_in, :func:`_slstm_xw`), with ``w_rec``
    (D, 4D) and ``b`` (4D,): the step loop of :func:`slstm_train_loop`,
    in the same order, inside the op ``repro_torch::slstm_scan``
    (bitwise equal to the loop on the same device for the same ``xw``).

    A trace meets the op once, whatever the sequence length; its FLOP
    formula counts the loop's one product a step (h @ w_rec), and its
    backward is the op ``repro_torch::slstm_scan_backward``, which
    returns the gradient of ``xw`` (the pre-activations') for the
    hoisted product's own backward.  Under grad the op also returns
    what the backward needs: the pre-activations (B, S, 4D) and the
    states c, n, m of every step (B, S, D); the backward recomputes the
    gates from them elementwise and no product of the forward.

    Raises on a DTensor, a dtype other than float32, operands on
    different devices or shapes that do not fit; nothing falls back to
    another path."""
    from torch.distributed.tensor import DTensor

    args = {"xw": xw, "w_rec": w_rec, "b": b}
    for name, t in args.items():
        if isinstance(t, DTensor):
            raise TypeError(f"slstm_scan: {name} is a DTensor; pass the "
                            "local tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"slstm_scan: {name} is {t.dtype}, not "
                            "float32")
        if t.device != xw.device:
            raise ValueError(f"slstm_scan: {name} on {t.device}, xw on "
                             f"{xw.device}")
    if xw.ndim != 3 or xw.shape[1] == 0 or xw.shape[2] % 4:
        raise ValueError(f"slstm_scan: xw must be (B, S >= 1, 4D), got "
                         f"{tuple(xw.shape)}")
    d = xw.shape[2] // 4
    for name, t, shape in (("w_rec", w_rec, (d, 4 * d)),
                           ("b", b, (4 * d,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"slstm_scan: {name} is {tuple(t.shape)}, "
                             f"expected {shape}")
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in args.values())
    hs, c, n, h, m, *_ = torch.ops.repro_torch.slstm_scan(
        xw, w_rec, b, keep)
    return hs, SLSTMState(c, n, h, m)


def slstm_scan_flops(b: int, s: int, d: int) -> int:
    """The forward's operations: one (B, D) @ (D, 4D) product a step."""
    return 8 * b * s * d * d


def slstm_scan_backward_flops(b: int, s: int, d: int) -> int:
    """The backward's: the gradient of w_rec (8BD² a step), and of the
    previous h at every step but the first."""
    return 16 * b * s * d * d - 8 * b * d * d


_Tensors9 = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor]


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def _slstm_scan_op(xw: torch.Tensor, w_rec: torch.Tensor, b: torch.Tensor,
                   keep: bool) -> _Tensors9:
    """``(hs, c, n, h, m, pre, cs, ns, ms)``: the outputs, the final
    state and, with ``keep``, the backward's saved tensors (else empty)."""
    bsz, sl, d4 = xw.shape
    d = d4 // 4
    st = _zero_state(bsz, d, xw.device)
    hs = xw.new_empty((bsz, sl, d))
    if keep:
        pre_s = xw.new_empty((bsz, sl, d4))
        cs, ns, ms = (xw.new_empty((bsz, sl, d)) for _ in range(3))
    for t in range(sl):
        st, pre = _slstm_step(xw[:, t], w_rec, b, st)
        hs[:, t] = st.h
        if keep:
            pre_s[:, t] = pre
            cs[:, t] = st.c
            ns[:, t] = st.n
            ms[:, t] = st.m
    if not keep:
        pre_s, cs, ns, ms = (xw.new_empty((0,)) for _ in range(4))
    return (hs, st.c.clone(), st.n.clone(), st.h.clone(), st.m.clone(),
            pre_s, cs, ns, ms)


@_slstm_scan_op.register_fake
def _(xw, w_rec, b, keep):
    bsz, sl, d4 = xw.shape
    d = d4 // 4
    state = [xw.new_empty((bsz, d)) for _ in range(4)]
    if keep:
        saved = [xw.new_empty((bsz, sl, d4))] + [
            xw.new_empty((bsz, sl, d)) for _ in range(3)]
    else:
        saved = [xw.new_empty((0,)) for _ in range(4)]
    return (xw.new_empty((bsz, sl, d)), *state, *saved)


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _slstm_scan_op_flops(xw_shape, *args, out_shape=None, **kwargs) -> int:
    b, s, d4 = xw_shape
    return slstm_scan_flops(b, s, d4 // 4)


@torch.library.custom_op("repro_torch::slstm_scan_backward", mutates_args=())
def _slstm_scan_backward_op(
        hs: torch.Tensor, w_rec: torch.Tensor, pre_s: torch.Tensor,
        cs: torch.Tensor, ns: torch.Tensor, ms: torch.Tensor,
        dhs: torch.Tensor | None, dc: torch.Tensor | None,
        dn: torch.Tensor | None, dh: torch.Tensor | None,
        dm: torch.Tensor | None
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dxw, dw_rec, db)`` from the gradients of ``hs`` and of the
    final state (``None`` is zero), walking t = S-1 ... 0 with the
    gradients of the state carried from step t+1; ``dxw`` is the
    pre-activations' gradient (B, S, 4D).  The rules at the edges are
    autograd's through the loop: ``torch.clamp(n, min=1)`` passes the
    gradient where n >= 1, ``torch.maximum(a, i)`` splits it evenly at
    a tie."""
    bsz, sl, d = hs.shape
    zero = hs.new_zeros((bsz, d))
    dh, dc, dn, dm = (zero if g is None else g for g in (dh, dc, dn, dm))
    dpre = torch.empty_like(pre_s)
    w_rec_t = w_rec.t()
    for t in range(sl - 1, -1, -1):
        if dhs is not None:
            dh = dh + dhs[:, t]
        z, i, f, o = torch.chunk(pre_s[:, t], 4, dim=-1)
        c, n, m = cs[:, t], ns[:, t], ms[:, t]
        if t:
            c_p, n_p, m_p = cs[:, t - 1], ns[:, t - 1], ms[:, t - 1]
        else:
            c_p, n_p, m_p = zero, zero, torch.full_like(zero, -1e30)
        # the forward's step, elementwise from its saved tensors
        a = F.logsigmoid(f) + m_p
        i_s = torch.exp(i - m)
        f_s = torch.exp(a - m)
        zt = torch.tanh(z)
        so = torch.sigmoid(o)
        nc = torch.clamp(n, min=1.0)
        # h = so * c / nc
        g = dh / nc
        do = g * c * so * (1 - so)
        dc = dc + g * so
        dn = dn - torch.where(n >= 1, g * so * c / nc, 0.0)
        # c = fs * c' + is * tanh(z), n = fs * n' + is
        dfs = dc * c_p + dn * n_p
        dis = dc * zt + dn
        dz = dc * i_s * (1 - zt * zt)
        di = dis * i_s
        da = dfs * f_s
        # is = exp(i - m), fs = exp(a - m); m = max(a, i)
        dm = dm - di - da
        tie = torch.where(a == i, 0.5 * dm, 0.0)
        da = da + torch.where(a > i, dm, 0.0) + tie
        di = di + torch.where(i > a, dm, 0.0) + tie
        # a = logsigmoid(f) + m'
        df = da * torch.sigmoid(-f)
        dm = da
        dc = dc * f_s
        dn = dn * f_s
        dpre_t = torch.cat([dz, di, df, do], dim=-1)
        dpre[:, t] = dpre_t
        if t:
            dh = dpre_t @ w_rec_t
    # the product of the whole sequence at once: h' is 0 at t = 0
    h_prev = torch.cat([zero[:, None], hs[:, :-1]], dim=1)
    flat = dpre.reshape(bsz * sl, 4 * d)
    dw_rec = h_prev.reshape(bsz * sl, d).t() @ flat
    return dpre, dw_rec, flat.sum(0)


@_slstm_scan_backward_op.register_fake
def _(hs, w_rec, pre_s, cs, ns, ms, dhs, dc, dn, dh, dm):
    return (torch.empty_like(pre_s), torch.empty_like(w_rec),
            hs.new_empty((w_rec.shape[1],)))


@register_flop_formula(torch.ops.repro_torch.slstm_scan_backward)
def _slstm_scan_backward_op_flops(hs_shape, *args, out_shape=None,
                                  **kwargs) -> int:
    return slstm_scan_backward_flops(*hs_shape)


def _slstm_scan_setup(ctx, inputs, output) -> None:
    _, w_rec, _, keep = inputs
    hs, *_, pre_s, cs, ns, ms = output
    ctx.keep = keep
    ctx.save_for_backward(hs, w_rec, pre_s, cs, ns, ms)
    ctx.mark_non_differentiable(pre_s, cs, ns, ms)
    ctx.set_materialize_grads(False)


def _slstm_scan_grad(ctx, dhs, dc, dn, dh, dm, *_):
    if not ctx.keep:
        raise RuntimeError("slstm_scan: the op ran without keeping its "
                           "backward's tensors (keep=False); call it "
                           "through slstm_scan under grad")
    dxw, dw_rec, db = torch.ops.repro_torch.slstm_scan_backward(
        *ctx.saved_tensors, dhs, dc, dn, dh, dm)
    return dxw, dw_rec, db, None


_slstm_scan_op.register_autograd(_slstm_scan_grad,
                                 setup_context=_slstm_scan_setup)


def slstm_decode(p: dict, x: torch.Tensor, s: XLSTMSpec, state: SLSTMState,
                 tp=None) -> tuple[torch.Tensor, SLSTMState]:
    """One-token sLSTM step; x (B, 1, D), ``state`` whole.  With ``tp``,
    ``w_in``, ``w_rec`` and ``b`` are the rank's 4D / tp columns: the
    rank's columns of the pre-activations are gathered over the group
    and the cell runs whole; the output projections on the rank's
    widths."""
    if tp is None:
        st2, h = _slstm_cell(p, x[:, 0].float(), state)
        return _slstm_out(p, h[:, None].to(x.dtype)), st2
    pre = x[:, 0].float() @ p["w_in"].float() \
        + state.h @ p["w_rec"].float() + p["b"].float()
    # contiguous, as one device's: the CPU's vectorised exp and tanh
    # round apart from their strided loops
    st2 = _slstm_gates(C.all_gather(pre, tp.group, dim=-1).contiguous(),
                       state)
    return _slstm_out(p, st2.h[:, None].to(x.dtype), tp), st2
