"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory with exponential gating), as in :mod:`repro.models.xlstm`.

  * mLSTM — the reference's chunked linear-attention form: the
    inter-chunk state (B, H, Dh, Dh) is carried by a Python loop over
    sequence chunks (the reference's ``lax.scan``), the intra-chunk work
    is batched einsums, with the same max-stabiliser
    ``m_pos = max(m_0, cummax(ig - cum)) + cum``.  Prefill follows the
    reference's arithmetic chunk for chunk; decode is the step
    recurrence.
  * sLSTM — a Python loop over time (the recurrence is non-associative
    because of the max-stabiliser state), vector ops and two small
    products a step.

Neither is a Pallas kernel in the reference: both stay torch ops.  Both
carry exact recurrent state for decode.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _gelu, linear, rmsnorm
from repro_torch.models.params import ParamDef

__all__ = [
    "XLSTMSpec", "mlstm_defs", "mlstm_train", "mlstm_decode",
    "slstm_defs", "slstm_train", "slstm_decode",
    "MLSTMState", "SLSTMState", "init_mlstm_state", "init_slstm_state",
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
    h, dh = s.n_heads, s.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(torch.zeros((batch, h, dh, dh), **f32),
                      torch.zeros((batch, h, dh), **f32),
                      torch.full((batch, h), -1e30, **f32))


def _mlstm_qkv(p: dict, x: torch.Tensor, s: XLSTMSpec):
    """x (B, S, D) -> q/k/v (B, S, H, Dh), gates (B, S, H), gate z."""
    b, sl, _ = x.shape
    up = linear(x, p["w_up"])
    u, z = torch.chunk(up, 2, dim=-1)
    q = linear(u, p["wq"]).reshape(b, sl, s.n_heads, s.head_dim)
    k = linear(u, p["wk"]).reshape(b, sl, s.n_heads, s.head_dim) \
        * (s.head_dim ** -0.5)
    v = linear(u, p["wv"]).reshape(b, sl, s.n_heads, s.head_dim)
    ig = (torch.einsum("bsd,dh->bsh", u, p["w_igate"])
          + p["b_igate"]).float()
    fg = (torch.einsum("bsd,dh->bsh", u, p["w_fgate"])
          + p["b_fgate"]).float()
    return q, k, v, ig, fg, z


def _mlstm_chunk(state: MLSTMState, qi, ki, vi, igi, fgi
                 ) -> tuple[MLSTMState, torch.Tensor]:
    """One chunk of the parallel form: inputs (B, ch, H, ...) in fp32;
    returns the state at the chunk's end and its (B, ch, H, Dh) output."""
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
    den = torch.abs(norm_intra + norm_inter)
    out = num / torch.clamp(den, min=1.0)[..., None]
    # state update to the chunk end (stabilised by m_last)
    decay = torch.exp(state.m + total - m_last)          # (B, H)
    kdec = torch.exp(igi + total[:, None] - cum - m_last[:, None])
    c_new = state.c * decay[..., None, None] + torch.einsum(
        "bthd,bthe,bth->bhde", ki, vi, kdec)
    n_new = state.n * decay[..., None] + torch.einsum(
        "bthd,bth->bhd", ki, kdec)
    return MLSTMState(c_new, n_new, m_last), out


def mlstm_train(p: dict, x: torch.Tensor, s: XLSTMSpec
                ) -> tuple[torch.Tensor, MLSTMState]:
    """Chunked parallel mLSTM over the full sequence.

    Returns (out, final state) — the state seeds decode.  The sequence
    is zero-padded to whole chunks, as in the reference (a padded
    position still moves the final state)."""
    b, sl, _ = x.shape
    q, k, v, ig, fg, z = _mlstm_qkv(p, x, s)
    ch = min(s.chunk, sl)
    nc = -(-sl // ch)
    pad = nc * ch - sl

    def pad_t(t):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((b, pad) + t.shape[2:])], dim=1)
        return t

    q, k, v, ig, fg = (pad_t(t) for t in (q, k, v, ig, fg))
    state = init_mlstm_state(b, s, x.device)
    outs = []
    for c in range(nc):
        sl_c = slice(c * ch, (c + 1) * ch)
        state, out = _mlstm_chunk(state, q[:, sl_c], k[:, sl_c],
                                  v[:, sl_c], ig[:, sl_c], fg[:, sl_c])
        outs.append(out)
    out = torch.cat(outs, dim=1).reshape(b, nc * ch, s.d_inner)
    out = out[:, :sl].to(x.dtype)
    out = rmsnorm(out, p["norm"]) * F.silu(z)
    return linear(out, p["w_down"]), state


def mlstm_decode(p: dict, x: torch.Tensor, s: XLSTMSpec, state: MLSTMState
                 ) -> tuple[torch.Tensor, MLSTMState]:
    """One-token mLSTM step; x (B, 1, D).  Returns a new state."""
    b = x.shape[0]
    q, k, v, ig, fg, z = _mlstm_qkv(p, x, s)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]      # (B, H, Dh)
    ig, fg = ig[:, 0], fg[:, 0]              # (B, H)
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(state.m + logf, ig)
    decay = torch.exp(state.m + logf - m_new)
    inject = torch.exp(ig - m_new)
    kf, vf, qf = (t.float() for t in (k, v, q))
    c_new = state.c * decay[..., None, None] \
        + inject[..., None, None] * kf[..., :, None] * vf[..., None, :]
    n_new = state.n * decay[..., None] + inject[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, c_new)
    den = torch.abs(torch.einsum("bhd,bhd->bh", qf, n_new))
    out = (num / torch.clamp(den, min=1.0)[..., None]).reshape(
        b, 1, s.d_inner)
    out = rmsnorm(out.to(x.dtype), p["norm"]) * F.silu(z)
    return linear(out, p["w_down"]), MLSTMState(c_new, n_new, m_new)


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
    d = s.d_model
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z, torch.full((batch, d), -1e30,
                                          dtype=torch.float32, device=device))


def _slstm_cell(p: dict, xt: torch.Tensor, st: SLSTMState
                ) -> tuple[SLSTMState, torch.Tensor]:
    """One sLSTM step; xt (B, D) fp32."""
    pre = (xt @ p["w_in"].float()
           + st.h @ p["w_rec"].float()
           + p["b"].float())
    z, i, f, o = torch.chunk(pre, 4, dim=-1)
    logf = F.logsigmoid(f)
    m_new = torch.maximum(logf + st.m, i)
    i_s = torch.exp(i - m_new)
    f_s = torch.exp(logf + st.m - m_new)
    c = f_s * st.c + i_s * torch.tanh(z)
    n = f_s * st.n + i_s
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1.0)
    return SLSTMState(c, n, h, m_new), h


def _slstm_out(p: dict, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(h, p["norm"])
    a, g = torch.chunk(linear(h, p["w_up"]), 2, dim=-1)
    return linear(a * _gelu(g), p["w_down"])


def slstm_train(p: dict, x: torch.Tensor, s: XLSTMSpec
                ) -> tuple[torch.Tensor, SLSTMState]:
    """Sequential loop over time (non-associative recurrence)."""
    b, sl, _ = x.shape
    xf = x.float()
    st = init_slstm_state(b, s, x.device)
    hs = []
    for t in range(sl):
        st, h = _slstm_cell(p, xf[:, t], st)
        hs.append(h)
    return _slstm_out(p, torch.stack(hs, dim=1).to(x.dtype)), st


def slstm_decode(p: dict, x: torch.Tensor, s: XLSTMSpec, state: SLSTMState
                 ) -> tuple[torch.Tensor, SLSTMState]:
    st2, h = _slstm_cell(p, x[:, 0].float(), state)
    return _slstm_out(p, h[:, None].to(x.dtype)), st2
