"""Port vs reference: the sLSTM recurrence as one torch op
(``repro_torch::slstm_scan``) with its hand-written backward
(``repro_torch::slstm_scan_backward``), on the CPU.  The op takes the
input part of the pre-activations, ``xw = x @ w_in``, hoisted out of
the recurrence as one product (``xlstm._slstm_xw``); it returns the
gradient of ``xw``, and the hoisted product's own backward gives those
of ``x`` and ``w_in``.

Inputs are made with numpy from a seed.  Yardsticks:

* the plain version ``slstm_train_loop`` (the same hoisted product, then
  the Python loop over time, differentiated by autograd): the op's
  forward bitwise, its gradients (of ``xw``, ``w_rec`` and ``b``, and
  through the hoisted product of ``x`` and ``w_in``) within
  ``LOOP_GRAD_TOL`` normwise (the backward sums in another order);
* the reference's ``slstm_train`` (``lax.scan``, ``jax.grad``) at the
  tolerances ``tests/test_torch_xlstm.py`` (``LAYER_TOL``) and
  ``tests/test_torch_train_families.py`` (``GRAD_TOL``) hold xlstm to;
* the op's fake implementations against its real outputs, its FLOP
  formulas against ``FlopCounterMode`` over the loop (one product a
  step; the hoisted product is the matmul's, counted once).

The gradient cases force the edges of the recurrence: a tie in the
stabiliser ``m = max(logsigmoid(f) + m', i)`` at every step after the
first (``torch.maximum`` splits the gradient there), and a normaliser
``n == 1`` at every step (``torch.clamp(n, min=1)`` passes it there; at
t = 0 every sequence has n == 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.models import xlstm as JX
from repro_torch.models import xlstm as X

torch.set_num_threads(1)

#: the block and state tolerance of tests/test_torch_xlstm.py
LAYER_TOL = 1e-5
#: the gradient tolerance of tests/test_torch_train_families.py
GRAD_TOL = 1e-4
#: the op's gradients against autograd through the loop (fp32)
LOOP_GRAD_TOL = 1e-6

#: (batch, length, d_model)
SIZES = [(2, 7, 16), (3, 40, 32)]
GRAD_CASES = ["random", "final_h_only", "tie", "n_is_1"]


def _params(d: int, seed: int, case: str = "random") -> dict:
    """An sLSTM block's parameters; ``w_rec`` large enough that the
    recurrence matters.  ``tie``: the input gate is the constant 0.5
    and the forget gate's pre-activation 30, so logsigmoid(f) + m' == i
    in fp32 at every step after the first; ``n_is_1``: the forget gate
    at -200, so the forget factor is 0 and n == 1 at every step."""
    r = np.random.default_rng(seed)
    p = {"w_in": r.standard_normal((d, 4 * d)) / np.sqrt(d),
         "w_rec": 0.5 * r.standard_normal((d, 4 * d)) / np.sqrt(d),
         "b": 0.5 * r.standard_normal(4 * d),
         "norm": 1 + 0.1 * r.standard_normal(d),
         "w_up": r.standard_normal((d, 2 * d)) / np.sqrt(d),
         "w_down": r.standard_normal((d, d)) / np.sqrt(d)}
    if case in ("tie", "n_is_1"):
        for w in (p["w_in"], p["w_rec"]):
            w[:, d:2 * d] = 0.0
        p["b"][d:2 * d] = 0.5
        p["b"][2 * d:3 * d] = 30.0 if case == "tie" else -200.0
    return {k: v.astype(np.float32) for k, v in p.items()}


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _specs(d):
    return X.XLSTMSpec(d_model=d, n_heads=2), JX.XLSTMSpec(d_model=d,
                                                          n_heads=2)


def _xw(p: dict, x) -> torch.Tensor:
    """The op's input from numpy weights and inputs: x @ w_in, fp32."""
    return _t(x) @ _t(p["w_in"])


def _normwise(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", SIZES, ids=str)
def test_op_forward_is_the_loop_bitwise(size, dtype):
    """The same steps in the same order: equal bits, the output and
    every field of the final state (bf16: the casts stay outside the
    op)."""
    b, s, d = size
    spec, _ = _specs(d)
    p = {k: _t(v).to(dtype) for k, v in _params(d, 1).items()}
    x = _t(_x(b, s, d, s)).to(dtype)
    with torch.no_grad():
        out, st = X.slstm_train(p, x, spec)
        want, want_st = X.slstm_train_loop(p, x, spec)
    assert out.dtype == dtype and torch.equal(out, want)
    for f in ("c", "n", "h", "m"):
        assert torch.equal(getattr(st, f), getattr(want_st, f)), f


@pytest.mark.parametrize("size", SIZES, ids=str)
def test_op_forward_matches_reference(size):
    b, s, d = size
    spec, jspec = _specs(d)
    p = _params(d, 2)
    x = _x(b, s, d, 10 + s)
    out, st = X.slstm_train({k: _t(v) for k, v in p.items()}, _t(x), spec)
    jout, jst = JX.slstm_train({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), jspec)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=LAYER_TOL, rtol=LAYER_TOL)
    for f in ("c", "n", "h", "m"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jst, f)),
                                   atol=LAYER_TOL, rtol=LAYER_TOL)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _loss_weights(b, s, d, case):
    """Fixed random weights of a scalar loss over the output and the
    final state; ``final_h_only`` leaves the state's c, n, m unused (the
    op's backward gets ``None`` for them) and weighs only h."""
    r = np.random.default_rng(99)
    w = {"out": r.standard_normal((b, s, d)).astype(np.float32)}
    for f in ("c", "n", "h", "m"):
        if case != "final_h_only" or f == "h":
            w[f] = r.standard_normal((b, d)).astype(np.float32)
    return w


def _torch_grads(fn, p, x, spec, w):
    tp = {k: _t(v) for k, v in p.items()}
    leaves = [_t(x)] + [tp[k] for k in ("w_in", "w_rec", "b")]
    for t in leaves:
        t.requires_grad_(True)
    out, st = fn(tp, leaves[0], spec)
    loss = (out * _t(w["out"])).sum()
    for f in ("c", "n", "h", "m"):
        if f in w:
            loss = loss + (getattr(st, f) * _t(w[f])).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _jax_grads(p, x, jspec, w):
    def loss(x, w_in, w_rec, b):
        q = {k: jnp.asarray(v) for k, v in p.items()}
        q.update(w_in=w_in, w_rec=w_rec, b=b)
        out, st = JX.slstm_train(q, x, jspec)
        total = (out * w["out"]).sum()
        for f in ("c", "n", "h", "m"):
            if f in w:
                total = total + (getattr(st, f) * w[f]).sum()
        return total
    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), *(jnp.asarray(p[k]) for k in ("w_in", "w_rec", "b")))


def _edges(p, x):
    """(ties of max(logsigmoid(f) + m', i) after the first step, steps
    with n == 1) of the forward, from the op's saved tensors."""
    d = x.shape[-1]
    with torch.no_grad():
        outs = torch.ops.repro_torch.slstm_scan(
            _xw(p, x), _t(p["w_rec"]), _t(p["b"]), True)
    pre, ns, ms = outs[5], outs[7], outs[8]
    i, f = pre[..., d:2 * d], pre[..., 2 * d:3 * d]
    a = F.logsigmoid(f[:, 1:]) + ms[:, :-1]
    return int((a == i[:, 1:]).sum()), int((ns == 1).sum())


@pytest.mark.parametrize("case", GRAD_CASES)
def test_op_gradients_match_loop_and_reference(case):
    b, s, d = 2, 9, 16
    spec, jspec = _specs(d)
    p = _params(d, 3, case)
    x = _x(b, s, d, 4)
    ties, ones = _edges(p, x)
    if case == "tie":
        assert ties == b * (s - 1) * d
    elif case == "n_is_1":
        assert ones == b * s * d
    else:
        assert ties == 0 and ones >= b * d     # n == 1 at t = 0
    w = _loss_weights(b, s, d, case)
    got = _torch_grads(X.slstm_train, p, x, spec, w)
    loop = _torch_grads(X.slstm_train_loop, p, x, spec, w)
    ref = _jax_grads(p, x, jspec, w)
    for name, g, gl, gj in zip(("x", "w_in", "w_rec", "b"), got, loop, ref):
        assert np.isfinite(g).all(), name
        assert _normwise(g, gl) < LOOP_GRAD_TOL, name
        assert _normwise(g, np.asarray(gj)) < GRAD_TOL, name
    # the op's own gradients, of xw, w_rec and b, against the loop's
    # steps over the same xw
    for name, g, gl in zip(("xw", "w_rec", "b"),
                           _scan_grads(X.slstm_scan, p, x, w),
                           _scan_grads(_step_loop, p, x, w)):
        assert np.isfinite(g).all(), name
        assert _normwise(g, gl) < LOOP_GRAD_TOL, name


def _step_loop(xw, w_rec, b):
    """The loop of ``slstm_train_loop`` over a given ``xw``: its hidden
    states and final state."""
    bsz, s, d4 = xw.shape
    st = X.init_slstm_state(bsz, X.XLSTMSpec(d_model=d4 // 4, n_heads=2))
    hs = []
    for t in range(s):
        st, _ = X._slstm_step(xw[:, t], w_rec, b, st)
        hs.append(st.h)
    return torch.stack(hs, dim=1), st


def _scan_grads(fn, p, x, w):
    """The gradients of the loss of ``_loss_weights`` over the hidden
    states and final state with respect to ``xw``, ``w_rec`` and ``b``
    of ``fn(xw, w_rec, b)``."""
    leaves = [_xw(p, x), _t(p["w_rec"]), _t(p["b"])]
    for t in leaves:
        t.requires_grad_(True)
    hs, st = fn(*leaves)
    loss = (hs * _t(w["out"])).sum()
    for f in ("c", "n", "h", "m"):
        if f in w:
            loss = loss + (getattr(st, f) * _t(w[f])).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def test_backward_without_saved_tensors_raises():
    """Called with ``keep=False`` the op saves nothing for its backward,
    and the backward says so instead of computing something else."""
    d = 8
    p = _params(d, 5)
    xw = _xw(p, _x(1, 3, d, 5)).requires_grad_(True)
    hs = torch.ops.repro_torch.slstm_scan(xw, _t(p["w_rec"]), _t(p["b"]),
                                          False)[0]
    with pytest.raises(RuntimeError, match="keep"):
        hs.sum().backward()


# ---------------------------------------------------------------------------
# fake implementations, FLOP formulas, refusals
# ---------------------------------------------------------------------------

def _op_inputs(b, s, d, seed=6):
    """The op's (xw, w_rec, b)."""
    p = _params(d, seed)
    return _xw(p, _x(b, s, d, seed)), _t(p["w_rec"]), _t(p["b"])


def _meta(outs):
    return [(tuple(t.shape), t.dtype, t.device) for t in outs]


@pytest.mark.parametrize("keep", [True, False])
def test_fake_outputs_match_real(keep):
    b, s, d = 2, 5, 8
    real_in = _op_inputs(b, s, d)
    real = torch.ops.repro_torch.slstm_scan(*real_in, keep)
    with FakeTensorMode() as mode:
        fake_in = [mode.from_tensor(t) for t in real_in]
        fake = torch.ops.repro_torch.slstm_scan(*fake_in, keep)
    assert _meta(fake) == _meta(real)
    if not keep:
        return
    grads = [torch.randn(tuple(t.shape)) for t in real[:5]]
    args = (real[0], real_in[1], *real[5:], *grads)
    real_b = torch.ops.repro_torch.slstm_scan_backward(*args)
    with FakeTensorMode() as mode:
        fake_b = torch.ops.repro_torch.slstm_scan_backward(
            *[mode.from_tensor(t) for t in args])
    assert _meta(fake_b) == _meta(real_b)
    assert _meta(real_b) == _meta(real_in)


def test_opcheck():
    """Schema, fake against real, and the autograd registration of both
    ops (``None`` gradients of the final state included)."""
    utils = ("test_schema", "test_autograd_registration",
             "test_faketensor")
    xw, w_rec, b = _op_inputs(2, 4, 8)
    torch.library.opcheck(torch.ops.repro_torch.slstm_scan.default,
                          (xw.requires_grad_(True), w_rec, b, True),
                          test_utils=utils)
    outs = torch.ops.repro_torch.slstm_scan(xw.detach(), w_rec, b, True)
    torch.library.opcheck(
        torch.ops.repro_torch.slstm_scan_backward.default,
        (outs[0], w_rec, *outs[5:], torch.randn_like(outs[0]), None, None,
         torch.randn_like(outs[3]), None), test_utils=utils)


@pytest.mark.parametrize("size", SIZES, ids=str)
def test_flop_formulas_count_the_loop(size):
    """The loop over a given ``xw`` under ``FlopCounterMode``: one
    (B, D) @ (D, 4D) product a step forward; with ``xw`` and the weights
    requiring grad the backward's products (w_rec's gradient a step, the
    previous h's at every step but the first).  Through the block's
    ``slstm_scan`` on the hoisted ``x @ w_in`` the product is the
    matmul's, counted once: the op's formulas plus its forward and its
    backward's two products."""
    b, s, d = size
    p = _params(d, 7)
    w_rec, bias = (_t(p[k]).requires_grad_(True) for k in ("w_rec", "b"))
    xw0 = _xw(p, _x(b, s, d, 7))

    def count(fn, grad):
        with FlopCounterMode(display=False) as fc:
            if grad:
                fn(grad)[0].sum().backward()
            else:
                with torch.no_grad():
                    fn(grad)
        return fc.get_flop_counts()["Global"]

    def loop(grad):
        return _step_loop(xw0.clone().requires_grad_(grad), w_rec, bias)

    def op(grad):
        return X.slstm_scan(xw0.clone().requires_grad_(grad), w_rec, bias)

    def hoisted(grad):
        x = _t(_x(b, s, d, 7)).requires_grad_(grad)
        w_in = _t(p["w_in"]).requires_grad_(grad)
        return X.slstm_scan(X._slstm_xw({"w_in": w_in}, x), w_rec, bias)

    fwd = X.slstm_scan_flops(b, s, d)
    bwd = X.slstm_scan_backward_flops(b, s, d)
    assert fwd == 8 * b * s * d * d
    assert bwd == 16 * b * s * d * d - 8 * b * d * d
    assert sum(count(loop, False).values()) == fwd
    assert sum(count(loop, True).values()) == fwd + bwd
    assert count(op, False) == {torch.ops.repro_torch.slstm_scan: fwd}
    assert count(op, True) == {torch.ops.repro_torch.slstm_scan: fwd,
                               torch.ops.repro_torch.slstm_scan_backward:
                               bwd}
    product = 2 * b * s * d * 4 * d
    assert sum(count(hoisted, False).values()) == fwd + product
    got = count(hoisted, True)
    assert got.pop(torch.ops.repro_torch.slstm_scan) == fwd
    assert got.pop(torch.ops.repro_torch.slstm_scan_backward) == bwd
    assert sum(got.values()) == 3 * product


def test_op_refuses_what_it_cannot_take():
    """No fallback: a dtype other than fp32, operands on two devices, a
    shape that does not fit, or a DTensor raise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    xw, w_rec, b = _op_inputs(2, 4, 8)
    with pytest.raises(TypeError, match="bfloat16"):
        X.slstm_scan(xw.bfloat16(), w_rec, b)
    with pytest.raises(ValueError, match="meta"):
        X.slstm_scan(xw, w_rec.to("meta"), b)
    with pytest.raises(ValueError, match="w_rec"):
        X.slstm_scan(xw, w_rec[:, :8], b)
    with pytest.raises(ValueError, match="S >= 1"):
        X.slstm_scan(xw[:, :0], w_rec, b)
    with pytest.raises(ValueError, match="4D"):
        X.slstm_scan(xw[..., :-1], w_rec, b)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        dxw = DTensor.from_local(xw, mesh, [Replicate()], run_check=False)
        with pytest.raises(TypeError, match="DTensor"):
            X.slstm_scan(dxw, w_rec, b)
    finally:
        dist.destroy_process_group()
