"""Port vs reference: multi-head latent attention and deepseek-v2 on the
CPU.

* ``_rope_1head`` at (S,) and at ragged (B, S) positions, on the 3-D
  shared rope key and the 4-D query rope part;
* ``mla_train``'s output and latents, ``mla_decode`` over 6 steps after
  a prefill, and ``mla_decode_paged`` against the reference's on the
  same weights and pages;
* ``mla_decode_paged`` against ``mla_decode`` sequence by sequence at
  ragged positions with an inactive slot, bit for bit;
* the paged primitives on rank-3 latent pools against the reference's;
* the deepseek-v2 smoke model with the reference's weights carried
  over: its layer plan and parameters, prefill and greedy decode, the
  recorded dispatch events, and the loss with its gradients against
  ``jax.grad``.

Everything is fp32: single layers are held to 1e-5, logits after the
whole stack to 1e-4, the loss to 1e-5 relative and each gradient to
1e-4 normwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.recorder import DispatchRecorder as JaxRecorder
from repro.models import mla as JMLA
from repro.models.params import init_params as jax_init_params
from repro.serve import kv_cache as JKV
from repro.train.step import make_ctx as jax_make_ctx
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.recorder import DispatchRecorder
from repro_torch.models import mla as MLA
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import LayerSpec
from repro_torch.serve.kv_cache import (
    HOLE,
    PagedLatent,
    append_token,
    gather_pages,
    init_paged_latent,
    seed_pages,
)
from repro_torch.train.step import make_ctx

pytestmark = pytest.mark.timeout(300)

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
ARCH = "deepseek-v2-236b"

#: the smoke config's MLA widths
_SPEC = dict(d_model=64, n_heads=4, q_lora_rank=48, kv_lora_rank=32,
             qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=tol, rtol=tol)


def _event(e):
    cfg = None if e.config is None else dataclasses.astuple(e.config)
    return (e.routine, e.m, e.k, e.n, cfg, e.count, e.cache_hit, e.site)


def _normwise(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return num / den if den > 0 else num


@pytest.fixture(scope="module")
def layer():
    """(jax spec, port spec, jax params as numpy, port params)."""
    jspec, spec = JMLA.MLASpec(**_SPEC), MLA.MLASpec(**_SPEC)
    jp = _np(jax_init_params(JMLA.mla_defs(jspec), jax.random.PRNGKey(5)))
    return jspec, spec, jp, {k: _t(v) for k, v in jp.items()}


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndim", [3, 4])
@pytest.mark.parametrize("ragged", [False, True])
def test_rope_1head_matches_reference(ndim, ragged):
    rng = np.random.default_rng(1)
    b, s, h, r = 3, 5, 4, 8
    shape = (b, s, h, r) if ndim == 4 else (b, s, r)
    x = rng.standard_normal(shape).astype(np.float32)
    if ragged:      # every sequence at its own positions, as paged decode
        pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11],
                        [30, 31, 32, 33, 34]])
    else:
        pos = np.arange(3, 3 + s)
    got = MLA._rope_1head(_t(x), torch.from_numpy(pos))
    want = JMLA._rope_1head(jnp.asarray(x), jnp.asarray(pos))
    assert got.shape == want.shape
    _close(got, want, LAYER_TOL)
    if ragged:
        # a row at its own positions is the row rotated alone
        for i in range(b):
            _close(got[i:i + 1], MLA._rope_1head(
                _t(x[i:i + 1]), torch.from_numpy(pos[i])), 0)


def test_mla_train_matches_reference(layer):
    jspec, spec, jp, p = layer
    x = np.random.default_rng(2).standard_normal((2, 20, 64)).astype(
        np.float32)
    with DispatchRecorder() as rec:
        out, (c_kv, k_rope) = MLA.mla_train(p, _t(x), spec)
    with JaxRecorder() as jrec:
        jout, (jc, jr) = JMLA.mla_train(jp, jnp.asarray(x), jspec)
    _close(out, jout, LAYER_TOL)
    _close(c_kv, jc, LAYER_TOL)
    _close(k_rope, jr, LAYER_TOL)
    assert [_event(e) for e in rec.events] == \
        [_event(e) for e in jrec.events]
    assert [e.site for e in rec.events] == [
        "mla.down_proj", "mla.up_proj_q", "mla.up_proj_kv", "mla.qk"]
    qk = rec.events[-1]
    assert (qk.routine, qk.m, qk.k, qk.n, qk.count) == \
        ("syrk", 20, spec.qk_head_dim, 20, 2 * spec.n_heads)


def test_mla_decode_after_prefill_matches_reference(layer):
    jspec, spec, jp, p = layer
    rng = np.random.default_rng(3)
    b, s, steps, cap = 2, 9, 6, 16
    x = rng.standard_normal((b, s, 64)).astype(np.float32)
    _, (c_kv, k_rope) = MLA.mla_train(p, _t(x), spec)
    _, (jc, jr) = JMLA.mla_train(jp, jnp.asarray(x), jspec)
    cache = MLA.seed_mla_cache(c_kv, k_rope, cap)
    jcache = JMLA.seed_mla_cache(jc, jr, cap)
    _close(cache.c_kv, jcache.c_kv, LAYER_TOL)
    assert not cache.c_kv[:, s:].any() and not cache.k_rope[:, s:].any()
    for pos in range(s, s + steps):
        xt = rng.standard_normal((b, 1, 64)).astype(np.float32)
        with DispatchRecorder() as rec:
            out, new = MLA.mla_decode(p, _t(xt), spec, cache, pos)
        with JaxRecorder() as jrec:
            jout, jcache = JMLA.mla_decode(jp, jnp.asarray(xt), jspec,
                                           jcache, jnp.int32(pos))
        assert new is cache                    # written in place
        _close(out, jout, LAYER_TOL)
        _close(cache.c_kv, jcache.c_kv, LAYER_TOL)
        _close(cache.k_rope, jcache.k_rope, LAYER_TOL)
        assert [_event(e) for e in rec.events] == \
            [_event(e) for e in jrec.events]
    assert [e.site for e in rec.events] == [
        "mla.down_proj", "mla.up_proj_q", "mla.cache_update"]
    upd = rec.events[-1]
    assert (upd.routine, upd.m, upd.k, upd.n) == \
        ("trsm", cap, spec.kv_lora_rank, b * spec.n_heads)


def test_init_and_seed_mla_cache():
    spec = MLA.MLASpec(**_SPEC)
    cache = MLA.init_mla_cache(3, 10, spec, torch.float32)
    assert tuple(cache.c_kv.shape) == (3, 10, 32)
    assert tuple(cache.k_rope.shape) == (3, 10, 8)
    assert not cache.c_kv.any() and not cache.k_rope.any()
    with pytest.raises(ValueError, match="exceeds"):
        MLA.seed_mla_cache(torch.zeros(1, 5, 32), torch.zeros(1, 5, 8), 4)


def _pool(seed, n_pages=12, page=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_pages, page, 32)).astype(np.float32),
            rng.standard_normal((n_pages, page, 8)).astype(np.float32))


#: (page table, positions): ragged positions, an inactive slot, a hole
#: past an active sequence's prefix, positions on page boundaries
_PAGED = [
    ([[2, 0, HOLE], [5, 1, 3], [HOLE, HOLE, HOLE], [7, HOLE, HOLE]],
     [5, 11, -1, 2]),
    ([[4, 6, HOLE], [0, 2, 9], [1, HOLE, HOLE], [HOLE, HOLE, HOLE]],
     [4, 8, 3, -1]),
]


@pytest.mark.parametrize("case", range(len(_PAGED)))
def test_mla_decode_paged_matches_reference(layer, case):
    jspec, spec, jp, p = layer
    table, pos = _PAGED[case]
    c_kv, k_rope = _pool(case)
    x = np.random.default_rng(10 + case).standard_normal(
        (len(pos), 1, 64)).astype(np.float32)
    pool = PagedLatent(_t(c_kv), _t(k_rope))
    with DispatchRecorder() as rec:
        out, pool2 = MLA.mla_decode_paged(
            p, _t(x), spec, pool, torch.tensor(table, dtype=torch.int32),
            torch.tensor(pos))
    with JaxRecorder() as jrec:
        jout, jpool = JMLA.mla_decode_paged(
            jp, jnp.asarray(x), jspec,
            JKV.PagedLatent(jnp.asarray(c_kv), jnp.asarray(k_rope)),
            jnp.asarray(table, jnp.int32), jnp.asarray(pos, jnp.int32))
    assert pool2 is pool
    act = np.asarray(pos) >= 0
    _close(out.numpy()[act], np.asarray(jout)[act], LAYER_TOL)
    for mine, ref, before in ((pool.c_kv, jpool.c_kv, c_kv),
                              (pool.k_rope, jpool.k_rope, k_rope)):
        _close(mine, ref, LAYER_TOL)
        moved = (mine.numpy() != before).any(axis=2)
        np.testing.assert_array_equal(
            moved, (np.asarray(ref) != before).any(axis=2))
        assert moved.sum() == act.sum()      # one row per active slot
    assert [_event(e) for e in rec.events] == \
        [_event(e) for e in jrec.events]
    upd = rec.events[-1]
    assert (upd.site, upd.routine, upd.m) == \
        ("mla.cache_update", "trsm", len(table[0]) * 4)


@pytest.mark.parametrize("case", range(len(_PAGED)))
def test_mla_decode_paged_is_contiguous_decode_bitwise(layer, case):
    """Sequence by sequence at its own position: the paged decode's row
    equals the contiguous decode's on the page-gathered cache bit for
    bit, and both write the same latent row; the inactive slot writes
    nothing."""
    _, spec, _, p = layer
    table, pos = _PAGED[case]
    tbl = torch.tensor(table, dtype=torch.int32)
    c_kv, k_rope = _pool(case)
    x = _t(np.random.default_rng(20 + case).standard_normal(
        (len(pos), 1, 64)).astype(np.float32))
    pool = PagedLatent(_t(c_kv), _t(k_rope))
    before = (gather_pages(pool.c_kv, tbl).clone(),
              gather_pages(pool.k_rope, tbl).clone())
    got, _ = MLA.mla_decode_paged(p, x, spec, pool, tbl, torch.tensor(pos))
    after = gather_pages(pool.c_kv, tbl)
    for b, pb in enumerate(pos):
        if pb < 0:
            continue
        contig = MLA.MLACache(before[0].clone(), before[1].clone())
        want, contig = MLA.mla_decode(p, x, spec, contig, pb)
        assert torch.equal(got[b], want[b]), f"row {b} at {pb}"
        assert torch.equal(after[b, pb], contig.c_kv[b, pb])
    written = (pool.c_kv.numpy() != c_kv).any(axis=2)
    assert written.sum() == sum(pb >= 0 for pb in pos)


@pytest.mark.parametrize("case", range(len(_PAGED)))
def test_latent_pool_primitives_match_reference(case):
    table, pos = _PAGED[case]
    c_kv, _ = _pool(30 + case)
    tbl = torch.tensor(table, dtype=torch.int32)
    want = np.asarray(JKV.gather_pages(jnp.asarray(c_kv),
                                       jnp.asarray(table, jnp.int32)))
    np.testing.assert_array_equal(gather_pages(_t(c_kv), tbl).numpy(), want)
    new = np.random.default_rng(40 + case).standard_normal(
        (len(pos), 32)).astype(np.float32)
    active = np.asarray(pos) >= 0
    want = np.asarray(JKV.append_token(
        jnp.asarray(c_kv), jnp.asarray(table, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(new),
        jnp.asarray(active)))
    mine = _t(c_kv)
    append_token(mine, tbl, torch.tensor(pos), _t(new),
                 torch.from_numpy(active))
    np.testing.assert_array_equal(mine.numpy(), want)
    vals = np.random.default_rng(50 + case).standard_normal(
        (2 * 4, 32)).astype(np.float32)
    want = np.asarray(JKV.seed_pages(jnp.asarray(c_kv),
                                     jnp.asarray([3, 1], jnp.int32),
                                     jnp.asarray(vals)))
    mine = _t(c_kv)
    seed_pages(mine, torch.tensor([3, 1]), _t(vals))
    np.testing.assert_array_equal(mine.numpy(), want)


def test_init_paged_latent_matches_reference():
    pool = init_paged_latent(6, 4, 32, 8, torch.float32)
    jpool = JKV.init_paged_latent(6, 4, 32, 8, jnp.float32)
    assert isinstance(pool, PagedLatent)
    assert pool.page_size == jpool.page_size == 4 and pool.n_pages == 6
    assert tuple(pool.c_kv.shape) == jpool.c_kv.shape
    assert tuple(pool.k_rope.shape) == jpool.k_rope.shape
    assert not pool.c_kv.any() and not pool.k_rope.any()


# ---------------------------------------------------------------------------
# the deepseek-v2 smoke model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jcfg = jax_smoke_config(ARCH)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jm, jp, build_model(cfg), params_from_jax(_np(jp))


def _model_order(jm, tree):
    """A reference tree of per-layer entries (parameters or caches) as
    the port's list, in model order: prefix, the scanned unit unstacked
    repeat by repeat, suffix."""
    out = list(tree["prefix"])
    for r in range(jm.repeats):
        out += [jax.tree.map(lambda a, r=r: a[r], u) for u in tree["scan"]]
    return out + list(tree["suffix"])


def test_layer_plan_and_params_carry_over(pair):
    jm, jp, model, state = pair
    cfg = model.cfg
    assert model.plan == [LayerSpec("attn", "mlp", cfg.d_ff_dense)] + \
        [LayerSpec("attn", "moe", cfg.d_ff_expert)] * (cfg.n_layers - 1)
    # the reference's segments (here the unit (dense, moe) once and a
    # moe suffix) unstack into the port's layer list in model order
    assert len(jm.prefix) + jm.repeats * len(jm.unit) + len(jm.suffix) \
        == cfg.n_layers == len(state["layers"])
    for mine, ref in zip(state["layers"], _model_order(jm, jp)):
        assert sorted(mine) == sorted(ref)
        for a, b in zip(tree_leaves(mine), tree_leaves(_np(ref))):
            np.testing.assert_array_equal(a.numpy(), b)
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert sum(t.numel() for t in tree_leaves(state)) == n_ref
    # the port's own init draws the same tree
    own = model.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [tuple(t.shape) for t in tree_leaves(state)]


def test_prefill_and_greedy_decode_match_reference(pair):
    jm, jp, model, state = pair
    cfg = model.cfg
    # the reference records its scanned unit once, the port every layer;
    # the smoke layout scans its unit once, so the events are the same
    assert jm.repeats == 1
    b, s, steps = 2, 12, 6
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (b, s))
    cache_len = s + steps
    with JaxRecorder() as jrec:
        jlogits, jcache = jm.prefill(
            jp, jnp.asarray(tokens, jnp.int32),
            jax_make_ctx(None, "prefill", cache_len=cache_len, remat=False))
    with DispatchRecorder() as rec:
        logits, cache = model.prefill(
            state, torch.from_numpy(tokens),
            make_ctx("prefill", cache_len=cache_len))
    _close(logits, jlogits, LOGIT_TOL)
    assert [_event(e) for e in rec.events] == \
        [_event(e) for e in jrec.events]
    assert {e.site for e in rec.events} >= {
        "mla.down_proj", "mla.up_proj_q", "mla.up_proj_kv", "mla.qk",
        "mlp.in_proj", "moe.wi", "moe.shared_in"}

    assert all(isinstance(c, MLA.MLACache) for c in cache)
    for c, jc in zip(cache, _model_order(jm, jcache), strict=True):
        _close(c.c_kv, jc.c_kv, LAYER_TOL)
        _close(c.k_rope, jc.k_rope, LAYER_TOL)
    empty = model.init_cache(b, make_ctx("decode", cache_len=cache_len))
    assert [tuple(c.c_kv.shape) for c in empty] == \
        [tuple(c.c_kv.shape) for c in cache]
    assert not any(c.c_kv.any() or c.k_rope.any() for c in empty)

    jdctx = jax_make_ctx(None, "decode", cache_len=cache_len)
    dctx = make_ctx("decode", cache_len=cache_len)
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        with JaxRecorder() as jrec:
            jlogits, jcache = jm.decode_step(jp, jtok, jcache,
                                             jnp.int32(s + i), jdctx)
        with DispatchRecorder() as rec:
            logits, cache = model.decode_step(state, tok, cache, s + i,
                                              dctx)
        _close(logits, jlogits, LOGIT_TOL)
        assert [_event(e) for e in rec.events] == \
            [_event(e) for e in jrec.events]
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for c, jc in zip(cache, _model_order(jm, jcache), strict=True):
        _close(c.c_kv, jc.c_kv, LAYER_TOL)
        _close(c.k_rope, jc.k_rope, LAYER_TOL)


def test_int8_flag_leaves_the_latent_cache_float(pair, monkeypatch):
    """The reference quantises GQA caches only: ADSALA_KV_INT8=1 changes
    nothing on MLA layers."""
    _, _, model, state = pair
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, model.cfg.vocab, (1, 6)))
    want, cache = model.prefill(state, tokens, make_ctx("prefill",
                                                        cache_len=8))
    monkeypatch.setenv("ADSALA_KV_INT8", "1")
    ctx = make_ctx("prefill", cache_len=8)
    assert ctx.kv_quantized
    got, qcache = model.prefill(state, tokens, ctx)
    assert torch.equal(got, want)
    assert all(q.c_kv.dtype == torch.float32 and torch.equal(q.c_kv, c.c_kv)
               for q, c in zip(qcache, cache))


@pytest.mark.parametrize("seq", [10, 24])
def test_loss_and_gradients_match_jax(pair, seq):
    jm, jp, model, _ = pair
    rng = np.random.default_rng(seq)
    tokens = rng.integers(0, model.cfg.vocab, (2, seq)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], 1)
    labels[rng.random((2, seq)) < 0.1] = -1
    batch = {"tokens": tokens, "labels": labels.astype(np.int32)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch),
                          jax_make_ctx(None, "train")))(jp)
    params = params_from_jax(_np(jp))
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss = model.loss(params, {k: torch.from_numpy(v)
                               for k, v in batch.items()},
                      make_ctx("train"))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
    want = tree_leaves(params_from_jax(_np(jgrads)))
    assert len(grads) == len(want)
    for g, jg in zip(grads, want):
        assert _normwise(g.numpy(), jg.numpy()) < GRAD_TOL
