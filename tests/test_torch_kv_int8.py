"""Port vs reference: the int8 KV cache on the CPU.

* ``_quantize_kv``'s payload and scales equal the reference's bit for
  bit (max-abs / 127 in fp32 floored at 1e-8, round half to even, clip
  to ±127, fp16 scales), on random rows, exact halves, all-zero and
  tiny rows; ``_dequantize_kv`` likewise;
* ``init_kv_cache`` / ``seed_kv_cache`` with ``quantized=True``, full
  and ring (the prompt longer than, equal to and shorter than the
  window), bit for bit;
* ``attention_decode`` on an int8 cache, full and ring, against the
  reference's, writing the quantised row and its scales in place;
* the ports of tests/test_sharding_serving.py's int8 tests (decode
  within 3 % relative logit error of the fp cache; fewer cache bytes);
* int8 decode of the stablelm-1.6b and mixtral-8x22b smoke models
  (mixtral past its window, on the ring) against the reference's int8
  decode: logits within 1e-4, the same tokens;
* ``make_ctx`` sets ``kv_quantized`` from ``ADSALA_KV_INT8=1`` for
  prefill and decode, never for training.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models.params import init_params as jax_init_params
from repro.train.step import make_ctx as jax_make_ctx
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as L
from repro_torch.models.transformer import Ctx
from repro_torch.train.step import make_ctx

pytestmark = pytest.mark.timeout(300)

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

LAYER_TOL = 1e-5
LOGIT_TOL = 1e-4
#: the reference's int8 quality gate (tests/test_sharding_serving.py)
INT8_REL_TOL = 0.03


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _rows(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    if kind == "halves":
        # every element an exact half of its row's step: round to even
        x = (np.arange(-8, 8, dtype=np.float32) + 0.5)[None, None, None]
        x = np.broadcast_to(x, (2, 5, 3, 16)).copy()
        x[..., 0] = 127.0                     # scale exactly 1
    elif kind == "zeros":
        x[:, 1] = 0.0                         # scale floored at 1e-8
        x[:, 2, 0] = 1e-12
    elif kind == "wide":
        x *= np.float32(1e4)
    return x


@pytest.mark.parametrize("kind", ["random", "halves", "zeros", "wide"])
def test_quantize_kv_is_the_reference_bitwise(kind):
    x = _rows(kind)
    q, s = L._quantize_kv(_t(x))
    jq, js = JL._quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float16
    _same(q.numpy(), jq)
    _same(s.numpy(), js)
    assert int(q.abs().max()) <= 127
    _same(L._dequantize_kv(q, s, torch.float32).numpy(),
          JL._dequantize_kv(jq, js, jnp.float32))
    if kind == "halves":
        # 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 3.5 -> 4 (half to even)
        np.testing.assert_array_equal(q[0, 0, 0, 8:12].numpy(),
                                      [0, 2, 2, 4])


def test_init_quantized_cache():
    c = L.init_kv_cache(2, 8, 3, 16, torch.float32, quantized=True)
    jc = JL.init_kv_cache(2, 8, 3, 16, jnp.float32, quantized=True)
    assert c.quantized and jc.quantized
    for a, b in ((c.k, jc.k), (c.v, jc.v), (c.k_scale, jc.k_scale),
                 (c.v_scale, jc.v_scale)):
        _same(a.numpy(), b)
    assert not L.init_kv_cache(2, 8, 3, 16, torch.float32).quantized


@pytest.mark.parametrize("windowed,sq", [(False, 5), (True, 11), (True, 8),
                                         (True, 5)])
def test_seed_quantized_cache_is_the_reference_bitwise(windowed, sq):
    rng = np.random.default_rng(1)
    k = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    c = L.seed_kv_cache(_t(k), _t(v), 8, windowed=windowed, quantized=True)
    jc = JL.seed_kv_cache(jnp.asarray(k), jnp.asarray(v), 8,
                          windowed=windowed, quantized=True)
    assert c.quantized and c.windowed == windowed
    for a, b in ((c.k, jc.k), (c.v, jc.v), (c.k_scale, jc.k_scale),
                 (c.v_scale, jc.v_scale)):
        _same(a.numpy(), b)
    if windowed and sq >= 8:
        # position p of the prompt sits in slot p % cap, its scale too
        for pos in range(sq - 8, sq):
            q, s = L._quantize_kv(_t(k[:, pos:pos + 1]))
            _same(c.k[:, pos % 8].numpy(), q[:, 0].numpy())
            _same(c.k_scale[:, pos % 8].numpy(), s[:, 0].numpy())


@pytest.mark.parametrize("window,sq", [(None, 6), (8, 11), (8, 3)])
def test_quantized_decode_matches_reference(window, sq):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              rope_fraction=0.5, window=window)
    jspec, spec = JL.AttnSpec(**kw), L.AttnSpec(**kw)
    jp = jax.tree.map(np.asarray, jax_init_params(
        JL.attention_defs(jspec), jax.random.PRNGKey(2)))
    p = {n: _t(a) for n, a in jp.items()}
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    cap = 8 if window else sq + 10
    windowed = window is not None
    cache = L.seed_kv_cache(_t(k), _t(v), cap, windowed=windowed,
                            quantized=True)
    jcache = JL.seed_kv_cache(jnp.asarray(k), jnp.asarray(v), cap,
                              windowed=windowed, quantized=True)
    for pos in range(sq, sq + 10):                 # a ring wraps
        x = rng.standard_normal((2, 1, 64)).astype(np.float32)
        before = cache.k.clone()
        out, new = L.attention_decode(p, _t(x), spec, cache, pos)
        jout, jcache = JL.attention_decode(jp, jnp.asarray(x), jspec,
                                           jcache, jnp.int32(pos))
        assert new is cache and cache.k.dtype == torch.int8
        _close(out, jout, LAYER_TOL)
        # only slot pos % cap (ring) or pos changed, in place
        slot = pos % cap if windowed else pos
        moved = (cache.k != before).any(dim=(0, 2, 3)).nonzero().flatten()
        assert set(moved.tolist()) <= {slot}
        # the new row comes from projections within 1e-6 of the
        # reference's, which may round one int8 step (and one fp16 ulp
        # of the scale) apart
        for mine, ref in ((cache.k, jcache.k), (cache.v, jcache.v)):
            assert np.abs(mine.numpy().astype(int)
                          - np.asarray(ref).astype(int)).max() <= 1
        for mine, ref in ((cache.k_scale, jcache.k_scale),
                          (cache.v_scale, jcache.v_scale)):
            _close(mine.float(), np.asarray(ref, np.float32), 1e-3)


def test_int8_kv_cache_decode_accuracy():
    """int8 KV decode within 3 % relative logit error of fp (the
    reference's quality gate, on the port)."""
    cfg = get_smoke_config("stablelm-1.6b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    s = 24
    tokens = torch.randint(0, cfg.vocab, (2, s + 1),
                           generator=torch.Generator().manual_seed(0))
    ctx = Ctx(mode="prefill", cache_len=s + 8, remat=False)
    full_logits, _ = model.prefill(params, tokens, ctx)
    qctx = Ctx(mode="prefill", cache_len=s + 8, remat=False,
               kv_quantized=True)
    _, qcache = model.prefill(params, tokens[:, :s], qctx)
    assert all(c.quantized for c in qcache)
    dctx = Ctx(mode="decode", cache_len=s + 8, kv_quantized=True)
    ql, _ = model.decode_step(params, tokens[:, s:s + 1], qcache, s, dctx)
    rel = float((full_logits - ql).abs().max()) \
        / float(full_logits.abs().max())
    assert rel < INT8_REL_TOL


def test_int8_kv_cache_halves_bytes():
    fp = L.init_kv_cache(2, 64, 4, 32, torch.bfloat16)
    q = L.init_kv_cache(2, 64, 4, 32, torch.bfloat16, quantized=True)

    def nbytes(c):
        return sum(t.numel() * t.element_size()
                   for t in (c.k, c.v, c.k_scale, c.v_scale)
                   if t is not None)

    assert nbytes(q) < 0.6 * nbytes(fp)
    # fp32 at head dim 64: 256 bytes a head against 64 + 2
    fp32 = L.init_kv_cache(1, 1, 1, 64, torch.float32)
    q64 = L.init_kv_cache(1, 1, 1, 64, torch.float32, quantized=True)
    assert (nbytes(fp32), nbytes(q64)) == (2 * 256, 2 * 66)


def test_make_ctx_reads_adsala_kv_int8(monkeypatch):
    for mode in ("prefill", "decode", "train"):
        assert not make_ctx(mode).kv_quantized
    monkeypatch.setenv("ADSALA_KV_INT8", "1")
    for mode in ("prefill", "decode", "train"):
        want = jax_make_ctx(None, mode).kv_quantized
        assert make_ctx(mode).kv_quantized == want == (mode != "train")
    monkeypatch.setenv("ADSALA_KV_INT8", "0")
    assert not make_ctx("decode").kv_quantized


@pytest.mark.parametrize("arch,s,steps", [("stablelm-1.6b", 12, 6),
                                          ("mixtral-8x22b", 40, 8)])
def test_int8_decode_matches_the_reference(arch, s, steps, monkeypatch):
    """The whole smoke model on int8 caches (mixtral's ring past its
    window): prefill, then greedy decode, against the reference's."""
    monkeypatch.setenv("ADSALA_KV_INT8", "1")
    jcfg = jax_smoke_config(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model = build_model(cfg)
    state = params_from_jax(jax.tree.map(np.asarray, jp))
    b = 2
    if cfg.window:
        assert s > cfg.window                      # the ring wraps
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (b, s))
    cache_len = s + steps
    jlogits, jcache = jm.prefill(
        jp, jnp.asarray(tokens, jnp.int32),
        jax_make_ctx(None, "prefill", cache_len=cache_len, remat=False))
    logits, cache = model.prefill(state, torch.from_numpy(tokens),
                                  make_ctx("prefill", cache_len=cache_len))
    _close(logits, jlogits, LOGIT_TOL)
    assert all(c.quantized and c.k.dtype == torch.int8 for c in cache)
    assert jcache["scan"][0].quantized
    jdctx = jax_make_ctx(None, "decode", cache_len=cache_len)
    dctx = make_ctx("decode", cache_len=cache_len)
    assert dctx.kv_quantized
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(steps):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlogits, jcache = jm.decode_step(jp, jtok, jcache,
                                         jnp.int32(s + i), jdctx)
        logits, cache = model.decode_step(state, tok, cache, s + i, dctx)
        _close(logits, jlogits, LOGIT_TOL)
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None]
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for i, c in enumerate(cache):
        jk = np.asarray(jcache["scan"][0].k[i]).astype(int)
        assert np.abs(c.k.numpy().astype(int) - jk).max() <= 1
        _close(c.k_scale.float(),
               np.asarray(jcache["scan"][0].k_scale[i], np.float32), 1e-3)
    # a fresh int8 cache has the prefilled one's layout
    empty = model.init_cache(b, dctx)
    assert [(c.k.shape, c.k_scale.shape, c.windowed) for c in empty] == \
        [(c.k.shape, c.k_scale.shape, c.windowed) for c in cache]
