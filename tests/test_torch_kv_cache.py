"""Port vs reference: the paged KV cache on the CPU.

* the page allocator's contract (the cases of
  tests/test_kv_cache_property.py, run on the port's allocator), and
  the two allocators handing out the same pages on the same trajectory;
* ``gather_pages`` / ``append_token`` / ``seed_pages`` give exactly the
  reference's values on the same numpy inputs, holes and inactive
  slots included — and ``append_token`` never writes an inactive slot's
  row, not even into page 0 that holes clamp to;
* ``attention_decode_paged`` against the reference's on the same
  weights and pages (1e-5), and bitwise against the port's contiguous
  ``attention_decode`` on the same rows;
* the paged cache refuses what the reference refuses.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models import layers as JL
from repro.serve import kv_cache as JKV
from repro_torch.models import layers as L
from repro_torch.serve.kv_cache import (
    HOLE,
    PageAllocator,
    PagedKV,
    append_token,
    gather_pages,
    init_paged_kv,
    pages_for,
    seed_pages,
)

pytestmark = pytest.mark.timeout(300)

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

LAYER_TOL = 1e-5


def test_pages_for_ceil():
    assert pages_for(1, 4) == 1
    assert pages_for(4, 4) == 1
    assert pages_for(5, 4) == 2
    assert pages_for(0, 4) == 0
    with pytest.raises(ValueError):
        pages_for(-1, 4)


# ---------------------------------------------------------------------------
# the allocator (carried over; the reference's property cases)
# ---------------------------------------------------------------------------

@settings(max_examples=25, deadline=None)
@given(n_pages=st.integers(1, 24), page_size=st.integers(1, 8),
       seed=st.integers(0, 10_000), n_ops=st.integers(1, 120))
def test_trajectory_invariants(n_pages, page_size, seed, n_ops):
    rng = np.random.default_rng(seed)
    alloc = PageAllocator(n_pages, page_size)
    next_seq = 0
    held: dict[int, int] = {}          # seq -> pages it must hold
    for _ in range(n_ops):
        op = rng.choice(["admit", "grow", "retire"])
        if op == "admit":
            want = int(rng.integers(1, 3 * page_size + 1))
            got = alloc.admit(next_seq, want)
            need = pages_for(want, page_size)
            if need > n_pages - sum(held.values()):
                assert got is None      # exhaustion defers, no change
            else:
                assert got is not None and len(got) == need
                assert len(set(got)) == need
                held[next_seq] = need
                next_seq += 1
        elif op == "grow" and held:
            seq = int(rng.choice(list(held)))
            total = int(rng.integers(1, 5 * page_size + 1))
            before = alloc.pages_of(seq)
            got = alloc.grow(seq, total)
            need = pages_for(total, page_size) - len(before)
            if need <= 0:
                assert got == []        # already covered
            elif need > n_pages - sum(held.values()):
                assert got is None
                assert alloc.pages_of(seq) == before   # untouched
            else:
                assert len(got) == need
                assert alloc.pages_of(seq) == before + got
                held[seq] += need
        elif op == "retire" and held:
            seq = int(rng.choice(list(held)))
            assert alloc.retire(seq) == held.pop(seq)
        alloc.check()
        assert alloc.free_pages + alloc.live_pages == n_pages
        assert alloc.live_pages == sum(held.values())
    all_pages = [p for s in alloc.live_seqs for p in alloc.pages_of(s)]
    assert len(set(all_pages)) == len(all_pages)


@settings(max_examples=15, deadline=None)
@given(page_size=st.integers(1, 8), n_seqs=st.integers(1, 6))
def test_retire_frees_exactly_and_pages_recycle(page_size, n_seqs):
    alloc = PageAllocator(n_seqs * 3, page_size)
    admitted = {}
    for s in range(n_seqs):
        admitted[s] = alloc.admit(s, (s % 3 + 1) * page_size)
        assert admitted[s] is not None
    for s in range(n_seqs):
        assert alloc.retire(s) == len(admitted[s])
        alloc.check()
    assert alloc.free_pages == n_seqs * 3
    again = alloc.admit(99, n_seqs * 3 * page_size)
    assert again is not None and sorted(again) == list(range(n_seqs * 3))


def test_exhaustion_defers_without_corruption():
    alloc = PageAllocator(4, 2)
    a = alloc.admit(0, 6)               # 3 pages
    assert len(a) == 3
    assert alloc.admit(1, 4) is None    # needs 2, only 1 free
    alloc.check()
    assert alloc.free_pages == 1
    assert alloc.pages_of(0) == a       # survivor untouched
    b = alloc.admit(1, 2)               # 1 page fits
    assert len(b) == 1 and not set(b) & set(a)
    assert alloc.grow(0, 8) is None     # 4th page: pool dry
    assert alloc.pages_of(0) == a
    alloc.retire(1)
    assert alloc.grow(0, 8) == b        # freed page recycles (LIFO)


def test_allocator_rejects_bad_usage():
    alloc = PageAllocator(4, 2)
    with pytest.raises(ValueError):
        alloc.admit(0, 0)               # empty sequence
    alloc.admit(0, 2)
    with pytest.raises(ValueError):
        alloc.admit(0, 2)               # duplicate seq id
    with pytest.raises(KeyError):
        alloc.retire(7)                 # never admitted
    with pytest.raises(ValueError):
        PageAllocator(0, 2)
    with pytest.raises(ValueError):
        PageAllocator(4, 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_hands_out_the_reference_pages(seed):
    """The same admit/grow/retire trajectory through both allocators
    returns the same page ids at every step."""
    rng = np.random.default_rng(seed)
    mine, ref = PageAllocator(16, 4), JKV.PageAllocator(16, 4)
    live: list[int] = []
    for seq in range(60):
        op = rng.choice(["admit", "grow", "retire"])
        if op == "admit":
            n = int(rng.integers(1, 13))
            assert mine.admit(seq, n) == ref.admit(seq, n)
            if seq in ref.live_seqs:
                live.append(seq)
        elif op == "grow" and live:
            s, n = int(rng.choice(live)), int(rng.integers(1, 25))
            assert mine.grow(s, n) == ref.grow(s, n)
        elif op == "retire" and live:
            s = live.pop(int(rng.integers(len(live))))
            assert mine.retire(s) == ref.retire(s)
        assert mine.free_pages == ref.free_pages
    for s in live:
        assert mine.pages_of(s) == ref.pages_of(s)


# ---------------------------------------------------------------------------
# device primitives against the reference
# ---------------------------------------------------------------------------

def _pool(seed, n_pages=6, page=4, h=2, d=8):
    return np.random.default_rng(seed).standard_normal(
        (n_pages, page, h, d)).astype(np.float32)


#: page tables with holes, inactive slots (pos -1), a hole under an
#: active position, and positions on page boundaries
_TABLES = [
    ([[2, 0, HOLE], [5, 1, 3], [HOLE, HOLE, HOLE]], [5, 11, -1],
     [True, True, False]),
    ([[4, HOLE, HOLE], [0, 2, HOLE]], [3, 4], [True, True]),
    ([[1, 3, HOLE], [HOLE, HOLE, HOLE]], [4, 0], [True, False]),
    ([[HOLE, HOLE, HOLE], [HOLE, HOLE, HOLE]], [-1, -1], [False, False]),
    ([[0, 5, HOLE], [2, HOLE, HOLE]], [7, 5], [True, True]),
]


@pytest.mark.parametrize("case", range(len(_TABLES)))
def test_gather_pages_matches_reference(case):
    table, _, _ = _TABLES[case]
    pool = _pool(case)
    want = np.asarray(JKV.gather_pages(jnp.asarray(pool),
                                       jnp.asarray(table, jnp.int32)))
    got = gather_pages(torch.from_numpy(pool),
                       torch.tensor(table, dtype=torch.int32))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", range(len(_TABLES)))
def test_append_token_matches_reference(case):
    table, pos, active = _TABLES[case]
    pool = _pool(10 + case)
    new = np.random.default_rng(20 + case).standard_normal(
        (len(pos),) + pool.shape[2:]).astype(np.float32)
    want = np.asarray(JKV.append_token(
        jnp.asarray(pool), jnp.asarray(table, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(new),
        jnp.asarray(active)))
    mine = torch.from_numpy(pool.copy())
    out = append_token(mine, torch.tensor(table, dtype=torch.int32),
                       torch.tensor(pos), torch.from_numpy(new),
                       torch.tensor(active))
    assert out is mine                   # written in place
    np.testing.assert_array_equal(mine.numpy(), want)


def test_append_token_never_writes_an_inactive_row_into_page_zero():
    """An inactive slot's clamped target is page 0, slot 0; page 0 here
    belongs to an active sequence writing elsewhere in it, and to one
    writing exactly there: neither may see the inactive row."""
    pool = torch.zeros((3, 2, 1, 1))
    table = torch.tensor([[HOLE, HOLE], [1, 0], [0, HOLE]],
                         dtype=torch.int32)
    pos = torch.tensor([-1, 3, 0])
    new = torch.tensor([[[9.0]], [[7.0]], [[5.0]]])
    active = pos >= 0
    append_token(pool, table, pos, new, active)
    assert pool[0, 1, 0, 0] == 7.0       # seq 1's 4th token (page 0)
    assert pool[0, 0, 0, 0] == 5.0       # seq 2's 1st token (page 0)
    assert (pool == 9.0).sum() == 0


@pytest.mark.parametrize("n", [1, 2, 3])
def test_seed_pages_matches_reference(n):
    pool = _pool(30 + n)
    ids = [4, 1, 3][:n]
    vals = np.random.default_rng(40 + n).standard_normal(
        (n * pool.shape[1],) + pool.shape[2:]).astype(np.float32)
    want = np.asarray(JKV.seed_pages(jnp.asarray(pool),
                                     jnp.asarray(ids, jnp.int32),
                                     jnp.asarray(vals)))
    mine = torch.from_numpy(pool.copy())
    assert seed_pages(mine, torch.tensor(ids), torch.from_numpy(vals)) \
        is mine
    np.testing.assert_array_equal(mine.numpy(), want)


def test_init_paged_kv_shape_and_page_size():
    kv = init_paged_kv(5, 4, 2, 8, torch.float32)
    assert isinstance(kv, PagedKV) and kv.page_size == 4
    assert tuple(kv.k.shape) == (5, 4, 2, 8) and not kv.v.any()


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

_SPEC = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
             rope_fraction=0.5)


def _attn_inputs(seed, b=3, n_pages=10, page=4, tpages=3):
    rng = np.random.default_rng(seed)
    s = L.AttnSpec(**_SPEC)
    p = {name: (rng.standard_normal(shape) * 0.2).astype(np.float32)
         for name, shape in (("wq", (32, 32)), ("wk", (32, 16)),
                             ("wv", (32, 16)), ("wo", (32, 32)))}
    x = rng.standard_normal((b, 1, 32)).astype(np.float32)
    k = rng.standard_normal((n_pages, page, 2, 8)).astype(np.float32)
    v = rng.standard_normal((n_pages, page, 2, 8)).astype(np.float32)
    perm = rng.permutation(n_pages)[: b * tpages].reshape(b, tpages)
    return s, p, x, k, v, perm.astype(np.int32)


@pytest.mark.parametrize("pos", [[5, 11, -1], [0, 7, 3], [-1, -1, 4]])
def test_paged_decode_matches_reference(pos):
    s, p, x, k, v, table = _attn_inputs(1)
    table[2, 2] = HOLE                    # a hole past the prefix
    js = JL.AttnSpec(**_SPEC)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    jout, jpool = JL.attention_decode_paged(
        jp, jnp.asarray(x), js, JKV.PagedKV(jnp.asarray(k), jnp.asarray(v)),
        jnp.asarray(table), jnp.asarray(pos, jnp.int32))
    pool = PagedKV(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    out, pool2 = L.attention_decode_paged(
        {n: torch.from_numpy(a) for n, a in p.items()},
        torch.from_numpy(x), s, pool, torch.from_numpy(table),
        torch.tensor(pos))
    assert pool2 is pool
    act = np.asarray(pos) >= 0
    np.testing.assert_allclose(out.numpy()[act], np.asarray(jout)[act],
                               atol=LAYER_TOL, rtol=0)
    # the new rows are projections (1e-5); every other row is untouched
    for mine, ref, before in ((pool.k, jpool.k, k), (pool.v, jpool.v, v)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                   atol=LAYER_TOL, rtol=0)
        moved = (mine.numpy() != before).any(axis=(2, 3))
        np.testing.assert_array_equal(
            moved, (np.asarray(ref) != before).any(axis=(2, 3)))


def test_paged_decode_is_contiguous_decode_bitwise():
    """Sequences at one position, their rows scattered over pages: the
    paged decode gives the contiguous decode's output bit for bit and
    writes the same new rows."""
    s, p, x, k, v, table = _attn_inputs(2)
    b, tpages = table.shape
    page = k.shape[1]
    pos = 6
    pt = {n: torch.from_numpy(a) for n, a in p.items()}
    pool = PagedKV(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    contig = L.KVCache(gather_pages(pool.k, torch.from_numpy(table)).clone(),
                       gather_pages(pool.v, torch.from_numpy(table)).clone())
    want, contig = L.attention_decode(pt, torch.from_numpy(x), s, contig,
                                      pos)
    got, pool = L.attention_decode_paged(
        pt, torch.from_numpy(x), s, pool, torch.from_numpy(table),
        torch.full((b,), pos))
    assert torch.equal(got, want)
    assert torch.equal(gather_pages(pool.k, torch.from_numpy(table)),
                       contig.k)
    assert tpages * page == contig.k.shape[1]


def test_per_sequence_rope_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    pos = np.array([[0], [5], [17]])
    jsin, jcos = JL.rope_angles(jnp.asarray(pos), 4)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jsin, jcos, 0.5))
    sin, cos = L.rope_angles(torch.from_numpy(pos), 4)
    got = L.apply_rope(torch.from_numpy(x), sin, cos, 0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_paged_decode_refuses_windowed_layers():
    s, p, x, k, v, table = _attn_inputs(4)
    s = dataclasses.replace(s, window=8)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        L.attention_decode_paged(
            {n: torch.from_numpy(a) for n, a in p.items()},
            torch.from_numpy(x), s,
            PagedKV(torch.from_numpy(k), torch.from_numpy(v)),
            torch.from_numpy(table), torch.tensor([1, 2, 3]))


def test_paged_decode_keeps_the_cache_update_tag():
    from repro_torch.kernels.recorder import DispatchRecorder

    s, p, x, k, v, table = _attn_inputs(5)
    with DispatchRecorder() as rec:
        L.attention_decode_paged(
            {n: torch.from_numpy(a) for n, a in p.items()},
            torch.from_numpy(x), s,
            PagedKV(torch.from_numpy(k), torch.from_numpy(v)),
            torch.from_numpy(table), torch.tensor([1, 2, -1]))
    upd = [e for e in rec.events if e.site == "attn.cache_update"]
    assert [(e.routine, e.m, e.k, e.n) for e in upd] == [
        ("trsm", table.shape[1] * k.shape[1], 8, 3 * 4)]
