"""Paged KV cache: host-side page allocator + device-side page pools.

The fixed-batch serving cache allocates ``B x cache_len`` token slots up
front, so cache memory caps the batch at
``B_max = mem / (cache_len * bytes_per_token)`` even when most requests
are far shorter than ``cache_len``.  Paging (vLLM, arXiv 2309.06180)
breaks the cache into fixed-size **pages** of ``page_size`` token slots
handed out from a free list; each sequence holds exactly the pages its
actual length needs, and a **page table** maps its logical token
positions to physical pages.  The ceiling becomes total *tokens in
flight*, not batch size — the property the continuous-batching
scheduler (:mod:`repro_torch.serve.scheduler`) is built on.

Split of responsibilities, as in :mod:`repro.serve.kv_cache`:

* :class:`PageAllocator` — pure-Python free-list bookkeeping (admit /
  grow / retire), carried over unchanged.
* :class:`PagedKV` / :class:`PagedLatent` — one attention layer's page
  pool: ``(n_pages, page_size, ...)`` tensors, the paged analogue of
  :class:`~repro_torch.models.layers.KVCache` and
  :class:`~repro_torch.models.mla.MLACache`.
* :func:`gather_pages` / :func:`append_token` / :func:`seed_pages` —
  the fixed-shape device primitives the paged decode read paths
  (``attention_decode_paged``, ``mla_decode_paged``) are built from, on
  pools of any rank, as tensor gathers and scatters with no loop over
  slots.  Holes in the page table are clamped on gather (the garbage
  rows land beyond every sequence's valid prefix, where the attention
  mask kills them); inactive slots and holes write nothing on scatter,
  never corrupting a live page.

Unlike the reference's functional updates, :func:`append_token` and
:func:`seed_pages` write the pool in place and return it, as the port's
``attention_decode`` and ``mla_decode`` write their caches.

On a mesh a pool is cut over its pages (the data axes) and over a
contracted dim or its KV heads ('model'), as ``paged_spec`` lays it out:
:class:`PagedSplit` is one layer's pool as the paged decode then reads
it, split-KV over pages.  :func:`plan_step` plans the step over the
whole batch's rows on the rank's own pages: a slot on another rank's
page writes nothing here, and the read masks it out.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = [
    "HOLE", "PageAllocator", "PagedKV", "PagedLatent", "init_paged_kv",
    "init_paged_latent",
    "PagePlan", "PagedSplit", "plan_pages", "plan_step", "gather_pages",
    "append_token", "seed_pages", "pages_for",
]

#: page-table entry marking an unallocated slot
HOLE = -1


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` token slots (ceil division)."""
    if n_tokens < 0:
        raise ValueError(f"n_tokens={n_tokens} < 0")
    return -(-n_tokens // page_size)


# ---------------------------------------------------------------------------
# Host-side allocator
# ---------------------------------------------------------------------------

class PageAllocator:
    """Free-list page allocator with per-sequence page accounting.

    All-or-nothing: :meth:`admit` and :meth:`grow` either return the
    full list of newly allocated page ids or ``None`` with the
    allocator state untouched — a caller that cannot get its pages
    defers (re-queues the request), it never observes a half-allocated
    sequence.  :meth:`retire` frees exactly the sequence's pages.

    The invariants the property suite pins:

    * a page is never handed out twice while live;
    * ``free_pages + live_pages == n_pages`` after every operation;
    * retiring a sequence frees exactly the page count it held;
    * exhaustion returns ``None`` and changes nothing.
    """

    def __init__(self, n_pages: int, page_size: int) -> None:
        if n_pages <= 0:
            raise ValueError(f"n_pages={n_pages} <= 0")
        if page_size <= 0:
            raise ValueError(f"page_size={page_size} <= 0")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO free stack: recently retired pages are re-used first,
        # keeping the hot pool compact
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self._live: dict[int, list[int]] = {}

    # -- views ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return sum(len(p) for p in self._live.values())

    @property
    def live_seqs(self) -> tuple[int, ...]:
        return tuple(self._live)

    def pages_of(self, seq_id: int) -> list[int]:
        """The sequence's pages in logical order (copy)."""
        return list(self._live[seq_id])

    def can_admit(self, n_tokens: int) -> bool:
        return pages_for(n_tokens, self.page_size) <= len(self._free)

    # -- mutations ------------------------------------------------------
    def admit(self, seq_id: int, n_tokens: int) -> list[int] | None:
        """Allocate pages for a new sequence of ``n_tokens`` slots.

        Returns the page ids (logical order) or ``None`` when the pool
        cannot cover the request — admission deferred, nothing changed.
        """
        if seq_id in self._live:
            raise ValueError(f"seq {seq_id} already live")
        need = pages_for(n_tokens, self.page_size)
        if need == 0:
            raise ValueError(f"admit of empty sequence {seq_id}")
        if need > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(need)]
        self._live[seq_id] = pages
        return pages

    def grow(self, seq_id: int, n_tokens_total: int) -> list[int] | None:
        """Extend a live sequence to ``n_tokens_total`` slots.

        Returns the *newly* allocated page ids ([] when already
        covered) or ``None`` when the pool is exhausted — the sequence
        keeps its current pages, nothing is partially allocated.
        """
        held = self._live[seq_id]
        need = pages_for(n_tokens_total, self.page_size) - len(held)
        if need <= 0:
            return []
        if need > len(self._free):
            return None
        fresh = [self._free.pop() for _ in range(need)]
        held.extend(fresh)
        return fresh

    def retire(self, seq_id: int) -> int:
        """Free a live sequence's pages; returns how many were freed."""
        pages = self._live.pop(seq_id)
        self._free.extend(pages)
        return len(pages)

    def check(self) -> None:
        """Raise AssertionError when any allocator invariant is broken."""
        live = [p for pages in self._live.values() for p in pages]
        assert len(set(live)) == len(live), "double-allocated live page"
        assert not set(live) & set(self._free), "live page on free list"
        assert len(live) + len(self._free) == self.n_pages, \
            "page conservation violated"
        assert all(0 <= p < self.n_pages for p in live + self._free)


# ---------------------------------------------------------------------------
# Device-side pools
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedKV:
    """One attention layer's page pool — the paged
    :class:`~repro_torch.models.layers.KVCache`.  ``k``/``v``:
    ``(n_pages, page_size, n_kv_heads, head_dim)``."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def n_pages(self) -> int:
        return self.k.shape[0]

    @property
    def page_size(self) -> int:
        return self.k.shape[-3]


@dataclasses.dataclass
class PagedLatent:
    """One MLA layer's page pool.  ``c_kv``:
    ``(n_pages, page_size, kv_lora_rank)``, ``k_rope``:
    ``(n_pages, page_size, qk_rope_dim)``."""

    c_kv: torch.Tensor
    k_rope: torch.Tensor

    @property
    def n_pages(self) -> int:
        return self.c_kv.shape[0]

    @property
    def page_size(self) -> int:
        return self.c_kv.shape[-2]


def init_paged_kv(n_pages: int, page_size: int, n_kv_heads: int,
                  head_dim: int, dtype: torch.dtype, *,
                  device: torch.device | str = "cpu") -> PagedKV:
    shape = (n_pages, page_size, n_kv_heads, head_dim)
    return PagedKV(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def init_paged_latent(n_pages: int, page_size: int, kv_lora_rank: int,
                      qk_rope_dim: int, dtype: torch.dtype, *,
                      device: torch.device | str = "cpu") -> PagedLatent:
    return PagedLatent(
        torch.zeros((n_pages, page_size, kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((n_pages, page_size, qk_rope_dim), dtype=dtype,
                    device=device))


# ---------------------------------------------------------------------------
# Fixed-shape device primitives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagePlan:
    """The index arithmetic of one decode step: every layer's K and V
    pools see the same page table and positions, so the paged decode
    computes it once a step (:func:`plan_pages`) instead of once a
    pool."""

    #: (B*T,) page ids to gather, holes clamped to page 0
    ids: torch.Tensor
    #: (B,) flat pool row each sequence's new token lands in
    dest: torch.Tensor
    #: (B,) row of ``new`` each write takes
    src: torch.Tensor
    #: () bool: some slot writes at all
    write: torch.Tensor
    #: on a rank's pages (``total`` given to :func:`plan_pages`): (B, T)
    #: bool, the page of each table entry is stored here; else None
    here: torch.Tensor | None = None
    #: on a rank's pages: the whole batch's (B, T) table and (B,)
    #: positions the plan is for (:func:`plan_step` gathers them)
    table: torch.Tensor | None = None
    pos: torch.Tensor | None = None


def plan_pages(table: torch.Tensor, pos: torch.Tensor,
               active: torch.Tensor, n_pages: int, page: int, *,
               lo: int = 0, total: int | None = None) -> PagePlan:
    """Plan one step's gathers and writes for a ``(B, T)`` page table
    and ``(B,)`` positions over pools of ``n_pages`` pages of ``page``
    token slots.

    Inactive slots and holes write nothing.  The reference drops them
    with an out-of-bounds scatter; here a dropped row is aimed at the
    first writing row's slot with that row's value (duplicate indices
    carrying equal values give the same result in any order), and when
    no row writes, every row rewrites its clamped slot with what it
    already holds — no host sync, and never a write to a page a live
    sequence owns.  Live sequences own disjoint pages, so the writing
    rows' slots never collide.

    With ``total`` the pools are a rank's pages ``[lo, lo + n_pages)``
    of ``total`` (a pool cut over its pages): the table's ids are
    global, a hole reads global page 0 (the reference's clamp) wherever
    that is stored, and a row whose page another rank stores (or that
    is past ``total``, which the reference's scatter drops) is dropped
    as well; ``here`` marks the entries this rank's pages serve."""
    cap = table.shape[1] * page
    idx = pos.clamp(0, cap - 1).long()
    page_ix = table.gather(1, (idx // page)[:, None])[:, 0].long()
    ok = active & (page_ix >= 0)
    here = None
    if total is None:
        dest = page_ix.clamp(0, n_pages - 1) * page + idx % page
        ids = table.clamp(0, n_pages - 1).reshape(-1).long()
    else:
        ok = ok & (page_ix >= lo) & (page_ix < lo + n_pages)
        dest = (page_ix - lo).clamp(0, n_pages - 1) * page + idx % page
        local = table.clamp(0, total - 1).long() - lo
        here = (local >= 0) & (local < n_pages)
        ids = local.clamp(0, n_pages - 1).reshape(-1)
    first = torch.argmax(ok.to(torch.int8))          # 0 when none is ok
    rows = torch.arange(table.shape[0], device=table.device)
    return PagePlan(
        ids=ids,
        dest=torch.where(ok, dest, dest[first]),
        src=torch.where(ok, rows, first),
        write=ok.any(), here=here,
        table=None if total is None else table,
        pos=None if total is None else pos)


@dataclasses.dataclass
class PagedSplit:
    """One attention layer's page pool on a mesh, as the paged decode
    reads it: split-KV over pages.

    ``pool`` (a :class:`PagedKV` or :class:`PagedLatent` of local
    tensors) holds this rank's pages ``[lo, lo + n_pages)`` of
    ``total``, cut over the mesh axes whose process groups are
    ``pages`` (mesh order; none where every rank holds every page).
    ``cuts`` names, for each field, the pool dim the 'model' axis
    (``tp``) cuts — a contracted dim (the head dim, MLA's latent and
    rope widths) or the KV heads — or None where the field is whole on
    every rank of a multi-rank 'model' axis (a one-rank axis counts as
    cutting the last dim, so its collectives run).  The step's slots
    are cut over the axes ``rows`` of ``mesh``.

    A decode step gathers every slot's rows (:meth:`gather`), writes the
    new row of each slot whose page the rank stores, attends every slot
    over the rank's pages, merges the partial softmaxes over ``pages``
    and keeps its rows (:meth:`keep`); no pool, and no slot's gathered
    view, is gathered over 'model'."""
    pool: Any
    lo: int
    total: int
    pages: tuple
    mesh: Any
    rows: tuple
    tp: Any
    cuts: dict

    @property
    def n_pages(self) -> int:
        return self.pool.n_pages

    @property
    def page_size(self) -> int:
        return self.pool.page_size

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch from this rank's rows ``t`` (dim 0)."""
        from repro_torch.dist.collectives import gather_rows
        return gather_rows(t, self.mesh, self.rows)

    def keep(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole batch ``t`` (dim 0)."""
        from repro_torch.dist.collectives import axis_size, row_index
        n = 1
        for a in self.rows:
            n *= axis_size(self.mesh, a)
        b = t.shape[0] // n
        i = row_index(self.mesh, self.rows)
        return t[i * b:(i + 1) * b]

    def _dim(self, name: str) -> int | None:
        """Field ``name``'s cut as a negative dim (it names the same dim
        of a row, a query or an output as of the pool), or None."""
        cut = self.cuts[name]
        return None if cut is None else \
            cut - getattr(self.pool, name).dim()

    def contracted(self, name: str) -> bool:
        """Does 'model' cut field ``name`` on its last (contracted) dim?"""
        return self._dim(name) == -1

    def piece(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's piece of a whole ``t`` along field ``name``'s cut
        (a new row, the query): its columns or its heads."""
        d = self._dim(name)
        if d is None:
            return t
        n = t.shape[d] // self.tp.size
        return t.narrow(d, self.tp.rank * n, n)

    def join(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The ranks' pieces of ``t`` along field ``name``'s cut, joined
        over 'model' (:meth:`piece`'s inverse)."""
        from repro_torch.dist.collectives import all_gather
        d = self._dim(name)
        return t if d is None else \
            all_gather(t, self.tp.group, dim=t.dim() + d)

    def scores(self, terms: list) -> torch.Tensor:
        """The sum of score terms ``(scores, field)``: a term over a field
        cut on its contracted dim is this rank's partial, summed over
        'model'; any other is whole already."""
        from repro_torch.dist.collectives import reduce_from
        part = [t for t, name in terms if self.contracted(name)]
        out = reduce_from(sum(part), self.tp.group) if part else None
        for t, name in terms:
            if not self.contracted(name):
                out = t if out is None else out + t
        return out


def plan_step(pool, table: torch.Tensor, pos: torch.Tensor) -> PagePlan:
    """:func:`plan_pages` for one decode step over every layer's pools,
    laid out like ``pool``: on one device the caller's table and
    positions; for a :class:`PagedSplit` the whole batch's (this rank's
    rows gathered over the axes that cut the slots, one collective) on
    the rank's pages."""
    if not isinstance(pool, PagedSplit):
        return plan_pages(table, pos, pos >= 0, pool.n_pages,
                          pool.page_size)
    both = pool.gather(torch.cat([table.long(), pos.long()[:, None]], 1))
    table, pos = both[:, :-1], both[:, -1]
    return plan_pages(table, pos, pos >= 0, pool.n_pages, pool.page_size,
                      lo=pool.lo, total=pool.total)


def gather_pages(pages: torch.Tensor, table: torch.Tensor,
                 plan: PagePlan | None = None) -> torch.Tensor:
    """Page-table gather: ``(P, page, ...)`` pool + ``(B, T)`` table ->
    a contiguous per-sequence ``(B, T*page, ...)`` view.

    Holes (:data:`HOLE`) clamp to page 0; whatever that page holds
    lands at token slots at/after the sequence's allocated prefix,
    where the downstream ``kv_ids <= pos`` attention mask zeroes it.
    ``plan`` (for this table) saves recomputing the clamped ids."""
    b, t = table.shape
    page = pages.shape[1]
    ids = plan.ids if plan is not None else \
        table.clamp(0, pages.shape[0] - 1).reshape(-1)
    gathered = pages.index_select(0, ids)
    return gathered.reshape((b, t * page) + tuple(pages.shape[2:]))


def append_token(pages: torch.Tensor, table: torch.Tensor,
                 pos: torch.Tensor, new: torch.Tensor,
                 active: torch.Tensor,
                 plan: PagePlan | None = None) -> torch.Tensor:
    """Write one token per sequence, in place: ``new[b]`` lands at
    physical slot ``(table[b, pos[b] // page], pos[b] % page)``.
    Inactive slots (and holes) write nothing (see :func:`plan_pages`,
    whose plan for these arguments ``plan`` may pass in).  Returns
    ``pages``."""
    n_pages, page = pages.shape[:2]
    if plan is None:
        plan = plan_pages(table, pos, active, n_pages, page)
    flat = pages.view((n_pages * page,) + tuple(pages.shape[2:]))
    vals = torch.where(plan.write,
                       new.index_select(0, plan.src).to(pages.dtype),
                       flat[plan.dest])
    flat.index_put_((plan.dest,), vals)
    return pages


def seed_pages(pages: torch.Tensor, page_ids: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """Bulk-write a prompt's cache rows into freshly allocated pages, in
    place.  ``values``: ``(n * page, ...)`` contiguous token rows (pad to
    a page multiple first), scattered as ``n`` whole pages at
    ``page_ids``.  Returns ``pages``."""
    n = page_ids.shape[0]
    page = pages.shape[1]
    vals = values.reshape((n, page) + tuple(pages.shape[2:]))
    pages.index_copy_(0, page_ids.to(pages.device).long(),
                      vals.to(pages.dtype))
    return pages
