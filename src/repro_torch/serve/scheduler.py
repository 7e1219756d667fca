"""Continuous-batching decode loop over the paged KV cache.

Fixed-batch serving admits one batch and steps it until the *slowest*
sequence finishes: every early-finishing slot idles, so goodput on
ragged-length traffic collapses toward the longest request.  The
scheduler here keeps a fixed number of decode **slots** and a shared
page pool (:mod:`repro_torch.serve.kv_cache`); per step it

1. admits queued requests into free slots — the prompt is prefilled at
   its exact length (one flash-kernel launch per layer on the card) and
   its cache rows are seeded into freshly allocated pages,
2. decodes one token for *every* active slot with a single paged
   ``decode_step`` of fixed shapes (slots x the page-table width),
3. retires finished sequences immediately — their pages re-enter the
   free list and the freed slot can admit the next request on the same
   step.

Admission reserves the worst case up front
(``pages_for(prompt + max_new - 1)``), so a running sequence can never
deadlock mid-decode waiting for pages; requests are admitted strictly
FIFO (a request that does not fit blocks the queue head — no
starvation of long prompts by short ones).

Dispatch observability, as in :mod:`repro.serve.scheduler`: prefill
records into the ``"prefill"`` recorder, decode into ``"decode"`` — the
per-traffic-class split the
:class:`~repro_torch.serve.reinstall.ReinstallManager` reads.  The
reference records at trace time: one prefill trace per distinct prompt
length, one trace of the decode step.  The port runs eagerly, so it
records the same calls by hand: the first prefill of each distinct
prompt length and the first decode step.  (Each records every layer of
the eager loop, where the reference's scanned stack records its unit
once.)
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.serve.kv_cache import (
    HOLE,
    PageAllocator,
    pages_for,
    seed_pages,
)

__all__ = ["Request", "FinishedSeq", "ContinuousBatchingScheduler"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One queued generation request (ragged prompt/output lengths)."""

    rid: int
    prompt: tuple[int, ...]
    max_new: int


@dataclasses.dataclass(frozen=True)
class FinishedSeq:
    """A retired sequence: the generated ids plus scheduling metadata."""

    rid: int
    prompt: tuple[int, ...]
    tokens: tuple[int, ...]
    admitted_step: int
    finished_step: int


def _seed_segment(pool: list, caches: list, page_ids: torch.Tensor) -> None:
    """Write a prefill's per-layer caches into the matching page pools.

    The two lists differ in type per layer (``KVCache`` vs ``PagedKV``,
    ``MLACache`` vs ``PagedLatent``) but align field for field — k with
    k, v with v, c_kv with c_kv, k_rope with k_rope; each cache holds
    one sequence of whole pages, (1, n * page, ...)."""
    if len(pool) != len(caches):
        raise ValueError(
            f"pool/prefill cache layer mismatch ({len(pool)} vs "
            f"{len(caches)}) — unsupported cache variant for paging")
    for pl, c in zip(pool, caches):
        for f in dataclasses.fields(pl):
            seed_pages(getattr(pl, f.name), page_ids, getattr(c, f.name)[0])


class ContinuousBatchingScheduler:
    """Admit/retire-per-step decode loop over a shared page pool.

    Parameters
    ----------
    model, cfg, params : the LM triple (``repro_torch.configs``).
    slots : decode batch width — the fixed shape of the decode step.
    n_pages, page_size : the shared pool (total token slots in flight
        = ``n_pages * page_size``, the real memory ceiling).
    max_seq_len : per-sequence cap (prompt + generated); sets the page
        table width, and with it the gathered attention span.
    tuner : optional ADSALA tuner / ReinstallManager facade, threaded
        into every routine-aware call site of prefill and decode.
    recorders : ``{"prefill": DispatchRecorder, "decode": ...}`` — the
        per-traffic-class recorders; created when omitted.
    eos_id : optional early-stop token id (None = run to ``max_new``).
    keep_logits : keep every request's logits, one (vocab,) CPU row per
        generated token in ``self.logits[rid]`` (for parity checks).

    Thread safety: ``submit`` may be called from any thread while one
    consumer thread runs ``step``/``run_until_drained``.

    ``decode_log`` holds one ``(seconds, active slots)`` pair per decode
    step: host time from the step's launch to its tokens on the host.
    """

    def __init__(self, model, cfg, params, *, slots: int, n_pages: int,
                 page_size: int, max_seq_len: int, tuner=None,
                 recorders: dict | None = None,
                 dtype: torch.dtype = torch.float32,
                 eos_id: int | None = None,
                 keep_logits: bool = False) -> None:
        if not hasattr(model, "init_paged_cache"):
            raise NotImplementedError(
                "continuous batching needs a decoder-only LM with a "
                "paged cache (encoder-decoder serving is fixed-batch)")
        if slots < 1:
            raise ValueError(f"slots={slots} < 1")
        from repro_torch.kernels.recorder import DispatchRecorder
        from repro_torch.train.step import make_ctx

        self.model, self.cfg, self.params = model, cfg, params
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.table_pages = pages_for(max_seq_len, page_size)
        #: gathered attention span per sequence (token slots)
        self.cap = self.table_pages * self.page_size
        self.tuner = tuner
        self.eos_id = eos_id
        self.recorders = recorders if recorders is not None else {
            "prefill": DispatchRecorder(), "decode": DispatchRecorder()}
        self.alloc = PageAllocator(n_pages, page_size)
        #: the pools live where the weights do
        self.device = params["embed"].device

        self._make_ctx = make_ctx
        self._dctx = make_ctx("decode", cache_len=self.cap, tuner=tuner)
        self.pool = model.init_paged_cache(n_pages, page_size,
                                           self._dctx, dtype, self.device)

        # host-side slot state
        self._table = np.full((slots, self.table_pages), HOLE, np.int32)
        self._pos = np.full((slots,), -1, np.int64)
        self._tok = np.zeros((slots,), np.int64)
        self._req: list[Request | None] = [None] * slots
        self._gen: list[list[int]] = [[] for _ in range(slots)]
        self._admit_step = [0] * slots

        self._lock = threading.Lock()
        self._queue: deque[Request] = deque()
        self._rids: set[int] = set()
        self._next_rid = 0
        self.finished: dict[int, FinishedSeq] = {}
        self.steps = 0
        self.admitted = 0
        self.keep_logits = keep_logits
        self.logits: dict[int, list[torch.Tensor]] = {}
        self.decode_log: list[tuple[float, int]] = []

        # what the reference's traces record, recorded once each here
        self._prefill_ctx: dict = {}
        self._decode_recorded = False

    # -- request intake -------------------------------------------------
    def submit(self, prompt, max_new: int, rid: int | None = None) -> int:
        """Queue one request; returns its rid.  Raises when the request
        could *never* run (exceeds the per-sequence cap or the whole
        pool) — deferral is for transient exhaustion only."""
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new={max_new} < 1")
        # the last generated token is returned, never written back, so
        # the sequence stores prompt + max_new - 1 token slots
        total = len(prompt) + max_new - 1
        if total > self.cap:
            raise ValueError(
                f"request needs {total} token slots > per-sequence cap "
                f"{self.cap} (max_seq_len)")
        if pages_for(total, self.page_size) > self.n_pages:
            raise ValueError(
                f"request needs {pages_for(total, self.page_size)} pages "
                f"> pool size {self.n_pages}: can never be admitted")
        with self._lock:
            if rid is None:
                while self._next_rid in self._rids:
                    self._next_rid += 1
                rid = self._next_rid
            if rid in self._rids:
                raise ValueError(f"duplicate rid {rid}")
            self._rids.add(rid)
            self._queue.append(Request(rid, prompt, max_new))
        return rid

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._req)

    # -- admission ------------------------------------------------------
    def _prefill_watch(self, prompt_len: int):
        """(prefill ctx, recorder or null context) for a prompt length:
        the first prefill of each length records, as the reference's
        per-length trace does."""
        ctx = self._prefill_ctx.get(prompt_len)
        if ctx is not None:
            return ctx, contextlib.nullcontext()
        # cache_len = whole pages, so the seeded rows reshape cleanly
        # into pages; the prompt runs at its exact length so
        # logits_last sees the real last token, not padding
        cache_len = pages_for(prompt_len, self.page_size) * self.page_size
        ctx = self._make_ctx("prefill", cache_len=cache_len,
                             tuner=self.tuner)
        self._prefill_ctx[prompt_len] = ctx
        return ctx, self.recorders["prefill"]

    def _admit(self) -> None:
        while True:
            slot = next((i for i in range(self.slots)
                         if self._req[i] is None), None)
            if slot is None:
                return
            with self._lock:
                if not self._queue:
                    return
                req = self._queue[0]
                pages = self.alloc.admit(
                    req.rid, len(req.prompt) + req.max_new - 1)
                if pages is None:        # transient exhaustion: defer
                    return
                self._queue.popleft()
            self._start(slot, req, pages)

    def _start(self, slot: int, req: Request, pages: list[int]) -> None:
        n_prompt_pages = pages_for(len(req.prompt), self.page_size)
        toks = torch.tensor([req.prompt], dtype=torch.long,
                            device=self.device)
        ctx, watch = self._prefill_watch(len(req.prompt))
        with torch.inference_mode():
            with watch:
                logits, cache = self.model.prefill(self.params, toks, ctx)
            page_ids = torch.tensor(pages[:n_prompt_pages],
                                    dtype=torch.long, device=self.device)
            _seed_segment(self.pool, cache, page_ids)
            first = int(torch.argmax(logits[0]))
        if self.keep_logits:
            self.logits[req.rid] = [logits[0].float().cpu()]
        row = np.full((self.table_pages,), HOLE, np.int32)
        row[: len(pages)] = pages
        self._table[slot] = row
        self._pos[slot] = len(req.prompt)   # next decode writes here
        self._tok[slot] = first
        self._req[slot] = req
        self._gen[slot] = [first]
        self._admit_step[slot] = self.steps
        self.admitted += 1
        if req.max_new == 1 or first == self.eos_id:
            self._retire(slot)              # finished at prefill

    # -- the decode step ------------------------------------------------
    def step(self) -> bool:
        """Admit, decode one token for every active slot, retire.

        Returns False when there was nothing to do (no active slots
        after admission)."""
        self._admit()
        if self.active == 0:
            return False
        watch = (contextlib.nullcontext() if self._decode_recorded
                 else self.recorders["decode"])
        self._decode_recorded = True
        dev = self.device
        t0 = time.perf_counter()
        with torch.inference_mode():
            with watch:
                logits, self.pool = self.model.decode_step(
                    self.params,
                    torch.from_numpy(self._tok[:, None]).to(dev),
                    self.pool, torch.from_numpy(self._pos).to(dev),
                    self._dctx, torch.from_numpy(self._table).to(dev))
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            rows = logits.float().cpu() if self.keep_logits else None
        self.decode_log.append((time.perf_counter() - t0, self.active))
        self.steps += 1
        for i in range(self.slots):
            req = self._req[i]
            if req is None:
                continue
            tok = int(nxt[i])
            self._gen[i].append(tok)
            if rows is not None:
                self.logits[req.rid].append(rows[i])
            self._pos[i] += 1
            self._tok[i] = tok
            if len(self._gen[i]) >= req.max_new or tok == self.eos_id:
                self._retire(i)
        self._admit()    # freed pages/slots serve the queue same-step
        return True

    def _retire(self, slot: int) -> None:
        req = self._req[slot]
        with self._lock:
            freed = self.alloc.retire(req.rid)
            assert freed == pages_for(
                len(req.prompt) + req.max_new - 1, self.page_size)
            self.finished[req.rid] = FinishedSeq(
                req.rid, req.prompt, tuple(self._gen[slot]),
                self._admit_step[slot], self.steps)
        self._table[slot] = HOLE
        self._pos[slot] = -1
        self._tok[slot] = 0
        self._req[slot] = None
        self._gen[slot] = []

    def run_until_drained(self, on_step: Callable | None = None,
                          max_steps: int = 1_000_000
                          ) -> dict[int, FinishedSeq]:
        """Step until queue and slots are empty; returns finished map.

        ``on_step(self)`` fires after every decode step — the hook the
        serve launcher uses for ReinstallManager drift checks.
        """
        idle_checks = 0
        while True:
            did = self.step()
            if did:
                idle_checks = 0
                if on_step is not None:
                    on_step(self)
            else:
                if self.pending == 0 and self.active == 0:
                    return dict(self.finished)
                idle_checks += 1
                if idle_checks > self.slots + 1:
                    raise RuntimeError(
                        "scheduler wedged: queued requests but nothing "
                        "admitted — pool/slot accounting broken")
            if self.steps > max_steps:
                raise RuntimeError(f"exceeded max_steps={max_steps}")

    # -- reporting ------------------------------------------------------
    @property
    def generated_tokens(self) -> int:
        return sum(len(f.tokens) for f in self.finished.values())

    def goodput(self) -> float:
        """Generated tokens per slot-step — 1.0 means every decode slot
        produced a kept token every step (the continuous-batching
        headline number; fixed-batch serving pays idle slots here)."""
        if self.steps == 0:
            return 0.0
        return self.generated_tokens / (self.steps * self.slots)
