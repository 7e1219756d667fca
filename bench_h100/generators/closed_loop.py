"""Requests for closed-loop clients of a served model.

A mix file gives ``prompt`` and ``answer`` (each ``{"dist": "uniform" |
"log_uniform", "lo", "hi"}``, bounds included), ``distinct_prompts``,
``pool``, ``shape_seed`` and ``clients``.  From the shape seed alone it
draws ``distinct_prompts`` prompt lengths, a pool of ``pool`` requests
(each length equally often, an answer length each) and the order they
are sent in (a new permutation of the pool each pass).  So every run
seed serves the same requests in the same order: in a closed loop the
order decides which prompts are admitted in one scheduler call, and so
the work and the tail of the first-token times.  The run seed draws the
token ids.  A client's first request has its answer cut to a length
drawn uniformly from 1 up to its own, so the clients start at
staggered points of their requests, as in a loop that has run for a
while."""

from __future__ import annotations

import numpy as np


def draw(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    lo, hi = spec["lo"], spec["hi"]
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, n)
    if spec["dist"] == "log_uniform":
        u = rng.uniform(np.log(lo), np.log(hi + 1), n)
        return np.minimum(np.floor(np.exp(u)), hi).astype(np.int64)
    raise ValueError(f"unknown distribution {spec['dist']!r}")


def prompt_lengths(mix: dict) -> list[int]:
    """The mix's distinct prompt lengths (from its shape seed)."""
    rng = np.random.default_rng([mix["shape_seed"], 0])
    got: set[int] = set()
    while len(got) < mix["distinct_prompts"]:
        got.update(int(x) for x in draw(mix["prompt"], 1, rng))
    return sorted(got)


def pool(mix: dict) -> list[tuple[int, int]]:
    """(prompt length, answer length) of every request of the pool."""
    lengths = prompt_lengths(mix)
    rng = np.random.default_rng([mix["shape_seed"], 1])
    answers = draw(mix["answer"], mix["pool"], rng)
    return [(lengths[i % len(lengths)], int(answers[i]))
            for i in range(mix["pool"])]


class Traffic:
    def __init__(self, mix: dict, vocab: int, seed: int):
        self.pool = pool(mix)
        self.lengths = prompt_lengths(mix)
        self.vocab = vocab
        self.rng = np.random.default_rng([seed, 1])
        self.sizes = np.random.default_rng([mix["shape_seed"], 2])
        self._order: list[int] = []

    def _ids(self, n: int) -> list[int]:
        return self.rng.integers(0, self.vocab, n).tolist()

    def next(self) -> tuple[list[int], int]:
        """(prompt token ids, answer length) of the next request."""
        if not self._order:
            self._order = list(self.sizes.permutation(len(self.pool)))
        p, a = self.pool[self._order.pop()]
        return self._ids(p), a

    def first(self) -> tuple[list[int], int]:
        """A client's first request, its answer cut short."""
        prompt, a = self.next()
        return prompt, int(self.sizes.integers(1, a + 1))

    def warm(self) -> list[list[int]]:
        """One prompt of every distinct length, for the warm-up."""
        return [self._ids(p) for p in self.lengths]
