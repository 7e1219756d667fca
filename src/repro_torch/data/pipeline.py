"""Deterministic synthetic token pipeline with background prefetch.

The reference's numpy stream, batch for batch: a stateless function of
(seed, step), so restarts resume mid-epoch exactly (the checkpoint
stores only the step counter).  :func:`make_global_batch` places a host
batch on a mesh as DTensors, or on one device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["SyntheticLM", "Prefetcher", "make_global_batch"]


class SyntheticLM:
    """Markov-ish synthetic LM tokens: learnable but non-trivial."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, audio_dim: int | None = None,
                 audio_len: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.audio_dim = audio_dim
        self.audio_len = audio_len

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.global_batch, self.seq_len
        # token t+1 = (a * t + drift) % V on half the stream, noise rest
        base = rng.integers(0, self.vocab, (b, 1))
        mult = rng.integers(1, 8, (b, 1))
        idx = np.arange(s)[None, :]
        structured = (base + mult * idx) % self.vocab
        noise = rng.integers(0, self.vocab, (b, s))
        mask = rng.random((b, 1)) < 0.5
        tokens = np.where(mask, structured, noise).astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], tokens[:, :1]], axis=1).astype(np.int32)
        out = {"tokens": tokens, "labels": labels}
        if self.audio_dim:
            out["audio_emb"] = rng.standard_normal(
                (b, self.audio_len, self.audio_dim)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_global_batch(batch: dict[str, np.ndarray], mesh,
                      specs: dict | None = None, *,
                      device="cuda") -> dict:
    """Host numpy -> tensors: DTensors laid out on ``mesh`` by the spec
    tree (each rank keeps its piece of the same global batch), or, with
    ``mesh=None``, plain tensors on ``device`` (the card unless the
    caller asks for the CPU; raises for ``cuda`` without a card)."""
    import torch

    if mesh is None:
        if torch.device(device).type == "cuda" \
                and not torch.cuda.is_available():
            raise ValueError("make_global_batch: no CUDA device; pass "
                             "device='cpu' to place the batch on the CPU")
        return {k: torch.from_numpy(np.asarray(v)).to(device)
                for k, v in batch.items()}
    from repro_torch.dist.collectives import distribute
    return {k: distribute(torch.from_numpy(np.asarray(v)).to(
        mesh.device_type), mesh, specs[k]) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of the next N batches (overlap of host
    data generation with device compute)."""

    def __init__(self, source: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._src = source
        self._done = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        try:
            for item in self._src:
                if self._done:
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self) -> None:
        self._done = True
