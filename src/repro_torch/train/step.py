"""Runtime context for the model's entry points.

The reference's train-step builder (loss -> grad -> AdamW) is not
ported yet; this module carries ``make_ctx`` only.
"""

from __future__ import annotations

import os

from repro_torch.models.transformer import Ctx

__all__ = ["make_ctx"]


def make_ctx(mode: str, *, cache_len: int = 0, tuner=None) -> Ctx:
    """Ctx for ``mode`` (prefill | decode) on a single device.

    ``ADSALA_KV_INT8=1`` asks the reference for int8 serving caches; the
    port has no int8 cache yet and refuses rather than ignore it.
    """
    if (os.environ.get("ADSALA_KV_INT8") == "1"
            and mode in ("prefill", "decode")):
        raise NotImplementedError(
            "ADSALA_KV_INT8=1: the int8 KV cache is not ported yet")
    return Ctx(mode=mode, cache_len=cache_len, tuner=tuner)
