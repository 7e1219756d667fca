"""Serving substrate: the paged KV cache, the continuous-batching
scheduler, and the drift-triggered online re-install loop.

The re-install manager is torch-free (it runs against the simulated or
measured timing backends), so it is re-exported eagerly; the
torch-backed names resolve lazily, as in :mod:`repro.serve`.  The
reference's ``serve/step.py`` (sharded prefill/decode builders) is not
ported yet.
"""

from repro_torch.serve.reinstall import (
    DriftTrigger,
    ReinstallConfig,
    ReinstallManager,
)

__all__ = ["DriftTrigger", "ReinstallConfig", "ReinstallManager",
           "ContinuousBatchingScheduler", "Request", "FinishedSeq",
           "PageAllocator", "PagedKV", "PagedLatent"]

_LAZY = {
    "ContinuousBatchingScheduler": "repro_torch.serve.scheduler",
    "Request": "repro_torch.serve.scheduler",
    "FinishedSeq": "repro_torch.serve.scheduler",
    "PageAllocator": "repro_torch.serve.kv_cache",
    "PagedKV": "repro_torch.serve.kv_cache",
    "PagedLatent": "repro_torch.serve.kv_cache",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
