"""Hopper kernels (+ plain PyTorch versions) and the tuned dispatcher.

matmul          — tiled GEMM, tile = ADSALA worker-config axis, CUDA
                  C++ for sm_90a under ``csrc/``
flash_attention — online-softmax blocked attention (causal / windowed),
                  CUDA C++ for sm_90a under ``csrc/``, dense and
                  block-sparse triangular KV walks
ops             — tuner-driven dispatch: ``matmul``, ``syrk``,
                  ``trsm``, ``flash_attention``, ``observe``,
                  ``dispatch_hint``
recorder        — DispatchRecorder: observe (routine, m, k, n, config,
                  cache_hit) per dispatch on the current thread
ref             — fp32 oracles for every kernel of the reference

The tuned entry points live in ``ops`` (``ops.matmul``, ``ops.syrk``,
``ops.trsm``, ``ops.flash_attention``) and are not re-exported here,
where ``matmul`` and ``flash_attention`` would shadow their submodules.
"""

from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_torch,
)
from repro_torch.kernels.matmul import matmul_cuda, matmul_torch
from repro_torch.kernels.ops import (
    dispatch_hint,
    observe,
    resolve_backend,
    supported_routine,
)
from repro_torch.kernels.recorder import DispatchEvent, DispatchRecorder
from repro_torch.kernels.ref import (
    flash_attention_ref,
    grouped_matmul_ref,
    matmul_ref,
    syrk_ref,
    trsm_ref,
)

__all__ = [
    "flash_attention_cuda", "flash_attention_torch",
    "matmul_cuda", "matmul_torch",
    "dispatch_hint", "observe",
    "resolve_backend", "supported_routine",
    "DispatchEvent", "DispatchRecorder",
    "matmul_ref", "syrk_ref", "trsm_ref", "grouped_matmul_ref",
    "flash_attention_ref",
]
