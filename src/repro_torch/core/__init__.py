"""ADSALA core: the paper's contribution as a composable library.

Pipeline:  halton -> timing backend -> features/preprocessing -> ml zoo
           -> installer (Fig 2) -> artifact -> AdsalaTuner (Fig 3)
           -> tuned GEMM dispatch (repro.kernels.ops.tuned_matmul).

One search harness sits under all of it: a declarative
:class:`~repro.core.search.ConfigSpace` (axes + admissibility gates)
turned into a :class:`~repro.core.search.SearchGraph` and explored by
:func:`~repro.core.search.beam_search` — the installer times its
survivors under a budget, the tuner beam-searches at dispatch on cache
miss, and ``candidate_configs`` is its exhaustive enumeration.
"""

from repro_torch.core.costmodel import (
    DEFAULT_ROUTINE,
    DEFAULT_TILES,
    ROUTINES,
    TRSM_SEQ_CHIPS,
    BatchBreakdown,
    GemmConfig,
    TimeBreakdown,
    TPUSpec,
    candidate_configs,
    estimate_batch,
    estimate_batch_terms,
    estimate_gemm_time,
    estimate_routine_time,
    routine_ids,
)
from repro_torch.core.halton import (
    gemm_bytes,
    sample_gemm_dims,
    sample_gemm_dims_mixture,
    scrambled_halton,
)
from repro_torch.core.installer import (
    DEFAULT_WORKER_CONFIG,
    GatheredData,
    InstallConfig,
    InstallReport,
    gather_data,
    install,
    load_artifact,
    transfer_gather,
)
from repro_torch.core.registry import (
    ArtifactRegistry,
    HardwareFingerprint,
    ResolvedArtifact,
    resolve_serving_artifact,
)
from repro_torch.core.search import (
    Axis,
    BeamResult,
    ConfigSpace,
    Gate,
    SearchGraph,
    beam_search,
    exhaustive_best,
)
from repro_torch.core.timing import (
    MeasuredCPUBackend,
    SimulatedBackend,
    backend_from_dict,
    describe_backend,
    time_gemm_grid,
    time_routine_cells,
    time_routine_grid,
)
from repro_torch.core.tuner import AdsalaTuner
from repro_torch.core.workload import WorkloadProfile

__all__ = [
    "TPUSpec", "GemmConfig", "TimeBreakdown", "BatchBreakdown",
    "DEFAULT_TILES", "ROUTINES", "DEFAULT_ROUTINE", "TRSM_SEQ_CHIPS",
    "candidate_configs",
    "estimate_gemm_time", "estimate_routine_time", "routine_ids",
    "estimate_batch", "estimate_batch_terms", "time_gemm_grid",
    "time_routine_grid", "time_routine_cells",
    "Axis", "Gate", "ConfigSpace", "SearchGraph", "BeamResult",
    "beam_search", "exhaustive_best",
    "scrambled_halton", "sample_gemm_dims", "sample_gemm_dims_mixture",
    "gemm_bytes", "WorkloadProfile",
    "InstallConfig", "GatheredData", "InstallReport", "gather_data",
    "install", "load_artifact", "transfer_gather",
    "DEFAULT_WORKER_CONFIG",
    "SimulatedBackend", "MeasuredCPUBackend",
    "describe_backend", "backend_from_dict",
    "HardwareFingerprint", "ArtifactRegistry", "ResolvedArtifact",
    "resolve_serving_artifact",
    "AdsalaTuner",
]

# port-only begin: the device counterpart of MeasuredCPUBackend
from repro_torch.core.timing import MeasuredCUDABackend  # noqa: E402

__all__ += ["MeasuredCUDABackend"]
# port-only end
