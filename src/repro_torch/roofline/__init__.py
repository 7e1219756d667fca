"""Analytic roofline terms (:mod:`repro_torch.roofline.analytic`)."""

from repro_torch.roofline.analytic import (
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    RooflineTerms,
    analytic_collective_bytes,
    analytic_hbm_bytes,
    ctx_enc,
    fwd_flops,
    step_flops,
)

__all__ = ["fwd_flops", "step_flops", "analytic_hbm_bytes",
           "analytic_collective_bytes", "ctx_enc", "RooflineTerms",
           "PEAK_FLOPS", "HBM_BW", "NVLINK_BW"]
