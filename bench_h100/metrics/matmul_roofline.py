"""The tiled GEMM kernel's share of its roofline in the BLAS cell: the
summed least time of every ``repro_torch::matmul`` launch in the window
(2mkn at the fp32 peak against A, B read and C written once) over their
summed device time."""

from benchlib import readers


def read(run):
    return readers.roofline_pct(run, "repro_torch::matmul",
                                readers.gemm_least)
