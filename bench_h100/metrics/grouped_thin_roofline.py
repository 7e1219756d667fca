"""The grouped GEMM's weight-streaming (thin) body's share of its
roofline: as the tiled body's, over the thin launches in the window."""

from benchlib import readers


def read(run):
    return readers.roofline_pct(
        run, "repro_torch::grouped_matmul", readers.grouped_least,
        keep=readers.is_thin)
