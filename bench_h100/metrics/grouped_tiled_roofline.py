"""The grouped GEMM's tiled body's share of its roofline: the summed
least time of every tiled ``repro_torch::grouped_matmul`` launch in the
window (2ECDF at the fp32 peak against X, W read and Y written once;
capacity rows count as given) over their summed device time."""

from benchlib import readers


def read(run):
    return readers.roofline_pct(
        run, "repro_torch::grouped_matmul", readers.grouped_least,
        keep=lambda launch: not readers.is_thin(launch))
