#!/usr/bin/env python3
"""Time the port's GEMM kernels from two or more source trees on one
card, in turns, to compare commits.

    git archive PARENT src | tar -x -C build/ab/parent   # a tree to compare
    python3 scripts/ab_kernels.py build/ab/parent .

Each TREE is a directory holding ``src/repro_torch``.  Every tree builds
its own kernels (into ``TREE/build/kernels``) in parallel; then each tree
is timed in its own process, in the order A B B A (for more trees, the
list and then its reverse).  One JSON line per timed run, then one line
of medians per tree.  Times are CUDA events over warm launches, fp32:

* ``gemm2048``: the tiled GEMM at 2048^3 on each of the 8 DEFAULT_TILES;
* ``trsm{2048,2956}_tile{3,5}``: ``ops.trsm`` (square right-hand side);
* ``grouped_decode``: the grouped GEMM at mixtral's decode bucket
  (8, 8, 6144) x (8, 6144, 16384), tile 3, where the tree has it;
* ``gemm_sum``: the sum of one 2048^3 product, to show equal results.

Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


def _time(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(tree: str) -> dict:
    """One timed run of ``tree``'s kernels (run in a process of its own:
    two trees' packages share module names)."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    from repro_torch.core import DEFAULT_TILES
    from repro_torch.kernels import matmul as M
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    a, b = rand(2048, 2048), rand(2048, 2048)
    out: dict = {"tree": tree, "gemm2048": {
        str(i): _time(lambda t=t: M.matmul_cuda(a, b, bm=t[0], bk=t[1],
                                                bn=t[2]), 10)
        for i, t in enumerate(DEFAULT_TILES)}}
    out["gemm_sum"] = float(M.matmul_cuda(a, b).double().sum())
    for d in (2048, 2956):
        ell = rand(d, d).tril_()
        ell.diagonal().copy_(ell.diagonal().abs() + d)
        rhs = rand(d, d)
        for tid in (3, 5):
            out[f"trsm{d}_tile{tid}"] = _time(
                lambda: ops.trsm(ell, rhs, tile=DEFAULT_TILES[tid]), 5)
    try:
        from repro_torch.kernels import grouped_matmul as G
    except ImportError:
        return out
    x, w = rand(8, 8, 6144), rand(8, 6144, 16384)
    bm, bk, bn = DEFAULT_TILES[3]
    out["grouped_decode"] = _time(
        lambda: G.grouped_matmul_cuda(x, w, bm=bm, bk=bk, bn=bn), 5)
    return out


def _flat(run: dict) -> dict:
    flat = {}
    for k, v in run.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{i}": x for i, x in v.items()})
        elif isinstance(v, float):
            flat[k] = v
    return flat


def main(trees: list[str]) -> int:
    me = os.path.abspath(__file__)
    trees = [os.path.abspath(t) for t in trees]
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from repro_torch.kernels import _build; _build.library()")
    procs = [subprocess.Popen([sys.executable, "-c", build,
                               os.path.join(t, "src")]) for t in trees]
    if any(p.wait() != 0 for p in procs):
        return 1
    runs: dict[str, list[dict]] = {t: [] for t in trees}
    for t in trees + trees[::-1]:
        res = subprocess.run([sys.executable, me, "--one", t],
                             capture_output=True, text=True, check=True)
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[t].append(_flat(json.loads(line)))
    for t, rs in runs.items():
        print(json.dumps({"tree": t, "median": {
            k: statistics.median(r[k] for r in rs) for k in rs[0]}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(sys.argv[2])))
        sys.exit(0)
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
