#!/usr/bin/env python3
"""Time the port's kernels (GEMM, grouped GEMM, flash attention) from
two or more source trees on one card, in turns, to compare commits.

    git archive PARENT src | tar -x -C build/ab/parent   # a tree to compare
    python3 scripts/ab_kernels.py build/ab/parent .

Each TREE is a directory holding ``src/repro_torch``.  Every tree builds
its own kernels (into ``TREE/build/kernels``) in parallel; then each tree
is timed in its own process, in the order A B B A (for more trees, the
list and then its reverse).  One JSON line per timed run, then one line
of medians per tree.  Times are CUDA events over warm launches, fp32:

* ``gemm2048``: the tiled GEMM at 2048^3 on each of the 8 DEFAULT_TILES;
* ``gemm2048_acol``: the same on tile 3 with A column-major (a
  transposed view), so A takes 16-byte copies instead of the 4-byte
  transposing copies of a row-major A;
* ``trsm{2048,2956}_tile{3,5}``: ``ops.trsm`` (square right-hand side);
* ``gemm2956``: the tiled GEMM at 2956^3 (the largest fp32 cube within
  100 MB) on tile 3;
* ``grouped_decode``, ``grouped_prefill``, ``grouped_deepseek``: the
  grouped GEMM, tile 3, at mixtral's decode bucket (8, 8, 6144) x
  (8, 6144, 16384), its prefill bucket (8, 1280, 6144) x
  (8, 6144, 16384) and deepseek-v2's experts (160, 192, 5120) x
  (160, 5120, 1536), where the tree has it; ``grouped_prefill_xcol``:
  the prefill bucket with each expert's X column-major (a transposed
  view), as ``gemm2048_acol``;
* ``longk_MxKxN_tile{3,5}``: the tiled GEMM at the three held-out
  shapes of ``chip_smoke.py``'s tuned loop that launch the fewest CTAs
  over the longest K (4, 12 and 24 CTAs of 128 x 128), which take most
  of that loop's time; ``longk_160x22380x645_acol``: the one whose
  column-major A rows are 16-byte aligned, on tile 3, as
  ``gemm2048_acol``;
* ``flash_stablelm_dense``, ``flash_stablelm_tri``: flash attention at
  stablelm-1.6b's prefill shape (128, 1024, 64), causal, block
  (1024, 512) (the tuner's), in each KV walk; ``flash_mixtral``: at
  mixtral-8x22b's (192, 1024, 128), causal, window 4096, block
  (1024, 512), dense walk; ``flash_stablelm_bf16``,
  ``flash_mixtral_bf16``: the same two shapes in bfloat16 (no served
  path runs them); ``flash_sum``: the sum of one stablelm-shape fp32
  output, to compare results (the trees may sum in another order);
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
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import matmul as M
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    out: dict = {"tree": tree}
    f32, bf16 = torch.float32, torch.bfloat16
    for name, bh, d, window, grids, dtype in (
            ("flash_stablelm", 128, 64, None, ("dense", "tri"), f32),
            ("flash_mixtral", 192, 128, 4096, ("dense",), f32),
            ("flash_stablelm_bf16", 128, 64, None, ("dense",), bf16),
            ("flash_mixtral_bf16", 192, 128, 4096, ("dense",), bf16)):
        q, k, v = (rand(bh, 1024, d).to(dtype) for _ in range(3))
        for grid in grids:
            key = f"{name}_{grid}" if len(grids) > 1 else name
            out[key] = _time(lambda: F.flash_attention_cuda(
                q, k, v, bq=1024, bkv=512, causal=True, window=window,
                grid=grid), 10)
        if name == "flash_stablelm":
            out["flash_sum"] = float(F.flash_attention_cuda(
                q, k, v, bq=1024, bkv=512).double().sum())
        del q, k, v
    a, b = rand(2048, 2048), rand(2048, 2048)
    out.update({"gemm2048": {
        str(i): _time(lambda t=t: M.matmul_cuda(a, b, bm=t[0], bk=t[1],
                                                bn=t[2]), 10)
        for i, t in enumerate(DEFAULT_TILES)}})
    out["gemm_sum"] = float(M.matmul_cuda(a, b).double().sum())
    bm, bk, bn = DEFAULT_TILES[3]
    a_col = rand(2048, 2048).T
    out["gemm2048_acol"] = _time(lambda: M.matmul_cuda(a_col, b, bm=bm,
                                                       bk=bk, bn=bn), 10)
    del a_col
    a, b = rand(2956, 2956), rand(2956, 2956)
    out["gemm2956"] = _time(lambda: M.matmul_cuda(a, b, bm=bm, bk=bk,
                                                  bn=bn), 10)
    del a, b
    for m, k, n in ((198, 51748, 135), (160, 22380, 645), (962, 20214, 290)):
        a, b = rand(m, k), rand(k, n)
        for tid in (3, 5):
            t = DEFAULT_TILES[tid]
            out[f"longk_{m}x{k}x{n}_tile{tid}"] = _time(
                lambda: M.matmul_cuda(a, b, bm=t[0], bk=t[1], bn=t[2]), 10)
        if m == 160:
            a = rand(k, m).T
            out[f"longk_{m}x{k}x{n}_acol"] = _time(
                lambda: M.matmul_cuda(a, b, bm=bm, bk=bk, bn=bn), 10)
    del a, b
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
    for name, (e, c, d, f), iters in (
            ("grouped_decode", (8, 8, 6144, 16384), 10),
            ("grouped_prefill", (8, 1280, 6144, 16384), 3),
            ("grouped_deepseek", (160, 192, 5120, 1536), 5)):
        x, w = rand(e, c, d), rand(e, d, f)
        out[name] = _time(
            lambda: G.grouped_matmul_cuda(x, w, bm=bm, bk=bk, bn=bn), iters)
        if name == "grouped_prefill":
            x = rand(e, d, c).transpose(1, 2)
            out[name + "_xcol"] = _time(
                lambda: G.grouped_matmul_cuda(x, w, bm=bm, bk=bk, bn=bn),
                iters)
        del x, w
        torch.cuda.empty_cache()
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
