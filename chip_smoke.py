#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (written for the H100) and
check it against its plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. environment: the card's name and power limit; TF32 off;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per compile unit, in parallel: the GEMM sources once per
   operand type);
3. kernels against plain: the flash-attention kernel in both KV walks
   against its plain PyTorch version on causal, windowed, non-causal,
   padded ragged, fully masked, GQA-broadcast and bf16 cases, every head
   dim in both dtypes, rows not a multiple of the CTA's, fewer CTA rows
   (bq 32, 64, Sq 12), windows starting mid-ring, and at the serving
   path's shape (dense and tri must be bitwise equal, and two launches
   too); then the
   GEMM kernel against its plain version on the reference's matmul
   cases in fp32 and bf16, ragged shapes, every DEFAULT_TILES entry, a
   transposed-B view, syrk and trsm, and its bits on 10 launch shapes
   (equal: no split-K); then the grouped GEMM kernel on the reference's
   grouped cases, every DEFAULT_TILES entry and ragged and strided
   operands, in fp32 and bf16, then thin buckets (C of 1, 3, 8, 16 and
   17, ragged d and f, a split-K shape) in fp32 and bf16, an
   expert-transposed W, strided X rows, split-K on a transposed W, and
   two launches bitwise equal (thin, split-K and tiled);
4. install: a small ADSALA artifact on the simulated backend;
5. serve: stablelm-1.6b at full width through ``repro_torch.launch.serve``
   with that artifact; the flash kernel's launch count must be one per
   layer per prefill, the logits finite, and the same prefill on the
   plain backend must agree;
6. measured install: the paper's loop on the card, timing the port's
   own GEMM kernel through ``ops.matmul``/``syrk``/``trsm`` with
   ``MeasuredCUDABackend`` on GEMMs within 100 MB (fp32);
7. tuned loop: that artifact served by ``AdsalaTuner`` on held-out
   shapes; the GEMM kernel's launch count must be the one the calls
   imply; tuned picks against the default tile and the best installed
   tile, each timed; the kernel against ``torch.matmul`` at 2048^3 and
   the largest cube;
8. mixtral: mixtral-8x22b at full width, cut to 4 layers (fp32),
   through ``serve.serve_config`` with the phase-4 artifact; the
   grouped kernel's launch count must be 3 per MoE layer per forward
   (prefill on the tiled body, each decode step on the thin one), the
   flash kernel's one per layer,
   the logits finite, and the same prefill on the plain backend must
   agree; then the grouped kernel against its plain version and
   ``torch.bmm`` at mixtral's prefill and decode buckets and at
   deepseek-v2's expert shape, and the flash kernel against its plain
   version and SDPA at mixtral's attention shape (192, 1024, 128) with
   the tuner's block;
9. report: one ``{"adsala": {...}}`` line, one ``{"mixtral": {...}}``
   line, one ``{"kernels": [...]}`` line (one entry per measured shape:
   flash attention at stablelm's and mixtral's prefill shapes, each with
   its launch plan; the GEMM at 2048^3 and the largest cube; the grouped
   GEMM at mixtral's decode and prefill buckets and deepseek-v2's
   experts; each with its body, ring stages and split count), the card's
   line, and the ``{"ok": true, ...}`` last line.

Exits non-zero without a result when no CUDA device is present or when
the repository's ``src/repro_torch`` is not beside this file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
WORK = ROOT / "build" / "chip_smoke"

#: H100 SXM peaks (NVIDIA data sheet): fp32 on the CUDA cores, HBM rate
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

ARCH = "stablelm-1.6b"
REQUESTS, PROMPT_LEN, GEN_TOKENS = 4, 1024, 16

#: kernel vs plain, as tests/test_flash.py holds the reference
TOL = {"float32": 2e-5, "bfloat16": 5e-2}
#: GEMM kernel vs plain, as tests/test_kernels.py holds the reference:
#: the matmul oracle cases, random shapes and syrk, trsm
GEMM_TOL = {"float32": 5e-5, "bfloat16": 1e-1}
RANDOM_TOL = 1e-4
TRSM_TOL = 1e-3
#: the reference's matmul cases (m, k, n, bm, bk, bn)
MATMUL_CASES = [(64, 64, 64, 64, 64, 64), (128, 256, 128, 64, 128, 64),
                (100, 130, 70, 32, 64, 32), (8, 8, 8, 32, 32, 32),
                (256, 64, 512, 128, 64, 128), (33, 257, 65, 16, 128, 16)]

#: the paper's install domain: GEMMs whose operands fit in 100 MB, fp32
MEM_LIMIT_MB = 100
INSTALL_TILES = (0, 1, 3, 5)
DEFAULT_TILE_ID = 3
INSTALL_SAMPLES = 480
INSTALL_MODELS = ("linear_regression", "decision_tree", "xgboost")
#: held-out shapes per routine in the tuned loop, beside two cubes:
#: LARGE_CUBE^3 and the largest cube within the memory limit
HELD_OUT = 32
LARGE_CUBE = 2048
#: the tuned loop compares a call's output with the plain path's while
#: the output has at most this many elements (memory on the card)
CHECK_ELEMS = 2 ** 26

#: kernel-path vs plain-path prefill logits after 24 fp32 layers: the
#: two attention functions differ in summation order only (~1e-6 per
#: layer), which the residual stream carries to the logits
LOGITS_TOL = 1e-3

#: mixtral-8x22b at full width, depth cut to fit one card in fp32
MIX_ARCH, MIX_LAYERS = "mixtral-8x22b", 4
#: the reference's grouped cases (tests/test_kernels.py), tile 32
GROUPED_CASES = [(4, 64, 32, 48), (2, 100, 64, 64), (8, 16, 16, 96)]
#: grouped GEMM timing shapes (name, E, C, d, f): mixtral's expert
#: buckets in prefill (4 x 1024 tokens) and decode (4 tokens), and
#: deepseek-v2's experts (160 of d_ff 1536) at 192 rows each
#: thin buckets (C <= 16: the weight-streaming body; 17: the tiled one),
#: ragged d and f, and a shape whose planner splits K (E, C, d, f)
SPLIT_CASE = (2, 8, 4096, 300)
THIN_CASES = [(8, 1, 300, 130), (8, 3, 300, 130), (8, 8, 300, 130),
              (8, 16, 300, 130), (8, 17, 300, 130), (4, 8, 257, 513),
              (3, 5, 1000, 3), SPLIT_CASE]
GROUPED_SHAPES = [("mixtral_prefill", 8, 1280, 6144, 16384),
                  ("mixtral_decode", 8, 8, 6144, 16384),
                  ("deepseek_v2_experts", 160, 192, 5120, 1536)]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def ptxas_report(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill-store bytes) for every kernel in an
    ``nvcc -Xptxas -v`` log, named by its template arguments as the
    mangled name holds them (e.g. ``gemm_kernel<f32,128,128,16,4,plain>``).
    """
    import re

    out, name, spills = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spills = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            k = re.search(r"(gemm_kernel|thin_kernel|split_sum_kernel|"
                          r"flash\w*?kernel)(I.*?EE)?", name)
            short = name if k is None else (
                k.group(1) + (f"<{_targs(k.group(2))}>" if k.group(2)
                              else ""))
            out.append((short, int(m.group(1)), spills))
            name = None
    return out


def _targs(mangled: str) -> str:
    """Template arguments of a mangled kernel name, comma separated."""
    import re

    args = []
    for tok in re.finditer(r"13__nv_bfloat16|Li(\d+)E|Lb(\d)E|f", mangled):
        if tok.group(0) == "13__nv_bfloat16":
            args.append("bf16")
        elif tok.group(0) == "f":
            args.append("f32")
        elif tok.group(1) is not None:
            args.append(tok.group(1))
        else:
            args.append("grouped" if tok.group(2) == "1" else "plain")
    return ",".join(args)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events over ``iters``."""
    import torch

    for _ in range(warmup):
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


def flash_bound_ms(bh: int, sq: int, skv: int, d: int, causal: bool,
                   itemsize: int) -> tuple[float, str]:
    """Least time for the work: 4*D flops per visible (q, kv) pair
    (QK^T and PV) at the fp32 CUDA-core rate, against q, k, v read and
    o written once at the HBM rate."""
    if causal:
        pairs = sum(min(i + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    t_ops = 4.0 * d * pairs * bh / FP32_FLOPS
    t_bytes = itemsize * d * bh * (2 * sq + 2 * skv) / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def phase_kernels(fa, torch) -> dict:
    """Phase 3: kernel vs plain over the listed cases."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # name, bh, sq, skv, d, dtype, causal, window, bq, bkv
        ("causal_square", 2, 96, 96, 16, f32, True, None, 32, 32),
        ("causal_padded_sq>skv", 2, 100, 64, 16, f32, True, None, 32, 32),
        ("causal_padded_130x70", 2, 130, 70, 16, f32, True, None, 32, 32),
        ("causal_sq<skv", 2, 64, 100, 16, f32, True, None, 32, 32),
        ("causal_window40", 2, 96, 96, 16, f32, True, 40, 32, 32),
        ("noncausal", 2, 80, 80, 16, f32, False, None, 32, 32),
        ("noncausal_window24", 2, 96, 96, 16, f32, False, 24, 32, 32),
        ("noncausal_padded", 2, 64, 50, 16, f32, False, None, 32, 32),
        ("causal_d32_sub-tiles", 3, 200, 200, 32, f32, True, None, 128, 64),
        ("causal_d128_clamped", 2, 300, 300, 128, f32, True, None, 256,
         512),
        ("causal_window100_d64", 4, 777, 777, 64, f32, True, 100, 256, 128),
        ("bf16_causal", 2, 64, 64, 16, bf16, True, None, 32, 32),
        ("bf16_causal_d64", 8, 1024, 1024, 64, bf16, True, None, 512, 512),
        ("bf16_noncausal_d128", 2, 200, 150, 128, bf16, False, None, 64,
         64),
        ("path_512x512", 128, 1024, 1024, 64, f32, True, None, 512, 512),
        ("path_128x512", 128, 1024, 1024, 64, f32, True, None, 128, 512),
        ("path_1024x512", 128, 1024, 1024, 64, f32, True, None, 1024, 512),
        # rows with no visible key: the reference's average over the
        # visible logical tiles, or 0
        ("fully_masked_noncausal", 1, 96, 40, 16, f32, False, 8, 32, 16),
        ("fully_masked_causal", 2, 130, 37, 32, f32, True, 5, 64, 16),
        ("fully_masked_bq128", 2, 300, 40, 32, f32, False, 16, 128, 64),
        # the redesigned body's edges: rows not a multiple of the CTA's
        # 128, fewer CTA rows (bq 32, 64; Sq 12: 16), windows that start
        # mid-tile and mid-ring, every head dim in both dtypes, and
        # sub-tiles rejected above the diagonal mid-tile (bkv 512)
        ("ragged_rows_bq256", 2, 300, 300, 64, f32, True, None, 256, 128),
        ("ragged_rows_clamped", 3, 200, 200, 64, f32, True, None, 1024,
         512),
        ("cta_rows32_d64", 2, 256, 256, 64, f32, True, None, 32, 64),
        ("cta_rows64_d128", 2, 256, 256, 128, f32, True, None, 64, 128),
        ("cta_rows16_sq12", 2, 12, 12, 64, f32, True, None, 512, 512),
        ("window_mid_ring", 2, 1024, 1024, 64, f32, True, 300, 512, 512),
        ("window_d128_bq256", 2, 1024, 1024, 128, f32, True, 200, 256,
         512),
        ("d16_bkv512", 4, 600, 600, 16, f32, True, None, 128, 512),
        ("d32_window", 2, 700, 700, 32, f32, True, 333, 256, 256),
        ("bf16_d16_window", 2, 300, 300, 16, bf16, True, 50, 32, 512),
        ("bf16_d32_bkv512", 4, 600, 600, 32, bf16, True, None, 128, 512),
        ("bf16_d64_bkv512_bq128", 8, 1024, 1024, 64, bf16, True, None, 128,
         512),
        ("bf16_d128_window", 2, 1024, 1024, 128, bf16, True, 700, 512,
         512),
    ]
    errs = {}
    for (name, bh, sq, skv, d, dt, causal, window, bq, bkv) in cases:
        q, k, v = rand(bh, sq, d, dtype=dt), rand(bh, skv, d, dtype=dt), \
            rand(bh, skv, d, dtype=dt)
        kw = dict(bq=bq, bkv=bkv, causal=causal, window=window)
        want = fa.flash_attention_torch(q, k, v, **kw)
        got = {g: fa.flash_attention_cuda(q, k, v, grid=g, **kw)
               for g in fa.FLASH_GRID_KINDS}
        got["again"] = fa.flash_attention_cuda(q, k, v, grid="tri", **kw)
        torch.cuda.synchronize()
        check_case(name, got, want, dt, torch, errs)
    # GQA: 8 query heads sharing 2 KV heads, broadcast before the call
    b, h, hk, s, d = 2, 8, 2, 72, 16
    q = rand(b * h, s, d, dtype=f32)
    k, v = (rand(b, hk, s, d, dtype=f32).repeat_interleave(h // hk, dim=1)
            .reshape(b * h, s, d).contiguous() for _ in range(2))
    want = fa.flash_attention_torch(q, k, v, bq=32, bkv=32)
    got = {g: fa.flash_attention_cuda(q, k, v, bq=32, bkv=32, grid=g)
           for g in fa.FLASH_GRID_KINDS}
    got["again"] = fa.flash_attention_cuda(q, k, v, bq=32, bkv=32,
                                           grid="tri")
    torch.cuda.synchronize()
    check_case("gqa_broadcast", got, want, f32, torch, errs)
    return errs


def check_case(name, got, want, dt, torch, errs) -> None:
    tol = TOL[str(dt).split(".")[-1]]
    if not torch.equal(got["dense"], got["tri"]):
        raise SystemExit(f"[chip_smoke] FAIL {name}: dense and tri "
                         "outputs are not bitwise equal")
    if not torch.equal(got["tri"], got["again"]):
        raise SystemExit(f"[chip_smoke] FAIL {name}: two launches are not "
                         "bitwise equal")
    err = (got["tri"].float() - want.float()).abs().max().item()
    bad = ~torch.isclose(got["tri"].float(), want.float(), atol=tol,
                         rtol=tol)
    errs[name] = err
    print(f"[chip_smoke] kernel {name:24s} {str(dt):15s} "
          f"max_abs_err={err:.3e} tol={tol:g} dense==tri==again bitwise")
    if bool(bad.any()) or not torch.isfinite(got["tri"]).all():
        raise SystemExit(f"[chip_smoke] FAIL {name}: kernel disagrees "
                         f"with the plain version (max_abs_err={err:.3e}, "
                         f"tol={tol:g})")


def time_flash(fa, torch, bh: int, s: int, d: int, bq: int, bkv: int,
               grid: str, window, seed: int) -> dict:
    """The flash kernel at one causal fp32 shape and block: checked
    against its plain version, then the kernel in both walks, the plain
    version and SDPA timed, beside the bound and the launch plan."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda")
               for _ in range(3))
    kw = dict(bq=bq, bkv=bkv, causal=True, window=window)
    got = fa.flash_attention_cuda(q, k, v, grid=grid, **kw)
    ref = fa.flash_attention_torch(q, k, v, **kw)
    err = (got - ref).abs().max().item()
    if not torch.allclose(got, ref, atol=TOL["float32"],
                          rtol=TOL["float32"]):
        raise SystemExit("[chip_smoke] FAIL: flash kernel disagrees at "
                         f"{(bh, s, d)} ({err:.3e})")
    del got, ref
    times = {g: cuda_ms(lambda g=g: fa.flash_attention_cuda(
        q, k, v, grid=g, **kw)) for g in fa.FLASH_GRID_KINDS}
    plain_ms = cuda_ms(lambda: fa.flash_attention_torch(q, k, v, **kw),
                       iters=3, warmup=1)
    # a window of at least S leaves the causal mask: SDPA's is_causal is
    # then the same function
    assert window is None or window >= s
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.
                      scaled_dot_product_attention(q, k, v, is_causal=True))
    bound, bound_by = flash_bound_ms(bh, s, s, d, True, 4)
    plan = fa.flash_launch(s, s, d, bq, bkv, dtype=torch.float32,
                           grid=grid)
    print(f"[chip_smoke] flash {(bh, s, d)} fp32 causal window {window} "
          f"block ({bq},{bkv}) plan {plan.cta_rows} rows x "
          f"{plan.sub_cols} cols, {plan.stages} stages, {plan.smem} B: "
          f"dense {times['dense']:.3f} ms, tri {times['tri']:.3f} ms, "
          f"plain {plain_ms:.3f} ms, sdpa {sdpa_ms:.3f} ms, bound "
          f"{bound:.3f} ms ({bound_by}), max_abs_err {err:.3e}")
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": [bh, s, d], "block": [bq, bkv], "grid": grid,
            "window": window, "max_abs_err": err, "ms": times[grid],
            "ms_by_grid": times, "plain_ms": plain_ms, "library_ms": sdpa_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "plan": {"cta_rows": plan.cta_rows, "sub_cols": plan.sub_cols,
                     "stages": plan.stages, "smem": plan.smem}}


def flash_entry(name: str, row: dict, launches: int, **extra) -> dict:
    """One flash entry of the ``{"kernels": [...]}`` line."""
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:244",
            "launches": launches, "dtype": "float32", **row, **extra}


def gemm_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time for an fp32 GEMM: 2mkn flops at the CUDA-core rate
    against A, B read and C written once at the HBM rate."""
    return _bound(2.0 * m * k * n, 4.0 * (m * k + k * n + m * n))


def syrk_bound_ms(m: int, k: int) -> tuple[float, str]:
    """Only the triangle the routine must produce: m(m+1)k flops; A read
    and the m x m output written once."""
    return _bound(float(m) * (m + 1) * k, 4.0 * (m * k + m * m))


def trsm_bound_ms(m: int, n: int) -> tuple[float, str]:
    """Substitution: m^2 n flops; A's triangle and B read, X written."""
    return _bound(float(m) * m * n, 4.0 * (m * (m + 1) / 2 + 2 * m * n))


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def check_close(name, got, want, tol, torch, errs, *, normwise=False,
                kind="gemm"):
    """Fail unless ``got`` is finite and within ``tol`` of ``want``
    (elementwise atol = rtol = tol; ``normwise``: max abs error within
    tol * max(1, max |want|), for long fp32 sums whose rounding grows
    with K)."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    errs[name] = err
    if normwise:
        scale = max(1.0, want.float().abs().max().item())
        ok = err <= tol * scale
    else:
        ok = not bool((~torch.isclose(got.float(), want.float(), atol=tol,
                                      rtol=tol)).any())
    print(f"[chip_smoke] {kind} {name:30s} {str(got.dtype):15s} "
          f"max_abs_err={err:.3e} tol={tol:g}"
          + (" (normwise)" if normwise else ""))
    if not ok or not bool(torch.isfinite(got).all()):
        raise SystemExit(f"[chip_smoke] FAIL {name}: kernel disagrees with "
                         f"the plain version (max_abs_err={err:.3e}, "
                         f"tol={tol:g})")


def phase_gemm_kernels(M, ops, torch) -> dict:
    """Phase 3, GEMM: the kernel against its plain version."""
    from repro_torch.core import DEFAULT_TILES

    gen = torch.Generator(device="cuda").manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16

    def rand(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def mm(name, a, b, tile, tol):
        bm, bk, bn = tile
        check_close(name, M.matmul_cuda(a, b, bm=bm, bk=bk, bn=bn),
                    M.matmul_torch(a, b, bm=bm, bk=bk, bn=bn), tol, torch,
                    errs)

    errs: dict[str, float] = {}
    for m, k, n, bm, bk, bn in MATMUL_CASES:
        for dt in (f32, bf16):
            dname = str(dt).split(".")[-1]
            mm(f"case_{m}x{k}x{n}_{dname}", rand(m, k, dtype=dt),
               rand(k, n, dtype=dt), (bm, bk, bn), GEMM_TOL[dname])
    shape_gen = torch.Generator().manual_seed(3)
    for i in range(8):                  # random shapes in [8, 96], tile 32
        m, k, n = (int(x) for x in torch.randint(8, 97, (3,),
                                                 generator=shape_gen))
        mm(f"random{i}_{m}x{k}x{n}", rand(m, k), rand(k, n), (32, 32, 32),
           RANDOM_TOL)
    for m, k, n, tile in [(1, 1000, 3, DEFAULT_TILES[0]),
                          (2049, 7, 1, DEFAULT_TILES[5]),
                          (300, 257, 130, DEFAULT_TILES[3])]:
        mm(f"ragged_{m}x{k}x{n}", rand(m, k), rand(k, n), tile,
           GEMM_TOL["float32"])
    for tid, tile in enumerate(DEFAULT_TILES):
        for dt in (f32, bf16):
            dname = str(dt).split(".")[-1]
            mm(f"tile{tid}_1024x512x768_{dname}", rand(1024, 512, dtype=dt),
               rand(512, 768, dtype=dt), tile, GEMM_TOL[dname])
    # no split-K: every launch shape gives the same bits, run after run
    a, b = rand(700, 1500), rand(1500, 900)
    outs = [M.matmul_cuda(a, b, bm=t[0], bk=t[1], bn=t[2])
            for t in list(DEFAULT_TILES) + [(64, 64, 64), DEFAULT_TILES[0]]]
    torch.cuda.synchronize()
    same = all(torch.equal(o, outs[0]) for o in outs)
    print(f"[chip_smoke] gemm 700x1500x900 on {len(outs)} launch shapes: "
          f"bitwise equal: {same}")
    if not same:
        raise SystemExit("[chip_smoke] FAIL: the GEMM's bits depend on the "
                         "launch shape")
    a, base = rand(200, 96), rand(300, 96)
    mm("transposed_b_view", a, base.T, DEFAULT_TILES[3], GEMM_TOL["float32"])
    mm("transposed_a_view", rand(96, 200).T, base.T, DEFAULT_TILES[1],
       GEMM_TOL["float32"])
    a, b = rand(300, 200), rand(300, 200)
    for lower in (True, False):
        side = "lower" if lower else "upper"
        for bb in (None, b):
            got = ops.syrk(a, bb, lower=lower, tile=DEFAULT_TILES[3])
            want = ops.syrk(a, bb, lower=lower, tile=DEFAULT_TILES[3],
                            backend="torch")
            check_close(f"syrk_{side}{'_b' if bb is not None else ''}",
                        got, want, RANDOM_TOL, torch, errs)
    m, n = 700, 40
    for lower in (True, False):
        for unit in (False, True):
            ell = torch.tril(rand(m, m))
            if unit:
                ell = ell / m
                ell.diagonal().fill_(1.0)
            else:
                ell.diagonal().copy_(ell.diagonal().abs() + m)
            if not lower:
                ell = ell.T.contiguous()
            rhs = rand(m, n)
            kw = dict(lower=lower, unit_diag=unit, tile=(256, 128, 256))
            before = M.matmul_cuda.launches
            got = ops.trsm(ell, rhs, **kw)
            if M.matmul_cuda.launches != before + 2:
                raise SystemExit("[chip_smoke] FAIL trsm: expected one GEMM "
                                 "launch per panel after the first")
            check_close(f"trsm_{'lower' if lower else 'upper'}"
                        f"{'_unit' if unit else ''}", got,
                        ops.trsm(ell, rhs, backend="torch", **kw), TRSM_TOL,
                        torch, errs)
    return errs


def phase_grouped_kernels(G, torch) -> dict:
    """Phase 3, grouped GEMM: the kernel against its plain version."""
    from repro_torch.core import DEFAULT_TILES

    gen = torch.Generator(device="cuda").manual_seed(5)
    f32, bf16 = torch.float32, torch.bfloat16

    def rand(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def gmm(name, x, w, tile, tol):
        bm, bk, bn = tile
        check_close(name, G.grouped_matmul_cuda(x, w, bm=bm, bk=bk, bn=bn),
                    G.grouped_matmul_torch(x, w, bm=bm, bk=bk, bn=bn), tol,
                    torch, errs, kind="grouped")

    errs: dict[str, float] = {}
    for dt in (f32, bf16):
        dname = str(dt).split(".")[-1]
        for e, c, d, f in GROUPED_CASES:
            gmm(f"case_{e}x{c}x{d}x{f}_{dname}", rand(e, c, d, dtype=dt),
                rand(e, d, f, dtype=dt), (32, 32, 32), GEMM_TOL[dname])
        for tid, tile in enumerate(DEFAULT_TILES):
            gmm(f"tile{tid}_8x300x257x130_{dname}", rand(8, 300, 257,
                                                         dtype=dt),
                rand(8, 257, 130, dtype=dt), tile, GEMM_TOL[dname])
        for e, c, d, f, tile in [(3, 33, 257, 65, (16, 128, 16)),
                                 (5, 1, 1000, 3, DEFAULT_TILES[0]),
                                 (2, 2049, 7, 1, DEFAULT_TILES[5]),
                                 (160, 12, 40, 24, (64, 64, 64))]:
            gmm(f"ragged_{e}x{c}x{d}x{f}_{dname}", rand(e, c, d, dtype=dt),
                rand(e, d, f, dtype=dt), tile, GEMM_TOL[dname])
    x, wt = rand(4, 96, 200), rand(4, 130, 200)
    gmm("expert_transposed_w", x, wt.transpose(1, 2), DEFAULT_TILES[3],
        GEMM_TOL["float32"])
    gmm("strided_x_rows", x[:, ::2], wt.transpose(1, 2), DEFAULT_TILES[1],
        GEMM_TOL["float32"])
    # thin buckets (the weight-streaming body) and split-K
    tile = DEFAULT_TILES[3]
    for dt in (f32, bf16):
        dname = str(dt).split(".")[-1]
        for e, c, d, f in THIN_CASES:
            plan = G.grouped_launch(e, c, d, f, *tile)
            gmm(f"{plan.variant}_s{plan.splits}_{e}x{c}x{d}x{f}_{dname}",
                rand(e, c, d, dtype=dt), rand(e, d, f, dtype=dt), tile,
                GEMM_TOL[dname])
    x, wt = rand(4, 16, 600), rand(4, 300, 600)
    gmm("thin_expert_transposed_w", x[:, :8], wt.transpose(1, 2), tile,
        GEMM_TOL["float32"])
    gmm("thin_strided_x_rows", x[:, ::2], rand(4, 600, 300), tile,
        GEMM_TOL["float32"])
    x, wt = rand(2, 8, 4096), rand(2, 200, 4096)
    if G.grouped_launch(2, 8, 4096, 200, *tile).splits < 2:
        raise SystemExit("[chip_smoke] FAIL: the split-K case does not "
                         "split")
    gmm("thin_split_k_transposed_w", x, wt.transpose(1, 2), tile,
        GEMM_TOL["float32"])
    # two launches on the same inputs give the same bits, split-K too
    for e, c, d, f in [(8, 8, 6144, 2048), SPLIT_CASE, (4, 192, 1024, 384)]:
        x, w = rand(e, c, d), rand(e, d, f)
        plan = G.grouped_launch(e, c, d, f, *tile)
        one = G.grouped_matmul_cuda(x, w, bm=tile[0], bk=tile[1], bn=tile[2])
        two = G.grouped_matmul_cuda(x, w, bm=tile[0], bk=tile[1], bn=tile[2])
        torch.cuda.synchronize()
        same = torch.equal(one, two)
        print(f"[chip_smoke] grouped determinism {e}x{c}x{d}x{f} "
              f"{plan.variant} splits={plan.splits}: two launches bitwise "
              f"equal: {same}")
        if not same:
            raise SystemExit("[chip_smoke] FAIL: two grouped launches on "
                             "the same inputs differ")
    return errs


def phase_install(torch) -> Path:
    """Phase 4: a small artifact on the simulated backend."""
    from repro_torch.core import InstallConfig, SimulatedBackend, install

    art = WORK / "artifact"
    cfg = InstallConfig(n_samples=48, repeats=2, tile_ids=(0, 3),
                        models=("linear_regression", "decision_tree"),
                        routines=("gemm", "attn"), grid_budget="small",
                        cv_splits=3, seed=0)
    t0 = time.perf_counter()
    rep = install(SimulatedBackend(seed=0), cfg, artifact_dir=str(art))
    print(f"[chip_smoke] install: model={rep.selected} in "
          f"{time.perf_counter() - t0:.2f}s -> {art}")
    return art


ROUTINES3 = ("gemm", "syrk", "trsm")


def phase_measured_install(torch) -> tuple[Path, dict]:
    """Phase 6: the paper's install on the card, timing the port's own
    GEMM kernel (the set-up of benchmarks/bench_registry.py's measured
    installs: one chip, partition M, the default config on tile 3)."""
    from repro_torch.core import (ConfigSpace, GemmConfig, InstallConfig,
                                  MeasuredCUDABackend, install)

    art = WORK / "measured_artifact"
    cfg = InstallConfig(
        n_samples=INSTALL_SAMPLES, repeats=1, mem_limit_mb=MEM_LIMIT_MB,
        dtype_bytes=4, routines=ROUTINES3, max_chips=1,
        tile_ids=INSTALL_TILES,
        space=ConfigSpace.default(1, tiles=INSTALL_TILES,
                                  partitions=("M",)),
        default_config=GemmConfig(1, "M", DEFAULT_TILE_ID),
        models=INSTALL_MODELS, seed=0)
    t0 = time.perf_counter()
    rep = install(MeasuredCUDABackend(repeats=3, warmup=1), cfg,
                  artifact_dir=str(art))
    took = time.perf_counter() - t0
    torch.cuda.empty_cache()
    backend = json.loads((art / "config.json").read_text())["backend"]
    print(f"[chip_smoke] measured install: {INSTALL_SAMPLES} samples x "
          f"{len(INSTALL_TILES)} tiles within {MEM_LIMIT_MB} MB (fp32) in "
          f"{took:.1f}s, model={rep.selected}, backend={json.dumps(backend)}")
    for line in rep.table().splitlines():
        print(f"[chip_smoke]   {line}")
    sel = next(r for r in rep.reports if r.name == rep.selected)
    return art, {"seconds": took, "n_samples": INSTALL_SAMPLES,
                 "mem_limit_mb": MEM_LIMIT_MB, "tiles": list(INSTALL_TILES),
                 "models": list(INSTALL_MODELS), "selected": rep.selected,
                 "backend": backend, "installer_per_routine": sel.per_routine}


def largest_cube(limit: int) -> int:
    from repro_torch.core import gemm_bytes

    d = int((limit / 12) ** 0.5)
    while gemm_bytes(d + 1, d + 1, d + 1, 4) <= limit:
        d += 1
    while gemm_bytes(d, d, d, 4) > limit:
        d -= 1
    return d


def phase_tuned_loop(art: Path, M, fa, G, torch) -> tuple[dict, dict]:
    """Phase 7: serve the measured artifact through ops on held-out
    shapes; count the kernel's launches; time the picks."""
    import numpy as np

    from repro_torch.core import (AdsalaTuner, DEFAULT_TILES, GemmConfig,
                                  MeasuredCUDABackend, sample_gemm_dims)
    from repro_torch.kernels import ops

    tuner = AdsalaTuner.from_artifact(str(art))
    limit = MEM_LIMIT_MB * 2 ** 20
    cube = largest_cube(limit)
    held = sample_gemm_dims(HELD_OUT, mem_limit_bytes=limit, dtype_bytes=4,
                            seed=1, log_space=False)
    shapes = [tuple(int(x) for x in d) for d in held] + [
        (LARGE_CUBE,) * 3, (cube,) * 3]
    gen = torch.Generator(device="cuda").manual_seed(4)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def operands(r, m, k, n):
        """The operands the install's backend builds for sample (m, k, n):
        gemm A (m, k), B (k, n); syrk A (m, k); trsm L (m, m), B (m, n)."""
        if r == "gemm":
            return rand(m, k), rand(k, n)
        if r == "syrk":
            return (rand(m, k),)
        ell = rand(m, m).tril_()
        ell.diagonal().copy_(ell.diagonal().abs() + m)
        return ell, rand(m, n)

    def dispatch(r, m, k, n):
        return {"gemm": (m, k, n), "syrk": (m, k, m), "trsm": (m, m, n)}[r]

    entry = {"gemm": ops.matmul, "syrk": ops.syrk, "trsm": ops.trsm}

    def pick(r, m, k, n) -> GemmConfig:
        return tuner.select(*dispatch(r, m, k, n),
                            ops.supported_routine(r, tuner))

    # -- the main path: tuned calls, launches counted -----------------------
    M.matmul_cuda.launches = 0
    fa.flash_attention_cuda.launches = 0
    G.grouped_matmul_cuda.launches = 0
    expected, checked = 0, 0
    picks: dict[str, list[int]] = {r: [] for r in ROUTINES3}
    errs: dict[str, float] = {}
    t0 = time.perf_counter()
    for r in ROUTINES3:
        fn = entry[r]
        tol = TRSM_TOL if r == "trsm" else RANDOM_TOL
        for m, k, n in shapes:
            args = operands(r, m, k, n)
            out = fn(*args, tuner=tuner)
            cfg = pick(r, m, k, n)
            picks[r].append(cfg.tile_id)
            expected += -(-m // cfg.tile[0]) - 1 if r == "trsm" else 1
            want_shape = (m, m) if r == "syrk" else (m, n)
            if tuple(out.shape) != want_shape or \
                    not bool(torch.isfinite(out).all()):
                raise SystemExit(f"[chip_smoke] FAIL tuned {r} {m}x{k}x{n}:"
                                 f" shape {tuple(out.shape)} or non-finite")
            if max(out.numel(), args[0].numel()) <= CHECK_ELEMS:
                want = fn(*args, tile=cfg.tile, backend="torch")
                check_close(f"tuned_{r}_{m}x{k}x{n}", out, want, tol, torch,
                            errs, normwise=True)
                checked += 1
            del args, out
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = M.matmul_cuda.launches
    flash_launches = fa.flash_attention_cuda.launches
    print(f"[chip_smoke] tuned loop: {len(shapes)} shapes x "
          f"{len(ROUTINES3)} routines in {main_s:.1f}s ({checked} outputs "
          f"checked against the plain path); matmul kernel launches="
          f"{launches} (expected {expected}), flash launches="
          f"{flash_launches}, grouped launches="
          f"{G.grouped_matmul_cuda.launches}")
    if launches != expected:
        raise SystemExit("[chip_smoke] FAIL: the tuned loop's GEMM launches "
                         "differ from the count its calls imply")
    torch.cuda.empty_cache()

    # -- every installed tile timed: tuned pick vs default vs best ----------
    truth = MeasuredCUDABackend(repeats=3, warmup=1, seed=1)
    routines = {}
    col = {t: i for i, t in enumerate(INSTALL_TILES)}
    for r in ROUTINES3:
        t = np.array([[truth.time_routine(m, k, n, GemmConfig(1, "M", tid),
                                          routine=r)
                       for tid in INSTALL_TILES] for m, k, n in shapes])
        idx = np.arange(len(shapes))
        tuned = t[idx, [col[p] for p in picks[r]]]
        default = t[:, col[DEFAULT_TILE_ID]]
        best = t.min(axis=1)
        routines[r] = {
            "shapes": len(shapes),
            "tuned_s": float(tuned.sum()), "default_s": float(default.sum()),
            "best_s": float(best.sum()),
            "speedup_vs_default": float(default.sum() / tuned.sum()),
            "regret_vs_best": float(tuned.sum() / best.sum() - 1.0),
            "mean_speedup_vs_default": float(np.mean(default / tuned)),
            "mean_regret_vs_best": float(np.mean(tuned / best - 1.0)),
            "picks": {str(tid): picks[r].count(tid) for tid in INSTALL_TILES},
            "best": {str(tid): int((t.argmin(axis=1) == col[tid]).sum())
                     for tid in INSTALL_TILES},
            "tile_s": {str(tid): float(t[:, col[tid]].sum())
                       for tid in INSTALL_TILES},
        }
        print(f"[chip_smoke] {r}: tuned {tuned.sum() * 1e3:.3f} ms vs "
              f"default tile {DEFAULT_TILE_ID} {default.sum() * 1e3:.3f} ms "
              f"(x{routines[r]['speedup_vs_default']:.3f}), best installed "
              f"{best.sum() * 1e3:.3f} ms (regret "
              f"{routines[r]['regret_vs_best']:.3%}); picks "
              f"{routines[r]['picks']}, best {routines[r]['best']}; ms by "
              "tile " + json.dumps({k: round(v * 1e3, 3) for k, v in
                                    routines[r]["tile_s"].items()}))
    del truth
    torch.cuda.empty_cache()

    # -- 2048^3 and the largest cube: kernel, plain, library, bound ---------
    gemm_shapes: dict[str, dict] = {}
    for r in ROUTINES3:
        routines[r]["large"] = {}
        for d in (LARGE_CUBE, cube):
            args = operands(r, d, d, d)
            tile = pick(r, d, d, d).tile
            if r == "gemm":
                a, b = args
                bound = gemm_bound_ms(d, d, d)
                lib = lambda: torch.matmul(a, b)              # noqa: E731
            elif r == "syrk":
                a, = args
                bound = syrk_bound_ms(d, d)
                lib = lambda: torch.matmul(a, a.T)            # noqa: E731
            else:
                ell, b = args
                bound = trsm_bound_ms(d, d)
                lib = lambda: torch.linalg.solve_triangular(  # noqa: E731
                    ell, b, upper=False)
            fn = entry[r]
            row = {
                "tile": list(tile),
                "ms": cuda_ms(lambda: fn(*args, tile=tile, backend="cuda"),
                              iters=5, warmup=1),
                "plain_ms": cuda_ms(lambda: fn(*args, tile=tile,
                                               backend="torch"),
                                    iters=5, warmup=1),
                "library_ms": cuda_ms(lib, iters=5, warmup=1),
                "bound_ms": bound[0], "bound_by": bound[1]}
            routines[r]["large"][str(d)] = row
            print(f"[chip_smoke] {r} {d}^3 tile {tile}: kernel path "
                  f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
                  f"library {row['library_ms']:.3f} ms, bound "
                  f"{row['bound_ms']:.3f} ms ({row['bound_by']})")
            if r == "gemm":
                bm, bk, bn = tile
                got = M.matmul_cuda(a, b, bm=bm, bk=bk, bn=bn)
                check_close(f"path_{d}", got, M.matmul_torch(
                    a, b, bm=bm, bk=bk, bn=bn), RANDOM_TOL, torch, errs,
                    normwise=True)
                del got
                cta_m, cta_n, k_step, stages, gm_, gn_ = M.launch_shape(
                    bm, bk, bn)
                gemm_shapes[f"gemm_{d}"] = {
                    "shape": [d, d, d], "tile": list(tile),
                    "variant": "tiled", "stages": stages, "splits": 1,
                    "cta": [cta_m, cta_n], "k_step": k_step,
                    "group": [gm_, gn_],
                    "max_abs_err": errs[f"path_{d}"],
                    **{k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")}}
            if r == "gemm" and d == LARGE_CUBE:
                gemm_shapes[f"gemm_{d}"]["ms_by_tile"] = {str(i): cuda_ms(
                    lambda t=t: M.matmul_cuda(a, b, bm=t[0], bk=t[1],
                                              bn=t[2]), iters=5, warmup=1)
                    for i, t in enumerate(DEFAULT_TILES)}
            del args
            torch.cuda.empty_cache()
    adsala = {"held_out": {"per_routine": HELD_OUT, "seed": 1,
                           "extra_cubes": [LARGE_CUBE, cube]},
              "main_path": {"seconds": main_s, "matmul_launches": launches,
                            "expected_launches": expected,
                            "flash_launches": flash_launches,
                            "outputs_checked": checked},
              "routines": routines}
    return adsala, {"launches": launches, "shapes": gemm_shapes}


def grouped_bound_ms(e: int, c: int, d: int, f: int) -> tuple[float, str]:
    """Least time for an fp32 grouped GEMM: 2ecdf flops at the CUDA-core
    rate against X, W read and Y written once at the HBM rate."""
    return _bound(2.0 * e * c * d * f, 4.0 * e * (c * d + d * f + c * f))


def phase_mixtral(art: Path, M, fa, G, torch) -> tuple[dict, dict]:
    """Phase 8: serve mixtral-8x22b (full width, MIX_LAYERS layers, fp32)
    through the port's serving code; count the grouped and flash
    launches; check against the plain path; time the grouped kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.params import tree_map
    from repro_torch.train.step import make_ctx

    cfg = dataclasses.replace(get_config(MIX_ARCH), n_layers=MIX_LAYERS)
    args = serve.parse_args([
        "--requests", str(REQUESTS), "--prompt-len", str(PROMPT_LEN),
        "--gen-tokens", str(GEN_TOKENS), "--artifact", str(art),
        "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    G.grouped_matmul_cuda.launches = 0
    G.grouped_matmul_cuda.launches_by_variant = {"thin": 0, "tiled": 0}
    fa.flash_attention_cuda.launches = 0
    M.matmul_cuda.launches = 0
    res = serve.serve_config(cfg, args)
    launches = G.grouped_matmul_cuda.launches
    by_variant = dict(G.grouped_matmul_cuda.launches_by_variant)
    flash_launches = fa.flash_attention_cuda.launches
    gemm_launches = M.matmul_cuda.launches
    moe_layers = sum(s.mlp == "moe" for s in res.model.plan)
    # one prefill and GEN_TOKENS - 1 decode steps, 3 expert GEMMs a layer
    want = 3 * moe_layers * GEN_TOKENS
    sizes: list[int] = []
    tree_map(lambda t: sizes.append(t.numel()), res.params)
    n_params = sum(sizes)
    print(f"[chip_smoke] mixtral: {cfg.n_layers} layers x d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k} x "
          f"d_ff {cfg.d_ff_expert}, window {cfg.window}: "
          f"{n_params / 1e9:.3f} B parameters (fp32)")
    print(f"[chip_smoke] mixtral serve: grouped kernel launches={launches} "
          f"(expected 3 x {moe_layers} MoE layers x (1 prefill + "
          f"{GEN_TOKENS - 1} decode steps) = {want}), flash launches="
          f"{flash_launches} (expected {cfg.n_layers}), matmul launches="
          f"{gemm_launches} (the projections go to torch.matmul)")
    # prefill buckets are tiled, decode buckets (8 rows) stream
    want_variant = {"tiled": 3 * moe_layers,
                    "thin": 3 * moe_layers * (GEN_TOKENS - 1)}
    print(f"[chip_smoke] mixtral serve: grouped launches by body "
          f"{by_variant} (expected {want_variant})")
    if launches != want or flash_launches != cfg.n_layers or \
            by_variant != want_variant:
        raise SystemExit("[chip_smoke] FAIL: the mixtral path did not run "
                         "the grouped kernel 3 times per MoE layer per "
                         "forward (tiled in prefill, thin in decode) and "
                         "the flash kernel once per layer")
    if not torch.isfinite(res.prefill_logits).all():
        raise SystemExit("[chip_smoke] FAIL: non-finite mixtral logits")
    if tuple(res.tokens.shape) != (REQUESTS, GEN_TOKENS):
        raise SystemExit(f"[chip_smoke] FAIL: generated {res.tokens.shape}")

    ctx = make_ctx("prefill", cache_len=PROMPT_LEN + GEN_TOKENS,
                   tuner=res.tuner)

    def prefill_k():
        return res.model.prefill(res.params, res.prompts, ctx)[0]

    def prefill_t():
        os.environ["ADSALA_BACKEND"] = "torch"
        try:
            return res.model.prefill(res.params, res.prompts, ctx)[0]
        finally:
            del os.environ["ADSALA_BACKEND"]

    with torch.inference_mode():
        logits_t = prefill_t()
        lerr = (logits_t - res.prefill_logits).abs().max().item()
        lscale = res.prefill_logits.abs().max().item()
        same_tok = torch.equal(logits_t.argmax(-1),
                               res.prefill_logits.argmax(-1))
        print(f"[chip_smoke] mixtral prefill logits kernel vs plain: "
              f"max_abs_err={lerr:.3e} (max |logit| {lscale:.3f}, tol "
              f"{LOGITS_TOL:g}), same greedy token: {same_tok}")
        if not (lerr <= LOGITS_TOL and same_tok):
            raise SystemExit("[chip_smoke] FAIL: mixtral kernel and plain "
                             "prefill disagree")
        del logits_t
        warm_k = cuda_ms(prefill_k, iters=2, warmup=1)
        warm_t = cuda_ms(prefill_t, iters=2, warmup=1)
        _, cache = res.model.prefill(res.params, res.prompts, ctx)
        dctx = make_ctx("decode", cache_len=PROMPT_LEN + GEN_TOKENS,
                        tuner=res.tuner)
        steps = iter(range(10 ** 6))

        def decode():
            pos = PROMPT_LEN + next(steps) % (GEN_TOKENS - 1)
            res.model.decode_step(res.params, res.tokens[:, :1], cache, pos,
                                  dctx)

        warm_d = cuda_ms(decode, iters=5, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    print(f"[chip_smoke] mixtral warm prefill ({REQUESTS}x{PROMPT_LEN}): "
          f"kernel path {warm_k:.1f} ms, plain path {warm_t:.1f} ms; warm "
          f"decode step {warm_d:.2f} ms ({REQUESTS / warm_d * 1e3:.1f} "
          f"tok/s); first call prefill {res.prefill_s * 1e3:.1f} ms, "
          f"decode {res.tok_per_s:.1f} tok/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    tuner = res.tuner
    mixtral = {"arch": MIX_ARCH, "n_layers": cfg.n_layers,
               "dtype": "float32", "parameters": n_params,
               "requests": REQUESTS, "prompt_len": PROMPT_LEN,
               "gen_tokens": GEN_TOKENS, "grouped_launches": launches,
               "expected_grouped_launches": want,
               "grouped_launches_by_variant": by_variant,
               "flash_launches": flash_launches,
               "matmul_launches": gemm_launches,
               "logits_max_abs_err": lerr,
               "first_prefill_ms": res.prefill_s * 1e3,
               "first_decode_tok_per_s": res.tok_per_s,
               "warm_prefill_ms": warm_k, "warm_prefill_plain_ms": warm_t,
               "warm_decode_step_ms": warm_d,
               "max_memory_allocated": peak}
    del res, cache, ctx, dctx
    torch.cuda.empty_cache()

    # -- the kernel at the path's bucket shapes and deepseek-v2's ----------
    gen = torch.Generator(device="cuda").manual_seed(6)
    errs: dict[str, float] = {}
    shapes = {}
    for name, e, c, d, f in GROUPED_SHAPES:
        x = torch.randn((e, c, d), generator=gen, device="cuda")
        w = torch.randn((e, d, f), generator=gen, device="cuda")
        tile = tuner.select(c, d, f).tile
        bm, bk, bn = tile
        plan = G.grouped_launch(e, c, d, f, bm, bk, bn)
        check_close(name, G.grouped_matmul_cuda(x, w, bm=bm, bk=bk, bn=bn),
                    G.grouped_matmul_torch(x, w, bm=bm, bk=bk, bn=bn),
                    RANDOM_TOL, torch, errs, normwise=True, kind="grouped")
        bound, bound_by = grouped_bound_ms(e, c, d, f)
        row = {
            "shape": [e, c, d, f], "tile": list(tile),
            "variant": plan.variant, "stages": plan.stages,
            "splits": plan.splits, "cta": [plan.cta_m, plan.cta_n],
            "k_step": plan.k_step, "max_abs_err": errs[name],
            "ms": cuda_ms(lambda: G.grouped_matmul_cuda(
                x, w, bm=bm, bk=bk, bn=bn), iters=3, warmup=1),
            "plain_ms": cuda_ms(lambda: G.grouped_matmul_torch(
                x, w, bm=bm, bk=bk, bn=bn), iters=3, warmup=1),
            "library_ms": cuda_ms(lambda: torch.bmm(x, w), iters=3,
                                  warmup=1),
            "bound_ms": bound, "bound_by": bound_by}
        shapes[name] = row
        print(f"[chip_smoke] grouped {name} {e}x{c}x{d}x{f} tile {tile} "
              f"({plan.variant}, CTA {plan.cta_m}x{plan.cta_n}, K step "
              f"{plan.k_step}, {plan.stages} stages, {plan.splits} "
              f"splits): kernel {row['ms']:.3f} ms, plain "
              f"{row['plain_ms']:.3f} ms, "
              f"torch.bmm {row['library_ms']:.3f} ms, bound "
              f"{bound:.3f} ms ({bound_by})")
        del x, w
        torch.cuda.empty_cache()
    # the flash kernel at mixtral's attention shape and the tuner's block
    hd = cfg.resolved_head_dim
    choice = tuner.select(PROMPT_LEN, hd, PROMPT_LEN, "attn")
    mixtral["flash"] = time_flash(
        fa, torch, REQUESTS * cfg.n_heads, PROMPT_LEN, hd,
        *choice.flash_block, choice.flash_grid, cfg.window, seed=7)
    entry = {"launches": launches, "launches_by_variant": by_variant,
             "shapes": shapes}
    return mixtral, entry


def main() -> int:
    try:
        import torch
    except ModuleNotFoundError:
        print("[chip_smoke] torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("[chip_smoke] no CUDA device: nothing to run",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"[chip_smoke] {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    # -- 1. environment ----------------------------------------------------
    card = card_line()
    print(f"[chip_smoke] card: {card}")
    print(f"[chip_smoke] torch {torch.__version__} cuda "
          f"{torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ------------------------------------------------------------
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import matmul as mm

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    took = time.perf_counter() - t0
    print(f"[chip_smoke] build: {lib_path.name} in {took:.1f}s")
    if _build.last_build is not None:
        for name, regs, spills in ptxas_report(_build.last_build[1]):
            print(f"[chip_smoke] ptxas: {name}: {regs} registers, {spills} "
                  "bytes spill stores")

    # -- 3. kernels against plain --------------------------------------------
    errs = phase_kernels(fa, torch)
    gemm_errs = phase_gemm_kernels(mm, ops, torch)
    grouped_errs = phase_grouped_kernels(gm, torch)

    # -- 4. install -------------------------------------------------------------
    art = phase_install(torch)

    # -- 5. serve ----------------------------------------------------------------
    from repro_torch.launch import serve
    from repro_torch.train.step import make_ctx

    argv = ["--arch", ARCH, "--scale", "full", "--requests", str(REQUESTS),
            "--prompt-len", str(PROMPT_LEN), "--gen-tokens",
            str(GEN_TOKENS), "--artifact", str(art), "--device", "cuda"]
    fa.flash_attention_cuda.launches = 0
    mm.matmul_cuda.launches = 0
    gm.grouped_matmul_cuda.launches = 0
    res = serve.run(argv)
    launches = fa.flash_attention_cuda.launches
    print(f"[chip_smoke] serve: matmul kernel launches="
          f"{mm.matmul_cuda.launches} (the projections go to torch.matmul),"
          f" grouped kernel launches={gm.grouped_matmul_cuda.launches} "
          "(no MoE layer)")
    cfg = res.cfg
    want = cfg.n_layers * 1          # one prefill, one launch per layer
    print(f"[chip_smoke] serve: flash kernel launches={launches} "
          f"(expected {cfg.n_layers} layers x 1 prefill = {want})")
    if launches != want:
        raise SystemExit("[chip_smoke] FAIL: the serving path did not run "
                         "the flash kernel once per layer")
    if not torch.isfinite(res.prefill_logits).all():
        raise SystemExit("[chip_smoke] FAIL: non-finite prefill logits")
    if tuple(res.tokens.shape) != (REQUESTS, GEN_TOKENS):
        raise SystemExit(f"[chip_smoke] FAIL: generated {res.tokens.shape}")

    hd = cfg.resolved_head_dim
    choice = res.tuner.select(PROMPT_LEN, hd, PROMPT_LEN, "attn")
    bq, bkv = choice.flash_block
    print(f"[chip_smoke] tuner attn {PROMPT_LEN}x{hd}x{PROMPT_LEN}: "
          f"flash_block={choice.flash_block} "
          f"flash_grid={choice.flash_grid}")
    print(f"[chip_smoke] serve: prefill {res.prefill_s * 1e3:.1f} ms "
          f"(first call), decode {res.tok_per_s:.1f} tok/s")

    ctx = make_ctx("prefill", cache_len=PROMPT_LEN + GEN_TOKENS,
                   tuner=res.tuner)

    def prefill_k():
        return res.model.prefill(res.params, res.prompts, ctx)[0]

    def prefill_t():
        # the same prefill with the kernels' plain versions
        os.environ["ADSALA_BACKEND"] = "torch"
        try:
            return res.model.prefill(res.params, res.prompts, ctx)[0]
        finally:
            del os.environ["ADSALA_BACKEND"]

    with torch.inference_mode():
        logits_t = prefill_t()
        lerr = (logits_t - res.prefill_logits).abs().max().item()
        lscale = res.prefill_logits.abs().max().item()
        same_tok = torch.equal(logits_t.argmax(-1),
                               res.prefill_logits.argmax(-1))
        print(f"[chip_smoke] prefill logits kernel vs plain: "
              f"max_abs_err={lerr:.3e} (max |logit| {lscale:.3f}, "
              f"tol {LOGITS_TOL:g}), same greedy token: {same_tok}")
        if not (lerr <= LOGITS_TOL and same_tok):
            raise SystemExit("[chip_smoke] FAIL: kernel and plain prefill "
                             "disagree")
        warm_k = cuda_ms(prefill_k, iters=3, warmup=1)
        warm_t = cuda_ms(prefill_t, iters=3, warmup=1)
        # warm decode steps on a fresh cache (positions stay inside it)
        _, cache = res.model.prefill(res.params, res.prompts, ctx)
        dctx = make_ctx("decode", cache_len=PROMPT_LEN + GEN_TOKENS,
                        tuner=res.tuner)
        steps = iter(range(10 ** 6))

        def decode():
            pos = PROMPT_LEN + next(steps) % (GEN_TOKENS - 1)
            res.model.decode_step(res.params, res.tokens[:, :1], cache, pos,
                                  dctx)

        warm_d = cuda_ms(decode, iters=10, warmup=2)
    print(f"[chip_smoke] warm prefill ({REQUESTS}x{PROMPT_LEN}): kernel "
          f"path {warm_k:.1f} ms, plain path {warm_t:.1f} ms; warm decode "
          f"step {warm_d:.2f} ms ({REQUESTS / warm_d * 1e3:.1f} tok/s)")

    # the kernel at the serving path's shape and the tuner's config
    flash_row = time_flash(fa, torch, REQUESTS * cfg.n_heads, PROMPT_LEN,
                           hd, bq, bkv, choice.flash_grid, None, seed=1)

    # -- 6. measured install ----------------------------------------------------
    del res, cache, ctx, dctx, logits_t
    torch.cuda.empty_cache()
    measured_art, install_info = phase_measured_install(torch)

    # -- 7. tuned loop -------------------------------------------------------------
    adsala, gemm_entry = phase_tuned_loop(measured_art, mm, fa, gm, torch)
    adsala["install"] = install_info

    # -- 8. mixtral ------------------------------------------------------------------
    mixtral, grouped_entry = phase_mixtral(art, mm, fa, gm, torch)

    # -- 9. report ---------------------------------------------------------------
    kernels = [flash_entry("flash_attention", flash_row, launches,
                           case_max_abs_err=errs),
               flash_entry("flash_attention@mixtral_prefill",
                           mixtral["flash"], mixtral["flash_launches"])]
    # one entry per measured shape: the tiled GEMM at 2048^3 (the main
    # entry) and the largest cube, the grouped kernel at mixtral's decode
    # bucket (the main entry: 180 of its 192 launches) and prefill bucket
    # and at deepseek-v2's experts
    for name, source, replaces, entry, errs_, main in (
            ("matmul", "matmul.cu", "src/repro/kernels/matmul.py:57",
             gemm_entry, gemm_errs, f"gemm_{LARGE_CUBE}"),
            ("grouped_matmul", "grouped_matmul.cu",
             "src/repro/kernels/grouped_matmul.py:51", grouped_entry,
             grouped_errs, "mixtral_decode")):
        order = [main] + [k for k in entry["shapes"] if k != main]
        for key in order:
            row = entry["shapes"][key]
            kernels.append({
                "name": name if key == main else f"{name}@{key}",
                "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces,
                "launches": entry["launches"],
                **{k: row[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "variant", "stages", "splits", "shape",
                    "tile")},
                "dtype": "float32",
                **({"launches_by_variant": entry["launches_by_variant"]}
                   if "launches_by_variant" in entry else {}),
                **({"case_max_abs_err": errs_} if key == main else {}),
                **{k: v for k, v in row.items()
                   if k in ("cta", "k_step", "group", "ms_by_tile")}})
    print(json.dumps({"adsala": adsala}))
    print(json.dumps({"mixtral": mixtral}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
