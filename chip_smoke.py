#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (written for the H100) and
check it against its plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. environment: the card's name and power limit; TF32 off;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel);
3. kernels against plain: the flash-attention kernel in both KV walks
   against its plain PyTorch version on causal, windowed, non-causal,
   padded ragged, fully masked, GQA-broadcast and bf16 cases and at the
   serving path's shape (dense and tri must be bitwise equal); then the
   GEMM kernel against its plain version on the reference's matmul
   cases in fp32 and bf16, ragged shapes, every DEFAULT_TILES entry, a
   transposed-B view, syrk and trsm;
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
8. report: one ``{"adsala": {...}}`` line, one ``{"kernels": [...]}``
   line, the card's line, and the ``{"ok": true, ...}`` last line.

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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


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
    ]
    errs = {}
    for (name, bh, sq, skv, d, dt, causal, window, bq, bkv) in cases:
        q, k, v = rand(bh, sq, d, dtype=dt), rand(bh, skv, d, dtype=dt), \
            rand(bh, skv, d, dtype=dt)
        kw = dict(bq=bq, bkv=bkv, causal=causal, window=window)
        want = fa.flash_attention_torch(q, k, v, **kw)
        got = {g: fa.flash_attention_cuda(q, k, v, grid=g, **kw)
               for g in fa.FLASH_GRID_KINDS}
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
    torch.cuda.synchronize()
    check_case("gqa_broadcast", got, want, f32, torch, errs)
    return errs


def check_case(name, got, want, dt, torch, errs) -> None:
    tol = TOL[str(dt).split(".")[-1]]
    if not torch.equal(got["dense"], got["tri"]):
        raise SystemExit(f"[chip_smoke] FAIL {name}: dense and tri "
                         "outputs are not bitwise equal")
    err = (got["tri"].float() - want.float()).abs().max().item()
    bad = ~torch.isclose(got["tri"].float(), want.float(), atol=tol,
                         rtol=tol)
    errs[name] = err
    print(f"[chip_smoke] kernel {name:24s} {str(dt):15s} "
          f"max_abs_err={err:.3e} tol={tol:g} dense==tri bitwise")
    if bool(bad.any()) or not torch.isfinite(got["tri"]).all():
        raise SystemExit(f"[chip_smoke] FAIL {name}: kernel disagrees "
                         f"with the plain version (max_abs_err={err:.3e}, "
                         f"tol={tol:g})")


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


def check_close(name, got, want, tol, torch, errs, *, normwise=False):
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
    print(f"[chip_smoke] gemm {name:30s} {str(got.dtype):15s} "
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


def phase_tuned_loop(art: Path, M, fa, torch) -> tuple[dict, dict]:
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
          f"{flash_launches}")
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
        }
        print(f"[chip_smoke] {r}: tuned {tuned.sum() * 1e3:.3f} ms vs "
              f"default tile {DEFAULT_TILE_ID} {default.sum() * 1e3:.3f} ms "
              f"(x{routines[r]['speedup_vs_default']:.3f}), best installed "
              f"{best.sum() * 1e3:.3f} ms (regret "
              f"{routines[r]['regret_vs_best']:.3%}); picks "
              f"{routines[r]['picks']}, best {routines[r]['best']}")
    del truth
    torch.cuda.empty_cache()

    # -- 2048^3 and the largest cube: kernel, plain, library, bound ---------
    gemm_entry = {}
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
            if r == "gemm" and d == LARGE_CUBE:
                bm, bk, bn = tile
                got = M.matmul_cuda(a, b, bm=bm, bk=bk, bn=bn)
                check_close("path", got, M.matmul_torch(
                    a, b, bm=bm, bk=bk, bn=bn), RANDOM_TOL, torch, errs,
                    normwise=True)
                gemm_entry = {
                    "shape": [d, d, d], "tile": list(tile),
                    "max_abs_err": errs["path"],
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "library_ms": row["library_ms"],
                    "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                    "ms_by_tile": {str(i): cuda_ms(
                        lambda t=t: M.matmul_cuda(a, b, bm=t[0], bk=t[1],
                                                  bn=t[2]), iters=5, warmup=1)
                        for i, t in enumerate(DEFAULT_TILES)}}
            del args
            torch.cuda.empty_cache()
    adsala = {"held_out": {"per_routine": HELD_OUT, "seed": 1,
                           "extra_cubes": [LARGE_CUBE, cube]},
              "main_path": {"seconds": main_s, "matmul_launches": launches,
                            "expected_launches": expected,
                            "flash_launches": flash_launches,
                            "outputs_checked": checked},
              "routines": routines}
    gemm_entry["launches"] = launches
    return adsala, gemm_entry


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
    from repro_torch.kernels import matmul as mm

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    took = time.perf_counter() - t0
    print(f"[chip_smoke] build: {lib_path.name} in {took:.1f}s")
    if _build.last_build is not None:
        for line in _build.last_build[1].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[chip_smoke] ptxas: {line.strip()}")

    # -- 3. kernels against plain --------------------------------------------
    errs = phase_kernels(fa, torch)
    gemm_errs = phase_gemm_kernels(mm, ops, torch)

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
    res = serve.run(argv)
    launches = fa.flash_attention_cuda.launches
    print(f"[chip_smoke] serve: matmul kernel launches="
          f"{mm.matmul_cuda.launches} (the projections go to torch.matmul)")
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
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (REQUESTS * cfg.n_heads, PROMPT_LEN, hd)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    kw = dict(bq=bq, bkv=bkv, causal=True)
    got = fa.flash_attention_cuda(q, k, v, grid=choice.flash_grid, **kw)
    ref = fa.flash_attention_torch(q, k, v, **kw)
    path_err = (got - ref).abs().max().item()
    if not torch.allclose(got, ref, atol=TOL["float32"],
                          rtol=TOL["float32"]):
        raise SystemExit("[chip_smoke] FAIL: kernel disagrees at the "
                         f"serving path's shape ({path_err:.3e})")
    times = {g: cuda_ms(lambda g=g: fa.flash_attention_cuda(
        q, k, v, grid=g, **kw)) for g in fa.FLASH_GRID_KINDS}
    plain_ms = cuda_ms(lambda: fa.flash_attention_torch(q, k, v, **kw))
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.
                      scaled_dot_product_attention(q, k, v, is_causal=True))
    bound_ms, bound_by = flash_bound_ms(shape[0], PROMPT_LEN,
                                        PROMPT_LEN, hd, True, 4)
    print(f"[chip_smoke] flash {shape} fp32 causal block ({bq},{bkv}): "
          f"dense {times['dense']:.3f} ms, tri {times['tri']:.3f} ms, "
          f"plain {plain_ms:.3f} ms, sdpa {sdpa_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}), max_abs_err {path_err:.3e}")

    # -- 6. measured install ----------------------------------------------------
    del res, cache, ctx, dctx, logits_t, q, k, v, got, ref
    torch.cuda.empty_cache()
    measured_art, install_info = phase_measured_install(torch)

    # -- 7. tuned loop -------------------------------------------------------------
    adsala, gemm_entry = phase_tuned_loop(measured_art, mm, fa, torch)
    adsala["install"] = install_info

    # -- 8. report ---------------------------------------------------------------
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:244",
        "launches": launches,
        "max_abs_err": path_err,
        "ms": times[choice.flash_grid],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": sdpa_ms,
        "grid": choice.flash_grid,
        "block": [bq, bkv],
        "shape": list(shape),
        "dtype": "float32",
        "ms_by_grid": times,
        "case_max_abs_err": errs,
    }, {
        "name": "matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:57",
        "launches": gemm_entry["launches"],
        "max_abs_err": gemm_entry["max_abs_err"],
        "ms": gemm_entry["ms"],
        "plain_ms": gemm_entry["plain_ms"],
        "bound_ms": gemm_entry["bound_ms"],
        "bound_by": gemm_entry["bound_by"],
        "library_ms": gemm_entry["library_ms"],
        "shape": gemm_entry["shape"],
        "dtype": "float32",
        "tile": gemm_entry["tile"],
        "ms_by_tile": gemm_entry["ms_by_tile"],
        "case_max_abs_err": gemm_errs,
    }]
    print(json.dumps({"adsala": adsala}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
