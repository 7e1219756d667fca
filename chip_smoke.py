#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (written for the H100) and
check it against its plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. environment: the card's name and power limit; TF32 off;
2. build: compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernel against plain: the flash-attention kernel in both KV walks
   against its plain PyTorch version on causal, windowed, non-causal,
   padded ragged, GQA-broadcast and bf16 cases and at the serving
   path's shape; dense and tri must be bitwise equal;
4. install: a small ADSALA artifact on the simulated backend;
5. serve: stablelm-1.6b at full width through ``repro_torch.launch.serve``
   with that artifact; the kernel's launch count must be one per layer
   per prefill, the logits finite, and the same prefill on the plain
   backend must agree;
6. report: one ``{"kernels": [...]}`` line, the card's line, and the
   ``{"ok": true, ...}`` last line.

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
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    took = time.perf_counter() - t0
    print(f"[chip_smoke] build: {lib_path.name} in {took:.1f}s")
    if _build.last_build is not None:
        for line in _build.last_build[1].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[chip_smoke] ptxas: {line.strip()}")

    # -- 3. kernel against plain ----------------------------------------------
    errs = phase_kernels(fa, torch)

    # -- 4. install -------------------------------------------------------------
    art = phase_install(torch)

    # -- 5. serve ----------------------------------------------------------------
    from repro_torch.launch import serve
    from repro_torch.train.step import make_ctx

    argv = ["--arch", ARCH, "--scale", "full", "--requests", str(REQUESTS),
            "--prompt-len", str(PROMPT_LEN), "--gen-tokens",
            str(GEN_TOKENS), "--artifact", str(art), "--device", "cuda"]
    fa.flash_attention_cuda.launches = 0
    res = serve.run(argv)
    launches = fa.flash_attention_cuda.launches
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

    # -- 6. report ---------------------------------------------------------------
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
    }]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
