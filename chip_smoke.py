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
   dim (16 to 256) in both dtypes, rows not a multiple of the CTA's, fewer CTA rows
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
   ``torch.bmm`` at mixtral's prefill and decode buckets, and the flash
   kernel against its plain
   version and SDPA at mixtral's attention shape (192, 1024, 128) with
   the tuner's block;
9. queue: stablelm-1.6b at full width served as a ragged trace of 8
   requests through ``launch.serve --queue`` (continuous batching over
   a paged KV pool, 4 slots, pages of 16 tokens), untuned; the flash
   kernel's launch count must be one per layer per admitted request,
   the allocator clean at the end, and every request must decode like
   the fixed-batch path at batch 1 (logits within ``LOGITS_TOL`` at
   every step; a token may differ only where the fixed-batch top-2
   logit gap is below that tolerance); a warm decode step of 4 slots
   on the page pools against the fixed-batch contiguous caches of the
   same span, in turns (shown, not checked); then the flash kernel at
   the trace's longest prefill with the untuned block and tri walk the
   trace ran;
10. closed loop: a serving profile recorded from the smoke config on
   the card, a measured install weighted by it (``launch.profile
   --install --backend measured``, the port's kernels timed by
   ``MeasuredCUDABackend``), then the full-width trace served with
   ``--queue --reinstall``: the drift must cross the threshold, the
   background re-install must run on the card's backend, fire, swap
   and end without error, and the allocator must be clean; decode
   steps are timed while the install runs and after it;
11. train: stablelm-1.6b trained on the card on the ``library``
   backend (no kernel has a backward; no kernel counter may move):
   (a) full width cut to 2 layers, one ``build_train_step`` step on
   the card and the same step on the CPU from the same seeded weights
   and batch (1 x 512: the SYRK-scores attention) — loss, grad norm,
   every gradient and the updated parameters within the CPU tests'
   tolerances; (b) full width and depth through ``launch.train --scale
   full --batch 4 --seq 1024 --steps 8`` (the chunked attention): 8
   finite losses, the last two below the first on average, step ms,
   tokens/s, the step's share of the fp32 peak, peak memory and the
   final checkpoint's GB and seconds;
   (c) that checkpoint restored onto the card equals the state in
   memory bit for bit; (d) ``--resume`` at the smoke scale continues
   at the saved step;
12. deepseek and int8: after checking that at most 2 GiB is still
   allocated, (a) deepseek-v2-236b at full width cut to 4 layers (the
   dense first layer and 3 MoE layers, fp32, 53.2 GB) through
   ``serve.serve_config`` with the phase-4 artifact: MLA on the chunked
   attention and the latent cache, the grouped kernel's launch count 3
   per MoE layer per forward (9 tiled, 135 thin), no flash or GEMM
   launch, finite logits, the plain backend's prefill and first decode
   step agreeing; warm prefill and decode step, peak memory, the latent
   cache's bytes a token; (b) the same model and weights through the
   continuous-batching scheduler over latent page pools (6 ragged
   requests up to the fixed batch's lengths, 2 slots, pages of 16): the
   grouped launches the prefills and steps imply, a clean allocator,
   every request decoding like the fixed batch at batch 1 (phase 9's
   rule); (c) the grouped kernel against its plain version and
   ``torch.bmm`` at deepseek's four buckets, prefill (160, 192, 5120,
   1536) and (160, 192, 1536, 5120), decode (160, 8, 5120, 1536) and
   (160, 8, 1536, 5120); (d) stablelm-1.6b at
   full width and depth through the launcher with ``ADSALA_KV_INT8=1``
   (the int8 KV cache), then fp32 and int8 caches fed the fp32 path's
   greedy tokens: max |dlogit| / max |logit| below 0.03 at every step,
   24 flash launches a prefill, the caches' bytes, warm decode steps
   of the two caches in turns and a profiler trace of each;
13. the remaining families, after the same 2 GiB check, each at full
   width through ``serve.serve_config`` with the phase-4 artifact (4 x
   1024 + 16 unless said): (a) recurrentgemma-2b whole (26 layers,
   13.3 GB): 8 flash launches (its local MQA layers, head dim 256,
   window 2048); (b) the same weights on one request of 3072 tokens
   (the window masks, the ring wraps when it is seeded): 8 launches;
   (c) xlstm-125m whole: no launch, and the card's logits against the
   same model on the CPU; (d) whisper-tiny whole (4 x 64 + 16, 1500
   frames): 8 launches, 4 unmasked encoder and 4 causal decoder; (e)
   chameleon-34b cut to 8 of 48 layers (qk-norm, 26.4 GB): 8 launches.
   In (a), (b), (d) and (e) the kernel path against the plain path:
   prefill and first decode step logits within ``FAMILY_TOL``, the
   same greedy tokens; warm prefill, decode step and peak memory of
   each; then the flash kernel at recurrentgemma's two attention shapes
   against its plain version and SDPA;
14. the four families trained, after the same 2 GiB check, on the
   ``library`` backend (no kernel counter may move): (a) full width,
   depth cut (recurrentgemma-2b's first unit of 3 layers, xlstm-125m's
   first 2, whisper-tiny whole at 1 x 448 + 1500 frames, chameleon-34b
   1 layer; 1 x 512 otherwise), card against CPU with phase 11's bounds,
   a leaf under ``NOISE_FRACTION`` of the gradient compared only inside
   the whole gradient vector; (b) full width through
   ``launch.train.train_config``, 6 steps of 4 x 1024 (whisper 4 x 448):
   recurrentgemma-2b and xlstm-125m whole, whisper-tiny whole,
   chameleon-34b cut to 2 of 48 layers (at a learning rate scaled to its
   width, ``FAM_TRAIN``), each after checking the disk
   holds 1.2 x its final checkpoint: finite losses, the last two below
   the first on average, step times, tokens/s, peak memory, the
   checkpoint's GB and seconds, and the step's share of the fp32 peak
   (``roofline.step_flops`` over the median of steps 3–6, as phase 11's
   stablelm run); (c) whisper-tiny's ``--resume`` at the smoke scale;
15. report: one ``{"adsala": {...}}`` line, one ``{"mixtral": {...}}``
   line, one ``{"deepseek": {...}}`` line, one ``{"serving": {...}}``
   line, one ``{"train": {...}}`` line, one ``{"families": {...}}``
   line, one ``{"train_families": {...}}`` line, one ``{"kernels": [...]}``
   line (one entry per measured shape:
   flash attention at stablelm's, mixtral's and recurrentgemma's
   prefill shapes, recurrentgemma's long request and at
   the queue trace's longest prefill, each with
   its launch plan; the GEMM at 2048^3 and the largest cube; the grouped
   GEMM at mixtral's decode and prefill buckets and deepseek-v2's
   four buckets; each with its body, ring stages and split
   count), the card's line, and the ``{"ok": true, ...}`` last line.

Exits non-zero without a result when no CUDA device is present or when
the repository's ``src/repro_torch`` is not beside this file.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
WORK = ROOT / "build" / "chip_smoke"

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

#: the continuous-batching trace (phases 9 and 10): requests with
#: prompt lengths in [QUEUE_PROMPT // 4, QUEUE_PROMPT] and outputs in
#: [QUEUE_GEN // 4, QUEUE_GEN], drawn by the launcher from
#: numpy.random.default_rng(1), over a pool of 2 x slots x the worst
#: case's pages
QUEUE_REQUESTS, QUEUE_PROMPT, QUEUE_GEN = 8, 1024, 32
QUEUE_SLOTS, QUEUE_PAGE = 4, 16
#: the closed loop: the smoke serving run whose profile weights the
#: measured install, that install's budget, the re-install's budget
#: and the drift threshold (the reference launcher's default)
LOOP_PROFILE_ARGS = ["--requests", "4", "--prompt-len", "64",
                     "--gen-tokens", "8"]
LOOP_SAMPLES, LOOP_BUDGET, REINSTALL_BUDGET = 48, 160, 160
REINSTALL_THRESHOLD = 0.25

#: phase 11: the card-against-CPU step (full width, depth cut, batch x
#: length; 512 takes the SYRK-scores attention) and the full-depth run
#: through the launcher (1024 takes the chunked attention)
TRAIN_CMP_LAYERS, TRAIN_CMP_BATCH, TRAIN_CMP_SEQ = 2, 1, 512
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
#: card vs CPU within the CPU tests' tolerances (tests/test_torch_train.py:
#: loss and grad norm relative, each gradient normwise, the updated
#: parameters normwise as one vector)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_PARAM_TOL = 1e-5, 1e-4, 1e-5

#: mixtral-8x22b at full width, depth cut to fit one card in fp32
MIX_ARCH, MIX_LAYERS = "mixtral-8x22b", 4
#: the reference's grouped cases (tests/test_kernels.py), tile 32
GROUPED_CASES = [(4, 64, 32, 48), (2, 100, 64, 64), (8, 16, 16, 96)]
#: thin buckets (C <= 16: the weight-streaming body; 17: the tiled one),
#: ragged d and f, and a shape whose planner splits K (E, C, d, f)
SPLIT_CASE = (2, 8, 4096, 300)
THIN_CASES = [(8, 1, 300, 130), (8, 3, 300, 130), (8, 8, 300, 130),
              (8, 16, 300, 130), (8, 17, 300, 130), (4, 8, 257, 513),
              (3, 5, 1000, 3), SPLIT_CASE]
#: grouped GEMM timing shapes (name, E, C, d, f): mixtral's expert
#: buckets in prefill (4 x 1024 tokens) and decode (4 tokens)
GROUPED_SHAPES = [("mixtral_prefill", 8, 1280, 6144, 16384),
                  ("mixtral_decode", 8, 8, 6144, 16384)]

#: phase 12: deepseek-v2-236b at full width, depth cut to the dense first
#: layer and 3 MoE layers (fp32, 53.2 GB of weights)
DS_ARCH, DS_LAYERS = "deepseek-v2-236b", 4
#: the grouped kernel at deepseek's served buckets (name, E, C, d, f):
#: 160 experts of d_ff 1536, 192 rows at 4 x 1024 prefill tokens, 8 at a
#: decode step of 4 (MoESpec.capacity's floor); wi and wg map d_model to
#: d_ff, wo maps d_ff back
DS_GROUPED_SHAPES = [("deepseek_prefill", 160, 192, 5120, 1536),
                     ("deepseek_prefill_wo", 160, 192, 1536, 5120),
                     ("deepseek_decode", 160, 8, 5120, 1536),
                     ("deepseek_decode_wo", 160, 8, 1536, 5120)]
#: the paged trace over deepseek's latent pools: requests, slots, page
#: size; prompt lengths in [DS_QUEUE_PROMPT // 4, DS_QUEUE_PROMPT] and
#: outputs in [DS_QUEUE_GEN // 4, DS_QUEUE_GEN], from
#: numpy.random.default_rng(1), up to the fixed batch's lengths
DS_QUEUE_REQUESTS, DS_QUEUE_SLOTS, DS_QUEUE_PAGE = 6, 2, 16
DS_QUEUE_PROMPT, DS_QUEUE_GEN = PROMPT_LEN, GEN_TOKENS
#: what the phase may find allocated when it starts (phase 11's leftovers)
DS_HELD_MAX = 2 * 2 ** 30
#: int8 KV cache against the fp32 cache: max |dlogit| / max |logit| at
#: every step, the reference's gate (tests/test_sharding_serving.py)
INT8_REL_TOL = 0.03
#: the fp32 and int8 caches' warm decode steps: turns, steps a turn
INT8_TURNS, INT8_ITERS = ("fp32", "int8", "int8", "fp32"), 20

#: phase 13: the remaining families at full width through the launcher
#: (fp32): recurrentgemma-2b whole (26 layers: 8 local MQA attention
#: layers at head dim 256, window 2048, between RG-LRU blocks), then one
#: request past its window; xlstm-125m whole (no attention); whisper-tiny
#: whole (its encoder attends unmasked over 1500 frames); chameleon-34b
#: cut to 8 of its 48 layers (26.4 GB in fp32; 48 need 137 GB)
RG_ARCH, RG_LONG = "recurrentgemma-2b", 3072
XL_ARCH = "xlstm-125m"
WH_ARCH, WH_PROMPT = "whisper-tiny", 64
CH_ARCH, CH_LAYERS = "chameleon-34b", 8
#: kernel path against plain path (xlstm: the card against the CPU),
#: prefill and first decode step logits: the paths differ in summation
#: order only
FAMILY_TOL = 1e-4

#: phase 14: the four families trained on the card (fp32, TF32 off, the
#: library backend).  (a) card against CPU at full width, depth cut:
#: (arch, layers or None for the whole model, batch, length); 448 is
#: whisper's text context, its encoder takes 1500 frames
FAM_CMP = [("recurrentgemma-2b", 3, 1, 512), ("xlstm-125m", 2, 1, 512),
           ("whisper-tiny", None, 1, 448), ("chameleon-34b", 1, 1, 512)]
#: (b) full width through the launcher, FAM_STEPS steps each, at the
#: launcher's learning rate (3e-4, one warmup step) but chameleon's:
#: chameleon cut to 2 of 48 layers (48 need 511 GiB of train state) at
#: 7.5e-5, 3e-4 x 2048 / d_model.  AdamW's first steps move every weight
#: by about lr, so a layer's output moves by about lr x its width: at
#: d_model 8192 and 3e-4 the loss rose from 11.62 to 13.46 in 6 steps
#: (H100 80GB HBM3, 700 W), where stablelm's (2048, phase 11) falls
FAM_TRAIN = [("recurrentgemma-2b", None, 4, 1024, None),
             ("xlstm-125m", None, 4, 1024, None),
             ("whisper-tiny", None, 4, 448, None),
             ("chameleon-34b", 2, 4, 1024, 7.5e-5)]
FAM_STEPS = 6
#: free disk the final checkpoint needs, as a multiple of its size
CKPT_DISK_FACTOR = 1.2
#: A leaf whose CPU gradient norm is below this fraction of the whole
#: gradient's norm is rounding noise on both devices, and is compared
#: only inside the whole-vector comparison: the mLSTM's input-gate bias
#: ``mixer/b_igate``, to which the max-stabiliser makes the output
#: insensitive (2e-9 – 6e-9 against a whole-gradient norm of 1.33 on the
#: CPU at smoke size, 0.78 – 6.3 normwise apart from the reference;
#: tests/test_torch_train_families.py); and at whisper-tiny's full width
#: ``ln_f/bias``, whose gradient is 0 in exact arithmetic there: the
#: tied logits saturate the softmax on each position's own token, and the
#: labels are the tokens rolled by one, so the bias's gradient, the sum
#: over positions of E[token] - E[label], telescopes to 0 (3.3 normwise
#: apart between the card and the CPU)
NOISE_FRACTION = 1e-6


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


@contextlib.contextmanager
def plain_backend():
    """Run the kernels' plain PyTorch versions (ADSALA_BACKEND=torch)."""
    os.environ["ADSALA_BACKEND"] = "torch"
    try:
        yield
    finally:
        del os.environ["ADSALA_BACKEND"]


def decoder(res, tok, cache, dctx):
    """A warm decode step over ``cache``, at positions that stay inside
    it."""
    steps = iter(range(10 ** 6))

    def decode():
        pos = PROMPT_LEN + next(steps) % (GEN_TOKENS - 1)
        res.model.decode_step(res.params, tok, cache, pos, dctx)
    return decode


def trace_steps(fn, torch, steps: int = 3) -> dict:
    """``steps`` calls of ``fn`` under ``torch.profiler``: the device
    events (kernels, copies) a call, their summed time a call in ms, and
    the five names with the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3 / steps
            n += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"events": n / steps, "device_ms": sum(by_name.values()),
            "top": [(k[:60], ms) for k, ms in top]}


def flash_bound_ms(bh: int, sq: int, skv: int, d: int, causal: bool,
                   itemsize: int, window: int | None = None
                   ) -> tuple[float, str]:
    """Least time for the work: 4*D flops per visible (q, kv) pair
    (QK^T and PV; a causal window of W leaves query i its last W keys)
    at the fp32 CUDA-core rate, against q, k, v read and o written once
    at the HBM rate."""
    if causal:
        pairs = sum(min(i + 1, skv, window or skv) for i in range(sq))
    else:
        pairs = sq * skv
    from repro_torch.roofline import HBM_BW, PEAK_FLOPS

    t_ops = 4.0 * d * pairs * bh / PEAK_FLOPS
    t_bytes = itemsize * d * bh * (2 * sq + 2 * skv) / HBM_BW
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
        # head dim 256 (recurrentgemma's local attention): causal at its
        # window, windowed mid-ring, ragged unmasked rows, fully masked
        # rows, 16-row CTAs, bf16
        ("d256_causal_window2048", 10, 1024, 1024, 256, f32, True, 2048,
         512, 512),
        ("d256_window300_bq256", 4, 1024, 1024, 256, f32, True, 300, 256,
         128),
        ("d256_noncausal_ragged", 3, 200, 150, 256, f32, False, None, 64,
         64),
        ("d256_fully_masked", 1, 96, 40, 256, f32, False, 8, 32, 16),
        ("d256_cta_rows16_sq12", 2, 12, 12, 256, f32, True, None, 512, 512),
        ("bf16_d256_window256", 4, 700, 700, 256, bf16, True, 256, 256,
         128),
        ("bf16_d256_sq12", 2, 12, 12, 256, bf16, True, None, 512, 512),
        ("bf16_d256_noncausal", 3, 200, 150, 256, bf16, False, None, 64, 64),
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
    version and SDPA (the same mask) timed, beside the bound and the
    launch plan."""
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
    # then the same function; a shorter one is a boolean band
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None or window >= s:
        sdpa_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True))
    else:
        ids = torch.arange(s, device="cuda")
        band = (ids[None, :] <= ids[:, None]) \
            & (ids[None, :] > ids[:, None] - window)
        sdpa_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=band))
        del band
    bound, bound_by = flash_bound_ms(bh, s, s, d, True, 4, window)
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
    from repro_torch.roofline import HBM_BW, PEAK_FLOPS

    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / HBM_BW
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


def kernel_counts(M, fa, G) -> dict:
    return {"grouped": G.grouped_matmul_cuda.launches,
            "grouped_by_variant": dict(
                G.grouped_matmul_cuda.launches_by_variant),
            "flash": fa.flash_attention_cuda.launches,
            "matmul": M.matmul_cuda.launches}


def reset_counts(M, fa, G) -> None:
    G.grouped_matmul_cuda.launches = 0
    G.grouped_matmul_cuda.launches_by_variant = {"thin": 0, "tiled": 0}
    fa.flash_attention_cuda.launches = 0
    M.matmul_cuda.launches = 0


def cache_bytes(caches) -> int:
    """Bytes of a list of per-layer caches or pools (every tensor
    field)."""
    import dataclasses

    total = 0
    for c in caches:
        for f in dataclasses.fields(c):
            t = getattr(c, f.name)
            if hasattr(t, "element_size"):
                total += t.numel() * t.element_size()
    return total


def time_grouped(G, torch, tuner, grouped_shapes, seed: int) -> dict:
    """The grouped kernel at each (name, E, C, d, f) with the tuner's
    tile, against its plain version (normwise within RANDOM_TOL) and
    ``torch.bmm``, beside its bound: one row per shape."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs: dict[str, float] = {}
    shapes = {}
    for name, e, c, d, f in grouped_shapes:
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
    return shapes


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
    reset_counts(M, fa, G)
    res = serve.serve_config(cfg, args)
    n = kernel_counts(M, fa, G)
    launches, by_variant = n["grouped"], n["grouped_by_variant"]
    flash_launches, gemm_launches = n["flash"], n["matmul"]
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
        with plain_backend():
            return prefill_k()

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
        warm_d = cuda_ms(decoder(res, res.tokens[:, :1], cache, dctx),
                         iters=5, warmup=1)
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

    # -- the kernel at the path's bucket shapes ------------------------------
    shapes = time_grouped(G, torch, tuner, GROUPED_SHAPES, seed=6)
    # the flash kernel at mixtral's attention shape and the tuner's block
    hd = cfg.resolved_head_dim
    choice = tuner.select(PROMPT_LEN, hd, PROMPT_LEN, "attn")
    mixtral["flash"] = time_flash(
        fa, torch, REQUESTS * cfg.n_heads, PROMPT_LEN, hd,
        *choice.flash_block, choice.flash_grid, cfg.window, seed=7)
    entry = {"launches": launches, "launches_by_variant": by_variant,
             "shapes": shapes}
    return mixtral, entry


def queue_argv(*extra: str) -> list[str]:
    return ["--arch", ARCH, "--scale", "full", "--queue", "--requests",
            str(QUEUE_REQUESTS), "--prompt-len", str(QUEUE_PROMPT),
            "--gen-tokens", str(QUEUE_GEN), "--slots", str(QUEUE_SLOTS),
            "--page-size", str(QUEUE_PAGE), "--device", "cuda", *extra]


def step_stats(steps) -> dict:
    """Mean decode step (ms) and slot occupancy over ``(seconds, active,
    ...)`` rows; the first step records dispatches, so it is left out
    when there are others."""
    rows = steps[1:] if len(steps) > 1 else steps
    if not rows:
        return {"steps": 0, "mean_ms": None, "median_ms": None,
                "mean_active": None}
    ms = sorted(1e3 * r[0] for r in rows)
    return {"steps": len(rows), "mean_ms": sum(ms) / len(ms),
            "median_ms": ms[len(ms) // 2],
            "mean_active": sum(r[1] for r in rows) / len(rows)}


def fixed_batch_parity(res, torch) -> dict:
    """Every request of a queue run against the fixed-batch path at
    batch 1 and the scheduler's ``cap`` (prefill at the exact prompt
    length, then greedy decode): logits within LOGITS_TOL at every step,
    tokens equal up to a near-tie (the fixed-batch top-2 gap below
    LOGITS_TOL), after which the two runs no longer see the same
    inputs."""
    from repro_torch.train.step import make_ctx

    sched, model, params = res.sched, res.model, res.params
    pctx = make_ctx("prefill", cache_len=sched.cap)
    dctx = make_ctx("decode", cache_len=sched.cap)
    worst, ties, compared = 0.0, [], 0
    for rid, fin in sorted(sched.finished.items()):
        got = sched.logits[rid]
        with torch.inference_mode():
            logits, cache = model.prefill(
                params, torch.tensor([fin.prompt], device="cuda"), pctx)
            for i in range(len(fin.tokens)):
                if i:
                    logits, cache = model.decode_step(
                        params, torch.tensor([[fin.tokens[i - 1]]],
                                             device="cuda"),
                        cache, len(fin.prompt) + i - 1, dctx)
                want = logits[0].float().cpu()
                err = (got[i] - want).abs().max().item()
                worst = max(worst, err)
                compared += 1
                if err > LOGITS_TOL:
                    raise SystemExit(
                        f"[chip_smoke] FAIL: request {rid} step {i}: "
                        f"scheduler logits differ from the fixed-batch "
                        f"path by {err:.3e} > {LOGITS_TOL:g}")
                tok = int(want.argmax())
                if tok != fin.tokens[i]:
                    top2 = want.topk(2).values
                    gap = (top2[0] - top2[1]).item()
                    print(f"[chip_smoke] queue parity: request {rid} step "
                          f"{i}: token {fin.tokens[i]} vs fixed-batch "
                          f"{tok}, fixed-batch top-2 gap {gap:.3e}")
                    if gap >= LOGITS_TOL:
                        raise SystemExit(
                            f"[chip_smoke] FAIL: request {rid} step {i}: "
                            "token differs where the fixed-batch top-2 "
                            f"gap {gap:.3e} >= {LOGITS_TOL:g}")
                    ties.append({"rid": rid, "step": i, "gap": gap})
                    break
        del cache
    return {"logits_max_abs_err": worst, "steps_compared": compared,
            "near_tie_divergences": ties,
            "token_identical_requests": len(sched.finished) - len(ties)}


def paged_vs_fixed_step(res, torch) -> dict:
    """A warm decode step of all QUEUE_SLOTS slots, every one at position
    ``cap - 32``: on the scheduler's page pools (a shuffled page table, as
    served) against the fixed-batch contiguous caches of the same ``cap``.
    CUDA events over 10 steps a turn, in turns fixed, paged, paged, fixed;
    a step includes the greedy token's copy to the host, as the
    scheduler's does."""
    from repro_torch.train.step import make_ctx

    sched, model, params = res.sched, res.model, res.params
    b, cap = QUEUE_SLOTS, sched.cap
    per = cap // QUEUE_PAGE
    ctx = make_ctx("decode", cache_len=cap)
    table = torch.randperm(b * per, generator=torch.Generator().manual_seed(1)
                           ).view(b, per).to(torch.int32).cuda()
    pos = max(cap - 32, 0)
    pos_t = torch.full((b,), pos, device="cuda")
    tok = torch.zeros((b, 1), dtype=torch.long, device="cuda")
    ms = {"fixed": [], "paged": []}
    with torch.inference_mode():
        caches = model.init_cache(b, ctx, device="cuda")

        def fixed():
            model.decode_step(params, tok, caches, pos, ctx)[0].argmax(
                -1).cpu()

        def paged():
            model.decode_step(params, tok, sched.pool, pos_t, ctx,
                              table)[0].argmax(-1).cpu()

        for name in ("fixed", "paged", "paged", "fixed"):
            ms[name].append(cuda_ms(fixed if name == "fixed" else paged,
                                    iters=10, warmup=2))
        del caches
    return {"slots": b, "cap": cap, "pos": pos, "fixed_ms": ms["fixed"],
            "paged_ms": ms["paged"]}


def phase_queue(M, fa, G, torch) -> dict:
    """Phase 9: the full-width ragged trace through the port's queue
    path, untuned; launch counts, allocator, golden parity."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    args = serve.parse_args(queue_argv())
    reset_counts(M, fa, G)
    res = serve.serve_config(get_config(ARCH), args, keep_logits=True)
    launches = fa.flash_attention_cuda.launches
    sched, cfg = res.sched, res.cfg
    want = cfg.n_layers * sched.admitted
    print(f"[chip_smoke] queue: flash launches={launches} (expected "
          f"{cfg.n_layers} layers x {sched.admitted} admitted = {want}), "
          f"matmul launches={M.matmul_cuda.launches}, grouped launches="
          f"{G.grouped_matmul_cuda.launches}")
    if launches != want or sched.admitted != QUEUE_REQUESTS:
        raise SystemExit("[chip_smoke] FAIL: the queue path did not run the "
                         "flash kernel once per layer per admitted request")
    sched.alloc.check()
    if sched.alloc.live_pages != 0 or len(sched.finished) != QUEUE_REQUESTS:
        raise SystemExit("[chip_smoke] FAIL: queue run left live pages or "
                         "unfinished requests")
    stats = step_stats(res.steps)
    print("[chip_smoke] queue: decode steps ms (active slots): " + " ".join(
        f"{1e3 * sec:.1f}({act})" for sec, act, _ in res.steps))
    print(f"[chip_smoke] queue: {sched.generated_tokens} tokens in "
          f"{res.wall_s:.2f}s ({res.tok_per_s:.1f} tok/s), goodput "
          f"{sched.goodput():.3f} over {sched.steps} steps, decode step "
          f"{stats['mean_ms']:.2f} ms mean, {stats['median_ms']:.2f} ms "
          f"median at {stats['mean_active']:.2f} active slots of "
          f"{QUEUE_SLOTS} (over {stats['steps']})")
    parity = fixed_batch_parity(res, torch)
    print(f"[chip_smoke] queue parity vs fixed batch: "
          f"{parity['token_identical_requests']}/{len(sched.finished)} "
          f"requests token-identical, logits max_abs_err="
          f"{parity['logits_max_abs_err']:.3e} over "
          f"{parity['steps_compared']} steps (tol {LOGITS_TOL:g})")
    step = paged_vs_fixed_step(res, torch)
    print(f"[chip_smoke] queue: warm decode step at {step['slots']} slots, "
          f"cap {step['cap']}: fixed-batch " + " / ".join(
              f"{t:.2f}" for t in step["fixed_ms"]) + " ms, paged "
          + " / ".join(f"{t:.2f}" for t in step["paged_ms"]) + " ms")
    # the kernel at the trace's longest prefill, with the untuned block
    # and walk every queue prefill took (ops' defaults under a mask)
    longest = max(len(f.prompt) for f in sched.finished.values())
    flash = time_flash(fa, torch, cfg.n_heads, longest,
                       cfg.resolved_head_dim, 512, 512, "tri", None, seed=9)
    out = {"trace": {"requests": QUEUE_REQUESTS,
                     "prompt_len": [QUEUE_PROMPT // 4, QUEUE_PROMPT],
                     "max_new": [QUEUE_GEN // 4, QUEUE_GEN],
                     "prompt_lens": [len(f.prompt) for _, f in
                                     sorted(sched.finished.items())],
                     "seed": 1},
           "slots": QUEUE_SLOTS, "page_size": QUEUE_PAGE,
           "n_pages": res.n_pages, "cap": sched.cap,
           "kv_bytes": cache_bytes(sched.pool),
           "flash_launches": launches, "expected_flash_launches": want,
           "tok_per_s": res.tok_per_s, "wall_s": res.wall_s,
           "goodput": sched.goodput(), "steps": sched.steps,
           "tokens": sched.generated_tokens,
           "decode_step": stats, "paged_vs_fixed_step": step,
           "parity": parity, "flash": flash}
    del res, sched
    torch.cuda.empty_cache()
    return out


def phase_closed_loop(torch) -> dict:
    """Phase 10: profile (smoke, on the card) -> measured install ->
    full-width queue with the drift-triggered re-install on the card."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch import profile, serve

    prof = WORK / "loop_profile.json"
    serve.run(["--arch", ARCH, "--scale", "smoke", *LOOP_PROFILE_ARGS,
               "--profile-out", str(prof), "--device", "cuda"])
    art = WORK / "loop_artifact"
    for d in (art, Path(f"{art}.prev"), Path(f"{art}.tmp")):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    profile.main(["--dryrun-dir", str(WORK / "no_dryrun"), "--profile",
                  str(prof), "--out", str(WORK / "loop_merged.json"),
                  "--install", "--backend", "measured", "--artifact",
                  str(art), "--samples", str(LOOP_SAMPLES),
                  "--timing-budget", str(LOOP_BUDGET)])
    install_s = time.perf_counter() - t0
    backend = json.loads((art / "config.json").read_text())["backend"]
    print(f"[chip_smoke] loop: measured install ({LOOP_SAMPLES} samples, "
          f"budget {LOOP_BUDGET} cells) in {install_s:.1f}s, backend "
          f"{json.dumps(backend)}")
    if backend.get("kind") != "measured-cuda":
        raise SystemExit("[chip_smoke] FAIL: the install did not time on "
                         "MeasuredCUDABackend")
    torch.cuda.empty_cache()

    args = serve.parse_args(queue_argv(
        "--artifact", str(art), "--reinstall", "--reinstall-cooldown", "0",
        "--reinstall-threshold", str(REINSTALL_THRESHOLD),
        "--reinstall-budget", str(REINSTALL_BUDGET)))
    res = serve.serve_config(get_config(ARCH), args)
    mgr, sched = res.manager, res.sched
    swapped = json.loads((art / "config.json").read_text())["backend"]
    drift = res.fire_drifts[0] if res.fire_drifts else mgr.last_drift
    print(f"[chip_smoke] loop: drift at the fire {drift}, threshold "
          f"{REINSTALL_THRESHOLD}; fires={mgr.fires} swaps={mgr.swaps} "
          f"last_error={mgr.last_error!r}; re-install seconds "
          f"{res.reinstall_s}; swapped-in backend {json.dumps(swapped)}")
    if not res.fire_drifts or res.fire_drifts[0] <= REINSTALL_THRESHOLD:
        raise SystemExit(f"[chip_smoke] FAIL: drift {drift} did not cross "
                         f"{REINSTALL_THRESHOLD}")
    if mgr.fires < 1 or mgr.swaps < 1 or mgr.last_error is not None:
        raise SystemExit("[chip_smoke] FAIL: the re-install did not fire "
                         "and swap cleanly")
    if swapped.get("kind") != "measured-cuda" or             mgr.tuner.backend_info.get("kind") != "measured-cuda" or             type(mgr.backend).__name__ != "MeasuredCUDABackend":
        raise SystemExit("[chip_smoke] FAIL: the re-install did not run on "
                         "MeasuredCUDABackend")
    sched.alloc.check()
    if sched.alloc.live_pages != 0:
        raise SystemExit("[chip_smoke] FAIL: live pages after the loop")
    print("[chip_smoke] loop: decode steps ms (install in flight): "
          + " ".join(f"{1e3 * sec:.1f}({'i' if inst else '-'})"
                     for sec, _, inst in res.steps))
    during = step_stats([r for r in res.steps if r[2]])
    goodput = sched.goodput()
    # after the swap: the same trace once more through the swapped tuner
    n0 = len(sched.decode_log)
    for f in sorted(sched.finished.values(), key=lambda f: f.rid):
        sched.submit(f.prompt, len(f.tokens))
    sched.run_until_drained()
    after = step_stats(sched.decode_log[n0:])
    sched.alloc.check()
    fmt = lambda st: ("n/a" if st["mean_ms"] is None else
                      f"{st['mean_ms']:.2f} ms mean, {st['median_ms']:.2f} "
                      f"ms median at {st['mean_active']:.2f} active slots "
                      f"over {st['steps']} steps")
    print(f"[chip_smoke] loop: decode step while the install ran "
          f"{fmt(during)}; after the swap {fmt(after)}; "
          f"{res.tok_per_s:.1f} tok/s, goodput {goodput:.3f} (first trace)")
    out = {"profile": {"config": "smoke", "args": LOOP_PROFILE_ARGS},
           "install": {"samples": LOOP_SAMPLES, "timing_budget": LOOP_BUDGET,
                       "seconds": install_s, "backend": backend},
           "reinstall": {"threshold": REINSTALL_THRESHOLD,
                         "timing_budget": REINSTALL_BUDGET,
                         "fire_drifts": res.fire_drifts,
                         "fires": mgr.fires, "swaps": mgr.swaps,
                         "last_error": None, "seconds": res.reinstall_s,
                         "backend": swapped},
           "tok_per_s": res.tok_per_s, "goodput": goodput,
           "steps": len(res.steps),
           "decode_step_during_install": during,
           "decode_step_after_swap": after}
    del res, sched, mgr
    torch.cuda.empty_cache()
    return out


def no_launches(what: str, M, fa, G) -> None:
    """Fail if a kernel launched since the counts were reset: training
    runs on the library backend (no kernel has a backward)."""
    n = {c.__name__: c.launches for c in (
        fa.flash_attention_cuda, M.matmul_cuda, G.grouped_matmul_cuda)}
    print(f"[chip_smoke] train: kernel launches during {what}: {n}")
    if any(n.values()):
        raise SystemExit(f"[chip_smoke] FAIL: a CUDA kernel launched "
                         f"under grad during {what}")


def diff_sums(got: list, want: list, torch,
              chunk: int = 1 << 24) -> list[tuple[float, float]]:
    """(||got - want||^2, ||want||^2) of each pair of tensors, summed in
    float64 a chunk at a time: a full-width model's parameters as one
    float64 vector would not fit beside the train state in host
    memory."""
    out = []
    for a, b in zip(got, want):
        a, b = a.reshape(-1), b.reshape(-1)
        num = den = 0.0
        for i in range(0, b.numel(), chunk):
            x, y = a[i:i + chunk].double(), b[i:i + chunk].double()
            num += torch.sum(torch.square(x - y)).item()
            den += torch.sum(torch.square(y)).item()
        out.append((num, den))
    return out


def normwise(sums: list[tuple[float, float]]) -> float:
    """||got - want|| / ||want|| over the tensors of ``sums`` taken as
    one vector (:func:`diff_sums`)."""
    num, den = sum(n for n, _ in sums), sum(d for _, d in sums)
    return (num / max(den, 1e-60)) ** 0.5


def train_card_vs_cpu(cfg, batch: int, seq: int, torch) -> dict:
    """One ``build_train_step`` step of ``cfg`` on the card and on the
    CPU from the same seeded weights and batch, with the loss and its
    gradients beside it.  Returns the card's errors against the CPU (the
    gradients leaf by leaf, over the leaves above NOISE_FRACTION and as
    one vector; the updated parameters as one vector), the noise leaves'
    paths and both devices' seconds."""
    from repro_torch.configs import build_model
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.params import tree_leaves, tree_map, tree_paths
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import (build_train_step, init_train_state,
                                        make_ctx)

    model = build_model(cfg)
    opt = AdamWConfig(warmup_steps=1, total_steps=TRAIN_STEPS)
    host = init_train_state(model, cfg, opt,
                            torch.Generator().manual_seed(0))
    paths = tree_paths(host["params"])
    data = SyntheticLM(
        cfg.vocab, seq, batch,
        audio_dim=cfg.d_model if cfg.family == "audio" else None,
        audio_len=cfg.encoder_len).batch_at(0)
    step, _, _ = build_train_step(model, cfg, opt)
    ctx = make_ctx("train")
    runs = {}
    for dev in ("cuda", "cpu"):
        state = (host if dev == "cpu"
                 else tree_map(lambda t: t.to(dev), host))
        b = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        t0 = time.perf_counter()
        params = tree_map(lambda t: t.detach().requires_grad_(True),
                          state["params"])
        loss = model.loss(params, b, ctx)
        grads = [g.cpu() for g in torch.autograd.grad(
            loss, tree_leaves(params))]
        del params
        new, met = step(state, b)
        if dev == "cuda":
            torch.cuda.synchronize()
        runs[dev] = {"seconds": time.perf_counter() - t0,
                     "loss": loss.item(), "grads": grads,
                     "metrics": {k: v.item() for k, v in met.items()},
                     "params": [t.cpu() for t in
                                tree_leaves(new["params"])]}
        del state, new, b
    card, cpu = runs["cuda"], runs["cpu"]
    rel = lambda a, b: abs(a - b) / abs(b)
    grads = diff_sums(card["grads"], cpu["grads"], torch)
    params = diff_sums(card["params"], cpu["params"], torch)
    leaf = [normwise([p]) for p in grads]
    whole = sum(d for _, d in grads) ** 0.5
    noise = [i for i, (_, d) in enumerate(grads)
             if d ** 0.5 < NOISE_FRACTION * whole]
    errs = {"loss_rel": rel(card["loss"], cpu["loss"]),
            "step_loss_rel": rel(card["metrics"]["loss"],
                                 cpu["metrics"]["loss"]),
            "grad_norm_rel": rel(card["metrics"]["grad_norm"],
                                 cpu["metrics"]["grad_norm"]),
            "grads_normwise_max": max(leaf),
            "grads_normwise_max_above_noise": max(
                e for i, e in enumerate(leaf) if i not in noise),
            "grads_normwise": normwise(grads),
            # the parameters as one vector: AdamW's first step is
            # lr * g / (|g| + eps), so a gradient element near zero whose
            # sign differs between the devices moves by 2 lr — a large
            # share of a small or zero-initialised tensor (the biases)
            "params_normwise": normwise(params),
            "params_normwise_max_tensor": max(normwise([p])
                                              for p in params)}
    noise_leaves = {"/".join(map(str, paths[i])): [
        grads[i][1] ** 0.5 / whole, leaf[i]] for i in noise}
    print(f"[chip_smoke] train: {cfg.name} full width, {cfg.n_layers} "
          f"layers, {batch}x{seq}: loss card {card['loss']:.6f} cpu "
          f"{cpu['loss']:.6f}; card vs cpu "
          + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f"; noise leaves (share of the gradient's norm, normwise "
          f"error) {noise_leaves}; card {card['seconds']:.1f}s, cpu "
          f"{cpu['seconds']:.1f}s")
    return {"layers": cfg.n_layers, "batch": [batch, seq],
            "card_s": card["seconds"], "cpu_s": cpu["seconds"],
            "loss": card["loss"], **errs, "noise_leaves": noise_leaves}


def train_agrees(r: dict, *, noise_rule: bool) -> bool:
    """Phase 11's bounds on :func:`train_card_vs_cpu`'s errors; with
    ``noise_rule`` the noise leaves' gradients count only inside the
    whole vector."""
    grads = (r["grads_normwise_max_above_noise"] <= TRAIN_GRAD_TOL
             and r["grads_normwise"] <= TRAIN_GRAD_TOL if noise_rule
             else r["grads_normwise_max"] <= TRAIN_GRAD_TOL)
    return (r["loss_rel"] <= TRAIN_LOSS_TOL
            and r["step_loss_rel"] <= TRAIN_LOSS_TOL
            and r["grad_norm_rel"] <= TRAIN_LOSS_TOL and grads
            and r["params_normwise"] <= TRAIN_PARAM_TOL)


def fp32_peak_share(cfg, batch: int, seq: int, step_s: float) -> dict:
    """The reference's analytic FLOPs of one train step (remat: four
    forwards) over the step's time and the card's fp32 peak."""
    from repro_torch.models.config import ShapeSpec
    from repro_torch.roofline import PEAK_FLOPS, step_flops

    flops = step_flops(cfg, ShapeSpec("train", seq, batch, "train"))
    return {"step_flops": flops,
            "fp32_peak_share": flops / (step_s * PEAK_FLOPS)}


def phase_train(M, fa, G, torch) -> dict:
    """Phase 11: training on the card — card against CPU at 2 layers,
    the full-depth launcher run, its checkpoint restored bitwise, a
    resume."""
    import dataclasses
    import shutil
    import statistics

    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.params import tree_leaves

    ckpt_root = WORK / "train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    ckpt_root.mkdir(parents=True)
    free_gb = shutil.disk_usage(ckpt_root).free / 1e9
    print(f"[chip_smoke] train: {free_gb:.1f} GB free for checkpoints "
          f"under {ckpt_root}")
    out = {"arch": ARCH, "dtype": "float32", "card": card_line(),
           "disk_free_gb": free_gb}

    # -- (a) card against CPU ------------------------------------------------
    cfg = dataclasses.replace(get_config(ARCH), n_layers=TRAIN_CMP_LAYERS)
    reset_counts(M, fa, G)
    cmp = train_card_vs_cpu(cfg, TRAIN_CMP_BATCH, TRAIN_CMP_SEQ, torch)
    no_launches("the card-against-CPU step", M, fa, G)
    if not train_agrees(cmp, noise_rule=False):
        raise SystemExit("[chip_smoke] FAIL: the card's train step "
                         "disagrees with the CPU's")
    out["card_vs_cpu"] = cmp
    torch.cuda.empty_cache()

    # -- (b) full depth through the launcher ---------------------------------
    full_dir = ckpt_root / "full"
    reset_counts(M, fa, G)
    res = train.run(["--arch", ARCH, "--scale", "full", "--batch",
                     str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--steps",
                     str(TRAIN_STEPS), "--ckpt-dir", str(full_dir),
                     "--ckpt-every", str(10 * TRAIN_STEPS), "--device",
                     "cuda"])
    no_launches("the full-depth run", M, fa, G)
    losses = res.losses
    steps_s = res.driver.step_times
    step_ms = 1e3 * statistics.median(steps_s[2:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    share = fp32_peak_share(res.cfg, TRAIN_BATCH, TRAIN_SEQ, step_ms / 1e3)
    print(f"[chip_smoke] train (b): {res.n_params:,} parameters, "
          f"{TRAIN_BATCH}x{TRAIN_SEQ}, losses "
          + " ".join(f"{x:.4f}" for x in losses)
          + "; step ms " + " ".join(f"{1e3 * t:.1f}" for t in steps_s)
          + f"; median of steps 3-{TRAIN_STEPS} {step_ms:.1f} ms, "
          f"{tok_s:.0f} tokens/s, {share['fp32_peak_share']:.1%} of the "
          f"fp32 peak ({share['step_flops']:.3e} FLOPs a step), peak "
          f"{res.peak_gib:.2f} GiB; checkpoint "
          f"{res.ckpt_bytes / 1e9:.3f} GB in {res.ckpt_s:.1f}s")
    if len(losses) != TRAIN_STEPS or not all(
            x == x and abs(x) != float("inf") for x in losses):
        raise SystemExit(f"[chip_smoke] FAIL: losses {losses}")
    if not (losses[-1] + losses[-2]) / 2 < losses[0]:
        raise SystemExit(f"[chip_smoke] FAIL: the loss did not fall: "
                         f"{losses}")

    # -- (c) the checkpoint restored onto the card ---------------------------
    t0 = time.perf_counter()
    restored = restore_checkpoint(str(full_dir), TRAIN_STEPS,
                                  res.driver.state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    live = tree_leaves(res.driver.state)
    back = tree_leaves(restored)
    same = len(live) == len(back) and all(
        a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(live, back))
    print(f"[chip_smoke] train (c): restored {len(back)} tensors onto "
          f"{back[0].device} in {restore_s:.1f}s; bitwise equal to the "
          f"state in memory: {same}")
    if not same:
        raise SystemExit("[chip_smoke] FAIL: the restored checkpoint differs "
                         "from the state in memory")
    out["full"] = {"layers": res.cfg.n_layers, "params": res.n_params,
                   "batch": [TRAIN_BATCH, TRAIN_SEQ], "losses": losses,
                   "step_s": steps_s, "step_ms_median_3_on": step_ms,
                   "tokens_per_s": tok_s, **share,
                   "peak_gib": res.peak_gib,
                   "ckpt_gb": res.ckpt_bytes / 1e9, "ckpt_s": res.ckpt_s,
                   "restore_s": restore_s, "restore_bitwise": same,
                   "wall_s": res.wall_s}
    del res, restored, live, back
    shutil.rmtree(full_dir)
    torch.cuda.empty_cache()

    # -- (d) resume on the card -----------------------------------------------
    smoke_dir = str(ckpt_root / "smoke")
    base = ["--arch", ARCH, "--scale", "smoke", "--device", "cuda",
            "--ckpt-dir", smoke_dir]
    reset_counts(M, fa, G)
    first = train.run(base + ["--steps", "3"])
    again = train.run(base + ["--steps", "5", "--resume"])
    no_launches("the smoke runs", M, fa, G)
    print(f"[chip_smoke] train (d): resumed from step {again.resumed_from}"
          f", ended at step {again.summary['step']}")
    if first.summary["step"] != 3 or again.resumed_from != 3 \
            or again.summary["step"] != 5 or len(again.losses) != 2 \
            or int(again.driver.state["step"]) != 5:
        raise SystemExit("[chip_smoke] FAIL: --resume did not continue at "
                         "the saved step")
    out["resume"] = {"saved_step": 3, "resumed_from": again.resumed_from,
                     "final_step": again.summary["step"]}
    shutil.rmtree(ckpt_root)
    return out


def phase_deepseek(art: Path, M, fa, G, torch) -> tuple[dict, dict]:
    """Phase 12 (a)-(c): serve deepseek-v2-236b (full width, DS_LAYERS
    layers, fp32) through ``serve.serve_config`` and through the
    continuous-batching scheduler over latent page pools; count the
    grouped launches; check against the plain path and the fixed batch;
    time the grouped kernel at deepseek's buckets."""
    import dataclasses
    import gc
    import types

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.params import tree_leaves
    from repro_torch.serve.kv_cache import pages_for
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    from repro_torch.train.step import make_ctx

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"[chip_smoke] deepseek: {held / 2 ** 30:.3f} GiB allocated at "
          f"the start (at most {DS_HELD_MAX / 2 ** 30:g})")
    if held > DS_HELD_MAX:
        raise SystemExit("[chip_smoke] FAIL: earlier phases left memory "
                         "allocated")

    # -- (a) the fixed batch through the launcher ---------------------------
    cfg = dataclasses.replace(get_config(DS_ARCH), n_layers=DS_LAYERS)
    args = serve.parse_args([
        "--requests", str(REQUESTS), "--prompt-len", str(PROMPT_LEN),
        "--gen-tokens", str(GEN_TOKENS), "--artifact", str(art),
        "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    reset_counts(M, fa, G)
    res = serve.serve_config(cfg, args)
    n = kernel_counts(M, fa, G)
    moe_layers = sum(s.mlp == "moe" for s in res.model.plan)
    want = 3 * moe_layers * GEN_TOKENS
    want_variant = {"tiled": 3 * moe_layers,
                    "thin": 3 * moe_layers * (GEN_TOKENS - 1)}
    n_params = sum(t.numel() for t in tree_leaves(res.params))
    print(f"[chip_smoke] deepseek: {cfg.n_layers} layers ({moe_layers} MoE) "
          f"x d_model {cfg.d_model}, {cfg.n_heads} heads, MLA q_lora "
          f"{cfg.q_lora_rank} kv_lora {cfg.kv_lora_rank}, {cfg.n_experts} "
          f"experts top-{cfg.top_k} x d_ff {cfg.d_ff_expert} + "
          f"{cfg.n_shared_experts} shared: {n_params / 1e9:.3f} B "
          f"parameters (fp32, {4 * n_params / 1e9:.1f} GB)")
    print(f"[chip_smoke] deepseek serve: grouped kernel launches="
          f"{n['grouped']} (expected 3 x {moe_layers} MoE layers x (1 "
          f"prefill + {GEN_TOKENS - 1} decode steps) = {want}), by body "
          f"{n['grouped_by_variant']} (expected {want_variant}); flash "
          f"launches={n['flash']}, matmul launches={n['matmul']} "
          "(expected 0: MLA attends on the chunked path, the projections "
          "go to torch.matmul)")
    if n["grouped"] != want or n["grouped_by_variant"] != want_variant \
            or n["flash"] or n["matmul"]:
        raise SystemExit("[chip_smoke] FAIL: the deepseek path did not run "
                         "the grouped kernel 3 times per MoE layer per "
                         "forward (tiled in prefill, thin in decode), or "
                         "ran another kernel")
    if not torch.isfinite(res.prefill_logits).all():
        raise SystemExit("[chip_smoke] FAIL: non-finite deepseek logits")
    if tuple(res.tokens.shape) != (REQUESTS, GEN_TOKENS):
        raise SystemExit(f"[chip_smoke] FAIL: generated {res.tokens.shape}")

    cache_len = PROMPT_LEN + GEN_TOKENS
    ctx = make_ctx("prefill", cache_len=cache_len, tuner=res.tuner)
    dctx = make_ctx("decode", cache_len=cache_len, tuner=res.tuner)

    def prefill_k():
        return res.model.prefill(res.params, res.prompts, ctx)[0]

    def prefill_t():
        with plain_backend():
            return prefill_k()

    def agree(what, got, want) -> float:
        err = (got - want).abs().max().item()
        same_tok = torch.equal(got.argmax(-1), want.argmax(-1))
        print(f"[chip_smoke] deepseek {what} logits kernel vs plain: "
              f"max_abs_err={err:.3e} (max |logit| "
              f"{want.abs().max().item():.3f}, tol {LOGITS_TOL:g}), same "
              f"greedy token: {same_tok}")
        if not (err <= LOGITS_TOL and same_tok):
            raise SystemExit(f"[chip_smoke] FAIL: deepseek kernel and plain "
                             f"{what} disagree")
        return err

    with torch.inference_mode():
        lerr = agree("prefill", res.prefill_logits, prefill_t())
        warm_k = cuda_ms(prefill_k, iters=2, warmup=1)
        warm_t = cuda_ms(prefill_t, iters=2, warmup=1)
        _, cache = res.model.prefill(res.params, res.prompts, ctx)

        def step(pos):
            return res.model.decode_step(res.params, res.tokens[:, :1],
                                         cache, pos, dctx)[0]

        # the first decode step on the kernel path (the thin body at both
        # decode buckets), then on the plain path over the same cache:
        # each writes its own latent row into slot PROMPT_LEN, then reads
        thin = G.grouped_matmul_cuda.launches_by_variant["thin"]
        step_k = step(PROMPT_LEN)
        thin = G.grouped_matmul_cuda.launches_by_variant["thin"] - thin
        if thin != 3 * moe_layers:
            raise SystemExit(f"[chip_smoke] FAIL: a deepseek decode step "
                             f"ran the thin body {thin} times")
        with plain_backend():
            derr = agree("decode step", step_k, step(PROMPT_LEN))
        warm_d = cuda_ms(decoder(res, res.tokens[:, :1], cache, dctx),
                         iters=5, warmup=1)
        latent = cache_bytes(cache) // (len(cache) * REQUESTS * cache_len)
        del cache
    per_head = 4 * cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim
                                  + cfg.v_head_dim)
    peak = torch.cuda.max_memory_allocated()
    print(f"[chip_smoke] deepseek warm prefill ({REQUESTS}x{PROMPT_LEN}): "
          f"kernel path {warm_k:.1f} ms, plain path {warm_t:.1f} ms; warm "
          f"decode step {warm_d:.2f} ms ({REQUESTS / warm_d * 1e3:.1f} "
          f"tok/s); first call prefill {res.prefill_s * 1e3:.1f} ms, "
          f"decode {res.tok_per_s:.1f} tok/s; peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    print(f"[chip_smoke] deepseek latent cache: {latent} B a token a layer "
          f"((kv_lora {cfg.kv_lora_rank} + rope {cfg.qk_rope_dim}) x 4); "
          f"a per-head K/V cache would hold {per_head} B "
          f"({per_head / latent:.1f}x)")
    out = {"arch": DS_ARCH, "n_layers": cfg.n_layers, "dtype": "float32",
           "card": card_line(), "parameters": n_params,
           "requests": REQUESTS, "prompt_len": PROMPT_LEN,
           "gen_tokens": GEN_TOKENS, "grouped_launches": n["grouped"],
           "expected_grouped_launches": want,
           "grouped_launches_by_variant": n["grouped_by_variant"],
           "flash_launches": n["flash"], "matmul_launches": n["matmul"],
           "logits_max_abs_err": lerr, "decode_logits_max_abs_err": derr,
           "first_prefill_ms": res.prefill_s * 1e3,
           "first_decode_tok_per_s": res.tok_per_s,
           "warm_prefill_ms": warm_k, "warm_prefill_plain_ms": warm_t,
           "warm_decode_step_ms": warm_d,
           "warm_decode_tok_per_s": REQUESTS / warm_d * 1e3,
           "max_memory_allocated": peak,
           "latent_cache_bytes_per_token_layer": latent,
           "per_head_kv_bytes_per_token_layer": per_head}

    # -- (b) the paged trace over latent pools ------------------------------
    max_seq = DS_QUEUE_PROMPT + DS_QUEUE_GEN
    sched = ContinuousBatchingScheduler(
        res.model, cfg, res.params, slots=DS_QUEUE_SLOTS,
        n_pages=2 * DS_QUEUE_SLOTS * pages_for(max_seq, DS_QUEUE_PAGE),
        page_size=DS_QUEUE_PAGE, max_seq_len=max_seq, keep_logits=True)
    rng = np.random.default_rng(1)
    for _ in range(DS_QUEUE_REQUESTS):
        length = int(rng.integers(DS_QUEUE_PROMPT // 4, DS_QUEUE_PROMPT + 1))
        new = int(rng.integers(DS_QUEUE_GEN // 4, DS_QUEUE_GEN + 1))
        sched.submit(rng.integers(0, cfg.vocab, length).tolist(), new)
    reset_counts(M, fa, G)
    t0 = time.perf_counter()
    finished = sched.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nq = kernel_counts(M, fa, G)
    want_q = 3 * moe_layers * (sched.admitted + sched.steps)
    stats = step_stats([(sec, act) for sec, act in sched.decode_log])
    print(f"[chip_smoke] deepseek queue: {len(finished)} requests "
          f"(prompts {sorted(len(f.prompt) for f in finished.values())}) on "
          f"{DS_QUEUE_SLOTS} slots, {sched.n_pages} pages x "
          f"{DS_QUEUE_PAGE}: {sched.generated_tokens} tokens in {wall:.2f}s "
          f"over {sched.steps} steps, goodput {sched.goodput():.3f}, decode "
          f"step {stats['mean_ms']:.2f} ms mean; grouped launches="
          f"{nq['grouped']} (expected 3 x {moe_layers} x ({sched.admitted} "
          f"prefills + {sched.steps} steps) = {want_q}), flash "
          f"{nq['flash']}, matmul {nq['matmul']}")
    if nq["grouped"] != want_q or nq["flash"] or nq["matmul"] \
            or sched.admitted != DS_QUEUE_REQUESTS:
        raise SystemExit("[chip_smoke] FAIL: the paged deepseek path did "
                         "not run the grouped kernel 3 times per MoE layer "
                         "per prefill and step")
    sched.alloc.check()
    if sched.alloc.live_pages != 0 or len(finished) != DS_QUEUE_REQUESTS:
        raise SystemExit("[chip_smoke] FAIL: deepseek queue run left live "
                         "pages or unfinished requests")
    parity = fixed_batch_parity(types.SimpleNamespace(
        sched=sched, model=res.model, params=res.params), torch)
    print(f"[chip_smoke] deepseek queue parity vs fixed batch: "
          f"{parity['token_identical_requests']}/{len(finished)} requests "
          f"token-identical, logits max_abs_err="
          f"{parity['logits_max_abs_err']:.3e} over "
          f"{parity['steps_compared']} steps (tol {LOGITS_TOL:g})")
    out["queue"] = {"requests": DS_QUEUE_REQUESTS, "slots": DS_QUEUE_SLOTS,
                    "page_size": DS_QUEUE_PAGE, "n_pages": sched.n_pages,
                    "prompt_lens": [len(f.prompt) for _, f in
                                    sorted(finished.items())],
                    "steps": sched.steps, "tokens": sched.generated_tokens,
                    "goodput": sched.goodput(), "wall_s": wall,
                    "decode_step": stats, "grouped_launches": nq["grouped"],
                    "expected_grouped_launches": want_q,
                    "latent_pool_bytes": cache_bytes(sched.pool),
                    "parity": parity}
    tuner = res.tuner
    del res, sched, finished, ctx, dctx
    torch.cuda.empty_cache()

    # -- (c) the grouped kernel at deepseek's buckets ------------------------
    entry = {"launches": n["grouped"],
             "launches_by_variant": n["grouped_by_variant"],
             "shapes": time_grouped(G, torch, tuner, DS_GROUPED_SHAPES,
                                    seed=8)}
    return out, entry


def phase_int8(M, fa, G, torch) -> dict:
    """Phase 12 (d): stablelm-1.6b at full width and depth on the int8 KV
    cache (ADSALA_KV_INT8=1) through the launcher, then the same prompts
    on the fp32 and the int8 cache fed the fp32 path's greedy tokens:
    relative logit error at every step, flash launches, cache bytes,
    warm decode steps."""
    from repro_torch.launch import serve
    from repro_torch.train.step import make_ctx

    argv = ["--arch", ARCH, "--scale", "full", "--requests", str(REQUESTS),
            "--prompt-len", str(PROMPT_LEN), "--gen-tokens",
            str(GEN_TOKENS), "--device", "cuda"]
    cache_len = PROMPT_LEN + GEN_TOKENS
    torch.cuda.reset_peak_memory_stats()
    reset_counts(M, fa, G)
    os.environ["ADSALA_KV_INT8"] = "1"
    try:
        res = serve.run(argv)
    finally:
        del os.environ["ADSALA_KV_INT8"]
    n = kernel_counts(M, fa, G)
    cfg = res.cfg
    print(f"[chip_smoke] int8: {ARCH} served with ADSALA_KV_INT8=1: flash "
          f"launches={n['flash']} (expected {cfg.n_layers})")
    if n["flash"] != cfg.n_layers or not torch.isfinite(
            res.prefill_logits).all():
        raise SystemExit("[chip_smoke] FAIL: the int8 serving path did not "
                         "run the flash kernel once per layer, or its "
                         "logits are not finite")

    paths = {}
    with torch.inference_mode():
        for name, flag in (("fp32", None), ("int8", "1")):
            if flag:
                os.environ["ADSALA_KV_INT8"] = flag
            try:
                pctx = make_ctx("prefill", cache_len=cache_len)
                dctx = make_ctx("decode", cache_len=cache_len)
            finally:
                os.environ.pop("ADSALA_KV_INT8", None)
            if pctx.kv_quantized != bool(flag):
                raise SystemExit("[chip_smoke] FAIL: ADSALA_KV_INT8 did not "
                                 "reach make_ctx")
            reset_counts(M, fa, G)
            logits, cache = res.model.prefill(res.params, res.prompts, pctx)
            flash = fa.flash_attention_cuda.launches
            if flash != cfg.n_layers or any(
                    c.quantized != bool(flag) for c in cache):
                raise SystemExit(f"[chip_smoke] FAIL: the {name} prefill ran "
                                 f"{flash} flash launches, or built the "
                                 "wrong cache")
            rows = [logits.float()]
            if name == "fp32":
                toks = [torch.argmax(logits, -1)[:, None]]
            for i in range(GEN_TOKENS - 1):
                logits, cache = res.model.decode_step(
                    res.params, toks[i], cache, PROMPT_LEN + i, dctx)
                rows.append(logits.float())
                if name == "fp32":
                    toks.append(torch.argmax(logits, -1)[:, None])
            paths[name] = {"rows": rows, "flash_launches": flash,
                           "cache_bytes": cache_bytes(cache),
                           "decode": decoder(res, toks[0], cache, dctx)}
            del cache
        # warm decode steps of the two caches in turns, then a profiler
        # trace of each: the kernels' own time against the step's
        for name in INT8_TURNS:
            paths[name].setdefault("warm_decode_step_ms", []).append(
                cuda_ms(paths[name]["decode"], iters=INT8_ITERS, warmup=2))
        for p in paths.values():
            p["trace"] = trace_steps(p["decode"], torch)
    rel = [((q - f).abs().max() / f.abs().max()).item()
           for f, q in zip(paths["fp32"]["rows"], paths["int8"]["rows"])]
    peak = torch.cuda.max_memory_allocated()
    ratio = paths["fp32"]["cache_bytes"] / paths["int8"]["cache_bytes"]
    print("[chip_smoke] int8 vs fp32 cache, max |dlogit| / max |logit| at "
          "prefill and each step (fed the fp32 greedy tokens): "
          + " ".join(f"{r:.2e}" for r in rel) + f" (gate {INT8_REL_TOL})")
    print(f"[chip_smoke] int8: cache bytes fp32 "
          f"{paths['fp32']['cache_bytes']} int8 "
          f"{paths['int8']['cache_bytes']} ({ratio:.2f}x); peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    for name, p in paths.items():
        t = p["trace"]
        traced = "the profiler recorded no device event"
        if t["events"]:
            steps_ms = p["warm_decode_step_ms"]
            idle = 1 - t["device_ms"] / (sum(steps_ms) / len(steps_ms))
            traced = (f"traced: {t['events']:.0f} device events, "
                      f"{t['device_ms']:.2f} ms of device time a step "
                      f"(idle {idle:.0%}); most: " + ", ".join(
                          f"{k} {ms:.3f} ms" for k, ms in t["top"]))
        print(f"[chip_smoke] int8: {name} warm decode step, {INT8_ITERS} "
              f"steps a turn in turns {' '.join(INT8_TURNS)}: "
              + ", ".join(f"{ms:.2f}" for ms in p["warm_decode_step_ms"])
              + f" ms; {traced}")
    if not max(rel) < INT8_REL_TOL:
        raise SystemExit("[chip_smoke] FAIL: the int8 KV cache misses the "
                         f"{INT8_REL_TOL} logit gate")
    out = {"arch": ARCH, "dtype": "float32", "requests": REQUESTS,
           "prompt_len": PROMPT_LEN, "gen_tokens": GEN_TOKENS,
           "serve_flash_launches": n["flash"], "rel_logit_err": rel,
           "cache_bytes_ratio": ratio, "max_memory_allocated": peak,
           "turns": list(INT8_TURNS), "iters": INT8_ITERS}
    for name, p in paths.items():
        out[name] = {k: v for k, v in p.items()
                     if k not in ("rows", "decode")}
    del res, paths
    torch.cuda.empty_cache()
    return out


def greedy_run(model, params, batch, prompt_len: int, gen: int, tuner,
               torch) -> tuple:
    """Prefill ``batch`` and decode ``gen - 1`` greedy steps: (prefill
    logits, first decode step's logits, tokens (B, gen))."""
    from repro_torch.train.step import make_ctx

    cache_len = prompt_len + gen
    pctx = make_ctx("prefill", cache_len=cache_len, tuner=tuner)
    dctx = make_ctx("decode", cache_len=cache_len, tuner=tuner)
    with torch.inference_mode():
        first, cache = model.prefill(params, batch, pctx)
        tok = torch.argmax(first, -1)[:, None]
        toks, step1 = [tok], None
        for i in range(gen - 1):
            logits, cache = model.decode_step(params, tok, cache,
                                              prompt_len + i, dctx)
            step1 = logits if step1 is None else step1
            tok = torch.argmax(logits, -1)[:, None]
            toks.append(tok)
    return first, step1, torch.cat(toks, dim=1)


def paths_agree(name: str, kernel: tuple, other: tuple, torch,
                what: str = "plain") -> dict:
    """The kernel path against the plain path (or the CPU): prefill and
    first decode step logits within FAMILY_TOL, the same greedy
    tokens."""
    out = {}
    for i, step in enumerate(("prefill", "decode_step")):
        got, want = kernel[i].float().cpu(), other[i].float().cpu()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        print(f"[chip_smoke] {name} {step} logits kernel vs {what}: "
              f"max_abs_err={err:.3e} (max |logit| {scale:.3f}, tol "
              f"{FAMILY_TOL:g})")
        if not err <= FAMILY_TOL:
            raise SystemExit(f"[chip_smoke] FAIL: {name} kernel and {what} "
                             f"{step} logits disagree")
        out[f"{step}_max_abs_err"] = err
        out[f"{step}_max_abs_logit"] = scale
    same = torch.equal(kernel[2].cpu(), other[2].cpu())
    print(f"[chip_smoke] {name} greedy tokens kernel vs {what}: "
          f"{'identical' if same else 'DIFFERENT'} "
          f"({tuple(kernel[2].shape)})")
    if not same:
        raise SystemExit(f"[chip_smoke] FAIL: {name} kernel and {what} "
                         "greedy tokens differ")
    return out


def serve_family(name: str, cfg, prompt_len: int, want_flash: int,
                 art: Path, M, fa, G, torch) -> tuple:
    """Serve ``cfg`` through ``serve.serve_config`` (REQUESTS x
    ``prompt_len`` + GEN_TOKENS, fp32, the phase-4 artifact); check the
    kernel launches, the output, and the kernel path against the plain
    path (when it launches a kernel); time a warm prefill and decode
    step.  Returns (the serve result, the report)."""
    from repro_torch.launch import serve
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.step import make_ctx

    args = serve.parse_args([
        "--requests", str(REQUESTS), "--prompt-len", str(prompt_len),
        "--gen-tokens", str(GEN_TOKENS), "--artifact", str(art),
        "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    reset_counts(M, fa, G)
    res = serve.serve_config(cfg, args)
    n = kernel_counts(M, fa, G)
    n_params = sum(t.numel() for t in tree_leaves(res.params))
    kinds = sorted({s.kind for s in getattr(res.model, "plan", [])}) \
        or ["encoder-decoder"]
    print(f"[chip_smoke] {name}: {cfg.n_layers} layers ({', '.join(kinds)})"
          f" x d_model {cfg.d_model}: {n_params / 1e9:.3f} B parameters "
          f"(fp32, {4 * n_params / 1e9:.1f} GB); flash launches="
          f"{n['flash']} (expected {want_flash}), grouped {n['grouped']}, "
          f"matmul {n['matmul']} (expected 0)")
    if n["flash"] != want_flash or n["grouped"] or n["matmul"]:
        raise SystemExit(f"[chip_smoke] FAIL: {name} did not launch the "
                         f"flash kernel {want_flash} times, or launched "
                         "another kernel")
    if not torch.isfinite(res.prefill_logits).all():
        raise SystemExit(f"[chip_smoke] FAIL: non-finite {name} logits")
    if tuple(res.tokens.shape) != (REQUESTS, GEN_TOKENS):
        raise SystemExit(f"[chip_smoke] FAIL: {name} generated "
                         f"{res.tokens.shape}")
    batch = res.prompts if res.audio_emb is None else {
        "tokens": res.prompts, "audio_emb": res.audio_emb}
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": "float32",
           "parameters": n_params, "requests": REQUESTS,
           "prompt_len": prompt_len, "gen_tokens": GEN_TOKENS,
           "flash_launches": n["flash"],
           "expected_flash_launches": want_flash,
           "first_prefill_ms": res.prefill_s * 1e3,
           "first_decode_tok_per_s": res.tok_per_s}
    if want_flash:
        # the block and walk the tuner gave the (causal) prefill attention
        hd = cfg.resolved_head_dim
        choice = res.tuner.select(prompt_len, hd, prompt_len, "attn")
        out["flash_block"] = list(choice.flash_block)
        out["flash_grid"] = choice.flash_grid
        print(f"[chip_smoke] {name} tuner attn {prompt_len}x{hd}x"
              f"{prompt_len}: flash_block={choice.flash_block} "
              f"flash_grid={choice.flash_grid}")
        kernel = greedy_run(res.model, res.params, batch, prompt_len,
                            GEN_TOKENS, res.tuner, torch)
        if not torch.equal(kernel[2], res.tokens):
            raise SystemExit(f"[chip_smoke] FAIL: {name}'s kernel path "
                             "does not repeat the launcher's tokens")
        with plain_backend():
            plain = greedy_run(res.model, res.params, batch, prompt_len,
                               GEN_TOKENS, res.tuner, torch)
        out.update(paths_agree(name, kernel, plain, torch))
        del kernel, plain
    cache_len = prompt_len + GEN_TOKENS
    pctx = make_ctx("prefill", cache_len=cache_len, tuner=res.tuner)
    dctx = make_ctx("decode", cache_len=cache_len, tuner=res.tuner)
    steps = iter(range(10 ** 6))
    with torch.inference_mode():
        warm_p = cuda_ms(lambda: res.model.prefill(res.params, batch, pctx),
                         iters=2, warmup=1)
        _, cache = res.model.prefill(res.params, batch, pctx)
        tok = res.tokens[:, :1]
        warm_d = cuda_ms(lambda: res.model.decode_step(
            res.params, tok, cache,
            prompt_len + next(steps) % (GEN_TOKENS - 1), dctx),
            iters=5, warmup=1)
        del cache
    peak = torch.cuda.max_memory_allocated()
    print(f"[chip_smoke] {name} warm prefill ({REQUESTS}x{prompt_len}) "
          f"{warm_p:.1f} ms, warm decode step {warm_d:.2f} ms "
          f"({REQUESTS / warm_d * 1e3:.1f} tok/s); first call prefill "
          f"{res.prefill_s * 1e3:.1f} ms; peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    out.update({"warm_prefill_ms": warm_p, "warm_decode_step_ms": warm_d,
                "warm_decode_tok_per_s": REQUESTS / warm_d * 1e3,
                "max_memory_allocated": peak})
    return res, out


def phase_families(art: Path, M, fa, G, torch) -> tuple[dict, list]:
    """Phase 13: recurrentgemma-2b (a, b), xlstm-125m (c), whisper-tiny
    (d) and chameleon-34b (e) at full width through the launcher; the
    flash kernel at recurrentgemma's two shapes.  Returns (the report,
    (label, row, launches) of each flash timing)."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models.params import tree_map

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    held = torch.cuda.memory_allocated()
    print(f"[chip_smoke] families: {held / 2 ** 30:.3f} GiB allocated at "
          f"the start (at most {DS_HELD_MAX / 2 ** 30:g})")
    if held > DS_HELD_MAX:
        raise SystemExit("[chip_smoke] FAIL: earlier phases left memory "
                         "allocated")
    report: dict = {"card": card_line()}

    # -- (a) recurrentgemma-2b, whole: one launch per local layer ---------------
    cfg = get_config(RG_ARCH)
    local = sum(cfg.pattern[i % len(cfg.pattern)] == "local"
                for i in range(cfg.n_layers))
    res, report["recurrentgemma"] = serve_family(
        RG_ARCH, cfg, PROMPT_LEN, local, art, M, fa, G, torch)
    rg_launches = report["recurrentgemma"]["flash_launches"]
    tuner = res.tuner

    # -- (b) one request past the window: the tri walk drops tiles, the
    #    ring wraps when it is seeded ---------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(13)
    prompt = torch.randint(0, cfg.vocab, (1, RG_LONG), device="cuda",
                           generator=gen)
    reset_counts(M, fa, G)
    kernel = greedy_run(res.model, res.params, prompt, RG_LONG, GEN_TOKENS,
                        tuner, torch)
    long_launches = fa.flash_attention_cuda.launches
    print(f"[chip_smoke] {RG_ARCH} long request (1 x {RG_LONG} + "
          f"{GEN_TOKENS}, window {cfg.local_window}): flash launches="
          f"{long_launches} (expected {local})")
    if long_launches != local:
        raise SystemExit("[chip_smoke] FAIL: the long request did not run "
                         "the flash kernel once per local layer")
    with plain_backend():
        plain = greedy_run(res.model, res.params, prompt, RG_LONG,
                           GEN_TOKENS, tuner, torch)
    report["recurrentgemma_long"] = {
        "prompt_len": RG_LONG, "gen_tokens": GEN_TOKENS,
        "flash_launches": long_launches,
        **paths_agree(f"{RG_ARCH} long", kernel, plain, torch)}
    del res, kernel, plain, prompt
    free()

    # the flash kernel at both shapes with the tuner's blocks
    hd = cfg.resolved_head_dim
    rows = []
    for label, bh, s, n in (
            ("recurrentgemma_prefill", REQUESTS * cfg.n_heads, PROMPT_LEN,
             rg_launches),
            ("recurrentgemma_long", cfg.n_heads, RG_LONG, long_launches)):
        choice = tuner.select(s, hd, s, "attn")
        rows.append((label, time_flash(
            fa, torch, bh, s, hd, *choice.flash_block, choice.flash_grid,
            cfg.local_window, seed=13), n))

    # -- (c) xlstm-125m, whole: no kernel; the card against the CPU ----------
    cfg = get_config(XL_ARCH)
    res, report["xlstm"] = serve_family(XL_ARCH, cfg, PROMPT_LEN, 0, art,
                                        M, fa, G, torch)
    card = greedy_run(res.model, res.params, res.prompts, PROMPT_LEN, 2,
                      None, torch)
    t0 = time.perf_counter()
    cpu = greedy_run(res.model, tree_map(lambda t: t.cpu(), res.params),
                     res.prompts.cpu(), PROMPT_LEN, 2, None, torch)
    report["xlstm"]["cpu_prefill_and_step_s"] = time.perf_counter() - t0
    report["xlstm"].update(paths_agree(XL_ARCH, card, cpu, torch,
                                       what="CPU"))
    del res, card, cpu
    free()

    # -- (d) whisper-tiny, whole: 4 unmasked encoder + 4 causal decoder
    #    launches ----------------------------------------------------------
    cfg = get_config(WH_ARCH)
    res, report["whisper"] = serve_family(
        WH_ARCH, cfg, WH_PROMPT, cfg.n_encoder_layers + cfg.n_layers, art,
        M, fa, G, torch)
    report["whisper"]["encoder_len"] = cfg.encoder_len
    del res
    free()

    # -- (e) chameleon-34b, 8 of 48 layers ---------------------------------------
    cfg = dataclasses.replace(get_config(CH_ARCH), n_layers=CH_LAYERS)
    res, report["chameleon"] = serve_family(CH_ARCH, cfg, PROMPT_LEN,
                                            CH_LAYERS, art, M, fa, G, torch)
    del res
    free()
    return report, rows


def phase_train_families(M, fa, G, torch) -> dict:
    """Phase 14: recurrentgemma-2b, xlstm-125m, whisper-tiny and
    chameleon-34b trained on the card — (a) card against CPU at full
    width, depth cut; (b) full width through the launcher, each
    checkpoint checked against the free disk first and deleted after;
    (c) whisper's resume at the smoke scale."""
    import dataclasses
    import gc
    import math
    import shutil
    import statistics

    from repro_torch.configs import build_model, get_config
    from repro_torch.launch import train
    from repro_torch.models.params import tree_leaves

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def config(arch, layers):
        cfg = get_config(arch)
        return cfg if layers is None else dataclasses.replace(
            cfg, n_layers=layers)

    free()
    held = torch.cuda.memory_allocated()
    print(f"[chip_smoke] train families: {held / 2 ** 30:.3f} GiB "
          f"allocated at the start (at most {DS_HELD_MAX / 2 ** 30:g})")
    if held > DS_HELD_MAX:
        raise SystemExit("[chip_smoke] FAIL: earlier phases left memory "
                         "allocated")
    ckpt_root = WORK / "train_families_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    ckpt_root.mkdir(parents=True)
    report: dict = {"card": card_line(), "dtype": "float32",
                    "card_vs_cpu": {}, "full": {}}

    # -- (a) card against CPU, full width, depth cut ---------------------------
    for arch, layers, batch, seq in FAM_CMP:
        reset_counts(M, fa, G)
        r = train_card_vs_cpu(config(arch, layers), batch, seq, torch)
        no_launches(f"{arch}'s card-against-CPU step", M, fa, G)
        if not train_agrees(r, noise_rule=True):
            raise SystemExit(f"[chip_smoke] FAIL: {arch}'s train step on "
                             "the card disagrees with the CPU's")
        report["card_vs_cpu"][arch] = r
        free()

    # -- (b) full width through the launcher ------------------------------------
    for arch, layers, batch, seq, lr in FAM_TRAIN:
        cfg = config(arch, layers)
        n_params = sum(math.prod(d.shape)
                       for d in tree_leaves(build_model(cfg).defs))
        # params, m and v in fp32
        ckpt_gb = 12 * n_params / 1e9
        free_gb = shutil.disk_usage(ckpt_root).free / 1e9
        print(f"[chip_smoke] train {arch}: {cfg.n_layers} layers, "
              f"{n_params:,} parameters, a {ckpt_gb:.1f} GB checkpoint, "
              f"{free_gb:.1f} GB free under {ckpt_root}")
        if free_gb < CKPT_DISK_FACTOR * ckpt_gb:
            raise SystemExit(
                f"[chip_smoke] FAIL: {arch}'s checkpoint needs "
                f"{CKPT_DISK_FACTOR:g} x {ckpt_gb:.1f} GB of disk, "
                f"{free_gb:.1f} GB is free")
        run_dir = ckpt_root / arch
        lr = lr or train.parse_args([]).lr
        reset_counts(M, fa, G)
        res = train.train_config(cfg, train.parse_args([
            "--batch", str(batch), "--seq", str(seq), "--steps",
            str(FAM_STEPS), "--ckpt-dir", str(run_dir), "--ckpt-every",
            str(10 * FAM_STEPS), "--lr", str(lr), "--device", "cuda"]))
        no_launches(f"{arch}'s run", M, fa, G)
        losses, steps_s = res.losses, res.driver.step_times
        step_s = statistics.median(steps_s[2:])
        share = fp32_peak_share(cfg, batch, seq, step_s)
        row = {"layers": cfg.n_layers, "params": res.n_params,
               "batch": [batch, seq], "lr": lr, "losses": losses,
               "step_s": steps_s,
               "step_ms_median_3_on": 1e3 * step_s,
               "tokens_per_s": batch * seq / step_s, **share,
               "peak_gib": res.peak_gib, "ckpt_gb": res.ckpt_bytes / 1e9,
               "ckpt_s": res.ckpt_s, "wall_s": res.wall_s}
        if cfg.family == "audio":
            row["encoder_len"] = cfg.encoder_len
        print(f"[chip_smoke] train {arch}: losses "
              + " ".join(f"{x:.4f}" for x in losses)
              + "; step ms " + " ".join(f"{1e3 * t:.1f}" for t in steps_s)
              + f"; median of steps 3-{FAM_STEPS} {1e3 * step_s:.1f} ms, "
              f"{row['tokens_per_s']:.0f} tokens/s, "
              f"{share['fp32_peak_share']:.1%} of the fp32 peak "
              f"({share['step_flops']:.3e} FLOPs a step), peak "
              f"{res.peak_gib:.2f} GiB; checkpoint "
              f"{res.ckpt_bytes / 1e9:.3f} GB in {res.ckpt_s:.1f}s")
        report["full"][arch] = row
        del res
        shutil.rmtree(run_dir)
        free()
        if len(losses) != FAM_STEPS or not all(
                math.isfinite(x) for x in losses):
            raise SystemExit(f"[chip_smoke] FAIL: {arch}'s losses {losses}")
        if not (losses[-1] + losses[-2]) / 2 < losses[0]:
            raise SystemExit(f"[chip_smoke] FAIL: {arch}'s loss did not "
                             f"fall: {losses}")

    # -- (c) whisper resumes on the card: its batches carry the frames
    #    (EncDecLM.loss reads batch["audio_emb"]) ------------------------------
    base = ["--arch", WH_ARCH, "--scale", "smoke", "--device", "cuda",
            "--ckpt-dir", str(ckpt_root / "smoke")]
    reset_counts(M, fa, G)
    first = train.run(base + ["--steps", "3"])
    again = train.run(base + ["--steps", "5", "--resume"])
    no_launches(f"{WH_ARCH}'s smoke runs", M, fa, G)
    print(f"[chip_smoke] train {WH_ARCH} smoke: resumed from step "
          f"{again.resumed_from}, ended at step {again.summary['step']}, "
          f"losses {again.losses}")
    if first.summary["step"] != 3 or again.resumed_from != 3 \
            or again.summary["step"] != 5 or len(again.losses) != 2 \
            or int(again.driver.state["step"]) != 5 \
            or not all(math.isfinite(x) for x in again.losses):
        raise SystemExit("[chip_smoke] FAIL: whisper's --resume did not "
                         "continue at the saved step")
    report["resume"] = {"arch": WH_ARCH, "saved_step": 3,
                        "resumed_from": again.resumed_from,
                        "final_step": again.summary["step"],
                        "losses": again.losses}
    shutil.rmtree(ckpt_root)
    return report


START = time.perf_counter()


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
        with plain_backend():
            return prefill_k()

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
        warm_d = cuda_ms(decoder(res, res.tokens[:, :1], cache, dctx),
                         iters=10, warmup=2)
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

    # -- 9. queue ---------------------------------------------------------------
    serving = {"arch": ARCH, "dtype": "float32", "card": card_line()}
    t0 = time.perf_counter()
    serving["queue"] = phase_queue(mm, fa, gm, torch)
    serving["queue"]["phase_s"] = time.perf_counter() - t0

    # -- 10. closed loop -----------------------------------------------------------
    t0 = time.perf_counter()
    serving["closed_loop"] = phase_closed_loop(torch)
    serving["closed_loop"]["phase_s"] = time.perf_counter() - t0
    print(f"[chip_smoke] phases 9 and 10 took "
          f"{serving['queue']['phase_s']:.1f}s and "
          f"{serving['closed_loop']['phase_s']:.1f}s; the script "
          f"{time.perf_counter() - START:.1f}s so far")

    # -- 11. train ----------------------------------------------------------------
    t0 = time.perf_counter()
    training = phase_train(mm, fa, gm, torch)
    training["phase_s"] = time.perf_counter() - t0
    print(f"[chip_smoke] phase 11 took {training['phase_s']:.1f}s; the "
          f"script {time.perf_counter() - START:.1f}s so far")

    # -- 12. deepseek and int8 ------------------------------------------------------
    t0 = time.perf_counter()
    deepseek, ds_grouped = phase_deepseek(art, mm, fa, gm, torch)
    deepseek["int8"] = phase_int8(mm, fa, gm, torch)
    deepseek["phase_s"] = time.perf_counter() - t0
    print(f"[chip_smoke] phase 12 took {deepseek['phase_s']:.1f}s; the "
          f"script {time.perf_counter() - START:.1f}s so far")

    # -- 13. the remaining families ------------------------------------------------
    t0 = time.perf_counter()
    families, family_flash = phase_families(art, mm, fa, gm, torch)
    families["phase_s"] = time.perf_counter() - t0
    print(f"[chip_smoke] phase 13 took {families['phase_s']:.1f}s; the "
          f"script {time.perf_counter() - START:.1f}s so far")

    # -- 14. the four families trained ---------------------------------------------
    t0 = time.perf_counter()
    train_families = phase_train_families(mm, fa, gm, torch)
    train_families["phase_s"] = time.perf_counter() - t0
    print(f"[chip_smoke] phase 14 took {train_families['phase_s']:.1f}s; "
          f"the script {time.perf_counter() - START:.1f}s so far")

    # -- 15. report ---------------------------------------------------------------
    kernels = [flash_entry("flash_attention", flash_row, launches,
                           case_max_abs_err=errs),
               flash_entry("flash_attention@mixtral_prefill",
                           mixtral["flash"], mixtral["flash_launches"]),
               flash_entry("flash_attention@queue_prefill",
                           serving["queue"]["flash"],
                           serving["queue"]["flash_launches"])]
    kernels += [flash_entry(f"flash_attention@{label}", row, n)
                for label, row, n in family_flash]
    # one entry per measured shape: the tiled GEMM at 2048^3 (the main
    # entry) and the largest cube, the grouped kernel at mixtral's decode
    # bucket (the main entry: 180 of its 192 launches) and prefill bucket,
    # and at deepseek-v2's four buckets with the launches of deepseek's
    # path (no main entry there)
    for name, source, replaces, entry, errs_, main in (
            ("matmul", "matmul.cu", "src/repro/kernels/matmul.py:57",
             gemm_entry, gemm_errs, f"gemm_{LARGE_CUBE}"),
            ("grouped_matmul", "grouped_matmul.cu",
             "src/repro/kernels/grouped_matmul.py:51", grouped_entry,
             grouped_errs, "mixtral_decode"),
            ("grouped_matmul", "grouped_matmul.cu",
             "src/repro/kernels/grouped_matmul.py:51", ds_grouped,
             grouped_errs, None)):
        for key in sorted(entry["shapes"], key=lambda k: k != main):
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
    print(json.dumps({"deepseek": deepseek}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"train": training}))
    print(json.dumps({"families": families}))
    print(json.dumps({"train_families": train_families}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
