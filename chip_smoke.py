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
   too), head dims between the kernel's (24, 80, 96, 192: zero-padded
   to the next one) and float16 (run in float32); then the
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
   recurrentgemma-2b cut to 8 of 26 layers, xlstm-125m to 6 of 12,
   whisper-tiny whole, chameleon-34b cut to 2 of 48 layers (at a
   learning rate scaled to its width, ``FAM_TRAIN``), each after
   checking the disk
   holds 1.2 x its final checkpoint: finite losses, the last two below
   the first on average, step times, tokens/s, peak memory, the
   checkpoint's GB and seconds, and the step's share of the fp32 peak
   (``roofline.step_flops`` over the median of steps 3–6, as phase 11's
   stablelm run); (c) whisper-tiny's ``--resume`` at the smoke scale;
   (d) the sLSTM (``repro_torch::slstm_scan``, no kernel: xlstm's
   training goes through it; it takes the input product x @ w_in
   hoisted out of the recurrence) against its plain loop over the same
   hoisted product at xlstm-125m's width, 4 x 1024 x 768: forward
   bitwise, the gradients of x, w_in,
   w_rec and b normwise within TRAIN_GRAD_TOL, forward and forward +
   backward ms of each in turns, and (b)'s xlstm step beside runs
   21a/21b's 18–19.6 s;
15. the mesh (the distribution layer): a one-rank NCCL world (an
   in-process store) and a (1, 1) ("data", "model") mesh, held from
   phase 11 to phase 12 (c); each part runs where its inputs live:
   (c), (d), (e) at the end of phase 11: its checkpoint restored onto
   the mesh as DTensors by the state specs, bitwise the state in
   memory, then MESH_TRAIN_STEPS sharded train steps from it, tensor-
   parallel over 'model' (the dense blocks on the rank's shards, the
   vocab-parallel loss), against the single-device step from the state,
   in turns: the losses within MESH_TOL and every leaf of the two states
   bitwise equal after the steps; (e) stablelm-1.6b whole through the
   built prefill on the mesh, tensor-parallel, 4 x 1024 on the flash
   kernel (24 launches, one a layer): logits and caches bitwise the
   single-device prefill's, warm times in turns (one rank cuts nothing:
   multi-rank correctness is shown by the gloo worlds of the CPU tests
   only); (a) in phase 12 between (a) and (b): deepseek's weights
   laid out on the mesh without a copy, ``serve.step.build_prefill``
   (the MoE's expert-parallel path: the grouped kernel behind a one-rank
   all_to_all, 9 tiled launches) and ``build_decode`` from the
   prefill's caches laid out by ``serve.step.shard_cache`` (the latent
   cache read split-KV, ``apply_moe_decode``: 135 thin launches, the
   shared experts on their FF slice) on the same prompts, MLA on its
   whole heads over the one-rank 'model' axis: the logits within
   MESH_TOL of phase 12's and the same greedy tokens, a decode step's
   device time and collectives (one all-gather of the absorbed query a
   layer, no weight moved); (b) after phase 12 (c): one mixtral-8x22b MoE layer at
   full width through ``apply_moe_tp`` against ``apply_moe``: 3 tiled
   launches, within the grouped bound; warm times of both paths in
   turns; (f) after (b): the decode on the reference's cache layout —
   stablelm-1.6b whole and mixtral-8x22b at MIX_LAYERS layers from a
   seed, MESH_DECODE_STEPS greedy steps of ``build_decode`` on the mesh
   against the single-device decode from the same prefill: the same
   tokens, the logits within MESH_DECODE_TOL, mixtral's grouped launches by
   body (12 thin a step), warm steps in turns, each path's device time
   a step and the collectives a mesh step dispatches;
   ``softmax_combine_local`` over 4 and 16 chunks of a 32k cache
   against one softmax within COMBINE_TOL; the grouped kernel at a
   rank's buckets of the production decode (RANK_GROUPED_SHAPES:
   mixtral's decode_32k block of slot rows on the tiled body, its
   long_500k block and deepseek's on the thin one) against
   its plain version and ``torch.bmm``, beside its bound; (g) the paged
   decode on the mesh (``build_decode_paged``: each pool read split-KV
   over its pages) — stablelm-1.6b whole on (f)'s weights and deepseek
   at DS_LAYERS layers on phase 12's, at the end of (f) and of (a):
   PAGED_STEPS greedy steps against the single-device paged decode on
   the same pools and page table (PAGED_SLOTS slots, an inactive slot,
   holes): the same tokens, the logits within MESH_DECODE_TOL, the pools
   alike after the steps, deepseek's grouped launches by body (9 thin a
   step), warm steps in turns, each path's device time a step and the
   collectives a mesh step dispatches; (h) after (f): the recurrent
   mixers on their width (MESH_REC: recurrentgemma-2b's first unit of 3
   layers, xlstm-125m whole; random fp32 weights from a seed) — the
   layout (``dense_mesh_layout``'s ``rglru.*``, ``mlstm.*``, ``slstm.*``
   and a decode step's ``state_slices``), the TP prefill against the
   single device (bitwise expected, MESH_TOL required; recurrentgemma's
   local layer on the flash kernel, its launches in the kernels line),
   MESH_TRAIN_STEPS sharded train steps, the losses within MESH_TOL and
   the state bitwise (xlstm's params, m and v normwise within
   MESH_REC_STATE_TOL), MESH_DECODE_STEPS greedy mesh decode steps
   with the same tokens and the logits within MESH_DECODE_TOL, warm
   steps in turns, device time a step and the collectives a mesh step
   dispatches; the collectives of the TP prefill, of the first sharded
   train step and of a mesh decode step by kind, all-reduces,
   all-gathers and reduce-scatters: an RG-LRU layer reduce-scatters its
   gates' partial products once a forward (twice a train step: the
   remat's recompute), and nothing else reduce-scatters on one rank;
   (i) after (h): attention on the rank's heads where the
   'model' axis does not divide them — starcoder2-3b whole (HEADS_ARCH,
   random fp32 weights from a seed): its layout on the production
   mesh's 16-way axis (a range of whole heads in train and prefill, the
   stored columns in a decode step) and on this one, the TP prefill
   bitwise the single one with the flash launches by head dim (one a
   layer, head dim 128), MESH_DECODE_STEPS greedy mesh decode steps with
   the same tokens and the logits within MESH_DECODE_TOL, the
   collectives a step; (j) after (i): ``launch.train.train_config`` on
   the mesh against the one-card launcher (stablelm-1.6b at full width
   cut to LAUNCH_LAYERS layers, LAUNCH_STEPS steps): every loss and
   every state leaf bitwise, then ``--resume`` restoring the mesh run's
   checkpoint onto the mesh bitwise; (k) after (j): the encoder-decoder
   on its shards — whisper-tiny whole (WH_ARCH, random fp32 weights from
   a seed): its layout on the production mesh's 16-way axis (its three
   attentions on a range of whole heads in train and prefill and on the
   stored columns in a decode step, its MLPs on their FF slice, its odd
   vocabulary on ranges of the whole embedding) and on this one, the TP
   prefill (REQUESTS x WH_PROMPT tokens, 1500 frames) bitwise the single
   one with the flash launches by head dim (4 unmasked encoder and 4
   causal decoder layers, head dim 64), MESH_DECODE_STEPS greedy mesh
   decode steps (the self cache split-KV, the cross K/V read in place on
   their head dim, no DTensor moved) with the same tokens and the logits
   within MESH_DECODE_TOL of their largest, the collectives a step,
   MESH_TRAIN_STEPS
   sharded train steps of ENCDEC_TRAIN against the single device
   (phase 12 (d), the int8 cache, runs after the mesh is gone); phase
   16 (b) runs inside (a);
16. the dry run: (a) ``python -m repro_torch.launch.dryrun --device
   cuda --mesh single`` on a fake 256-rank world, in processes run
   together: stablelm-1.6b on every shape (long_500k skipped),
   mixtral-8x22b on decode_32k, xlstm-125m's train_4k, prefill_32k and
   decode_32k, deepseek-v2-236b's prefill_32k and decode_32k, one
   process each, and recurrentgemma-2b, starcoder2-3b and whisper-tiny
   on every shape in one process each;
   each cell's status, trace seconds,
   FLOPs a rank against ``step_flops / n_devices`` (stablelm's
   train_4k and prefill_32k must be within x0.85–1.25 of it, its
   decode_32k within x0.8–1.5: the dense blocks tensor-parallel over
   the 16-way 'model' axis, the cache read split-KV), peak bytes a rank
   (stablelm's and mixtral's decode_32k under the card's 80 GiB,
   deepseek's under DS_DECODE_PEAK_GIB; mixtral's decode_32k FLOPs at
   most MIX_DECODE_RATIO_MAX of its share and its collective bytes
   under MIX_DECODE_GB: a rank's block of the experts' slot rows, its
   KV projections on their stored columns; deepseek's prefill_32k FLOPs at
   most DS_PREFILL_RATIO_MAX of its share: MLA on its heads;
   recurrentgemma's and xlstm's cells at most REC_RATIO_MAX of theirs:
   the recurrent mixers on their width, the sLSTM's input product and
   the mLSTM core on the rank's share; recurrentgemma's train_4k
   collective bytes under RG_TRAIN_GB_MAX: its gates' sum a
   reduce-scatter; starcoder2's at most HEADS_RATIO_MAX: attention on the rank's 2 of 24 heads; whisper's at
   most WHISPER_RATIO_MAX and its decode_32k's collective bytes under
   WHISPER_DECODE_GB: the encoder-decoder on its shards, its decode
   reading its caches in place),
   collective bytes by kind, the kernels' ops traced (stablelm's
   prefill must trace the flash op once per layer, mixtral's decode the
   grouped op, xlstm's prefill the sLSTM op once per sLSTM layer, its
   train step twice (the remat's recompute) and its backward op once)
   and ``roofline_for_cell``'s three terms; the records
   folded by ``launch.profile --dryrun-dir`` into a profile; (b) in
   phase 15 (a), on its one-rank NCCL mesh: deepseek's mesh prefill
   traced on fake tensors laid out like its real inputs — its grouped-op
   calls must equal the real prefill's tiled launches; its FLOPs
   against ``fwd_flops`` and its peak bytes against the real
   ``max_memory_allocated`` are printed as ratios;
17. report: one ``{"adsala": {...}}`` line, one ``{"mixtral": {...}}``
   line, one ``{"deepseek": {...}}`` line, one ``{"serving": {...}}``
   line, one ``{"train": {...}}`` line, one ``{"families": {...}}``
   line, one ``{"train_families": {...}}`` line, one ``{"mesh": {...}}``
   line, one ``{"dryrun": {...}}`` line, one ``{"kernels": [...]}``
   line (one entry per measured shape:
   flash attention at stablelm's, mixtral's and recurrentgemma's
   prefill shapes, recurrentgemma's long request, the queue trace's
   longest prefill and three padded head dims (their launches: those
   the counted main paths made at that head dim, tallied from the
   wrapper's ``launches_by_head_dim``), each with its launch plan, the
   main entry with its launches on the TP mesh prefills (stablelm's in
   phase 15 (e), recurrentgemma's in (h), starcoder2's in (i),
   whisper's in (k)); the
   GEMM at 2048^3 and the
   largest cube; the grouped
   GEMM at mixtral's decode and prefill buckets and deepseek-v2's
   four buckets, with its launches on the mesh paths (the paged one of
   phase 15 (g) too), and at a rank's
   six buckets of the production decode, which no path of a one-rank
   mesh launches (0 launches, with a note); each with its
   body, ring stages and split count), the card's line, and the ``{"ok": true, ...}`` last line.

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
TOL = {"float32": 2e-5, "bfloat16": 5e-2, "float16": 5e-2}
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
#: (H100 80GB HBM3, 700 W), where stablelm's (2048, phase 11) falls.
#: recurrentgemma at 8 of 26 layers and xlstm at 6 of 12, to keep the
#: script inside its 1200 s on slow hosts (the whole models: 85.6 s and
#: a 42.6 GB checkpoint in 71.7 s, and 79.1 s, of a 1210.6 s run on
#: H100 80GB HBM3, 700 W)
FAM_TRAIN = [("recurrentgemma-2b", 8, 4, 1024, None),
             ("xlstm-125m", 6, 4, 1024, None),
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

#: phase 15: the distribution layer on a one-rank NCCL mesh.  The mesh
#: paths against the single-device ones on the same card: deepseek's
#: prefill logits (max |diff| / max |logit|) and the sharded train
#: step's losses (absolute), within MESH_TOL; a one-rank mesh cuts
#: nothing, so both should be bitwise equal
MESH_TOL = 1e-5
MESH_TRAIN_STEPS = 2
#: phase 15 (f): greedy steps of the mesh decode and of the single
#: device; the split softmax over a 32k cache in 4 and 16 chunks against
#: one softmax (max |diff| / max |out|, fp32); a rank's grouped buckets
#: on (16, 16) (name, E, C, d, f): mixtral's 8 experts, which 16 'data'
#: ranks do not divide, split by slot rows (``moe.slot_block``): one
#: expert on an FF slice of 1024 at 20 of decode_32k's global capacity
#: 40, or 4 of long_500k's floor of 8; deepseek's 10 experts a data rank
#: on an FF slice of 96 at decode_32k's capacity 8
MESH_DECODE_STEPS = 16
#: phase 15 (f): the mesh decode's logits against the single device's,
#: fp32, as ``torch.testing.assert_close(atol=, rtol=)`` holds them:
#: |mesh - single| <= MESH_DECODE_TOL x (1 + |single|) element by
#: element.  A one-rank mesh is not bitwise the single device: the
#: split-KV combine divides after the value product
MESH_DECODE_TOL = 1e-5
COMBINE_SHAPE, COMBINE_VALID = (4, 32768, 32, 64), 20000
COMBINE_CHUNKS, COMBINE_TOL = (4, 16), 1e-5
RANK_GROUPED_SHAPES = [("mixtral_decode_rank", 1, 20, 6144, 1024),
                       ("mixtral_decode_rank_wo", 1, 20, 1024, 6144),
                       ("mixtral_long_rank", 1, 4, 6144, 1024),
                       ("mixtral_long_rank_wo", 1, 4, 1024, 6144),
                       ("deepseek_decode_rank", 10, 8, 5120, 96),
                       ("deepseek_decode_rank_wo", 10, 8, 96, 5120)]
#: phase 15 (g): the paged decode on the mesh against the single device:
#: PAGED_SLOTS slots over pools of PAGED_SLOTS x PAGED_TABLE pages of
#: PAGED_PAGE slots (random fp32 contents from a seed), a table dealing
#: out a permutation of the pages, positions from a seed in the second
#: half of the capacity; slot PAGED_INACTIVE inactive (pos -1), slot
#: PAGED_HOLES at a quarter of it with holes past its pages; PAGED_STEPS
#: greedy steps of each path, the logits held at MESH_DECODE_TOL
PAGED_SLOTS, PAGED_PAGE, PAGED_TABLE, PAGED_STEPS = 8, 16, 66, 8
PAGED_INACTIVE, PAGED_HOLES = 5, 2
#: phase 16 (a): stablelm's decode_32k FLOPs a rank against step_flops /
#: 256 (the dense blocks and the split cache), and the card's memory
#: that stablelm's and mixtral's decode_32k peaks a rank stay under
DECODE_RATIO = (0.8, 1.5)
CARD_GIB = 80
#: flash at head dims between the kernel's (zero-padded to 128, 128 and
#: 256): (BH, S, D), causal, fp32
FLASH_PADDED = [(64, 1024, 80), (64, 1024, 96), (32, 1024, 192)]
#: phase 14 (d): the sLSTM op against its plain loop on the card at
#: (b)'s batch x length, xlstm-125m's width; timed in turns, each turn
#: SLSTM_ITERS calls after one warm-up
SLSTM_CMP = (4, 1024)
SLSTM_TURNS, SLSTM_ITERS = ("loop", "op", "op", "loop"), 2
#: xlstm-125m's train step (4 x 1024) through the loop, runs 21a/21b
XL_STEP_S_LOOP = "18-19.6 s"
#: phase 15 (h): the recurrent mixers on their width over the one-rank
#: mesh, full width: (arch, layers or None for the whole model, prompt
#: length of the REQUESTS-row prefill and decode, train batch, train
#: length): recurrentgemma-2b's first unit (rglru, rglru, local: its
#: local layer on the flash kernel at head dim 256), xlstm-125m whole
#: (its sLSTM steps one token at a time: shorter prompts and batches)
MESH_REC = [("recurrentgemma-2b", 3, PROMPT_LEN, 1, 512),
            ("xlstm-125m", None, 128, 1, 128)]
#: phase 15 (h): the sharded train state after MESH_TRAIN_STEPS steps
#: against the single device's, as (c) holds it: every leaf bitwise,
#: but for the archs here, whose params, m and v are each held as one
#: vector, normwise, within these bounds: xlstm's packed q/k/v product
#: sums its gradient in another order than three separate products.
#: Read at 1.285e-08, 8.317e-06 and 8.507e-06, the 2 steps moving the
#: params 8.481e-04 (H100 80GB HBM3, 700 W)
MESH_REC_STATE_TOL = {"xlstm-125m": {"params": 1e-6, "m": 1e-4,
                                    "v": 1e-4}}
#: phase 15 (i): attention on the rank's heads where the 'model' axis
#: does not divide them: starcoder2-3b whole (30 layers, 24 heads, 2 KV
#: heads, head dim 128) on the one-rank mesh, whose one rank divides
#: every head count (the uneven layout itself runs in the CPU worlds and
#: the dry run's trace)
HEADS_ARCH = "starcoder2-3b"
#: phase 15 (j): the training launcher on the one-rank mesh against the
#: one-card launcher: stablelm-1.6b at full width cut to LAUNCH_LAYERS
#: layers, LAUNCH_BATCH x LAUNCH_SEQ, LAUNCH_STEPS steps
LAUNCH_LAYERS, LAUNCH_BATCH, LAUNCH_SEQ, LAUNCH_STEPS = 2, 1, 512, 3
#: phase 15 (k): the encoder-decoder on its shards: WH_ARCH whole on the
#: one-rank mesh, prefilled and decoded at REQUESTS x WH_PROMPT (its
#: encoder on 1500 frames a request), trained MESH_TRAIN_STEPS steps of
#: ENCDEC_TRAIN (batch, text length)
ENCDEC_TRAIN = (2, 448)
#: phase 16 (a): (arch, shape or every shape) of each dry-run process
DRYRUN_CELLS = [("stablelm-1.6b", None), ("mixtral-8x22b", "decode_32k"),
                ("xlstm-125m", "train_4k"), ("xlstm-125m", "prefill_32k"),
                ("xlstm-125m", "decode_32k"),
                ("deepseek-v2-236b", "prefill_32k"),
                ("deepseek-v2-236b", "decode_32k"),
                ("recurrentgemma-2b", None), ("starcoder2-3b", None),
                ("whisper-tiny", None)]
#: phase 16 (a): the recurrent mixers on their width: the most FLOPs a
#: rank of each cell may do, as a multiple of step_flops / 256 (G25, all
#: whole on every rank: recurrentgemma x5.33 / x4.74 / x4.55, xlstm
#: x11.87 / x11.97 / x11.36; recurrentgemma's, with its local
#: attention on its heads too, read at x1.04 / x0.87 / x1.00 on the
#: card's host, H100 80GB HBM3, 700 W; xlstm's, with its projections on
#: their widths but the sLSTM's input product and the mLSTM core whole,
#: at x4.84 / x4.68 / x0.95, G28, and with those on the rank's share at
#: x2.54 / x2.37 / x0.95); recurrentgemma's train_4k at most
#: RG_TRAIN_GB_MAX collective GB a rank (117.7 GB with its gates' sum an
#: all-reduce, G29; 72.4 GB with it a reduce-scatter)
REC_RATIO_MAX = {("recurrentgemma-2b", "train_4k"): 1.5,
                 ("recurrentgemma-2b", "prefill_32k"): 1.5,
                 ("recurrentgemma-2b", "decode_32k"): 1.3,
                 ("xlstm-125m", "train_4k"): 3.0,
                 ("xlstm-125m", "prefill_32k"): 2.8,
                 ("xlstm-125m", "decode_32k"): 2.5}
RG_TRAIN_GB_MAX = 85.0
#: phase 16 (a): attention on the rank's heads where 16 does not divide
#: them: starcoder2's FLOPs a rank at most these multiples of
#: step_flops / 256 (x7.04 / x9.98 / x2.01 with its attention whole on
#: every rank; read at x1.24 / x1.23 / x1.00 on its heads, H100 80GB
#: HBM3, 700 W)
HEADS_RATIO_MAX = {("starcoder2-3b", "train_4k"): 1.5,
                   ("starcoder2-3b", "prefill_32k"): 1.5,
                   ("starcoder2-3b", "decode_32k"): 1.3}
#: phase 16 (a): the encoder-decoder on its shards: whisper's FLOPs a
#: rank at most these multiples of step_flops / 256 (x13.67 / x12.12 /
#: x0.12 with all of it but its MLPs' weights whole on every rank, G25,
#: measured on one H100 80GB HBM3, 700 W), and a decode step's
#: collective GB a rank under WHISPER_DECODE_GB (1.7 GB in G25: its
#: caches' rows gathered every step)
WHISPER_RATIO_MAX = {("whisper-tiny", "train_4k"): 3.0,
                     ("whisper-tiny", "prefill_32k"): 3.5,
                     ("whisper-tiny", "decode_32k"): 0.5}
WHISPER_DECODE_GB = 0.05
DRYRUN_TIMEOUT = 300
#: phase 16 (a): stablelm's train_4k and prefill_32k FLOPs a rank
#: against step_flops / 256 (the dense blocks cut over 'model')
TP_RATIO = (0.85, 1.25)
#: phase 16 (a): deepseek's MLA on its heads: its prefill_32k FLOPs a
#: rank at most this multiple of step_flops / 256 (x23.65 with MLA whole
#: on every rank, G25), its decode_32k peak a rank under this many GiB
#: (26.1 with the MLA and shared-expert weights gathered whole, G25)
DS_PREFILL_RATIO_MAX = 4.0
DS_DECODE_PEAK_GIB = 10.0
#: phase 16 (a): mixtral's decode_32k on the rank's share: its FLOPs a
#: rank at most this multiple of step_flops / 256 (x16.42 with every
#: 'data' rank running all 8 experts' slot rows, G25) and its collective
#: GB a rank under this (1.6 with the picked KV heads' wk and wv
#: gathered whole every step, G25)
MIX_DECODE_RATIO_MAX = 1.6
MIX_DECODE_GB = 0.6
#: the flash kernel's launches on the counted main-path runs, by the
#: caller's head dim (tally_flash adds each run's to it)
FLASH_PATH_BY_D: dict[int, int] = {}


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
    (QK^T and PV; a window of W leaves query i its last W keys) at the
    fp32 CUDA-core rate (``flash_flops``, the flash op's FLOP formula),
    against q, k, v read and o written once at the HBM rate."""
    from repro_torch.kernels.flash_attention import flash_flops
    from repro_torch.roofline import HBM_BW, PEAK_FLOPS

    t_ops = flash_flops(bh, sq, skv, d, causal, window) / PEAK_FLOPS
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

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
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
        # head dims between the kernel's (zero-padded to the next one)
        # and float16 (run in float32)
        ("d24_padded", 2, 200, 200, 24, f32, True, None, 64, 64),
        ("d80_padded_window", 4, 700, 700, 80, f32, True, 100, 256, 128),
        ("d96_padded_noncausal", 3, 200, 150, 96, f32, False, None, 64, 64),
        ("d192_padded", 4, 1024, 1024, 192, f32, True, None, 512, 512),
        ("bf16_d80_padded", 2, 300, 300, 80, bf16, True, None, 128, 128),
        ("fp16_causal_d64", 4, 1024, 1024, 64, f16, True, None, 512, 512),
        ("fp16_d96_padded_window", 2, 300, 300, 96, f16, True, 50, 128,
         128),
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
    kd = fa.kernel_head_dim(d)
    plan = fa.flash_launch(s, s, kd, bq, bkv, dtype=torch.float32,
                           grid=grid)
    print(f"[chip_smoke] flash {(bh, s, d)} fp32 causal window {window} "
          f"block ({bq},{bkv}) plan {plan.cta_rows} rows x "
          f"{plan.sub_cols} cols, {plan.stages} stages, {plan.smem} B: "
          f"dense {times['dense']:.3f} ms, tri {times['tri']:.3f} ms, "
          f"plain {plain_ms:.3f} ms, sdpa {sdpa_ms:.3f} ms, bound "
          f"{bound:.3f} ms ({bound_by}), max_abs_err {err:.3e}")
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": [bh, s, d], "kernel_head_dim": kd,
            "block": [bq, bkv], "grid": grid,
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
    """Least time for an fp32 GEMM: 2mkn flops (``matmul_flops``, the
    GEMM op's FLOP formula) at the CUDA-core rate against A, B read and C
    written once at the HBM rate."""
    from repro_torch.kernels.matmul import matmul_flops

    return _bound(float(matmul_flops(m, k, n)),
                  4.0 * (m * k + k * n + m * n))


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
    reset_flash(fa)
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
    tally_flash(fa)
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
    """Least time for an fp32 grouped GEMM: 2ecdf flops (``grouped_flops``,
    the grouped op's FLOP formula) at the CUDA-core rate against X, W
    read and Y written once at the HBM rate."""
    from repro_torch.kernels.grouped_matmul import grouped_flops

    return _bound(float(grouped_flops(e, c, d, f)),
                  4.0 * e * (c * d + d * f + c * f))


def kernel_counts(M, fa, G) -> dict:
    return {"grouped": G.grouped_matmul_cuda.launches,
            "grouped_by_variant": dict(
                G.grouped_matmul_cuda.launches_by_variant),
            "flash": fa.flash_attention_cuda.launches,
            "matmul": M.matmul_cuda.launches}


def reset_counts(M, fa, G) -> None:
    G.grouped_matmul_cuda.launches = 0
    G.grouped_matmul_cuda.launches_by_variant = {"thin": 0, "tiled": 0}
    reset_flash(fa)
    M.matmul_cuda.launches = 0


def reset_flash(fa) -> None:
    fa.flash_attention_cuda.launches = 0
    fa.flash_attention_cuda.launches_by_head_dim = {}


def tally_flash(fa) -> None:
    """Add the flash launches by head dim of the main-path run just read
    (since the counts were reset) to FLASH_PATH_BY_D."""
    for d, n in fa.flash_attention_cuda.launches_by_head_dim.items():
        FLASH_PATH_BY_D[d] = FLASH_PATH_BY_D.get(d, 0) + n


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
    tally_flash(fa)
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
    tally_flash(fa)
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


def phase_train(M, fa, G, torch, mesh) -> tuple[dict, dict]:
    """Phase 11: training on the card — card against CPU at 2 layers,
    the full-depth launcher run, its checkpoint restored bitwise, a
    resume; with phase 15 (c), (d) on ``mesh`` while the state and its
    checkpoint live."""
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
    del restored, live, back
    torch.cuda.empty_cache()
    on_mesh = mesh_train(res, full_dir, mesh, M, fa, G, torch)
    del res
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
    return out, on_mesh


def phase_deepseek(art: Path, M, fa, G, torch, mesh
                   ) -> tuple[dict, dict, dict]:
    """Phase 12 (a)-(c): serve deepseek-v2-236b (full width, DS_LAYERS
    layers, fp32) through ``serve.serve_config`` and through the
    continuous-batching scheduler over latent page pools; count the
    grouped launches; check against the plain path and the fixed batch;
    time the grouped kernel at deepseek's buckets.  Phase 15 (a) runs on
    ``mesh`` between (a) and (b), on the same weights."""
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

    on_mesh = mesh_deepseek(res, cfg, mesh, M, fa, G, torch)

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
    return out, entry, on_mesh


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
    tally_flash(fa)
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
            tally_flash(fa)
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
    tally_flash(fa)
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
    tally_flash(fa)
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

    # -- (d) the sLSTM op against its plain loop ----------------------------------
    reset_counts(M, fa, G)
    report["slstm"] = slstm_op_vs_loop(torch)
    no_launches("the sLSTM comparison", M, fa, G)
    xl_step = report["full"][XL_ARCH]["step_ms_median_3_on"] / 1e3
    report["slstm"]["xlstm_step_s"] = xl_step
    print(f"[chip_smoke] train {XL_ARCH}: a step of "
          f"{SLSTM_CMP[0]}x{SLSTM_CMP[1]} through the sLSTM op "
          f"{xl_step:.2f} s (median of steps 3-{FAM_STEPS}); through the "
          f"loop {XL_STEP_S_LOOP} (runs 21a/21b)")
    free()
    return report


def slstm_op_vs_loop(torch) -> dict:
    """Phase 14 (d): one xlstm-125m sLSTM block (``slstm_train``: the
    hoisted input product x @ w_in, then ``repro_torch::slstm_scan`` over
    it and its backward) against the plain loop (``slstm_train_loop``:
    the same hoisted product, then the steps under autograd) on the
    card, seeded weights at the model's init: the forward must be
    bitwise the loop's, the gradients of x, w_in, w_rec and b within
    TRAIN_GRAD_TOL normwise; forward and forward + backward ms of each,
    in turns."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.models import xlstm as XL
    from repro_torch.models.params import init_params

    cfg = get_config(XL_ARCH)
    spec = XL.XLSTMSpec(d_model=cfg.d_model, n_heads=cfg.n_heads)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = init_params(XL.slstm_defs(spec), gen, torch.float32)
    b, s = SLSTM_CMP
    x = torch.randn((b, s, spec.d_model), generator=gen, device="cuda")
    dy = torch.randn((b, s, spec.d_model), generator=gen, device="cuda")
    fns = {"op": XL.slstm_train, "loop": XL.slstm_train_loop}
    names = ("x", "w_in", "w_rec", "b")

    def forward(name):
        with torch.no_grad():
            return fns[name](p, x, spec)[0]

    def backward(name):
        leaves = [t.detach().requires_grad_(True)
                  for t in (x, p["w_in"], p["w_rec"], p["b"])]
        q = {**p, **dict(zip(names[1:], leaves[1:]))}
        out, _ = fns[name](q, leaves[0], spec)
        return torch.autograd.grad(out, leaves, dy)

    fwd_diff = (forward("op") - forward("loop")).abs().max().item()
    grads = {name: backward(name) for name in fns}
    grad_err = {n: ((g - w).double().norm() / w.double().norm()).item()
                for n, g, w in zip(names, grads["op"], grads["loop"])}
    del grads
    fwd_ms = {name: [] for name in fns}
    fb_ms = {name: [] for name in fns}
    for name in SLSTM_TURNS:
        fwd_ms[name].append(cuda_ms(lambda: forward(name),
                                    iters=SLSTM_ITERS, warmup=1))
        fb_ms[name].append(cuda_ms(lambda: backward(name),
                                   iters=SLSTM_ITERS, warmup=1))
    med = {k: {name: statistics.median(v[name]) for name in fns}
           for k, v in (("fwd", fwd_ms), ("fwd_bwd", fb_ms))}
    print(f"[chip_smoke] sLSTM op vs loop ({b}x{s}x{spec.d_model}, fp32): "
          f"forward max |diff| {fwd_diff:.3e}; gradients normwise "
          + ", ".join(f"{n} {e:.3e}" for n, e in grad_err.items())
          + f" (tol {TRAIN_GRAD_TOL:g}); forward ms op "
          f"{med['fwd']['op']:.1f} loop {med['fwd']['loop']:.1f}; "
          f"forward + backward ms op {med['fwd_bwd']['op']:.1f} loop "
          f"{med['fwd_bwd']['loop']:.1f} (turns {SLSTM_TURNS}: forward "
          f"{fwd_ms}, forward + backward {fb_ms})")
    if fwd_diff != 0.0 or not all(e <= TRAIN_GRAD_TOL
                                  for e in grad_err.values()):
        raise SystemExit("[chip_smoke] FAIL: the sLSTM op disagrees with "
                         "its plain loop on the card")
    return {"shape": [b, s, spec.d_model], "dtype": "float32",
            "forward_max_abs_diff": fwd_diff, "grads_normwise": grad_err,
            "forward_ms": fwd_ms, "forward_backward_ms": fb_ms,
            "median_ms": med}


# ---------------------------------------------------------------------------
# phase 15: the distribution layer on a one-rank mesh
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def one_rank_mesh(torch):
    """A one-rank NCCL world (an in-process store: no address, no port)
    and its (1, 1) ("data", "model") mesh on the card, destroyed on
    leaving."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cuda")
    finally:
        dist.destroy_process_group()


def in_turns(fns: dict, torch, iters: int) -> dict:
    """Each of two callables timed by CUDA events in the order a, b, b, a;
    the mean of its two turns."""
    (ka, fa_), (kb, fb) = fns.items()
    t = {ka: [], kb: []}
    for k, f in ((ka, fa_), (kb, fb), (kb, fb), (ka, fa_)):
        t[k].append(cuda_ms(f, iters=iters, warmup=1))
    return {k: sum(v) / len(v) for k, v in t.items()}


def coll_kinds(counts: dict) -> dict:
    """``CommDebugMode``'s counts by op, summed by kind."""
    kinds = {"all-reduce": ("allreduce", "all_reduce"),
             "all-gather": ("allgather", "all_gather"),
             "reduce-scatter": ("reduce_scatter",),
             "all-to-all": ("alltoall", "all_to_all")}
    out = {k: 0 for k in kinds}
    for op, n in counts.items():
        name = str(op).lower()
        for k, marks in kinds.items():
            if any(m in name for m in marks):
                out[k] += n
    return out


def mesh_train(res, ckpt_dir, mesh, M, fa, G, torch) -> dict:
    """Phase 15 (c), (d), (e), inside phase 11 while its state and
    checkpoint live: (d) the checkpoint restored onto the mesh by the
    state specs, bitwise the state in memory; (c) MESH_TRAIN_STEPS
    sharded steps from that state (tensor-parallel over 'model': the
    rank's shards and the vocab-parallel loss) against the single-device
    step from the state itself, in turns on the same batches: the losses
    within MESH_TOL, and then every leaf of the two states (params,
    moments, step) bitwise equal (a one-rank mesh cuts nothing); (e)
    :func:`mesh_prefill_tp` on the stepped weights."""
    from torch.distributed.tensor import DTensor

    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.data.pipeline import SyntheticLM, make_global_batch
    from repro_torch.dist.sharding import partition_params, state_specs
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import build_train_step

    cfg, model, live = res.cfg, res.model, res.driver.state
    specs = state_specs(partition_params(model, cfg, mesh))
    # -- (d) the checkpoint onto the mesh -----------------------------------
    t0 = time.perf_counter()
    on_mesh = restore_checkpoint(str(ckpt_dir), TRAIN_STEPS, live,
                                 mesh=mesh, specs=specs)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    pairs = list(zip(tree_leaves(live), tree_leaves(on_mesh)))
    same = all(isinstance(b, DTensor) and b.dtype == a.dtype
               and torch.equal(b.to_local(), a) for a, b in pairs)
    print(f"[chip_smoke] mesh (d): phase 11's checkpoint restored onto "
          f"the (1, 1) mesh as {len(pairs)} DTensors by the state specs in "
          f"{restore_s:.1f}s; bitwise the state in memory: {same}")
    if not same:
        raise SystemExit("[chip_smoke] FAIL: the checkpoint restored onto "
                         "the mesh differs from the state in memory")
    del pairs
    # -- (c) sharded steps against the single-device step -----------------
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=100)
    shape = ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    step_m, _, b_specs = build_train_step(model, cfg, opt, shape=shape,
                                          mesh=mesh)
    step_1, _, _ = build_train_step(model, cfg, opt)
    data = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH)
    reset_counts(M, fa, G)
    losses = {"single": [], "mesh": []}
    step_s = {"single": [], "mesh": []}
    for i in range(MESH_TRAIN_STEPS):
        batch = data.batch_at(TRAIN_STEPS + i)
        for kind in ("single", "mesh") if i % 2 == 0 else ("mesh",
                                                            "single"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "single":
                live, m = step_1(live, make_global_batch(batch, None,
                                                         device="cuda"))
            else:
                on_mesh, m = step_m(on_mesh, make_global_batch(
                    batch, mesh, b_specs))
            loss = float(m["loss"])
            step_s[kind].append(time.perf_counter() - t0)
            losses[kind].append(loss)
    no_launches("the mesh train steps", M, fa, G)
    err = max(abs(a - b) for a, b in zip(losses["single"], losses["mesh"]))
    # the whole state after the steps (params, moments, step), leaf by
    # leaf: the losses alone barely see a wrong update
    pairs = list(zip(tree_leaves(live), tree_leaves(on_mesh)))
    state_diff = sum(not (isinstance(b, DTensor) and torch.equal(
        b.to_local(), a)) for a, b in pairs)
    del pairs
    print(f"[chip_smoke] mesh (c): {MESH_TRAIN_STEPS} sharded steps of "
          f"{cfg.name} ({TRAIN_BATCH}x{TRAIN_SEQ}) from the restored state "
          f"against the single-device step: losses mesh "
          f"{losses['mesh']} single {losses['single']}, max |diff| "
          f"{err:.3e} (tol {MESH_TOL:g}); state leaves that differ "
          f"after the steps: {state_diff} of {len(tree_leaves(live))}; "
          "step s mesh "
          + " ".join(f"{t:.3f}" for t in step_s["mesh"]) + ", single "
          + " ".join(f"{t:.3f}" for t in step_s["single"]))
    if not err <= MESH_TOL or state_diff:
        raise SystemExit("[chip_smoke] FAIL: the sharded train step "
                         "disagrees with the single-device step")
    del on_mesh
    torch.cuda.empty_cache()
    tp_prefill = mesh_prefill_tp(model, cfg, live["params"], mesh, M, fa, G,
                                 torch)
    return {"restore_s": restore_s, "restore_bitwise": same,
            "train_losses": losses, "train_loss_max_abs_err": err,
            "train_state_leaves_differ": state_diff,
            "train_step_s": step_s, "tp_prefill": tp_prefill}


def leaves_of(caches) -> list:
    """Every tensor of a list of per-layer caches, in order."""
    import dataclasses

    return [getattr(c, f.name) for c in caches
            for f in dataclasses.fields(c)
            if hasattr(getattr(c, f.name), "element_size")]


def mesh_prefill_tp(model, cfg, params, mesh, M, fa, G, torch,
                    prompt_len: int = PROMPT_LEN,
                    bitwise: bool = True) -> dict:
    """Phase 15 (e), at the end of phase 11 (and (h) for the recurrent
    mixers): ``cfg`` (fp32, its weights laid out on the mesh without a
    copy) through ``serve.step.build_prefill`` on the mesh,
    tensor-parallel over 'model' (on one rank its shards are the whole
    weights and its collectives run on a one-rank group), against the
    single-device prefill on the same REQUESTS x ``prompt_len`` prompts:
    the flash kernel's launches (one an attention layer), logits and
    caches bitwise (``bitwise``; else within MESH_TOL, max |diff| / max
    |value|, bitwise reported), warm times in turns."""
    from repro_torch.dist.collectives import distribute
    from repro_torch.dist.sharding import partition_params
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.serve.step import build_prefill
    from repro_torch.train.step import make_ctx

    cache_len = prompt_len + GEN_TOKENS
    it = iter(tree_leaves(partition_params(model, cfg, mesh),
                          is_leaf=is_spec))
    sharded = tree_map(lambda t: distribute(t, mesh, next(it)), params)
    no_copy = all(a.to_local().data_ptr() == b.data_ptr() for a, b in zip(
        tree_leaves(sharded), tree_leaves(params)))
    prefill, _, b_specs = build_prefill(
        model, cfg, ShapeSpec("prefill", cache_len, REQUESTS, "prefill"),
        mesh)
    gen = torch.Generator(device="cuda").manual_seed(15)
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, prompt_len),
                            generator=gen, device="cuda")
    batch = {"tokens": distribute(prompts, mesh, b_specs["tokens"])}
    ctx = make_ctx("prefill", cache_len=cache_len)
    want_flash = sum(s.kind in ("attn", "local") for s in model.plan)
    from torch.distributed.tensor.debug import CommDebugMode

    with torch.inference_mode():
        reset_counts(M, fa, G)
        with CommDebugMode() as comm:
            logits, cache = prefill(sharded, batch)
        torch.cuda.synchronize()
        n = kernel_counts(M, fa, G)
        colls = coll_kinds(comm.get_comm_counts())
        by_d = dict(fa.flash_attention_cuda.launches_by_head_dim)
        tally_flash(fa)
        reset_counts(M, fa, G)
        want, cache1 = model.prefill(params, prompts, ctx)
        pairs = list(zip(leaves_of(cache), leaves_of(cache1)))
        same_logits = torch.equal(logits, want)
        same_cache = len(pairs) == len(leaves_of(cache1)) and all(
            torch.equal(a, b) for a, b in pairs)
        err = (logits - want).abs().max().item()
        rel = err / want.abs().max().item()
        cache_rel = max((a - b).abs().max().item()
                        / max(b.abs().max().item(), 1e-30) for a, b in pairs)
        del cache, cache1, pairs
        ms = in_turns({
            "single": lambda: model.prefill(params, prompts, ctx)[0],
            "mesh": lambda: prefill(sharded, batch)[0]}, torch, iters=2)
    print(f"[chip_smoke] mesh: {cfg.name} ({cfg.n_layers} layers, "
          f"{cfg.n_heads} heads, {REQUESTS}x{prompt_len}) through "
          f"build_prefill on the (1, 1) mesh, tensor-parallel over 'model' "
          f"(weights laid out without a copy: {no_copy}): flash launches "
          f"{n['flash']} (expected {want_flash}; by head dim {by_d}), "
          f"matmul {n['matmul']}, "
          f"grouped {n['grouped']}; logits bitwise the single-device "
          f"prefill's: {same_logits} (max |diff| {err:.3e}, rel {rel:.3e}),"
          f" caches bitwise: {same_cache} (max rel {cache_rel:.3e}; "
          f"{'bitwise' if bitwise else f'tol {MESH_TOL:g}'} required); "
          f"warm in turns single {ms['single']:.1f} ms, mesh "
          f"{ms['mesh']:.1f} ms; collectives {colls}")
    if n["flash"] != want_flash or n["matmul"] or n["grouped"]:
        raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s tensor-parallel "
                         "prefill did not run the flash kernel once an "
                         "attention layer")
    agree = (same_logits and same_cache) if bitwise else (
        rel <= MESH_TOL and cache_rel <= MESH_TOL)
    if not (no_copy and agree):
        raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s tensor-parallel "
                         "prefill differs from the single-device prefill")
    del sharded, batch
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "batch": [REQUESTS, prompt_len],
            "flash_launches": n["flash"], "flash_by_head_dim": by_d,
            "logits_bitwise": same_logits,
            "caches_bitwise": same_cache, "logits_max_abs_err": err,
            "logits_rel_err": rel, "caches_rel_err": cache_rel,
            "prefill_ms": ms, "collectives": colls}


def mesh_train_tp(model, cfg, params, mesh, batch: int, seq: int, M, fa,
                  G, torch) -> dict:
    """Phase 15 (h), (k): MESH_TRAIN_STEPS sharded train steps of
    ``model`` on the mesh (its state laid out by the state specs: a copy of the
    single device's) against the single-device step from the same
    state, in turns on the same ``batch`` x ``seq`` batches: the losses
    within MESH_TOL; after the steps every state leaf bitwise, or for an
    arch of MESH_REC_STATE_TOL its params, m and v normwise within their
    bounds (beside how far the steps moved the params); each step's
    seconds reported (the first mesh step's under ``CommDebugMode``,
    which counts its collectives by kind); no kernel may launch."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data.pipeline import SyntheticLM, make_global_batch
    from repro_torch.dist.collectives import distribute
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.train.optim import AdamWConfig, init_state
    from repro_torch.train.step import build_train_step

    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=100)
    shape = ShapeSpec("train", seq, batch, "train")
    step_m, s_specs, b_specs = build_train_step(model, cfg, opt,
                                                shape=shape, mesh=mesh)
    step_1, _, _ = build_train_step(model, cfg, opt)
    live = init_state(tree_map(lambda t: t.clone(), params), opt)
    on_mesh = {}
    for k, v in live.items():
        it = iter(tree_leaves(s_specs[k], is_leaf=is_spec)) if k != "step" \
            else iter([()])
        # a one-rank mesh lays a tensor out without a copy: clone first
        on_mesh[k] = tree_map(lambda t: distribute(t.clone(), mesh,
                                                   next(it)), v)
    audio = {"audio_dim": cfg.d_model, "audio_len": cfg.encoder_len} \
        if cfg.family == "audio" else {}
    data = SyntheticLM(cfg.vocab, seq, batch, **audio)
    reset_counts(M, fa, G)
    losses = {"single": [], "mesh": []}
    step_s = {"single": [], "mesh": []}
    for i in range(MESH_TRAIN_STEPS):
        b = data.batch_at(i)
        for kind in ("single", "mesh") if i % 2 == 0 else ("mesh",
                                                            "single"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "single":
                live, m = step_1(live, make_global_batch(b, None,
                                                         device="cuda"))
            elif i == 0:
                with CommDebugMode() as comm:
                    on_mesh, m = step_m(on_mesh, make_global_batch(
                        b, mesh, b_specs))
                colls = coll_kinds(comm.get_comm_counts())
            else:
                on_mesh, m = step_m(on_mesh, make_global_batch(b, mesh,
                                                               b_specs))
            losses[kind].append(float(m["loss"]))
            step_s[kind].append(time.perf_counter() - t0)
    no_launches(f"{cfg.name}'s mesh train steps", M, fa, G)
    err = max(abs(a - b) for a, b in zip(losses["single"], losses["mesh"]))
    pairs = list(zip(tree_leaves(live), tree_leaves(on_mesh)))
    state_diff = sum(not torch.equal(b.to_local(), a) for a, b in pairs)
    n_leaves = len(pairs)
    del pairs

    def normwise(got, want) -> float:
        num = sum(float((g - w).double().square().sum())
                  for g, w in zip(got, want))
        den = sum(float(w.double().square().sum()) for w in want)
        return (num / den) ** 0.5

    state_err = {k: normwise([t.to_local() for t in tree_leaves(on_mesh[k])],
                             tree_leaves(live[k]))
                 for k in live if k != "step"}
    moved = normwise(tree_leaves(live["params"]), tree_leaves(params))
    tol = MESH_REC_STATE_TOL.get(cfg.name)
    del live, on_mesh
    torch.cuda.empty_cache()
    print(f"[chip_smoke] mesh: {MESH_TRAIN_STEPS} sharded steps of "
          f"{cfg.name} ({batch}x{seq}) against the single-device step: "
          f"losses mesh {losses['mesh']} single {losses['single']}, max "
          f"|diff| {err:.3e} (tol {MESH_TOL:g}); state leaves that differ "
          f"after the steps: {state_diff} of {n_leaves}; normwise "
          + ", ".join(f"{k} {e:.3e}" for k, e in state_err.items())
          + (" (bitwise required" if tol is None else f" (tol {tol}")
          + f"; the steps moved the params {moved:.3e} normwise); step s "
          "mesh " + " ".join(f"{t:.3f}" for t in step_s["mesh"])
          + ", single " + " ".join(f"{t:.3f}" for t in step_s["single"])
          + f"; collectives of the first mesh step {colls}")
    agree = not state_diff if tol is None else all(
        e <= tol[k] for k, e in state_err.items())
    if not (err <= MESH_TOL and agree):
        raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s sharded train "
                         "step disagrees with the single-device step")
    return {"batch": [batch, seq], "losses": losses,
            "loss_max_abs_err": err, "state_leaves_differ": state_diff,
            "state_leaves": n_leaves, "state_normwise": state_err,
            "state_tol": tol, "params_moved_normwise": moved,
            "step_s": step_s, "collectives": colls}


def mesh_recurrent(mesh, M, fa, G, torch) -> dict:
    """Phase 15 (h): the recurrent mixers on their width over the
    one-rank mesh's 'model' axis — for each MESH_REC entry (fp32, random
    weights from a seed, full width, depth as given): the TP prefill
    against the single device (:func:`mesh_prefill_tp`: recurrentgemma's
    local layer on the flash kernel, its launches counted), the sharded
    train steps (:func:`mesh_train_tp`) and MESH_DECODE_STEPS greedy
    steps of the mesh decode (:func:`mesh_decode_model`: the RG-LRU's
    state and the mLSTM's matrix memory read in place, the sLSTM on its
    stored columns), each against the single device; and the layout the
    mesh computes the mixers in (``dense_mesh_layout``'s ``rglru.*``,
    ``mlstm.*``, ``slstm.*``; a decode step's ``state_slices``)."""
    import dataclasses

    from repro_torch.configs import build_model, get_config
    from repro_torch.models.transformer import dense_mesh_layout, \
        state_slices

    out = {}
    for arch, layers, prompt_len, train_batch, train_seq in MESH_REC:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        model = build_model(cfg)
        cut = sorted(k for k in dense_mesh_layout(cfg, mesh, decode=True)
                     if k.split(".")[0] in ("rglru", "mlstm", "slstm"))
        slices = {s.kind: state_slices(cfg, s.kind, 1) for s in model.plan}
        print(f"[chip_smoke] mesh (h): {cfg.name} ({cfg.n_layers} layers) "
              f"computes on 'model': {cut}; a decode step reads in place "
              f"{ {k: v for k, v in slices.items() if v} }")
        if not cut or not any(slices.values()):
            raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s mixers are "
                             "not cut over 'model'")
        gen = torch.Generator(device="cuda").manual_seed(28)
        params = model.init(gen)
        row = {"cut": cut, "prefill": mesh_prefill_tp(
            model, cfg, params, mesh, M, fa, G, torch,
            prompt_len=prompt_len, bitwise=False)}
        row["train"] = mesh_train_tp(model, cfg, params, mesh, train_batch,
                                     train_seq, M, fa, G, torch)
        del params
        torch.cuda.empty_cache()
        row["decode"] = mesh_decode_model(arch, layers, mesh, M, fa, G,
                                          torch, prompt_len=prompt_len)
        # the RG-LRU gates' sum is a reduce-scatter, once a forward
        n_rglru = sum(s.kind == "rglru" for s in model.plan)
        want = {"prefill": n_rglru, "train": 2 * n_rglru,
                "decode": n_rglru}
        got = {k: row[k]["collective_kinds" if k == "decode"
                         else "collectives"]["reduce-scatter"]
               for k in want}
        print(f"[chip_smoke] mesh (h): {cfg.name} reduce-scatters: "
              f"{got} (expected {want}: the RG-LRU gates' sum, once a "
              f"forward)")
        if got != want:
            raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s RG-LRU "
                             "gates are not reduce-scattered once a "
                             "forward")
        row["phase_s"] = time.perf_counter() - t0
        out[arch] = row
    return out


def mesh_heads(mesh, M, fa, G, torch) -> dict:
    """Phase 15 (i): attention on the rank's heads where the 'model'
    axis does not divide them — HEADS_ARCH whole at full width (random
    fp32 weights from a seed): the layout it computes attention in on
    the production mesh's 16-way axis and on this one
    (``dense_mesh_layout``), the TP prefill bitwise the single one with
    its flash launches by head dim (:func:`mesh_prefill_tp`), and
    MESH_DECODE_STEPS greedy steps of the mesh decode against the single
    device with the collectives a step dispatches
    (:func:`mesh_decode_model`)."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.dist.sharding import MeshShape
    from repro_torch.models.transformer import dense_mesh_layout

    t0 = time.perf_counter()
    cfg = get_config(HEADS_ARCH)
    model = build_model(cfg)
    prod = MeshShape({"data": 16, "model": 16})
    lay = {k: v for k, v in dense_mesh_layout(cfg, prod).items()
           if k.startswith("attn.")}
    dec = {k: v for k, v in dense_mesh_layout(cfg, prod, decode=True
                                              ).items()
           if k.startswith("attn.")}
    here = sorted(k for k in dense_mesh_layout(cfg, mesh)
                  if k.startswith("attn."))
    print(f"[chip_smoke] mesh (i): {cfg.name} ({cfg.n_layers} layers, "
          f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads) on (16, 16): "
          f"train and prefill {lay}; a decode step {dec}; on this mesh "
          f"{here}")
    if not (lay.get("attn.wq") == ((), True)
            and dec.get("attn.wq") == ((None, "model"), False)
            and "attn.wq" in here):
        raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s attention is "
                         "not laid out on its heads")
    gen = torch.Generator(device="cuda").manual_seed(29)
    params = model.init(gen)
    row = {"layout": {"train": {k: repr(v) for k, v in lay.items()},
                      "decode": {k: repr(v) for k, v in dec.items()}},
           "prefill": mesh_prefill_tp(model, cfg, params, mesh, M, fa, G,
                                      torch)}
    del params
    torch.cuda.empty_cache()
    row["decode"] = mesh_decode_model(HEADS_ARCH, None, mesh, M, fa, G,
                                      torch)
    row["phase_s"] = time.perf_counter() - t0
    return row


def mesh_launcher(mesh, M, fa, G, torch) -> dict:
    """Phase 15 (j): ``launch.train.train_config`` on the one-rank mesh
    against the one-card launcher — stablelm-1.6b at full width cut to
    LAUNCH_LAYERS layers, LAUNCH_STEPS steps of LAUNCH_BATCH x
    LAUNCH_SEQ from the same seed on the same batches: every loss and
    every state leaf bitwise (a one-rank mesh cuts nothing); then
    ``--resume`` of the mesh run's checkpoint restores its state onto the
    mesh, bitwise.  No kernel may launch (training runs on the
    ``library`` backend)."""
    import dataclasses
    import shutil

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.params import tree_leaves

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(ARCH), n_layers=LAUNCH_LAYERS)
    root = WORK / "launch_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def args(name: str, *extra: str):
        return train.parse_args(
            ["--device", "cuda", "--steps", str(LAUNCH_STEPS), "--batch",
             str(LAUNCH_BATCH), "--seq", str(LAUNCH_SEQ), "--ckpt-dir",
             str(root / name), "--ckpt-every", str(10 * LAUNCH_STEPS),
             *extra])

    reset_counts(M, fa, G)
    one = train.train_config(cfg, args("one"))
    on = train.train_config(cfg, args("mesh"), mesh=mesh)
    no_launches("the launcher's steps", M, fa, G)
    pairs = list(zip(tree_leaves(one.driver.state),
                     tree_leaves(on.driver.state)))
    differ = sum(not (isinstance(b, DTensor) and torch.equal(
        b.to_local(), a)) for a, b in pairs)
    same_losses = one.losses == on.losses
    wall = {"one": one.wall_s, "mesh": on.wall_s}
    del one, pairs
    shutil.rmtree(root / "one", ignore_errors=True)
    back = train.train_config(cfg, args("mesh", "--resume"), mesh=mesh)
    pairs = list(zip(tree_leaves(on.driver.state),
                     tree_leaves(back.driver.state)))
    restored = sum(not (isinstance(b, DTensor) and torch.equal(
        b.to_local(), a.to_local())) for a, b in pairs)
    n_leaves = len(pairs)
    del pairs
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "batch": [LAUNCH_BATCH, LAUNCH_SEQ], "steps": LAUNCH_STEPS,
           "losses": on.losses, "same_losses": same_losses,
           "state_leaves_differ": differ, "state_leaves": n_leaves,
           "resumed_from": back.resumed_from,
           "resumed_leaves_differ": restored,
           "ckpt_gb": on.ckpt_bytes / 1e9, "ckpt_s": on.ckpt_s,
           "wall_s": wall}
    del on, back
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    print(f"[chip_smoke] mesh (j): launch.train.train_config of "
          f"{cfg.name} ({cfg.n_layers} layers, {LAUNCH_BATCH}x{LAUNCH_SEQ}, "
          f"{LAUNCH_STEPS} steps) on the (1, 1) mesh against the one-card "
          f"launcher: losses {out['losses']}, bitwise {same_losses}; "
          f"state leaves that differ {differ} of {n_leaves}; --resume "
          f"from step {out['resumed_from']} onto the mesh, leaves that "
          f"differ from the state it saved {restored}; checkpoint "
          f"{out['ckpt_gb']:.3f} GB in {out['ckpt_s']:.1f}s; "
          f"{out['phase_s']:.1f}s")
    if not (same_losses and not differ and not restored
            and out["resumed_from"] == LAUNCH_STEPS):
        raise SystemExit("[chip_smoke] FAIL: the launcher on the mesh "
                         "differs from the one-card launcher or does not "
                         "resume onto the mesh")
    return out


def mesh_encdec(mesh, M, fa, G, torch) -> dict:
    """Phase 15 (k): the encoder-decoder on its shards — WH_ARCH whole at
    full width (random fp32 weights from a seed) on the one-rank mesh:
    the layout it computes in on the production mesh's 16-way axis and
    on this one (``dense_mesh_layout``); the TP prefill through
    ``build_prefill`` (the encoder's and the decoder's self-attention on
    the rank's heads through the flash kernel, launches counted by head
    dim; the cross-attention on its heads, the MLPs on their FF slice,
    the logits on the rank's vocab rows) bitwise the single-device
    prefill on REQUESTS x WH_PROMPT tokens and 1500 frames; then
    MESH_DECODE_STEPS greedy steps of ``build_decode`` from the
    single-device prefill's caches laid out by ``shard_cache`` (the self
    cache read split-KV, the cross K/V in place on their head dim, no
    DTensor moved) against the single-device decode: the same tokens,
    the logits within MESH_DECODE_TOL of their largest; the collectives
    a step dispatches and the steps timed in turns; MESH_TRAIN_STEPS sharded train steps against the
    single device (:func:`mesh_train_tp`)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import build_model, get_config
    from repro_torch.dist.collectives import distribute
    from repro_torch.dist.sharding import MeshShape, partition_params
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.models.transformer import dense_mesh_layout
    from repro_torch.serve.step import _map_arrays, build_decode, \
        build_prefill, shard_cache
    from repro_torch.train.step import make_ctx

    t0 = time.perf_counter()
    cfg = get_config(WH_ARCH)
    model = build_model(cfg)
    prod = MeshShape({"data": 16, "model": 16})
    lay = dense_mesh_layout(cfg, prod)
    dec = dense_mesh_layout(cfg, prod, decode=True)
    here = sorted(dense_mesh_layout(cfg, mesh))
    print(f"[chip_smoke] mesh (k): {cfg.name} ({cfg.n_encoder_layers} + "
          f"{cfg.n_layers} layers, {cfg.n_heads} heads, vocab {cfg.vocab}) "
          f"on (16, 16): train and prefill {lay}; a decode step {dec}; on "
          f"this mesh {here}")
    if not (lay.get("attn.wq") == ((), True)
            and lay.get("embed") == ((), True)
            and lay.get("mlp.wi") == ((None, "model"), False)
            and dec.get("attn.wq") == ((None, "model"), False)
            and {"attn.wq", "embed", "mlp.wi"} <= set(here)):
        raise SystemExit(f"[chip_smoke] FAIL: {cfg.name} is not laid out "
                         "on its shards")

    def leaves(caches) -> list:
        out = []
        _map_arrays(out.append, caches)
        return out

    gen = torch.Generator(device="cuda").manual_seed(30)
    params = model.init(gen)
    steps = MESH_DECODE_STEPS
    cache_len = WH_PROMPT + steps
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, WH_PROMPT),
                            generator=gen, device="cuda")
    audio = torch.randn((REQUESTS, cfg.encoder_len, cfg.d_model),
                        generator=gen, device="cuda")
    whole = {"tokens": prompts, "audio_emb": audio}
    it = iter(tree_leaves(partition_params(model, cfg, mesh),
                          is_leaf=is_spec))
    sharded = tree_map(lambda t: distribute(t, mesh, next(it)), params)
    prefill, _, b_specs = build_prefill(
        model, cfg, ShapeSpec("prefill", cache_len, REQUESTS, "prefill"),
        mesh)
    batch = {k: distribute(v, mesh, b_specs[k]) for k, v in whole.items()}
    pctx = make_ctx("prefill", cache_len=cache_len)
    dctx = make_ctx("decode", cache_len=cache_len)
    want_flash = cfg.n_encoder_layers + cfg.n_layers
    with torch.inference_mode():
        # -- the TP prefill against the single-device one ------------------
        reset_counts(M, fa, G)
        logits, cache = prefill(sharded, batch)
        torch.cuda.synchronize()
        n = kernel_counts(M, fa, G)
        by_d = dict(fa.flash_attention_cuda.launches_by_head_dim)
        tally_flash(fa)
        reset_counts(M, fa, G)
        want, cache1 = model.prefill(params, whole, pctx)
        pairs = list(zip(leaves(cache), leaves(cache1)))
        same_logits = torch.equal(logits, want)
        same_cache = len(pairs) == len(leaves(cache1)) == 4 * cfg.n_layers \
            and all(torch.equal(a, b) for a, b in pairs)
        p_err = (logits - want).abs().max().item()
        del cache, pairs
        p_ms = in_turns({
            "single": lambda: model.prefill(params, whole, pctx)[0],
            "mesh": lambda: prefill(sharded, batch)[0]}, torch, iters=2)
        print(f"[chip_smoke] mesh (k): {cfg.name} through build_prefill on "
              f"the (1, 1) mesh on its shards: flash launches {n['flash']} "
              f"(expected {want_flash}: {cfg.n_encoder_layers} unmasked "
              f"encoder, {cfg.n_layers} causal decoder; by head dim {by_d}),"
              f" matmul {n['matmul']}, grouped {n['grouped']}; logits "
              f"bitwise the single-device prefill's: {same_logits} (max "
              f"|diff| {p_err:.3e}), caches bitwise: {same_cache}; warm in "
              f"turns single {p_ms['single']:.1f} ms, mesh "
              f"{p_ms['mesh']:.1f} ms")
        if n["flash"] != want_flash or n["matmul"] or n["grouped"]:
            raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s TP prefill "
                             "did not run the flash kernel once an "
                             "attention layer")
        if not (same_logits and same_cache):
            raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s TP prefill "
                             "differs from the single-device prefill")
        # -- the mesh decode from the same caches --------------------------
        decode, d_specs, (_, c_specs, _) = build_decode(
            model, cfg, ShapeSpec("decode", cache_len, REQUESTS, "decode"),
            mesh)
        it = iter(tree_leaves(d_specs, is_leaf=is_spec))
        on_mesh = tree_map(lambda t: distribute(t, mesh, next(it)), params)
        # a one-rank mesh lays a tensor out without a copy: clone first
        cache_m = shard_cache(_map_arrays(lambda t: t.clone(), cache1),
                              mesh, c_specs)
        tok1 = tokm = want.argmax(-1, keepdim=True)
        got1, gotm, want_l = [tok1], [tokm], []
        for i in range(steps):
            l1, cache1 = model.decode_step(params, tok1, cache1,
                                           WH_PROMPT + i, dctx)
            tok1 = l1.argmax(-1, keepdim=True)
            got1.append(tok1)
            want_l.append(l1)
        torch.cuda.synchronize()
        reset_counts(M, fa, G)
        errs = []
        for i in range(steps):
            lm, cache_m = decode(on_mesh, tokm, cache_m, WH_PROMPT + i)
            tokm = lm.argmax(-1, keepdim=True)
            gotm.append(tokm)
            errs.append(lm - want_l[i])
        torch.cuda.synchronize()
        dn = kernel_counts(M, fa, G)
        err = max(e.abs().max().item() for e in errs)
        scale = max(w.abs().max().item() for w in want_l)
        over = max((e.abs() - MESH_DECODE_TOL * w.abs()).max().item()
                   for e, w in zip(errs, want_l))
        same = torch.equal(torch.cat(got1, 1), torch.cat(gotm, 1))
        del errs, want_l
        tok = got1[1]
        fns = {"single": lambda: model.decode_step(params, tok, cache1,
                                                   WH_PROMPT, dctx)[0],
               "mesh": lambda: decode(on_mesh, tok, cache_m,
                                      WH_PROMPT)[0]}
        d_ms = in_turns(fns, torch, iters=5)
        traced = {k: trace_steps(f, torch) for k, f in fns.items()}
        with CommDebugMode() as comm:
            fns["mesh"]()
        colls = {str(k).split(".")[-1]: v
                 for k, v in comm.get_comm_counts().items()}
        moved = sum(v for k, v in comm.get_comm_counts().items()
                    if "functional" in str(k))
    # whisper's tied logits reach ~200 (its embedding drawn at scale 1),
    # where one fp32 ulp (1.5e-5 in [128, 256)) exceeds an absolute 1e-5,
    # and a logit near 0 carries the rounding of terms of that size: the
    # one-rank mesh decode differs from the single device only in the
    # self cache's split-KV combine, which divides after the value
    # product (read whole, it is bitwise), so its logits are held to
    # MESH_DECODE_TOL relative to their largest, as a non-bitwise TP
    # prefill is (elementwise atol = rtol reported beside it)
    rel = err / scale
    print(f"[chip_smoke] mesh (k): {cfg.name} {steps} greedy steps of the "
          f"mesh decode (the self cache split-KV, the cross K/V in place on "
          f"their head dim, the attentions on their stored columns) against "
          f"the single device: the same tokens {same}; logits max |diff| "
          f"{err:.3e} (max |logit| {scale:.3f}, rel {rel:.3e}, tol "
          f"{MESH_DECODE_TOL:g}; max |diff| - rtol |logit| {over:.3e}); "
          f"launches "
          f"flash {dn['flash']}, matmul {dn['matmul']}, grouped "
          f"{dn['grouped']}; warm step in turns single "
          f"{d_ms['single']:.2f} ms, mesh {d_ms['mesh']:.2f} ms; device "
          f"time a step single {traced['single']['device_ms']:.2f} ms, mesh "
          f"{traced['mesh']['device_ms']:.2f} ms; collectives a mesh step "
          f"{colls} (DTensor moves {moved})")
    if not (same and rel <= MESH_DECODE_TOL):
        raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s mesh decode "
                         "disagrees with the single-device decode")
    if dn["flash"] or dn["matmul"] or dn["grouped"] or moved:
        raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s mesh decode "
                         "launched a kernel or moved a DTensor")
    del sharded, batch, on_mesh, cache1, cache_m, fns
    torch.cuda.empty_cache()
    row = {"arch": cfg.name, "layout": {
        "train": {k: repr(v) for k, v in lay.items()},
        "decode": {k: repr(v) for k, v in dec.items()}},
        "prefill": {"batch": [REQUESTS, WH_PROMPT],
                    "encoder_len": cfg.encoder_len,
                    "flash_launches": n["flash"],
                    "flash_by_head_dim": by_d,
                    "logits_bitwise": same_logits,
                    "caches_bitwise": same_cache,
                    "logits_max_abs_err": p_err, "prefill_ms": p_ms},
        "decode": {"steps": steps, "same_tokens": same,
                   "logits_max_abs_err": err, "logits_max_abs": scale,
                   "logits_rel_err": rel, "logits_over_rtol": over,
                   "tol": MESH_DECODE_TOL, "step_ms": d_ms, "trace": traced, "collectives": colls,
                   "dtensor_moves": moved}}
    row["train"] = mesh_train_tp(model, cfg, params, mesh, *ENCDEC_TRAIN,
                                 M, fa, G, torch)
    del params
    torch.cuda.empty_cache()
    row["phase_s"] = time.perf_counter() - t0
    return row


def mesh_deepseek(res, cfg, mesh, M, fa, G, torch) -> dict:
    """Phase 15 (a), inside phase 12 while deepseek's weights live: the
    same weights as DTensors on the mesh (no copy), ``build_prefill``
    and ``build_decode`` on phase 12's prompts (the prefill's caches laid
    out by ``shard_cache``): the MoE on its expert-parallel path (the
    grouped kernel behind a one-rank all_to_all) in the prefill, on
    ``apply_moe_decode`` (the whole batch onto the stored experts and
    the shared experts on their FF slice) in decode, MLA on its whole
    heads over 'model' (``dense_mesh_layout``'s ``mla.*`` cut, which a
    one-rank axis keeps with its collectives) and the latent cache read
    split-KV; logits and greedy tokens against phase 12's, launches
    counted by body, times in turns, a decode step's device time
    (``torch.profiler``) and collectives (``CommDebugMode``: each MLA
    layer gathers its absorbed query once, no weight moves); then phase
    15 (g)'s deepseek (:func:`mesh_paged`)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.dist.collectives import distribute
    from repro_torch.dist.sharding import partition_params
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.models.transformer import dense_mesh_layout, \
        moe_mesh_layout
    from repro_torch.serve.step import build_decode, build_prefill, \
        shard_cache
    from repro_torch.train.step import make_ctx

    cache_len = PROMPT_LEN + GEN_TOKENS
    mla_cut = sorted(k for k in dense_mesh_layout(cfg, mesh)
                     if k.startswith("mla."))
    if mla_cut != ["mla.wk_b", "mla.wo", "mla.wq_b", "mla.wv_b"]:
        raise SystemExit(f"[chip_smoke] FAIL: the mesh does not cut "
                         f"deepseek's MLA on its heads ({mla_cut})")
    it = iter(tree_leaves(partition_params(res.model, cfg, mesh),
                          is_leaf=is_spec))
    sharded = tree_map(lambda t: distribute(t, mesh, next(it)), res.params)
    no_copy = all(a.to_local().data_ptr() == b.data_ptr() for a, b in zip(
        tree_leaves(sharded), tree_leaves(res.params)))
    if not no_copy:
        raise SystemExit("[chip_smoke] FAIL: laying deepseek's weights "
                         "out on the mesh copied them")
    prefill, _, b_specs = build_prefill(
        res.model, cfg, ShapeSpec("prefill", cache_len, REQUESTS,
                                  "prefill"), mesh, tuner=res.tuner)
    decode, _, (_, c_specs, _) = build_decode(
        res.model, cfg, ShapeSpec("decode", cache_len, REQUESTS, "decode"),
        mesh, tuner=res.tuner)
    batch = {"tokens": distribute(res.prompts, mesh, b_specs["tokens"])}
    path = moe_mesh_layout(cfg, mesh, PROMPT_LEN)[0]
    moe_layers = sum(s.mlp == "moe" for s in res.model.plan)
    with torch.inference_mode():
        reset_counts(M, fa, G)
        torch.cuda.reset_peak_memory_stats()
        logits, cache = prefill(sharded, batch)
        torch.cuda.synchronize()
        n_pre = kernel_counts(M, fa, G)
        real_peak = torch.cuda.max_memory_allocated()
        toks = logits.argmax(-1)[:, None]
        gen = [toks]
        cache = shard_cache(cache, mesh, c_specs)
        for i in range(GEN_TOKENS - 1):
            step_logits, cache = decode(sharded, toks, cache,
                                        PROMPT_LEN + i)
            toks = step_logits.argmax(-1)[:, None]
            gen.append(toks)
        torch.cuda.synchronize()
        n_all = kernel_counts(M, fa, G)
        scale = res.prefill_logits.abs().max().item()
        rel = (logits - res.prefill_logits).abs().max().item() / scale
        same_tokens = torch.equal(torch.cat(gen, dim=1), res.tokens)
        del cache
        want_pre = {"tiled": 3 * moe_layers, "thin": 0}
        want_dec = 3 * moe_layers * (GEN_TOKENS - 1)
        dec_by = {k: n_all["grouped_by_variant"][k]
                  - n_pre["grouped_by_variant"][k] for k in want_pre}
        print(f"[chip_smoke] mesh (a): deepseek on the (1, 1) mesh (MoE "
              f"path {path!r}, weights laid out without a copy: "
              f"{no_copy}): prefill grouped launches "
              f"{n_pre['grouped_by_variant']} (expected {want_pre}), "
              f"decode {dec_by} (expected {want_dec} thin: "
              f"apply_moe_decode), flash {n_all['flash']}, matmul "
              f"{n_all['matmul']}; prefill logits max rel err {rel:.3e} "
              f"(tol {MESH_TOL:g}) against phase 12's; {GEN_TOKENS} greedy "
              f"tokens the same: {same_tokens}")
        if path != "ep" or n_pre["grouped_by_variant"] != want_pre \
                or dec_by != {"thin": want_dec, "tiled": 0} \
                or n_all["flash"] or n_all["matmul"]:
            raise SystemExit("[chip_smoke] FAIL: the mesh path did not run "
                             "the grouped kernel as expected")
        if not (rel <= MESH_TOL and same_tokens):
            raise SystemExit("[chip_smoke] FAIL: deepseek on the mesh "
                             "disagrees with the single-device path")
    trace = trace_mesh_prefill(res, cfg, mesh, prefill, b_specs,
                               n_pre["grouped_by_variant"]["tiled"],
                               real_peak, torch)
    with torch.inference_mode():
        pctx = make_ctx("prefill", cache_len=cache_len, tuner=res.tuner)
        dctx = make_ctx("decode", cache_len=cache_len, tuner=res.tuner)
        prefill_ms = in_turns({
            "single": lambda: res.model.prefill(res.params, res.prompts,
                                                pctx)[0],
            "mesh": lambda: prefill(sharded, batch)[0]}, torch, iters=2)
        _, c1 = res.model.prefill(res.params, res.prompts, pctx)
        cm = shard_cache(prefill(sharded, batch)[1], mesh, c_specs)
        tok = res.tokens[:, :1]
        fns = {"single": lambda: res.model.decode_step(
                   res.params, tok, c1, PROMPT_LEN, dctx)[0],
               "mesh": lambda: decode(sharded, tok, cm, PROMPT_LEN)[0]}
        decode_ms = in_turns(fns, torch, iters=5)
        # device time a step, and the collectives a mesh step dispatches
        traced = {k: trace_steps(f, torch) for k, f in fns.items()}
        with CommDebugMode() as comm:
            fns["mesh"]()
        colls = {str(k).split(".")[-1]: v
                 for k, v in comm.get_comm_counts().items()}
        del c1, cm, fns
    # the all-gathers of a mesh decode step: each layer's absorbed query
    # over 'model' (MLA on its heads), each MoE layer's rows, the logits
    gathers = colls.get("_allgather_base_", 0)
    want_gathers = cfg.n_layers + moe_layers + 1
    print(f"[chip_smoke] mesh (a) warm, in turns: prefill single "
          f"{prefill_ms['single']:.1f} ms, mesh {prefill_ms['mesh']:.1f} "
          f"ms; decode step single {decode_ms['single']:.2f} ms, mesh "
          f"{decode_ms['mesh']:.2f} ms; device time a step single "
          f"{traced['single']['device_ms']:.2f} ms, mesh "
          f"{traced['mesh']['device_ms']:.2f} ms; collectives a mesh "
          f"decode step {colls} (MLA cut on its heads: {mla_cut}; "
          f"{want_gathers} all-gathers expected, one of the absorbed query "
          f"a layer; no DTensor move of a weight)")
    if gathers != want_gathers or any("functional" in str(k) for k in
                                      comm.get_comm_counts()):
        raise SystemExit("[chip_smoke] FAIL: deepseek's mesh decode step "
                         "did not compute MLA on its heads, or moved a "
                         "weight")
    del sharded, batch
    torch.cuda.empty_cache()
    # phase 15 (g): the paged decode on the mesh, on the same weights
    paged = mesh_paged(res.model, res.params, mesh, M, fa, G, torch,
                       tuner=res.tuner)
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "moe_path": path,
            "weights_copied": not no_copy,
            "prefill_launches": n_pre["grouped_by_variant"],
            "decode_launches": n_all["grouped"] - n_pre["grouped"],
            "prefill_logits_max_rel_err": rel, "same_tokens": same_tokens,
            "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
            "decode_trace": traced, "decode_collectives": colls,
            "mla_cut": mla_cut, "trace": trace, "paged": paged}


def trace_mesh_prefill(res, cfg, mesh, prefill, b_specs, tiled: int,
                       real_peak: int, torch) -> dict:
    """Phase 16 (b), inside phase 15 (a): the mesh prefill that phase 15
    (a) ran traced on fake tensors laid out like its inputs (fp32
    weights by the param specs, the prompts by the batch specs) under
    the dry run's trace mode: its grouped-op calls must equal the tiled
    launches of the real prefill; its FLOPs against the analytic forward
    count of the config and its peak bytes against the real peak are
    printed as ratios."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.sharding import partition_params
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import abstract_params
    from repro_torch.roofline import fwd_flops

    t0 = time.perf_counter()
    prompts = torch.empty(tuple(res.prompts.shape), dtype=res.prompts.dtype,
                          device="meta")
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = dryrun.lay_out(abstract_params(res.model.defs,
                                                torch.float32),
                                partition_params(res.model, cfg, mesh),
                                mesh, "cuda")
        batch = dryrun.lay_out({"tokens": prompts}, b_specs, mesh, "cuda")
        seen = dryrun.trace_cell(prefill, (params, batch), "cuda")
        del params, batch
    traced = seen["kernel_ops"].get("repro_torch::grouped_matmul", 0)
    analytic = fwd_flops(cfg, ShapeSpec("prefill", PROMPT_LEN, REQUESTS,
                                        "prefill"))
    out = {"grouped_op_calls": traced, "tiled_launches": tiled,
           "kernel_ops": seen["kernel_ops"], "trace_s": seen["trace_s"],
           "flops": seen["flops"], "analytic_fwd_flops": analytic,
           "flops_ratio": seen["flops"] / analytic,
           "peak_bytes": seen["peak_bytes"],
           "argument_bytes": seen["argument_bytes"],
           "real_peak_bytes": real_peak,
           "peak_ratio": seen["peak_bytes"] / real_peak,
           "phase_s": time.perf_counter() - t0}
    print(f"[chip_smoke] dry run (b): deepseek's mesh prefill traced on "
          f"fake tensors in {seen['trace_s']:.2f}s: grouped op calls "
          f"{traced} (real tiled launches {tiled}), kernel ops "
          f"{seen['kernel_ops']}; FLOPs {seen['flops']:.4e} against "
          f"fwd_flops {analytic:.4e} (ratio {out['flops_ratio']:.4f}); "
          f"traced peak {seen['peak_bytes'] / 2 ** 30:.2f} GiB (inputs "
          f"{seen['argument_bytes'] / 2 ** 30:.2f}) against the real "
          f"max_memory_allocated {real_peak / 2 ** 30:.2f} GiB (ratio "
          f"{out['peak_ratio']:.4f})")
    if traced != tiled:
        raise SystemExit("[chip_smoke] FAIL: the trace's grouped-op calls "
                         "differ from the real prefill's launches")
    return out


def mesh_mixtral_tp(mesh, M, fa, G, torch) -> dict:
    """Phase 15 (b): one mixtral-8x22b MoE layer at full width (10.4 GB of
    experts, fp32) through ``apply_moe_tp`` on the mesh (each rank's FF
    slice: on one rank the whole weights, and a one-rank all-reduce)
    against ``apply_moe`` on the same weights and 4 x 1024 tokens;
    launches counted, times in turns."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import _moe_spec

    cfg = get_config(MIX_ARCH)
    spec = dataclasses.replace(_moe_spec(cfg), ep_axis="model")
    gen = torch.Generator(device="cuda").manual_seed(11)
    p = init_params(MOE.moe_defs(spec), gen)
    x = torch.randn((REQUESTS, PROMPT_LEN, cfg.d_model), generator=gen,
                    device="cuda")
    with torch.inference_mode():
        reset_counts(M, fa, G)
        want, want_aux = MOE.apply_moe(p, x, spec)
        torch.cuda.synchronize()
        n_dense = kernel_counts(M, fa, G)
        reset_counts(M, fa, G)
        got, aux = MOE.apply_moe_tp(p, x, spec, mesh=mesh)
        torch.cuda.synchronize()
        n_tp = kernel_counts(M, fa, G)
        err = (got - want).abs().max().item()
        close = torch.allclose(got, want, atol=GEMM_TOL["float32"],
                               rtol=GEMM_TOL["float32"])
        aux_err = (aux - want_aux).abs().item()
        ms = in_turns({
            "single": lambda: MOE.apply_moe(p, x, spec)[0],
            "mesh": lambda: MOE.apply_moe_tp(p, x, spec, mesh=mesh)[0]},
            torch, iters=2)
    print(f"[chip_smoke] mesh (b): mixtral MoE layer ({spec.n_experts} "
          f"experts x d_ff {spec.d_ff}, {REQUESTS}x{PROMPT_LEN} tokens) "
          f"through apply_moe_tp on the mesh: grouped launches "
          f"{n_tp['grouped_by_variant']} (single-device "
          f"{n_dense['grouped_by_variant']}), max_abs_err {err:.3e} "
          f"(tol {GEMM_TOL['float32']:g}), aux err {aux_err:.3e}; warm "
          f"in turns single {ms['single']:.1f} ms, mesh {ms['mesh']:.1f} "
          "ms")
    if not close or n_tp["grouped"] != 3 \
            or n_tp["grouped_by_variant"] != n_dense["grouped_by_variant"]:
        raise SystemExit("[chip_smoke] FAIL: apply_moe_tp disagrees with "
                         "apply_moe, or did not run the grouped kernel 3 "
                         "times")
    del p, x, got, want
    torch.cuda.empty_cache()
    return {"arch": MIX_ARCH, "tokens": REQUESTS * PROMPT_LEN,
            "launches": n_tp["grouped_by_variant"], "max_abs_err": err,
            "aux_abs_err": aux_err, "layer_ms": ms}


def mesh_decode_model(arch: str, n_layers, mesh, M, fa, G, torch,
                      paged: bool = False,
                      prompt_len: int = PROMPT_LEN) -> dict:
    """Phase 15 (f), one model: ``arch`` at full width (cut to
    ``n_layers``, or whole), random fp32 weights from a seed, prefilled
    on the single device (REQUESTS x ``prompt_len``), then
    MESH_DECODE_STEPS greedy steps
    of the single-device decode and of ``serve.step.build_decode`` on
    the mesh from the same caches (laid out by ``shard_cache``): the
    mesh decode reads every attention cache split-KV, the dense blocks
    through the tensor-parallel path and the MoE through
    ``apply_moe_decode`` (the grouped kernel, counted by body); the same
    greedy tokens, the logits within MESH_DECODE_TOL (absolute and
    relative), warm steps
    in turns, each path's device time a step (``torch.profiler``) and
    the collectives a mesh step dispatches (``CommDebugMode``).  With
    ``paged``, phase 15 (g) on the same weights (:func:`mesh_paged`)."""
    import dataclasses

    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import build_model, get_config
    from repro_torch.dist.collectives import distribute
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.serve.step import _map_arrays, build_decode, \
        shard_cache
    from repro_torch.train.step import make_ctx

    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    steps = MESH_DECODE_STEPS
    cache_len = prompt_len + steps
    gen = torch.Generator(device="cuda").manual_seed(16)
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, prompt_len),
                            generator=gen, device="cuda")
    decode, p_specs, (_, c_specs, _) = build_decode(
        model, cfg, ShapeSpec("decode", cache_len, REQUESTS, "decode"),
        mesh)
    it = iter(tree_leaves(p_specs, is_leaf=is_spec))
    sharded = tree_map(lambda t: distribute(t, mesh, next(it)), params)
    dctx = make_ctx("decode", cache_len=cache_len)
    moe_layers = sum(s.mlp == "moe" for s in model.plan)
    with torch.inference_mode():
        logits, cache1 = model.prefill(
            params, prompts, make_ctx("prefill", cache_len=cache_len))
        cache_m = shard_cache(_map_arrays(lambda t: t.clone(), cache1),
                              mesh, c_specs)
        tok1 = tokm = logits.argmax(-1, keepdim=True)
        got1, gotm, want = [tok1], [tokm], []
        for i in range(steps):
            l1, cache1 = model.decode_step(params, tok1, cache1,
                                           prompt_len + i, dctx)
            tok1 = l1.argmax(-1, keepdim=True)
            got1.append(tok1)
            want.append(l1)
        torch.cuda.synchronize()
        reset_counts(M, fa, G)
        errs = []
        for i in range(steps):
            lm, cache_m = decode(sharded, tokm, cache_m, prompt_len + i)
            tokm = lm.argmax(-1, keepdim=True)
            gotm.append(tokm)
            errs.append(lm - want[i])
        torch.cuda.synchronize()
        n = kernel_counts(M, fa, G)
        # while the tokens agree both paths step from the same token
        err = max(e.abs().max().item() for e in errs)
        scale = max(w.abs().max().item() for w in want)
        # the largest |diff| - rtol |single|, within atol
        over = max((e.abs() - MESH_DECODE_TOL * w.abs()).max().item()
                   for e, w in zip(errs, want))
        same = torch.equal(torch.cat(got1, 1), torch.cat(gotm, 1))
        del errs, want
        tok = got1[1]
        fns = {"single": lambda: model.decode_step(params, tok, cache1,
                                                   prompt_len, dctx)[0],
               "mesh": lambda: decode(sharded, tok, cache_m,
                                      prompt_len)[0]}
        ms = in_turns(fns, torch, iters=5)
        # device time a step, and the collectives a mesh step dispatches
        traced = {k: trace_steps(f, torch) for k, f in fns.items()}
        with CommDebugMode() as comm:
            fns["mesh"]()
        colls = {str(k).split(".")[-1]: v
                 for k, v in comm.get_comm_counts().items()}
        kinds = coll_kinds(comm.get_comm_counts())
    want = {"thin": 3 * moe_layers * steps, "tiled": 0}
    print(f"[chip_smoke] mesh: {cfg.name} ({cfg.n_layers} layers) "
          f"{steps} greedy steps of the mesh decode (split-KV caches, "
          f"tensor-parallel blocks, apply_moe_decode) against the single "
          f"device: the same tokens {same}; logits max |diff| "
          f"{err:.3e} (max |logit| {scale:.3f}; max |diff| - rtol "
          f"|logit| {over:.3e}, atol = rtol = {MESH_DECODE_TOL:g}); "
          f"grouped launches {n['grouped_by_variant']} (expected {want}), "
          f"flash {n['flash']}, matmul {n['matmul']}; warm step in turns "
          f"single {ms['single']:.2f} ms, mesh {ms['mesh']:.2f} ms; device "
          f"time a step single {traced['single']['device_ms']:.2f} ms, mesh "
          f"{traced['mesh']['device_ms']:.2f} ms; collectives a mesh step "
          f"{colls} ({kinds})")
    if not (same and over <= MESH_DECODE_TOL):
        raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s mesh decode "
                         "disagrees with the single-device decode")
    if n["grouped_by_variant"] != want or n["flash"] or n["matmul"]:
        raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s mesh decode did "
                         "not run the grouped kernel as expected")
    del sharded, cache1, cache_m, fns
    torch.cuda.empty_cache()
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "steps": steps,
           "prompt": [REQUESTS, prompt_len],
           "same_tokens": same, "logits_max_abs_err": err,
           "logits_max_abs": scale, "logits_over_rtol": over,
           "tol": MESH_DECODE_TOL, "launches": n["grouped_by_variant"],
           "step_ms": ms, "trace": traced, "collectives": colls,
           "collective_kinds": kinds}
    if paged:
        out["paged"] = mesh_paged(model, params, mesh, M, fa, G, torch)
    del params
    torch.cuda.empty_cache()
    return out


def mesh_paged(model, params, mesh, M, fa, G, torch, tuner=None) -> dict:
    """Phase 15 (g), one model: ``serve.step.build_decode_paged`` on the
    mesh against the single-device paged ``decode_step`` on the same
    pools and page table (PAGED_*: an inactive slot, holes past a
    prefix), PAGED_STEPS greedy steps of each from the same token: the
    mesh step reads each pool split-KV over its pages
    (``kv_cache.PagedSplit``), the dense blocks through the
    tensor-parallel path and the MoE through ``apply_moe_decode`` (the
    grouped kernel, counted by body); the same tokens, the logits within
    MESH_DECODE_TOL (absolute and relative), the pools alike after the
    steps, warm steps in turns, each path's device time a step
    (``torch.profiler``), the collectives a mesh step dispatches
    (``CommDebugMode``) and the bytes each path's step allocates above
    what it holds (``max_memory_allocated``)."""
    import numpy as np
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.dist.collectives import distribute
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.serve.kv_cache import pages_for
    from repro_torch.serve.step import _map_arrays, build_decode_paged
    from repro_torch.train.step import make_ctx

    t0 = time.perf_counter()
    cfg = model.cfg
    b, page, width, steps = PAGED_SLOTS, PAGED_PAGE, PAGED_TABLE, \
        PAGED_STEPS
    cap, n_pages = width * page, b * width
    rng = np.random.default_rng(26)
    table = rng.permutation(n_pages).reshape(b, width)
    pos = rng.integers(cap // 2, cap - steps, b)
    tok0 = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1))).cuda()
    pos[PAGED_INACTIVE] = -1
    pos[PAGED_HOLES] = cap // 4
    table[PAGED_HOLES, pages_for(cap // 4 + steps, page):] = -1
    table_t, pos0 = torch.from_numpy(table).cuda(), \
        torch.from_numpy(pos).cuda()
    decode, p_specs, (_, pool_specs, _, _) = build_decode_paged(
        model, cfg, slots=b, n_pages=n_pages, page_size=page,
        table_pages=width, mesh=mesh, tuner=tuner)
    it = iter(tree_leaves(p_specs, is_leaf=is_spec))
    sharded = tree_map(lambda t: distribute(t, mesh, next(it)), params)
    dctx = make_ctx("decode", cache_len=cap, tuner=tuner)
    gen = torch.Generator(device="cuda").manual_seed(26)
    pool1 = _map_arrays(
        lambda t: torch.randn(t.shape, generator=gen, device="cuda"),
        model.init_paged_cache(n_pages, page, dctx, device="meta"))
    # a one-rank mesh lays a tensor out without a copy: clone first
    pool_m = _map_arrays(lambda t, spec: distribute(t.clone(), mesh, spec),
                         pool1, pool_specs)
    moe_layers = sum(s.mlp == "moe" for s in model.plan)

    def run(step):
        tok, at, logits, toks = tok0, pos0, [], [tok0]
        for _ in range(steps):
            out = step(tok, at)
            tok = out.argmax(-1, keepdim=True)
            logits.append(out)
            toks.append(tok)
            at = torch.where(at >= 0, at + 1, at)
        return logits, torch.cat(toks, 1)

    with torch.inference_mode():
        want, got1 = run(lambda tok, at: model.decode_step(
            params, tok, pool1, at, dctx, table_t)[0])
        torch.cuda.synchronize()
        reset_counts(M, fa, G)
        logits_m, gotm = run(lambda tok, at: decode(
            sharded, tok, pool_m, at, table_t)[0])
        torch.cuda.synchronize()
        n = kernel_counts(M, fa, G)
        same = torch.equal(got1, gotm)
        err = max((m - w).abs().max().item()
                  for m, w in zip(logits_m, want))
        scale = max(w.abs().max().item() for w in want)
        over = max(((m - w).abs() - MESH_DECODE_TOL * w.abs()).max().item()
                   for m, w in zip(logits_m, want))
        leaves1, leaves_m = [], []
        _map_arrays(leaves1.append, pool1)
        _map_arrays(leaves_m.append, pool_m)
        pool_err = max((a - c.to_local()).abs().max().item()
                       for a, c in zip(leaves1, leaves_m))
        del logits_m, want
        fns = {"single": lambda: model.decode_step(
                   params, tok0, pool1, pos0, dctx, table_t)[0],
               "mesh": lambda: decode(sharded, tok0, pool_m, pos0,
                                      table_t)[0]}
        ms = in_turns(fns, torch, iters=3)
        traced = {k: trace_steps(f, torch) for k, f in fns.items()}
        with CommDebugMode() as comm:
            fns["mesh"]()
        colls = {str(k).split(".")[-1]: v
                 for k, v in comm.get_comm_counts().items()}
        # the bytes a step allocates above what it holds before and after
        transient = {}
        for k, f in fns.items():
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            f()
            torch.cuda.synchronize()
            transient[k] = torch.cuda.max_memory_allocated() - held
    want_n = {"thin": 3 * moe_layers * steps, "tiled": 0}
    print(f"[chip_smoke] mesh (g): {cfg.name} ({cfg.n_layers} layers) "
          f"{steps} greedy steps of the paged mesh decode ({b} slots, "
          f"{n_pages} pages of {page}, cap {cap}, slot {PAGED_INACTIVE} "
          f"inactive, slot {PAGED_HOLES} with holes; pools split-KV over "
          f"their pages, tensor-parallel blocks, apply_moe_decode) against "
          f"the single-device paged decode: the same tokens {same}; logits "
          f"max |diff| {err:.3e} (max |logit| {scale:.3f}; max |diff| - "
          f"rtol |logit| {over:.3e}, atol = rtol = {MESH_DECODE_TOL:g}); "
          f"pools max |diff| {pool_err:.3e}; grouped launches "
          f"{n['grouped_by_variant']} (expected {want_n}), flash "
          f"{n['flash']}, matmul {n['matmul']}; warm step in turns single "
          f"{ms['single']:.2f} ms, mesh {ms['mesh']:.2f} ms; device time a "
          f"step single {traced['single']['device_ms']:.2f} ms, mesh "
          f"{traced['mesh']['device_ms']:.2f} ms; collectives a mesh step "
          f"{colls}; transient bytes a step single {transient['single']}, "
          f"mesh {transient['mesh']}")
    if not (same and over <= MESH_DECODE_TOL
            and pool_err <= MESH_DECODE_TOL):
        raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s paged mesh "
                         "decode disagrees with the single-device one")
    if n["grouped_by_variant"] != want_n or n["flash"] or n["matmul"]:
        raise SystemExit(f"[chip_smoke] FAIL: {cfg.name}'s paged mesh "
                         "decode did not run the grouped kernel as expected")
    del sharded, pool1, pool_m, leaves1, leaves_m
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "slots": b,
            "page_size": page, "n_pages": n_pages, "cap": cap,
            "steps": steps, "same_tokens": same, "logits_max_abs_err": err,
            "logits_max_abs": scale, "logits_over_rtol": over,
            "pools_max_abs_err": pool_err, "tol": MESH_DECODE_TOL,
            "launches": n["grouped_by_variant"], "step_ms": ms,
            "trace": traced, "collectives": colls,
            "transient_bytes": transient,
            "phase_s": time.perf_counter() - t0}


def combine_on_card(torch) -> dict:
    """Phase 15 (f): ``softmax_combine_local`` over 4 and 16 chunks of a
    32k cache (COMBINE_SHAPE: 4 x 32768 slots x 32 heads x 64, fp32,
    valid through slot COMBINE_VALID: the last chunks have no valid
    slot) against one softmax
    over the whole cache (the single-device decode's arithmetic), max
    |diff| / max |out| within COMBINE_TOL; times of each."""
    from repro_torch.dist.collectives import softmax_combine_local
    from repro_torch.models.layers import _decode_scores, _repeat_kv, \
        decode_partial

    b, n, h, d = COMBINE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(17)
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda")
    k = torch.randn((b, n, h, d), generator=gen, device="cuda")
    v = torch.randn((b, n, h, d), generator=gen, device="cuda")
    valid = (torch.arange(n, device="cuda") <= COMBINE_VALID)[None]

    def whole():
        probs = torch.softmax(_decode_scores(q, k, valid), dim=-1)
        return torch.einsum("bhk,bkhd->bhd", probs, _repeat_kv(v, h))

    def split(chunks):
        return lambda: softmax_combine_local([
            decode_partial(q, kc, vc, mc) for kc, vc, mc in zip(
                k.tensor_split(chunks, 1), v.tensor_split(chunks, 1),
                valid.tensor_split(chunks, 1))])

    out = {}
    with torch.inference_mode():
        want = whole()
        scale = want.abs().max().item()
        out["whole_ms"] = cuda_ms(whole, iters=5, warmup=1)
        for chunks in COMBINE_CHUNKS:
            err = (split(chunks)() - want).abs().max().item() / scale
            out[str(chunks)] = {"max_rel_err": err,
                                "ms": cuda_ms(split(chunks), iters=5,
                                              warmup=1)}
    print(f"[chip_smoke] mesh (f): softmax_combine_local over a {b}x{n}x"
          f"{h}x{d} cache against one softmax ({out['whole_ms']:.2f} ms): "
          + ", ".join(f"{c} chunks max rel err "
                      f"{out[str(c)]['max_rel_err']:.2e} in "
                      f"{out[str(c)]['ms']:.2f} ms" for c in COMBINE_CHUNKS)
          + f" (tol {COMBINE_TOL:g})")
    if not all(out[str(c)]["max_rel_err"] <= COMBINE_TOL
               for c in COMBINE_CHUNKS):
        raise SystemExit("[chip_smoke] FAIL: the split softmax disagrees "
                         "with one softmax")
    del q, k, v
    torch.cuda.empty_cache()
    return out


def mesh_decode(art: Path, mesh, M, fa, G, torch) -> tuple[dict, dict]:
    """Phase 15 (f): the decode on the reference's cache layout on the
    one-rank mesh — stablelm-1.6b whole and mixtral-8x22b at
    MIX_LAYERS layers (:func:`mesh_decode_model`; deepseek's runs in
    (a)), the split softmax on the card (:func:`combine_on_card`), and
    the grouped kernel at a rank's buckets of the production decode
    (decode_32k on (16, 16), RANK_GROUPED_SHAPES) against its plain
    version and ``torch.bmm``; phase 15 (g)'s stablelm on (f)'s
    weights."""
    from repro_torch.core import AdsalaTuner

    out = {"stablelm": mesh_decode_model(ARCH, None, mesh, M, fa, G,
                                         torch, paged=True),
           "mixtral": mesh_decode_model(MIX_ARCH, MIX_LAYERS, mesh, M, fa,
                                        G, torch),
           "combine": combine_on_card(torch)}
    tuner = AdsalaTuner.from_artifact(str(art))
    shapes = time_grouped(G, torch, tuner, RANK_GROUPED_SHAPES, seed=18)
    for name, _, c, _, _ in RANK_GROUPED_SHAPES:
        # mixtral's 20 rows > 16 take the tiled body; its 4 and
        # deepseek's 8 (F 96: the thin one's masked edge) the thin one
        want = "tiled" if c > 16 else "thin"
        if shapes[name]["variant"] != want:
            raise SystemExit(f"[chip_smoke] FAIL: {name} took the "
                             f"{shapes[name]['variant']} body")
    # no path of this run gives these shapes: a one-rank mesh routes the
    # whole batch onto every expert at the single-device buckets
    entry = {"shapes": shapes, "launches": 0,
             "launches_by_variant": {"thin": 0, "tiled": 0},
             "note": "a rank's bucket of the production decode "
                     "(decode_32k or long_500k) on a (16, 16) mesh: no "
                     "path of a one-rank mesh launches it"}
    return out, entry


def phase_dryrun(torch) -> dict:
    """Phase 16 (a): ``python -m repro_torch.launch.dryrun --device cuda
    --mesh single`` in subprocesses (a fake world is global to its
    process), one per entry of DRYRUN_CELLS, run together (a timeout
    fails the phase); each cell's
    record read back beside the reference count ``step_flops /
    n_devices`` and ``roofline_for_cell``'s terms; the records folded
    by ``launch.profile --dryrun-dir`` into a profile (no install)."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.core.workload import WorkloadProfile
    from repro_torch.launch import profile
    from repro_torch.launch.dryrun import cell_is_runnable
    from repro_torch.models.config import SHAPES
    from repro_torch.roofline import roofline_for_cell, step_flops

    out = WORK / "dryrun_torch"
    for old in out.glob("*.json"):
        old.unlink()
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cuda", "--mesh", "single", "--out", str(out), "--arch", arch]
        + (["--shape", shape] if shape else []), env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, shape in DRYRUN_CELLS]
    failed = []
    for (arch, _), proc in zip(DRYRUN_CELLS, procs):
        try:
            log, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            raise SystemExit(f"[chip_smoke] FAIL: the dry run of {arch} "
                             f"took more than {DRYRUN_TIMEOUT}s")
        for line in log.splitlines():
            print(f"[chip_smoke]   {line}")
        if proc.returncode != 0:
            failed.append(arch)
    wall = time.perf_counter() - t0
    if failed:
        raise SystemExit(f"[chip_smoke] FAIL: the dry run failed for "
                         f"{failed}")
    cells = []
    for path in sorted(out.glob("*.json")):
        rec = json.loads(path.read_text())
        row = {"arch": rec["arch"], "shape": rec["shape"],
               "mesh": rec["mesh"], "status": rec["status"]}
        cells.append(row)
        if rec["status"] != "ok":
            row["reason"] = rec.get("reason", rec.get("error"))
            print(f"[chip_smoke] dry run (a): {rec['arch']} x "
                  f"{rec['shape']}: {rec['status']} ({row['reason']})")
            continue
        cfg, shape = get_config(rec["arch"]), SHAPES[rec["shape"]]
        terms = roofline_for_cell(cfg, shape, rec["mesh"], rec)
        ref = step_flops(cfg, shape) / rec["n_devices"]
        flops = rec["cost"]["flops_per_device"]
        row.update({
            "trace_s": rec["lower_s"], "flops_per_device": flops,
            "reference_flops_per_device": ref, "flops_ratio": flops / ref,
            "peak_gib": rec["memory"]["peak_bytes"] / 2 ** 30,
            "argument_gib": rec["memory"]["argument_bytes"] / 2 ** 30,
            "collective_bytes": {k: v["bytes"] for k, v in
                                 rec["collectives"].items()},
            "collective_counts": {k: v["count"] for k, v in
                                  rec["collectives"].items()},
            "kernel_ops": rec["kernel_ops"],
            "roofline": {"compute_s": terms.compute_s,
                         "memory_s": terms.memory_s,
                         "collective_s": terms.collective_s,
                         "dominant": terms.dominant}})
        print(f"[chip_smoke] dry run (a): {rec['arch']} x {rec['shape']} "
              f"x {rec['mesh']}: ok, traced in {rec['lower_s']}s; FLOPs a "
              f"rank {flops:.4e} against step_flops / {rec['n_devices']} "
              f"{ref:.4e} (ratio {flops / ref:.3f}); peak "
              f"{row['peak_gib']:.2f} GiB a rank (inputs "
              f"{row['argument_gib']:.2f}); collective bytes "
              f"{row['collective_bytes']}; kernel ops {rec['kernel_ops']}; "
              f"roofline compute {terms.compute_s:.4e} s, memory "
              f"{terms.memory_s:.4e} s, collective {terms.collective_s:.4e}"
              f" s: {terms.dominant}-bound")
    by_cell = {(c["arch"], c["shape"]): c for c in cells}
    want = {(arch, s) for arch, shape in DRYRUN_CELLS
            for s in ((shape,) if shape else SHAPES)}
    if set(by_cell) != want:
        raise SystemExit(f"[chip_smoke] FAIL: dry-run cells "
                         f"{sorted(by_cell)}, expected {sorted(want)}")
    for key, c in by_cell.items():
        if c["status"] != ("ok" if cell_is_runnable(*key)[0]
                           else "skipped"):
            raise SystemExit(f"[chip_smoke] FAIL: dry-run cell {key} "
                             f"{c['status']}")
    n_flash = by_cell["stablelm-1.6b", "prefill_32k"]["kernel_ops"].get(
        "repro_torch::flash_attention", 0)
    n_grouped = by_cell["mixtral-8x22b", "decode_32k"]["kernel_ops"].get(
        "repro_torch::grouped_matmul", 0)
    n_layers = get_config("stablelm-1.6b").n_layers
    # the dense blocks on their 'model' shards: a rank does its 1/256
    tp_ratios = {shape: by_cell["stablelm-1.6b", shape]["flops_ratio"]
                 for shape in ("train_4k", "prefill_32k")}
    n_slstm = sum(s.kind == "slstm"
                  for s in build_model(get_config("xlstm-125m")).plan)
    # the train step runs each sLSTM layer's forward twice (the remat's
    # recompute) and its backward once
    want_slstm = {
        "prefill_32k": {"repro_torch::slstm_scan": n_slstm},
        "train_4k": {"repro_torch::slstm_scan": 2 * n_slstm,
                     "repro_torch::slstm_scan_backward": n_slstm}}
    got_slstm = {
        shape: {k: by_cell["xlstm-125m", shape]["kernel_ops"].get(k)
                for k in ops}
        for shape, ops in want_slstm.items()}
    print(f"[chip_smoke] dry run (a): stablelm prefill_32k traced the "
          f"flash op {n_flash} times (expected {n_layers}, one a layer); "
          f"mixtral decode_32k the grouped op {n_grouped} times; xlstm's "
          f"sLSTM ops {got_slstm} (expected {want_slstm}); stablelm's FLOPs "
          f"a rank against step_flops / 256: {tp_ratios} (expected "
          f"{TP_RATIO[0]}-{TP_RATIO[1]}); {wall:.1f}s for the "
          f"{len(DRYRUN_CELLS)} processes")
    if n_flash != n_layers or n_grouped <= 0 or got_slstm != want_slstm:
        raise SystemExit("[chip_smoke] FAIL: the dry run did not trace "
                         "the kernels' and the sLSTM's ops")
    if not all(TP_RATIO[0] <= r <= TP_RATIO[1] for r in tp_ratios.values()):
        raise SystemExit("[chip_smoke] FAIL: a rank of the dry run does not "
                         "compute its share of stablelm's cells")
    # the decode on the reference's cache layout: its share of the FLOPs,
    # and a rank's peak inside the card
    decode_ratio = by_cell["stablelm-1.6b", "decode_32k"]["flops_ratio"]
    decode_peaks = {arch: by_cell[arch, "decode_32k"]["peak_gib"]
                    for arch in ("stablelm-1.6b", "mixtral-8x22b")}
    print(f"[chip_smoke] dry run (a): stablelm decode_32k FLOPs a rank "
          f"against step_flops / 256: {decode_ratio:.3f} (expected "
          f"{DECODE_RATIO[0]}-{DECODE_RATIO[1]}); decode_32k peaks a rank "
          f"{decode_peaks} GiB (under {CARD_GIB})")
    if not (DECODE_RATIO[0] <= decode_ratio <= DECODE_RATIO[1]
            and all(p < CARD_GIB for p in decode_peaks.values())):
        raise SystemExit("[chip_smoke] FAIL: a rank of the dry run's decode "
                         "does not compute its share or fit the card")
    # mixtral's decode on the rank's share: its block of the experts'
    # slot rows, its KV projections where they are stored
    mix = by_cell["mixtral-8x22b", "decode_32k"]
    mix_gb = sum(mix["collective_bytes"].values()) / 1e9
    print(f"[chip_smoke] dry run (a): mixtral decode_32k FLOPs a rank "
          f"x{mix['flops_ratio']:.4f} of step_flops / 256 (at most "
          f"x{MIX_DECODE_RATIO_MAX:g}), collective GB {mix_gb:.4f} (under "
          f"{MIX_DECODE_GB:g}), peak {mix['peak_gib']:.2f} GiB")
    if not (mix["flops_ratio"] <= MIX_DECODE_RATIO_MAX
            and mix_gb < MIX_DECODE_GB):
        raise SystemExit("[chip_smoke] FAIL: a rank of mixtral's decode "
                         "does not compute its share of the experts' slot "
                         "rows or still gathers its KV projections")
    # deepseek's MLA on its heads and its decode's shared experts on 'ff'
    ds_pre = by_cell["deepseek-v2-236b", "prefill_32k"]
    ds_dec = by_cell["deepseek-v2-236b", "decode_32k"]
    print(f"[chip_smoke] dry run (a): deepseek prefill_32k FLOPs a rank "
          f"x{ds_pre['flops_ratio']:.3f} of step_flops / 256 (at most "
          f"x{DS_PREFILL_RATIO_MAX:g}), peak {ds_pre['peak_gib']:.2f} GiB, "
          f"collective GB {sum(ds_pre['collective_bytes'].values()) / 1e9:.3f}"
          f"; decode_32k peak a rank {ds_dec['peak_gib']:.2f} GiB (under "
          f"{DS_DECODE_PEAK_GIB:g}), FLOPs x{ds_dec['flops_ratio']:.3f}, "
          f"collective GB {sum(ds_dec['collective_bytes'].values()) / 1e9:.3f}")
    if not (ds_pre["flops_ratio"] <= DS_PREFILL_RATIO_MAX
            and ds_dec["peak_gib"] < DS_DECODE_PEAK_GIB):
        raise SystemExit("[chip_smoke] FAIL: a rank of deepseek's dry run "
                         "does not compute MLA on its heads or still holds "
                         "gathered weights")
    # the recurrent mixers on their width
    rec = {f"{a} {k}": by_cell[a, k]["flops_ratio"]
           for a, k in REC_RATIO_MAX}
    rec_gb = {f"{a} {k}": sum(by_cell[a, k]["collective_bytes"].values())
              / 1e9 for a, k in REC_RATIO_MAX}
    rec_peak = {f"{a} {k}": by_cell[a, k]["peak_gib"]
                for a, k in REC_RATIO_MAX}
    print(f"[chip_smoke] dry run (a): the recurrent mixers' FLOPs a rank "
          f"against step_flops / 256: {rec} (at most "
          f"{ {f'{a} {k}': v for (a, k), v in REC_RATIO_MAX.items()} }); "
          f"peaks a rank GiB {rec_peak}; collective GB {rec_gb}")
    rg_gb = rec_gb["recurrentgemma-2b train_4k"]
    print(f"[chip_smoke] dry run (a): recurrentgemma train_4k collective "
          f"GB a rank {rg_gb:.4f} (at most {RG_TRAIN_GB_MAX:g}: the RG-LRU "
          f"gates' sum a reduce-scatter)")
    if not all(by_cell[key]["flops_ratio"] <= most
               for key, most in REC_RATIO_MAX.items()):
        raise SystemExit("[chip_smoke] FAIL: a rank of recurrentgemma's or "
                         "xlstm's dry run does not compute its mixers on "
                         "their width")
    if rg_gb > RG_TRAIN_GB_MAX:
        raise SystemExit("[chip_smoke] FAIL: a rank of recurrentgemma's "
                         "train_4k moves more collective bytes than its "
                         "gates' reduce-scatter would")
    # attention on the rank's heads where 16 does not divide them
    heads = {f"{a} {k}": {"flops_ratio": by_cell[a, k]["flops_ratio"],
                          "peak_gib": by_cell[a, k]["peak_gib"],
                          "collective_gb": sum(by_cell[a, k][
                              "collective_bytes"].values()) / 1e9}
             for a, k in HEADS_RATIO_MAX}
    print(f"[chip_smoke] dry run (a): attention on the rank's heads: "
          f"{heads} (FLOPs ratio at most "
          f"{ {f'{a} {k}': v for (a, k), v in HEADS_RATIO_MAX.items()} })")
    if not all(by_cell[key]["flops_ratio"] <= most
               for key, most in HEADS_RATIO_MAX.items()):
        raise SystemExit("[chip_smoke] FAIL: a rank of starcoder2's dry run "
                         "does not compute attention on its heads")
    # the encoder-decoder on its shards
    wh = {f"{a} {k}": {"flops_ratio": by_cell[a, k]["flops_ratio"],
                       "peak_gib": by_cell[a, k]["peak_gib"],
                       "collective_gb": sum(by_cell[a, k][
                           "collective_bytes"].values()) / 1e9}
          for a, k in WHISPER_RATIO_MAX}
    wh_gb = wh["whisper-tiny decode_32k"]["collective_gb"]
    print(f"[chip_smoke] dry run (a): the encoder-decoder on its shards: "
          f"{wh} (FLOPs ratio at most "
          f"{ {f'{a} {k}': v for (a, k), v in WHISPER_RATIO_MAX.items()} }"
          f"; decode_32k collective GB under {WHISPER_DECODE_GB:g})")
    if not (all(by_cell[key]["flops_ratio"] <= most
                for key, most in WHISPER_RATIO_MAX.items())
            and wh_gb < WHISPER_DECODE_GB):
        raise SystemExit("[chip_smoke] FAIL: a rank of whisper's dry run "
                         "does not compute on its shards or its decode "
                         "still gathers its caches")
    dest = WORK / "dryrun_profile.json"
    profile.main(["--dryrun-dir", str(out), "--out", str(dest)])
    prof = WorkloadProfile.load(str(dest))
    return {"card": card_line(), "world": "fake, 256 ranks",
            "mesh": {"data": 16, "model": 16}, "cells": cells,
            "processes_s": wall,
            "profile": {"routine_weights": prof.routine_weights,
                        "total": prof.total, "by": prof.by}}


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
    reset_flash(fa)
    mm.matmul_cuda.launches = 0
    gm.grouped_matmul_cuda.launches = 0
    res = serve.run(argv)
    launches = fa.flash_attention_cuda.launches
    tally_flash(fa)
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
    # head dims between the kernel's: zero-padded, on no served path
    padded_rows = [(d, time_flash(fa, torch, bh, s, d, 512, 512, "tri",
                                  None, seed=20 + d))
                   for bh, s, d in FLASH_PADDED]

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

    # -- 11., 12. train, deepseek and int8; 15. the mesh -------------------------
    mesh_out = {"card": card_line(), "world": "nccl, 1 rank",
                "mesh": {"data": 1, "model": 1}}
    with one_rank_mesh(torch) as mesh:
        t0 = time.perf_counter()
        training, mesh_out["train"] = phase_train(mm, fa, gm, torch, mesh)
        training["phase_s"] = time.perf_counter() - t0
        print(f"[chip_smoke] phase 11 took {training['phase_s']:.1f}s; "
              f"the script {time.perf_counter() - START:.1f}s so far")

        t0 = time.perf_counter()
        deepseek, ds_grouped, mesh_out["deepseek"] = phase_deepseek(
            art, mm, fa, gm, torch, mesh)
        t1 = time.perf_counter()
        mesh_out["mixtral_tp"] = mesh_mixtral_tp(mesh, mm, fa, gm, torch)
        mesh_out["mixtral_tp_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        mesh_out["decode"], rank_grouped = mesh_decode(art, mesh, mm, fa,
                                                       gm, torch)
        mesh_out["decode_s"] = time.perf_counter() - t1
        mesh_out["paged"] = {
            "stablelm": mesh_out["decode"]["stablelm"].pop("paged"),
            "deepseek": mesh_out["deepseek"].pop("paged")}
        t1 = time.perf_counter()
        mesh_out["recurrent"] = mesh_recurrent(mesh, mm, fa, gm, torch)
        mesh_out["recurrent_s"] = time.perf_counter() - t1
        mesh_out["heads"] = mesh_heads(mesh, mm, fa, gm, torch)
        mesh_out["launcher"] = mesh_launcher(mesh, mm, fa, gm, torch)
        mesh_out["encdec"] = mesh_encdec(mesh, mm, fa, gm, torch)
        print(f"[chip_smoke] phase 15 (f) took {mesh_out['decode_s']:.1f}s"
              f", (g) " + ", ".join(
                  f"{k} {v['phase_s']:.1f}s"
                  for k, v in mesh_out["paged"].items())
              + f", (h) {mesh_out['recurrent_s']:.1f}s, (i) "
              f"{mesh_out['heads']['phase_s']:.1f}s, (j) "
              f"{mesh_out['launcher']['phase_s']:.1f}s, (k) "
              f"{mesh_out['encdec']['phase_s']:.1f}s")
    deepseek["int8"] = phase_int8(mm, fa, gm, torch)
    deepseek["phase_s"] = (time.perf_counter() - t0
                           - mesh_out["mixtral_tp_s"] - mesh_out["decode_s"]
                           - mesh_out["recurrent_s"]
                           - mesh_out["heads"]["phase_s"]
                           - mesh_out["launcher"]["phase_s"]
                           - mesh_out["encdec"]["phase_s"])
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

    # -- 16. the dry run -------------------------------------------------------------
    t0 = time.perf_counter()
    dryrun = phase_dryrun(torch)
    dryrun["trace_vs_card"] = mesh_out["deepseek"]["trace"]
    dryrun["phase_s"] = time.perf_counter() - t0
    print(f"[chip_smoke] phase 16 took {dryrun['phase_s']:.1f}s; the "
          f"script {time.perf_counter() - START:.1f}s so far")

    # -- 17. report ---------------------------------------------------------------
    kernels = [flash_entry("flash_attention", flash_row, launches,
                           case_max_abs_err=errs,
                           path_launches_by_head_dim=FLASH_PATH_BY_D,
                           mesh_launches={
                               "stablelm_tp_prefill": mesh_out["train"][
                                   "tp_prefill"]["flash_launches"],
                               "recurrentgemma_tp_prefill": mesh_out[
                                   "recurrent"]["recurrentgemma-2b"][
                                   "prefill"]["flash_launches"],
                               "starcoder2_tp_prefill": mesh_out["heads"][
                                   "prefill"]["flash_launches"],
                               "whisper_tp_prefill": mesh_out["encdec"][
                                   "prefill"]["flash_launches"]}),
               flash_entry("flash_attention@mixtral_prefill",
                           mixtral["flash"], mixtral["flash_launches"]),
               flash_entry("flash_attention@queue_prefill",
                           serving["queue"]["flash"],
                           serving["queue"]["flash_launches"])]
    kernels += [flash_entry(f"flash_attention@{label}", row, n)
                for label, row, n in family_flash]
    # the padded head dims' launches on the counted main paths, by head
    # dim (no served model has one of them)
    kernels += [flash_entry(f"flash_attention@d{d}_padded", row,
                            FLASH_PATH_BY_D.get(d, 0),
                            on_path=d in FLASH_PATH_BY_D)
                for d, row in padded_rows]
    # one entry per measured shape: the tiled GEMM at 2048^3 (the main
    # entry) and the largest cube, the grouped kernel at mixtral's decode
    # bucket (the main entry: 180 of its 192 launches) and prefill bucket,
    # and at deepseek-v2's four buckets with the launches of deepseek's
    # path (no main entry there), and at a rank's four buckets of the
    # production decode with none (no path here gives those shapes)
    # the grouped kernel's launches on the mesh paths (phase 15)
    grouped_entry["mesh_launches"] = {
        "mixtral_tp_call": mesh_out["mixtral_tp"]["launches"],
        "mixtral_mesh_decode": mesh_out["decode"]["mixtral"]["launches"]}
    ds_grouped["mesh_launches"] = {
        "deepseek_prefill_ep": mesh_out["deepseek"]["prefill_launches"],
        "deepseek_decode": mesh_out["deepseek"]["decode_launches"],
        "deepseek_paged_decode": mesh_out["paged"]["deepseek"]["launches"]}
    for name, source, replaces, entry, errs_, main in (
            ("matmul", "matmul.cu", "src/repro/kernels/matmul.py:57",
             gemm_entry, gemm_errs, f"gemm_{LARGE_CUBE}"),
            ("grouped_matmul", "grouped_matmul.cu",
             "src/repro/kernels/grouped_matmul.py:51", grouped_entry,
             grouped_errs, "mixtral_decode"),
            ("grouped_matmul", "grouped_matmul.cu",
             "src/repro/kernels/grouped_matmul.py:51", ds_grouped,
             grouped_errs, None),
            ("grouped_matmul", "grouped_matmul.cu",
             "src/repro/kernels/grouped_matmul.py:51", rank_grouped,
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
                **({"mesh_launches": entry["mesh_launches"]}
                   if "mesh_launches" in entry else {}),
                **({"note": entry["note"]} if "note" in entry else {}),
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
    print(json.dumps({"mesh": mesh_out}))
    print(json.dumps({"dryrun": dryrun}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
