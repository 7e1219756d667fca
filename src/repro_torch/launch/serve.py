"""Serving launcher: batched prefill + decode loop with the ADSALA tuner.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --scale full --requests 4 --prompt-len 1024 --gen-tokens 16 \
        --artifact DIR

The runtime workflow of the paper (Fig 3), as in
``repro.launch.serve``: the tuner is loaded once at boot, consulted per
call *shape* (memoised), and its chosen worker configurations are
reported beside the generation stats.  Prefill attention runs through
the Hopper flash kernel with the block and KV walk the tuner chose.

``--queue`` serves a ragged request trace through the paged-KV
continuous-batching scheduler instead of one fixed batch;
``--reinstall`` closes the loop: drift of the live dispatch mix from the
installed profile fires a background re-install and an atomic artifact
hot-swap while serving continues; ``--registry`` resolves the artifact
by this machine's fingerprint:

    PYTHONPATH=src python -m repro_torch.launch.serve --scale full \
        --queue --requests 8 --prompt-len 1024 --gen-tokens 32 \
        --slots 4 --page-size 16 --artifact DIR --reinstall

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
on a host without a GPU raises.  Weights and prompts are random, drawn
from seeded ``torch.Generator``s on the device; an encoder-decoder arch
(``audio`` family: whisper-tiny) also gets random frame embeddings
``audio_emb`` (requests x encoder_len x d_model) from the prompts'
generator, and serves fixed batches only (``--queue`` refuses it, as
the reference's scheduler does).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Any

import torch

from repro_torch.configs import (
    ARCH_IDS,
    build_model,
    get_config,
    get_smoke_config,
)
from repro_torch.kernels.recorder import DispatchRecorder
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import _moe_spec
from repro_torch.train.step import make_ctx

#: total-variation distance between the serving routine mix and the
#: installed workload profile above which serve warns (0 = identical)
DRIFT_WARN = 0.25


@dataclasses.dataclass
class QueueResult:
    """What one ``--queue`` run produced, for callers that check it."""
    cfg: Any
    model: Any
    params: dict
    tuner: Any
    manager: Any                   # ReinstallManager or None
    recs: dict                     # traffic class -> DispatchRecorder
    sched: Any                     # the scheduler: finished, alloc, logs
    n_pages: int
    wall_s: float
    tok_per_s: float
    #: per decode step: (seconds, active slots, re-install in flight)
    steps: list
    #: the drift each fire was launched at
    fire_drifts: list
    #: seconds from each fire to its install's end (read once a decode
    #: step, or at the drain)
    reinstall_s: list


@dataclasses.dataclass
class ServeResult:
    """What one fixed-batch run produced, for callers that check it."""
    cfg: Any
    model: Any
    params: dict
    prompts: torch.Tensor          # (requests, prompt_len)
    #: the ``audio`` family's frame embeddings (requests, encoder_len,
    #: d_model), else None
    audio_emb: torch.Tensor | None
    tuner: Any
    recs: dict                     # traffic class -> DispatchRecorder
    prefill_logits: torch.Tensor   # (requests, vocab)
    tokens: torch.Tensor           # (requests, gen_tokens)
    prefill_s: float
    tok_per_s: float


def resolve_device(name: str) -> torch.device:
    """The device to serve on; ``cuda`` without a GPU raises (there is
    no fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device on this host")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b", choices=ARCH_IDS)
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--queue", action="store_true",
                    help="trace-driven continuous batching: serve a "
                         "ragged request queue (prompt lengths up to "
                         "--prompt-len, outputs up to --gen-tokens) "
                         "through the paged-KV scheduler instead of "
                         "one fixed batch")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (batch width) in --queue mode")
    ap.add_argument("--page-size", type=int, default=8,
                    help="KV page size (token slots) in --queue mode")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="total KV pages in the shared pool (default: "
                         "2x worst case for --slots sequences)")
    ap.add_argument("--artifact", default=None,
                    help="ADSALA artifact dir (tuner enabled when set)")
    ap.add_argument("--registry", default=None,
                    help="per-architecture artifact registry root: "
                         "fingerprint this host and serve from its own "
                         "cell, falling back to the nearest populated "
                         "neighbour (mutually exclusive with "
                         "--artifact); with --reinstall the loop "
                         "targets this machine's cell")
    ap.add_argument("--search-width", type=int, default=None,
                    help="beam width for dispatch-time config search "
                         "over the artifact's persisted space (default: "
                         "fixed-candidate argmin, the paper's policy)")
    ap.add_argument("--profile-out", default=None,
                    help="write the recorded dispatch mix as a "
                         "WorkloadProfile JSON")
    ap.add_argument("--profile-by", default="flops",
                    choices=["flops", "events"],
                    help="dispatch-volume weighting of --profile-out")
    ap.add_argument("--reinstall", action="store_true",
                    help="close the serving loop: watch live dispatch "
                         "drift vs the installed workload profile and "
                         "re-install + hot-swap the artifact in the "
                         "background when it crosses the threshold "
                         "(requires --artifact)")
    ap.add_argument("--reinstall-threshold", type=float, default=0.25,
                    help="drift (total variation, 0..1) that triggers "
                         "a background re-install")
    ap.add_argument("--reinstall-budget", type=int, default=2000,
                    help="timing budget (cells) for each background "
                         "re-install; keeps the online install cheap")
    ap.add_argument("--reinstall-cooldown", type=float, default=300.0,
                    help="minimum seconds between re-installs")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; "
                         "'cpu' runs the kernels' plain versions)")
    return ap.parse_args(argv)


def run(argv: list[str] | None = None) -> ServeResult | QueueResult:
    """Parse ``argv``, serve one fixed batch (or the ``--queue`` trace),
    print the report."""
    args = parse_args(argv)
    cfg = (get_config if args.scale == "full"
           else get_smoke_config)(args.arch)
    return serve_config(cfg, args)


def serve_config(cfg: ArchConfig, args: argparse.Namespace, *,
                 keep_logits: bool = False) -> ServeResult | QueueResult:
    """Serve one fixed batch of ``cfg`` (or, with ``--queue``, the
    request trace) with the options of ``args`` (as :func:`parse_args`
    makes them; ``--arch`` and ``--scale`` are not read) and print the
    report.  ``keep_logits`` keeps every queued request's logits in
    ``sched.logits`` (for parity checks)."""
    dev = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    # separate recorders per traffic class: prefill and decode have very
    # different shape profiles, and the re-install manager merges them
    # volume-weighted so the install budget follows serving volume
    recs = {"prefill": DispatchRecorder(), "decode": DispatchRecorder()}

    fingerprint = None
    if args.registry:
        fingerprint = _resolve_registry(args)

    tuner = None
    manager = None
    if args.artifact and os.path.isdir(args.artifact):
        mode = (f"beam search width {args.search_width}"
                if args.search_width else "fixed-candidate argmin")
        if args.reinstall:
            from repro_torch.core.costmodel import ROUTINES
            from repro_torch.core.installer import InstallConfig
            from repro_torch.serve import ReinstallConfig, ReinstallManager
            # backend=None on purpose: the manager rebuilds the same
            # kind of backend that installed the artifact (its
            # "backend" provenance block) — a measured artifact
            # re-installs measured on the card, legacy ones fall back
            # to the simulator, which the card refuses (below).  Every
            # routine keeps its coverage (the
            # reference's launcher re-installs gemm only, which its
            # manager's default template warns against: a narrowing
            # swap strands the routines it drops)
            manager = ReinstallManager(
                args.artifact, recs,
                fingerprint=fingerprint,
                cfg=ReinstallConfig(
                    threshold=args.reinstall_threshold,
                    cooldown_s=args.reinstall_cooldown,
                    min_events=8,
                    install=InstallConfig(
                        n_samples=160, repeats=2,
                        routines=tuple(ROUTINES),
                        models=("lightgbm",),
                        timing_budget=args.reinstall_budget)),
                search_width=args.search_width)
            _require_measured_reinstall(dev, manager)
            tuner = manager
            print(f"[serve] ADSALA tuner loaded from {args.artifact} "
                  f"({mode}); online re-install armed at drift > "
                  f"{args.reinstall_threshold}")
        else:
            from repro_torch.core import AdsalaTuner
            tuner = AdsalaTuner.from_artifact(
                args.artifact, search_width=args.search_width,
                local_fingerprint=fingerprint)
            print(f"[serve] ADSALA tuner loaded from {args.artifact} "
                  f"({mode})")
    elif args.reinstall:
        raise SystemExit("--reinstall requires --artifact (or "
                         "--registry) pointing at an installed ADSALA "
                         "artifact")

    if args.queue:
        return _serve_queue(args, cfg, model, params, tuner, manager, recs,
                            dev, keep_logits)

    cache_len = args.prompt_len + args.gen_tokens
    pctx = make_ctx("prefill", cache_len=cache_len, tuner=tuner)
    dctx = make_ctx("decode", cache_len=cache_len, tuner=tuner)

    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(
        0, cfg.vocab, (args.requests, args.prompt_len), device=dev,
        generator=gen)
    audio_emb = None
    batch: Any = prompts
    if cfg.family == "audio":
        audio_emb = torch.randn(
            (args.requests, cfg.encoder_len, cfg.d_model), device=dev,
            generator=gen)
        batch = {"tokens": prompts, "audio_emb": audio_emb}

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        with recs["prefill"]:
            logits, cache = model.prefill(params, batch, pctx)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        if tuner is not None:
            # the serving GEMM shapes the tuner is consulted for
            d = cfg.d_model
            shapes = [(args.requests * args.prompt_len, d, d),  # qkv/o
                      (args.requests, d, cfg.vocab)]            # logits
            if cfg.n_experts:                       # one expert bucket
                spec = _moe_spec(cfg)
                shapes.append((spec.capacity(args.requests
                                             * args.prompt_len),
                               d, spec.d_ff))
            for (m, k, n) in shapes:
                c = tuner.select(m, k, n)
                print(f"[serve] tuner GEMM {m}x{k}x{n} -> "
                      f"chips={c.n_chips} partition={c.partition} "
                      f"tile={c.tile}")

        prefill_logits = logits
        toks = torch.argmax(logits, -1)[:, None]
        generated = [toks]
        t0 = time.perf_counter()
        for i in range(args.gen_tokens - 1):
            # the reference records its jitted decode step once, while
            # tracing; record the first eager step only, so the steady
            # loop pays no recorder cost (eager dispatch records every
            # layer, where the reference's traced scan body records one)
            watch = recs["decode"] if i == 0 else contextlib.nullcontext()
            with watch:
                logits, cache = model.decode_step(
                    params, toks, cache, args.prompt_len + i, dctx)
            toks = torch.argmax(logits, -1)[:, None]
            generated.append(toks)
            if manager is not None and manager.check():
                print(f"[serve] drift {manager.last_drift:.3f} crossed "
                      f"{args.reinstall_threshold} at decode step {i}: "
                      "background re-install launched (serving "
                      "continues)")
        _sync(dev)
        t_decode = time.perf_counter() - t0

    out = torch.cat(generated, dim=1)
    tps = args.requests * (args.gen_tokens - 1) / max(t_decode, 1e-9)
    print(f"[serve] {cfg.name}: {args.requests} requests, "
          f"prefill {args.prompt_len} toks in {t_prefill*1e3:.1f}ms, "
          f"decoded {args.gen_tokens} toks at {tps:.1f} tok/s")
    print(f"[serve] sample continuation ids: {out[0, :8].tolist()}")
    _report_tail(args, cfg, recs, tuner, manager)
    return ServeResult(cfg, model, params, prompts, audio_emb, tuner, recs,
                       prefill_logits, out, t_prefill, tps)


def _require_measured_reinstall(dev: torch.device, manager) -> None:
    """On the card the background re-install times the port's kernels:
    refuse an artifact whose install backend does not rebuild as
    :class:`~repro_torch.core.timing.MeasuredCUDABackend` (a simulated
    or legacy artifact would re-install against the v5e model)."""
    from repro_torch.core.timing import MeasuredCUDABackend

    if dev.type == "cuda" and not isinstance(manager.backend,
                                             MeasuredCUDABackend):
        kind = (manager.tuner.backend_info or {}).get("kind")
        raise SystemExit(
            f"--reinstall on {dev}: the artifact {manager.artifact_dir} "
            f"was installed by a {kind or 'legacy (unrecorded)'} backend, "
            "so its re-install would not time this card; install it "
            "with launch.profile --install --backend measured")


def _resolve_registry(args: argparse.Namespace):
    """Point ``args.artifact`` at this machine's registry cell (or its
    nearest populated neighbour; under ``--reinstall`` a cold cell is
    seeded by adopting the neighbour, so re-installs stay local) and
    return this machine's fingerprint."""
    if args.artifact:
        raise SystemExit("--registry and --artifact are mutually "
                         "exclusive: the registry resolves the "
                         "artifact by this machine's fingerprint")
    from repro_torch.core.registry import (ArtifactRegistry,
                                           resolve_serving_artifact)
    resolved = resolve_serving_artifact(args.registry)
    fingerprint = resolved.local
    if resolved.path is None:
        raise SystemExit(
            f"registry {args.registry} has no servable artifact in "
            f"any cell — run an install first "
            "(repro_torch.launch.profile --registry ...)")
    if not resolved.exact and args.reinstall:
        # the re-install loop must own a LOCAL cell (never overwrite the
        # neighbour's artifact with this machine's corrected timings):
        # seed ours by adopting the neighbour
        reg = ArtifactRegistry(args.registry)
        args.artifact = reg.adopt(fingerprint, resolved.path)
        print(f"[serve] registry: cold cell {fingerprint.key()} "
              f"seeded from nearest neighbour "
              f"{resolved.cell.key()} (adopt; re-installs stay "
              "local)")
    else:
        args.artifact = resolved.path
        cell = ("own cell" if resolved.exact
                else f"nearest cell {resolved.cell.key()}")
        print(f"[serve] registry: serving {cell} for "
              f"{fingerprint.key()}")
    return fingerprint


def _report_tail(args, cfg, recs, tuner, manager) -> None:
    """Shared post-run reporting: routine mix, tuner/re-install stats,
    optional --profile-out — identical for fixed-batch and --queue."""
    # combined view across traffic classes for reporting / --profile-out
    rec = DispatchRecorder()
    for r in recs.values():
        rec.events.extend(r.events)
    mix = rec.routine_mix(by="events")
    if mix:
        pretty = " ".join(f"{r}={f:.2f}" for r, f in mix.items())
        print(f"[serve] dispatch routine mix (by events): {pretty} "
              f"over {len(rec.events)} traced events")
    if manager is not None:
        if manager.installing:
            print("[serve] waiting for the background re-install...")
        manager.wait()
        if manager.last_error is not None:
            print(f"[serve] re-install failed (old artifact still "
                  f"serving): {manager.last_error!r}")
        drift = manager.drift()
        print(f"[serve] tuner stats: {tuner.stats}")
        print(f"[serve] re-install: fires={manager.fires} "
              f"swaps={manager.swaps} post-swap drift="
              f"{'n/a' if drift is None else format(drift, '.3f')}")
    elif tuner is not None:
        print(f"[serve] tuner stats: {tuner.stats}")
        # compare the live mix against the profile the install grid was
        # weighted by (same weighting the profile was built with)
        if tuner.workload is not None and rec.events:
            drift = tuner.workload_drift(
                rec.routine_mix(by=tuner.workload.by))
            print(f"[serve] workload drift vs installed profile: "
                  f"{drift:.3f} (total variation)")
            if drift > DRIFT_WARN:
                print(f"[serve] WARNING: serving mix drifted "
                      f"{drift:.2f} > {DRIFT_WARN} from the installed "
                      "workload profile — the install budget was spent "
                      "on a different routine mix; re-profile and "
                      "re-install")
    if args.profile_out:
        from repro_torch.core.workload import WorkloadProfile
        prof = WorkloadProfile.from_recorder(
            rec, by=args.profile_by,
            source={"kind": "serve", "arch": cfg.name,
                    "queue": bool(args.queue),
                    "requests": args.requests,
                    "prompt_len": args.prompt_len,
                    "gen_tokens": args.gen_tokens})
        prof.save(args.profile_out)
        print(f"[serve] workload profile written to {args.profile_out}")


def _serve_queue(args, cfg, model, params, tuner, manager, recs,
                 dev: torch.device, keep_logits: bool) -> QueueResult:
    """Trace-driven continuous batching: ragged requests through the
    paged-KV scheduler, re-install drift checks riding the step hook."""
    import numpy as np

    from repro_torch.serve.kv_cache import pages_for
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    max_seq = args.prompt_len + args.gen_tokens
    worst = pages_for(max_seq, args.page_size)
    n_pages = (args.kv_pages if args.kv_pages is not None
               else 2 * args.slots * worst)
    sched = ContinuousBatchingScheduler(
        model, cfg, params, slots=args.slots, n_pages=n_pages,
        page_size=args.page_size, max_seq_len=max_seq, tuner=tuner,
        recorders=recs, keep_logits=keep_logits)

    rng = np.random.default_rng(1)
    for _ in range(args.requests):
        length = int(rng.integers(max(2, args.prompt_len // 4),
                                  args.prompt_len + 1))
        new = int(rng.integers(max(1, args.gen_tokens // 4),
                               args.gen_tokens + 1))
        sched.submit(rng.integers(0, cfg.vocab, length).tolist(), new)

    installing: list[bool] = []
    fire_drifts: list[float] = []
    fired_at: list[float] = []
    reinstall_s: list[float] = []

    def install_ended() -> None:
        if len(reinstall_s) < len(fired_at) and not manager.installing:
            reinstall_s.append(time.perf_counter() - fired_at[-1])

    def on_step(s):
        installing.append(manager is not None and manager.installing)
        if manager is None:
            return
        install_ended()
        if manager.check():
            fired_at.append(time.perf_counter())
            fire_drifts.append(manager.last_drift)
            print(f"[serve] drift {manager.last_drift:.3f} crossed the "
                  f"threshold at decode step {s.steps}: background "
                  "re-install launched (serving continues)")

    _sync(dev)
    t0 = time.perf_counter()
    finished = sched.run_until_drained(on_step=on_step)
    _sync(dev)
    wall = time.perf_counter() - t0
    if fired_at:
        manager.wait()
        install_ended()

    toks = sum(len(f.tokens) for f in finished.values())
    tps = toks / max(wall, 1e-9)
    print(f"[serve] {cfg.name}: {len(finished)} requests via "
          f"continuous batching ({args.slots} slots, {n_pages} pages x "
          f"{args.page_size} tokens), {toks} tokens in {wall*1e3:.1f}ms "
          f"({tps:.1f} tok/s), goodput {sched.goodput():.3f} "
          f"tok/slot-step over {sched.steps} steps")
    sample = min(finished)
    print(f"[serve] sample continuation ids: "
          f"{list(finished[sample].tokens)[:8]}")
    sched.alloc.check()
    steps = [(sec, act, inst) for (sec, act), inst
             in zip(sched.decode_log, installing)]
    _report_tail(args, cfg, recs, tuner, manager)
    return QueueResult(cfg, model, params, tuner, manager, recs, sched,
                       n_pages, wall, tps, steps, fire_drifts, reinstall_s)


def main(argv: list[str] | None = None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
