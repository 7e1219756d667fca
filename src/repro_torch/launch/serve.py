"""Serving launcher: batched prefill + decode loop with the ADSALA tuner.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --scale full --requests 4 --prompt-len 1024 --gen-tokens 16 \
        --artifact DIR

The runtime workflow of the paper (Fig 3), as in
``repro.launch.serve``: the tuner is loaded once at boot, consulted per
call *shape* (memoised), and its chosen worker configurations are
reported beside the generation stats.  Prefill attention runs through
the Hopper flash kernel with the block and KV walk the tuner chose.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for ``cuda``
on a host without a GPU raises.  Weights and prompts are random, drawn
from seeded ``torch.Generator``s on the device.
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
class ServeResult:
    """What one fixed-batch run produced, for callers that check it."""
    cfg: Any
    model: Any
    params: dict
    prompts: torch.Tensor          # (requests, prompt_len)
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
    ap.add_argument("--artifact", default=None,
                    help="ADSALA artifact dir (tuner enabled when set)")
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
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; "
                         "'cpu' runs the kernels' plain versions)")
    return ap.parse_args(argv)


def run(argv: list[str] | None = None) -> ServeResult:
    """Parse ``argv``, serve one fixed batch, print the report."""
    args = parse_args(argv)
    cfg = (get_config if args.scale == "full"
           else get_smoke_config)(args.arch)
    return serve_config(cfg, args)


def serve_config(cfg: ArchConfig, args: argparse.Namespace) -> ServeResult:
    """Serve one fixed batch of ``cfg`` with the options of ``args`` (as
    :func:`parse_args` makes them; ``--arch`` and ``--scale`` are not
    read) and print the report."""
    dev = resolve_device(args.device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    # separate recorders per traffic class: prefill and decode have very
    # different shape profiles
    recs = {"prefill": DispatchRecorder(), "decode": DispatchRecorder()}

    tuner = None
    if args.artifact and os.path.isdir(args.artifact):
        from repro_torch.core import AdsalaTuner
        mode = (f"beam search width {args.search_width}"
                if args.search_width else "fixed-candidate argmin")
        tuner = AdsalaTuner.from_artifact(args.artifact,
                                          search_width=args.search_width)
        print(f"[serve] ADSALA tuner loaded from {args.artifact} ({mode})")

    cache_len = args.prompt_len + args.gen_tokens
    pctx = make_ctx("prefill", cache_len=cache_len, tuner=tuner)
    dctx = make_ctx("decode", cache_len=cache_len, tuner=tuner)

    prompts = torch.randint(
        0, cfg.vocab, (args.requests, args.prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        with recs["prefill"]:
            logits, cache = model.prefill(params, prompts, pctx)
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
        _sync(dev)
        t_decode = time.perf_counter() - t0

    out = torch.cat(generated, dim=1)
    tps = args.requests * (args.gen_tokens - 1) / max(t_decode, 1e-9)
    print(f"[serve] {cfg.name}: {args.requests} requests, "
          f"prefill {args.prompt_len} toks in {t_prefill*1e3:.1f}ms, "
          f"decoded {args.gen_tokens} toks at {tps:.1f} tok/s")
    print(f"[serve] sample continuation ids: {out[0, :8].tolist()}")
    _report_tail(args, cfg, recs, tuner)
    return ServeResult(cfg, model, params, prompts, tuner, recs,
                       prefill_logits, out, t_prefill, tps)


def _report_tail(args, cfg, recs, tuner) -> None:
    """Post-run reporting: routine mix, tuner stats, --profile-out."""
    # combined view across traffic classes for reporting / --profile-out
    rec = DispatchRecorder()
    for r in recs.values():
        rec.events.extend(r.events)
    mix = rec.routine_mix(by="events")
    if mix:
        pretty = " ".join(f"{r}={f:.2f}" for r, f in mix.items())
        print(f"[serve] dispatch routine mix (by events): {pretty} "
              f"over {len(rec.events)} traced events")
    if tuner is not None:
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
            source={"kind": "serve", "arch": cfg.name, "queue": False,
                    "requests": args.requests,
                    "prompt_len": args.prompt_len,
                    "gen_tokens": args.gen_tokens})
        prof.save(args.profile_out)
        print(f"[serve] workload profile written to {args.profile_out}")


def main(argv: list[str] | None = None) -> None:
    run(argv)


if __name__ == "__main__":
    main()
