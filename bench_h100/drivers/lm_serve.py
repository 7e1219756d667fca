"""A decoder LM served by the program's continuous-batching scheduler to
closed-loop clients.

Set-up makes the weights on the device from the run seed (the
reference's layout), builds the model from the configuration's
published keys, loads the tuner from the install cache, and builds the
``ContinuousBatchingScheduler`` with the mix's slots and pages.
Warm-up prefills one prompt of every length the mix serves, then starts
the clients (each submits its next request when the last one finishes)
and runs the loop for the mix's ``warm_s``.  The window runs the loop
for the run's seconds (a traced run profiles its last part,
``Tracer.head``).

Token times come from the scheduler's public state: a request leaves
the queue in the ``step`` call that prefills it (first in, first out),
and its first token is known when that call returns; a request admitted
at the start of call ``a`` (``FinishedSeq.admitted_step``) has its j-th
token (j >= 2) at the end of decode step ``a + j - 2`` (the
scheduler's ``steps`` count before the call).  The window counts the
tokens and first tokens whose call ends inside it.

After the window the scheduler is freed and a sample of the requests
finished in the window, drawn from the seed with the one that served
most tokens in it, is run through the plain reference: ``logit_gap`` is
the widest gap by which a served token's logit lies below the
reference's best (a routing that the reference finds tied within
rounding may go either way: ``reference.mixtral.widest_gap``)."""

from __future__ import annotations

import dataclasses
import inspect
import sys
import time
from collections import deque
from itertools import islice

import numpy as np

from benchlib import counts, install, peaks, registry, stats
from benchlib.cli import RunFailed


@dataclasses.dataclass
class Rec:
    prompt: list
    max_new: int
    t_submit: float
    call_admit: int = -1       # the step call that prefilled it
    a: int = -1                # its admitted_step
    tokens: tuple | None = None


def arch_config(cfg: dict):
    """The program's ArchConfig for the published keys of ``cfg``."""
    from repro_torch.models.config import ArchConfig

    if cfg.get("hidden_act") != "silu" or cfg.get("model_type") != "mixtral":
        raise RunFailed("lm_serve runs Mixtral-style configurations "
                        "(silu experts, model_type mixtral)")
    return ArchConfig(
        name=cfg["model_type"], family="moe",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        attn_kind="gqa", window=cfg["sliding_window"], mlp_kind="swiglu",
        norm_kind="rmsnorm", n_experts=cfg["num_local_experts"],
        top_k=cfg["num_experts_per_tok"],
        d_ff_expert=cfg["intermediate_size"],
        tie_embeddings=cfg["tie_word_embeddings"])


def check_program(cfg: dict, model, ref) -> None:
    """Refuse a configuration the program would not run as stated: its
    RoPE base, norm epsilon, capacity factor and weight layout."""
    from repro_torch.models import layers, moe
    from repro_torch.models.params import tree_leaves, tree_paths

    fixed = {
        "rope_theta": inspect.signature(layers.rope_angles)
        .parameters["base"].default,
        "rms_norm_eps": inspect.signature(layers.rmsnorm)
        .parameters["eps"].default,
        "moe_capacity.factor": next(
            f.default for f in dataclasses.fields(moe.MoESpec)
            if f.name == "capacity_factor"),
    }
    stated = {"rope_theta": cfg["rope_theta"],
              "rms_norm_eps": cfg["rms_norm_eps"],
              "moe_capacity.factor": cfg["moe_capacity"]["factor"]}
    for k, v in fixed.items():
        if float(v) != float(stated[k]):
            raise RunFailed(f"the program runs {k} = {v}, the "
                            f"configuration states {stated[k]}")
    want = {tuple(p): tuple(s) for p, s, _, _ in ref.weight_specs(cfg)}
    have = {tuple(p): tuple(d.shape) for p, d in
            zip(tree_paths(model.defs), tree_leaves(model.defs))}
    if want != have:
        raise RunFailed("the program's weight layout differs from the "
                        "reference's: "
                        f"{sorted(set(want.items()) ^ set(have.items()))[:4]}")


class Loop:
    """The closed loop over the scheduler, and what it saw."""

    def __init__(self, sched, traffic, tracer, slots: int):
        self.sched, self.traffic, self.tr = sched, traffic, tracer
        self.slots = slots
        self.recs: dict[int, Rec] = {}
        self.fifo: deque[int] = deque()
        self.ends: list[float] = []          # end of each step call
        self.step_end: dict[int, float] = {}  # decode step -> its end
        self.n_seen = len(sched.finished)
        self.open = True                     # clients still submit

    def submit(self, first: bool = False) -> None:
        prompt, n = self.traffic.first() if first else self.traffic.next()
        rid = self.sched.submit(prompt, n)
        self.recs[rid] = Rec(prompt, n, time.perf_counter())
        self.fifo.append(rid)

    def step(self) -> None:
        s = self.sched
        k, n = len(self.ends), s.steps
        pending, active = s.pending, s.active
        with self.tr.range("sched.step"):
            s.step()
        self.ends.append(time.perf_counter())
        if s.steps > n:
            self.step_end[n] = self.ends[-1]
        with self.tr.range("client"):
            admitted = pending - s.pending
            at_start = min(self.slots - active, pending)
            for j in range(admitted):
                rec = self.recs[self.fifo.popleft()]
                rec.call_admit = k
                rec.a = n if j < at_start else n + 1
            for rid in islice(s.finished, self.n_seen, None):
                fs = s.finished[rid]
                rec = self.recs[rid]
                if fs.admitted_step != rec.a:
                    raise RunFailed(
                        f"request {rid}: admitted_step {fs.admitted_step}"
                        f", the loop's bookkeeping says {rec.a}")
                rec.tokens = fs.tokens
                if self.open:
                    self.submit()
            self.n_seen = len(s.finished)

    def run_until(self, t_end: float) -> None:
        while not self.ends or self.ends[-1] < t_end:
            self.step()

    def token_times(self, rec: Rec) -> list[float]:
        """The times the request's tokens became known, up to the last
        call made."""
        if rec.call_admit < 0:
            return []
        last = self.sched.steps - 1
        n = len(rec.tokens) if rec.tokens is not None \
            else min(rec.max_new, last - rec.a + 2)
        return [self.ends[rec.call_admit]] + [
            self.step_end[rec.a + j - 2] for j in range(2, n + 1)]


def run(r) -> None:
    import torch

    from repro_torch.configs import build_model
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler

    t_in = time.perf_counter()
    cfg, mix = r.config, r.mix
    ref = registry.module("reference", cfg["reference"])
    model = build_model(arch_config(cfg))
    check_program(cfg, model, ref)
    slots = mix["slots"]
    if ref.capacity(cfg, slots) < slots:
        raise RunFailed(
            f"a decode step of {slots} slots can drop pairs past an "
            f"expert's capacity {ref.capacity(cfg, slots)}: a request's "
            "tokens would depend on its neighbours")
    spec = r.extra.get("install_spec") or registry.install_spec(
        cfg["install"], r.here)
    tuner, r.first_setup = install.load_tuner(r.root, spec)
    t_w = time.perf_counter()
    weights = ref.make_weights(cfg, r.seed, r.device)
    t_w = time.perf_counter() - t_w
    traffic = registry.module("generators", mix["generator"]).Traffic(
        mix, cfg["vocab_size"], r.seed)
    page = mix["page_size"]
    n_pages = slots * -(-mix["max_seq_len"] // page)
    sched = ContinuousBatchingScheduler(
        model, model.cfg, weights, slots=slots, n_pages=n_pages,
        page_size=page, max_seq_len=mix["max_seq_len"], tuner=tuner)

    # warm-up: every prompt length once, then the loop itself
    t_warm = time.perf_counter()
    for prompt in traffic.warm():
        sched.submit(prompt, 2)
    sched.run_until_drained()
    t_loop = time.perf_counter()
    loop = Loop(sched, traffic, r.tracer, slots)
    for _ in range(mix["clients"]):
        loop.submit(first=True)
    loop.run_until(time.perf_counter() + mix["warm_s"])
    r.setup_s = time.perf_counter() - r.t_start
    log0 = len(sched.decode_log)
    t0 = time.perf_counter()
    if r.tracer.head(r.seconds):
        loop.run_until(t0 + r.tracer.head(r.seconds))
    with r.tracer.window():
        loop.run_until(t0 + r.seconds)
    t1 = loop.ends[-1]
    loop.open = False
    r.memory_peak = torch.cuda.max_memory_allocated() \
        if r.device == "cuda" else 0
    window_s = t1 - t0

    def inside(t):
        return t0 < t <= t1

    ttft, gaps, tokens, flops, touched = [], [], 0, 0.0, 0
    for rec in loop.recs.values():
        times = loop.token_times(rec)
        if not times:
            continue
        if any(inside(t) for t in times):
            touched += 1
        if inside(times[0]):
            ttft.append(times[0] - rec.t_submit)
            flops += counts.lm_prefill_flops(cfg, len(rec.prompt))
        for j, t in enumerate(times):
            if inside(t):
                tokens += 1
                if j:
                    flops += counts.lm_decode_flops(cfg, len(rec.prompt) + j)
            if j and inside(t) and inside(times[j - 1]):
                gaps.append(t - times[j - 1])
    r.metrics["output_tok_s"] = tokens / window_s
    if ttft:
        r.metrics["ttft_p90_ms"] = 1e3 * stats.percentile(ttft, 90)
    if gaps:
        r.metrics["itl_p95_ms"] = 1e3 * stats.percentile(gaps, 95)
    steps = sched.decode_log[log0:]
    r.attempted = touched
    r.extra.update(
        mfu_pct=100.0 * flops / window_s / peaks.FP32_FLOPS,
        occupancy_pct=(100.0 * sum(a for _, a in steps)
                       / (len(steps) * slots)) if steps else None)

    # the requests finished in the window against the plain reference
    done = [rec for rec in loop.recs.values() if rec.tokens is not None
            and inside(loop.token_times(rec)[-1])]
    del loop, sched
    if r.device == "cuda":
        torch.cuda.empty_cache()
    sample = pick_sample(done, mix["check_requests"], r.seed)
    from reference import fp32_highest

    gap, t_ref = 0.0, time.perf_counter()
    with torch.inference_mode(), fp32_highest():
        for rec in sample:
            gap = max(gap, ref.widest_gap(weights, cfg, rec.prompt,
                                          list(rec.tokens)))
    if not sample:
        r.failed += 1
    print(f"[bench] lm_serve: set-up {r.setup_s:.1f} s (start-up "
          f"{t_in - r.t_start:.1f} s, weights {t_w:.1f} s, warm prefills "
          f"{t_loop - t_warm:.1f} s, loop warm-up "
          f"{r.t_start + r.setup_s - t_loop:.1f} s), window "
          f"{window_s:.2f} s, {len(ttft)} first tokens, {tokens} tokens, "
          f"{len(gaps)} gaps, {len(steps)} decode steps; reference "
          f"{time.perf_counter() - t_ref:.1f} s over {len(sample)} "
          f"requests, {sum(len(x.tokens) for x in sample)} tokens",
          file=sys.stderr)
    r.checks["logit_gap"] = (gap, float(cfg["checks"]["logit_gap"]))
    r.extra.update(sample=sample, weights=weights)


def control(r) -> dict:
    """The control's reading on the run's sample: the reference in TF32
    in the program's place, each position's first token under TF32
    held against the float32 reference's logits."""
    import torch

    from reference import fp32_highest, mm_tf32

    ref = registry.module("reference", r.config["reference"])
    gap = 0.0
    with torch.inference_mode(), fp32_highest():
        for rec in r.extra["sample"]:
            args = (r.extra["weights"], r.config, rec.prompt,
                    list(rec.tokens))
            low = ref.served_logits(*args, mm=mm_tf32).argmax(dim=1)
            gap = max(gap, ref.widest_gap(*args, chosen=low.tolist()))
    return {"logit_gap": gap}


def pick_sample(done: list[Rec], n: int, seed: int) -> list[Rec]:
    """``n`` finished requests drawn from the seed, always with the one
    that served most tokens (then the longest prompt)."""
    if not done:
        return []
    longest = max(done, key=lambda x: (len(x.tokens), len(x.prompt)))
    rest = [x for x in done if x is not longest]
    rng = np.random.default_rng([seed, 3])
    take = rng.permutation(len(rest))[: max(0, n - 1)]
    return [longest] + [rest[i] for i in sorted(take)]
