"""The port's continuous-batching scheduler on the CPU.

* golden parity: every request through the scheduler (paged KV, ragged
  admission, slot reuse) decodes token for token like the port's
  fixed-batch ``prefill`` + ``decode_step`` path at batch 1 and the
  same ``cap``, for stablelm-1.6b, for chameleon-34b (qk-norm) and for
  deepseek-v2-236b's latent pools (the cases of tests/test_scheduler.py);
* admission under a tiny pool, ``max_new=1``, submit validation, and
  the refusals of unpageable layers with the reference's messages;
* concurrent arrivals and live artifact swaps (tests/test_scheduler_race.py);
* cross-package: the same trace through the reference's scheduler and
  the port's with the weights carried across — identical tokens,
  per-step logits within 1e-4, and the same recorded dispatches: the
  reference records each prefill length and its decode step once at
  trace time, its scanned unit once; the port records the same calls
  eagerly, every layer of its loop.
"""

import dataclasses
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as jax_build_model
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.workload import WorkloadProfile as JWorkloadProfile
from repro.kernels.recorder import DispatchRecorder as JDispatchRecorder
from repro.serve.scheduler import (
    ContinuousBatchingScheduler as JScheduler,
)
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.installer import InstallConfig, install
from repro_torch.core.timing import SimulatedBackend
from repro_torch.core.tuner import AdsalaTuner
from repro_torch.core.workload import WorkloadProfile
from repro_torch.kernels.recorder import DispatchRecorder
from repro_torch.models.transformer import Ctx, LayerSpec
from repro_torch.serve import ReinstallManager
from repro_torch.serve.scheduler import ContinuousBatchingScheduler
from repro_torch.train.step import make_ctx

pytestmark = pytest.mark.timeout(300)

# one intra-op thread: these tests share the host with timing-sensitive
# tests of the reference running in other workers
torch.set_num_threads(1)

#: logits after the whole smoke stack (tests/test_torch_model.py)
LOGIT_TOL = 1e-4

_BUILT: dict = {}


def _built(arch="stablelm-1.6b"):
    if arch not in _BUILT:
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        _BUILT[arch] = (cfg, model, params)
    return _BUILT[arch]


def _trace(cfg, n=6, seed=7):
    """A fixed ragged request trace: (prompt, max_new) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(3, 10))
        out.append((rng.integers(0, cfg.vocab, length).tolist(),
                    int(rng.integers(1, 7))))
    return out


def _reference(model, params, prompt, max_new, cache_len):
    """The port's fixed-batch serving path, batch of one: (tokens,
    per-token logits)."""
    pctx = make_ctx("prefill", cache_len=cache_len)
    dctx = make_ctx("decode", cache_len=cache_len)
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.tensor([prompt]), pctx)
        out, rows = [int(torch.argmax(logits[0]))], [logits[0]]
        for i in range(max_new - 1):
            logits, cache = model.decode_step(
                params, torch.tensor([[out[-1]]]), cache, len(prompt) + i,
                dctx)
            out.append(int(torch.argmax(logits[0])))
            rows.append(logits[0])
    return out, rows


def test_golden_parity_vs_fixed_batch():
    _golden_parity("stablelm-1.6b")


def test_golden_parity_vs_fixed_batch_qk_norm():
    """chameleon-34b: GQA with qk-norm, through the same paged pools."""
    _golden_parity("chameleon-34b")


def test_golden_parity_vs_fixed_batch_mla():
    """The MLA family: latent page pools (PagedLatent) seeded field for
    field from the prefill's MLACache, read by ``mla_decode_paged``."""
    _golden_parity("deepseek-v2-236b")


def _golden_parity(arch):
    cfg, model, params = _built(arch)
    sched = ContinuousBatchingScheduler(
        model, cfg, params, slots=3, n_pages=32, page_size=4,
        max_seq_len=16, keep_logits=True)
    trace = _trace(cfg)
    rids = [sched.submit(p, n) for p, n in trace]
    finished = sched.run_until_drained()

    assert len(finished) == len(trace)
    for rid, (prompt, max_new) in zip(rids, trace):
        want, rows = _reference(model, params, prompt, max_new, sched.cap)
        assert list(finished[rid].tokens) == want, \
            f"{arch} rid={rid} prompt_len={len(prompt)}"
        # the decode step's projections run at M = slots here and at
        # M = 1 there, which BLAS may sum in another order
        torch.testing.assert_close(torch.stack(sched.logits[rid]),
                                   torch.stack(rows).float(),
                                   atol=LOGIT_TOL, rtol=0)
    sched.alloc.check()
    assert sched.alloc.live_pages == 0
    assert len(sched.decode_log) == sched.steps
    assert all(1 <= act <= 3 for _, act in sched.decode_log)


def test_slot_reuse_does_not_cross_contaminate():
    """The same prompt admitted early and late (through recycled pages
    and slots) must decode identically — stale page contents from a
    retired sequence can never leak into a new one."""
    cfg, model, params = _built()
    sched = ContinuousBatchingScheduler(
        model, cfg, params, slots=2, n_pages=12, page_size=4,
        max_seq_len=12)
    rng = np.random.default_rng(3)
    probe = rng.integers(0, cfg.vocab, 5).tolist()
    first = sched.submit(probe, 4)
    fillers = [sched.submit(rng.integers(0, cfg.vocab,
                                         int(rng.integers(3, 9))).tolist(),
                            int(rng.integers(2, 6))) for _ in range(3)]
    again = sched.submit(probe, 4)      # admitted after retires/recycling
    finished = sched.run_until_drained()
    assert finished[first].tokens == finished[again].tokens
    assert len(finished) == len(fillers) + 2


def test_trsm_site_tags_survive_paging():
    cfg, model, params = _built()
    sched = ContinuousBatchingScheduler(
        model, cfg, params, slots=2, n_pages=16, page_size=4,
        max_seq_len=12)
    sched.submit([1, 2, 3, 4, 5], 3)
    sched.run_until_drained()
    decode_sites = {e.site for e in sched.recorders["decode"].events}
    assert "attn.cache_update" in decode_sites
    trsm = [e for e in sched.recorders["decode"].events
            if e.site == "attn.cache_update"]
    assert len(trsm) == cfg.n_layers     # one decode step recorded
    assert all(e.routine == "trsm" for e in trsm)
    # cache-update events price the gathered span, not the pool size
    assert all(e.m == sched.cap for e in trsm)
    assert sched.recorders["prefill"].events, "prefill traffic unrecorded"


def test_mla_cache_update_tag():
    cfg, model, params = _built("deepseek-v2-236b")
    sched = ContinuousBatchingScheduler(
        model, cfg, params, slots=1, n_pages=8, page_size=4,
        max_seq_len=12)
    assert all(type(p).__name__ == "PagedLatent" for p in sched.pool)
    sched.submit([1, 2, 3], 2)
    sched.run_until_drained()
    sites = {e.site for e in sched.recorders["decode"].events}
    assert "mla.cache_update" in sites
    upd = [e for e in sched.recorders["decode"].events
           if e.site == "mla.cache_update"]
    assert len(upd) == cfg.n_layers     # one decode step recorded
    assert all(e.routine == "trsm" and e.m == sched.cap for e in upd)


def test_records_each_prompt_length_once_and_one_decode_step():
    """What the reference's traces record: one prefill per distinct
    prompt length, one decode step."""
    cfg, model, params = _built()
    sched = ContinuousBatchingScheduler(
        model, cfg, params, slots=2, n_pages=16, page_size=4,
        max_seq_len=12)
    for prompt in ([1, 2, 3], [4, 5, 6], [7, 8, 9, 10], [1, 2, 3]):
        sched.submit(prompt, 3)
    sched.run_until_drained()
    core = [e for e in sched.recorders["prefill"].events
            if e.site == "attn.core"]
    assert sorted(e.m for e in core) == [3] * cfg.n_layers \
        + [4] * cfg.n_layers
    assert sched.steps > 1
    upd = [e for e in sched.recorders["decode"].events
           if e.site == "attn.cache_update"]
    assert len(upd) == cfg.n_layers


def test_admission_defers_then_completes_under_tiny_pool():
    """A pool that fits one sequence at a time forces FIFO deferral;
    everything still finishes with zero drops."""
    cfg, model, params = _built()
    sched = ContinuousBatchingScheduler(
        model, cfg, params, slots=4, n_pages=3, page_size=4,
        max_seq_len=12)
    rng = np.random.default_rng(11)
    rids = [sched.submit(rng.integers(0, cfg.vocab, 6).tolist(), 4)
            for _ in range(4)]
    finished = sched.run_until_drained()
    assert sorted(finished) == sorted(rids)
    admits = [finished[r].admitted_step for r in rids]
    assert admits == sorted(admits) and len(set(admits)) == len(admits)
    sched.alloc.check()


def test_max_new_one_finishes_at_prefill():
    cfg, model, params = _built()
    sched = ContinuousBatchingScheduler(
        model, cfg, params, slots=1, n_pages=8, page_size=4,
        max_seq_len=12)
    rid = sched.submit([5, 6, 7], 1)
    finished = sched.run_until_drained()
    assert len(finished[rid].tokens) == 1
    assert sched.steps == 0             # never needed a decode step
    assert finished[rid].tokens[0] == _reference(
        model, params, [5, 6, 7], 1, sched.cap)[0][0]


def test_submit_validation():
    cfg, model, params = _built()
    sched = ContinuousBatchingScheduler(
        model, cfg, params, slots=1, n_pages=4, page_size=4,
        max_seq_len=8)
    with pytest.raises(ValueError, match="cap"):
        sched.submit(list(range(7)), 4)     # 10 slots > cap 8
    with pytest.raises(ValueError, match="empty"):
        sched.submit([], 2)
    with pytest.raises(ValueError, match="max_new"):
        sched.submit([1, 2], 0)
    with pytest.raises(ValueError, match="pool size"):
        ContinuousBatchingScheduler(
            model, cfg, params, slots=1, n_pages=1, page_size=4,
            max_seq_len=8).submit([1, 2, 3, 4, 5], 2)
    rid = sched.submit([1, 2], 2)
    with pytest.raises(ValueError, match="duplicate"):
        sched.submit([3, 4], 2, rid=rid)


def _refusal(fn):
    with pytest.raises(NotImplementedError) as e:
        fn()
    return str(e.value)


def test_unpageable_layers_refuse_like_the_reference():
    """Ring, recurrent and int8 caches have no paged form: refused at
    construction with the reference's messages, never corrupted at
    decode."""
    from repro.models import transformer as JT
    from repro.train.step import make_ctx as jax_make_ctx
    from repro_torch.models import transformer as T

    # sliding-window layers (mixtral): the whole scheduler refuses
    mcfg, mmodel, mparams = _built("mixtral-8x22b")
    msg = _refusal(lambda: ContinuousBatchingScheduler(
        mmodel, mcfg, mparams, slots=1, n_pages=4, page_size=4,
        max_seq_len=8))
    jcfg = jax_smoke_config("mixtral-8x22b")
    jctx = jax_make_ctx(None, "decode", cache_len=8)
    want = _refusal(lambda: JT._init_layer_paged(
        jcfg, JT.LayerSpec("attn", "moe", jcfg.d_ff), 4, 4, jctx,
        jnp.float32))
    assert msg == want and "sliding-window" in msg

    cfg = get_smoke_config("stablelm-1.6b")
    jcfg = jax_smoke_config("stablelm-1.6b")
    ctx = Ctx(mode="decode", cache_len=8)
    for kind in ("rglru", "mlstm"):
        got = _refusal(lambda: T._init_layer_paged(
            cfg, LayerSpec(kind, "none"), 4, 4, ctx, torch.float32, "cpu"))
        want = _refusal(lambda: JT._init_layer_paged(
            jcfg, JT.LayerSpec(kind, "none"), 4, 4, jctx, jnp.float32))
        assert got == want and "recurrent" in got
    q_ctx = dataclasses.replace(ctx, kv_quantized=True)
    jq_ctx = dataclasses.replace(jctx, kv_quantized=True)
    got = _refusal(lambda: T._init_layer_paged(
        cfg, LayerSpec("attn", "mlp"), 4, 4, q_ctx, torch.float32, "cpu"))
    want = _refusal(lambda: JT._init_layer_paged(
        jcfg, JT.LayerSpec("attn", "mlp"), 4, 4, jq_ctx, jnp.float32))
    assert got == want and "int8" in got
    # a model without a paged cache (encoder-decoder serving)
    _refusal(lambda: ContinuousBatchingScheduler(
        types.SimpleNamespace(), cfg, {}, slots=1, n_pages=4,
        page_size=4, max_seq_len=8))


# ---------------------------------------------------------------------------
# concurrent arrivals + live artifact swaps
# ---------------------------------------------------------------------------

_TILES_A = (0, 1, 2)
_TILES_B = (5, 6, 7)


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_sched_race")
    dirs = {}
    for name, tiles in (("a", _TILES_A), ("b", _TILES_B)):
        d = str(root / name)
        install(SimulatedBackend(seed=0),
                InstallConfig(n_samples=48, repeats=1,
                              routines=("gemm", "syrk", "trsm"),
                              models=("decision_tree",),
                              tile_ids=tiles, seed=3),
                artifact_dir=d)
        dirs[name] = d
    return dirs


def test_concurrent_arrivals_with_live_swaps(arts):
    cfg, model, params = _built()
    recs = {"prefill": DispatchRecorder(), "decode": DispatchRecorder()}
    mgr = ReinstallManager(arts["a"], recs,
                           backend=SimulatedBackend(seed=0))
    sched = ContinuousBatchingScheduler(
        model, cfg, params, slots=3, n_pages=24, page_size=4,
        max_seq_len=16, tuner=mgr, recorders=recs)

    rng = np.random.default_rng(5)
    probe = rng.integers(0, cfg.vocab, 5).tolist()
    expected: dict[int, tuple] = {}
    errors: list = []
    done_submitting = threading.Event()
    lock = threading.Lock()

    def submitter(tid: int) -> None:
        try:
            trng = np.random.default_rng(100 + tid)
            for i in range(5):
                if i == 2:              # every thread replays the probe
                    prompt, new = probe, 4
                else:
                    prompt = trng.integers(
                        0, cfg.vocab, int(trng.integers(3, 10))).tolist()
                    new = int(trng.integers(2, 6))
                rid = sched.submit(prompt, new)
                with lock:
                    expected[rid] = (tuple(prompt), new)
                time.sleep(0.002 * tid)
        except Exception as e:          # noqa: BLE001
            errors.append(e)

    def swapper() -> None:
        try:
            i = 0
            while not done_submitting.is_set() or sched.active \
                    or sched.pending:
                mgr.swap_now(arts["b"] if i % 2 == 0 else arts["a"])
                i += 1
                time.sleep(0.003)
        except Exception as e:          # noqa: BLE001
            errors.append(e)

    subs = [threading.Thread(target=submitter, args=(t,))
            for t in range(3)]
    swap = threading.Thread(target=swapper)
    for t in subs:
        t.start()
    swap.start()
    try:
        while any(t.is_alive() for t in subs) or sched.pending \
                or sched.active:
            sched.step()
    finally:
        done_submitting.set()
        for t in subs:
            t.join()
        swap.join()

    assert not errors, errors
    finished = sched.finished
    assert sorted(finished) == sorted(expected)
    for rid, (prompt, new) in expected.items():
        f = finished[rid]
        assert f.prompt == prompt
        assert len(f.tokens) == new, f"rid {rid} truncated"
    probe_tokens = {finished[r].tokens for r, (p, n) in expected.items()
                    if p == tuple(probe) and n == 4}
    assert len(probe_tokens) == 1, \
        f"identical requests decoded differently: {probe_tokens}"
    sched.alloc.check()
    assert sched.alloc.live_pages == 0
    assert mgr.swaps > 0, "no swap ever fired mid-stream"

    tuners = {name: AdsalaTuner.from_artifact(d)
              for name, d in arts.items()}
    events = [e for rec in recs.values() for e in rec.events
              if e.config is not None]
    assert events, "no tuned dispatches recorded"
    torn = [(e.site, e.routine, e.m, e.k, e.n, e.config) for e in events
            if e.config not in {t.select(e.m, e.k, e.n, e.routine)
                                for t in tuners.values()}]
    assert not torn, f"dispatches served by no single artifact: {torn[:3]}"


# ---------------------------------------------------------------------------
# cross-package: the reference's scheduler and the port's
# ---------------------------------------------------------------------------

def _key(e):
    return (e.routine, e.m, e.k, e.n, e.site, e.count)


def _run_reference_scheduler(jm, jcfg, jp, trace, **kw):
    """The reference's scheduler on ``trace``; returns it and each
    request's per-token logits, captured around its jitted steps."""
    recs = {"prefill": JDispatchRecorder(), "decode": JDispatchRecorder()}
    sched = JScheduler(jm, jcfg, jp, recorders=recs, **kw)
    rows: dict[int, list] = {}
    prefill_fn, decode = sched._prefill_fn, sched._decode
    admitting: list = []

    def prefill_fn_capture(n):
        fn = prefill_fn(n)

        def run(p, toks):
            logits, cache = fn(p, toks)
            admitting.append(np.asarray(logits[0]))
            return logits, cache
        return run

    start = sched._start

    def start_capture(slot, req, pages):
        start(slot, req, pages)
        rows[req.rid] = [admitting.pop()]

    def decode_capture(*a):
        logits, pool = decode(*a)
        out = np.asarray(logits)
        for i, r in enumerate(sched._req):
            if r is not None:
                rows[r.rid].append(out[i])
        return logits, pool

    sched._prefill_fn = prefill_fn_capture
    sched._start = start_capture
    sched._decode = decode_capture
    rids = [sched.submit(p, n) for p, n in trace]
    sched.run_until_drained()
    return sched, rids, rows


def test_trace_matches_the_reference_scheduler(monkeypatch):
    _trace_vs_reference("stablelm-1.6b", monkeypatch)


def test_mla_trace_matches_the_reference_scheduler(monkeypatch):
    _trace_vs_reference("deepseek-v2-236b", monkeypatch)


def _trace_vs_reference(arch, monkeypatch):
    jcfg = jax_smoke_config(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    trace = _trace(cfg, n=7, seed=19)
    kw = dict(slots=3, n_pages=20, page_size=4, max_seq_len=16)

    # the reference's pallas backend (interpret mode here): its events
    # are the flash dispatches the port records, where its xla backend
    # may take the SYRK-scores path
    with monkeypatch.context() as env:
        env.setenv("ADSALA_BACKEND", "pallas")
        jsched, jrids, jrows = _run_reference_scheduler(jm, jcfg, jp,
                                                        trace, **kw)
    sched = ContinuousBatchingScheduler(model, cfg, params,
                                        keep_logits=True, **kw)
    rids = [sched.submit(p, n) for p, n in trace]
    sched.run_until_drained()

    assert rids == jrids and sched.steps == jsched.steps
    for rid in rids:
        assert sched.finished[rid].tokens == jsched.finished[rid].tokens
        assert sched.finished[rid].admitted_step == \
            jsched.finished[rid].admitted_step
        got = torch.stack(sched.logits[rid]).numpy()
        np.testing.assert_allclose(got, np.stack(jrows[rid]),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert sched.goodput() == pytest.approx(jsched.goodput(), abs=0)

    # the recorded dispatches: per trace, the reference's unit events,
    # once per layer of the port's loop (deepseek's smoke layout scans
    # its (dense, moe) unit once beside a moe suffix: the same events)
    reps = jm.repeats
    if reps > 1:
        assert not jm.prefix and not jm.suffix and reps == cfg.n_layers
    n_lengths = len({len(p) for p, _ in trace})
    for cls, traces in (("prefill", n_lengths), ("decode", 1)):
        ref = [_key(e) for e in jsched.recorders[cls].events]
        unit = len(ref) // traces
        assert unit * traces == len(ref) and unit > 0
        want = [k for t in range(traces)
                for k in ref[t * unit:(t + 1) * unit] * reps]
        assert [_key(e) for e in sched.recorders[cls].events] == want
    # so the live profiles, and every drift read from them, agree
    mine = WorkloadProfile.merge([WorkloadProfile.from_recorder(r)
                                  for r in sched.recorders.values()])
    ref = JWorkloadProfile.merge([JWorkloadProfile.from_recorder(r)
                                  for r in jsched.recorders.values()])
    assert mine.routine_weights == pytest.approx(ref.routine_weights,
                                                 abs=1e-12)
    assert set(mine.cells) == set(ref.cells)
    for c, w in ref.cells.items():
        assert mine.cells[c] == pytest.approx(w, abs=1e-12)
    assert mine.by == ref.by
