"""The encoder-decoder (whisper-tiny) on its 'model' shards, on
multi-rank gloo worlds on the CPU.

On a mesh the encoder's attention, the decoder's self- and
cross-attention compute on the rank's whole heads (⌈H / tp⌉ a rank,
none past the last), the MLPs on their FF slice, the embedding, the
logits and the loss on the rank's vocab rows (a range of the whole
stored embedding where the axis does not divide V), as
``dense_mesh_layout`` lays them out; a mesh decode step projects on the
stored columns of the attention weights, reads its self-attention cache
split-KV and its cross K/V in place, cut on the frames or on the head
dim as ``cache_specs`` cut them.

Three worlds over ("data", "model"), each spawned once
(``init_method=file://``: no port) and running its cases in one go, one
after another while the reference runs in this process; the tests
below read what the ranks wrote.  The kernels' plain versions run (CPU
tensors).

* (1, 2) and (2, 2): the smoke whisper (4 heads, 2 a rank; V 256 cut
  evenly);
* (1, 4): the smoke whisper with 6 heads at D 48 and V 251: ranks 0-2
  compute 2 heads each, rank 3 none; vocab ranges of 63, 63, 63, 62.

Each world serves two encoder lengths, so that the cross K/V specs cut
their frames (16 frames) in one case and their head dim (15 frames on
a 2-way axis, 18 on the 4-way one, as whisper's 1500 frames on 16) in
the other, and trains on the first (a train step has no cache).

For each training case: the reference's ``model.loss`` and its
gradients by ``jax.value_and_grad`` on the reference's weights (carried
across by ``convert.params_from_jax``), against the sharded step's
first loss and gradients (1e-5, and 1e-4 normwise a leaf,
``NOISE_FRACTION`` the only noise rule); STEPS sharded steps against
the single-device port step (the first loss and each step's update on
its own gradients 1e-5, the later losses and the parameters after the
steps ``STEP_TOL``).  For each case: the built prefill against the
single-device one (1e-5); STEPS greedy steps of the built mesh decode
from the single-device prefill's caches laid out by ``shard_cache``,
against the reference's ``prefill`` and ``decode_step`` (logits within
``LOGIT_TOL`` = ``MESH_DECODE_TOL``, the same tokens), the caches kept
in their layout and no DTensor redistribution in a step; the weights,
heads and vocab rows each rank computes with.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.timeout(400)

ARCH = "whisper-tiny"
SEQ, BATCH, STEPS = 16, 4, 3
PROMPT, CACHE_LEN = 8, 48
LOSS_TOL, PARAM_TOL, GRAD_TOL, PREFILL_TOL = 1e-5, 1e-5, 1e-4, 1e-5
LOGIT_TOL = 1e-5
#: the losses after the first step and the parameters after STEPS steps
#: against the single device's (rtol; the parameters normwise), as
#: tests/test_torch_tp.py's REC_PARAM_TOL: AdamW's first steps are
#: lr x g / (|g| + eps), and a gradient element near 1e-7 changes sign
#: with a cut product's summation order (the gradients agree to 1.1e-6
#: a leaf).  Read on the 6-heads, 18-frames case: one element flipped
#: in each of six leaves, 2.4e-5 normwise after 3 steps, the third
#: step's loss 1.8e-5 apart; every other case within 1e-5
STEP_TOL = 1e-4
#: a leaf whose reference gradient norm is below this fraction of the
#: whole gradient's is rounding noise, held only inside the whole vector
#: (the rule of tests/test_torch_tp.py)
NOISE_FRACTION = 1e-6
#: six heads on four ranks (2, 2, 2, 0), V 251 (63, 63, 63, 62)
H6 = {"n_heads": 6, "n_kv_heads": 6, "d_model": 48, "vocab": 251}
CASES = {"e16": {"encoder_len": 16}, "e15": {"encoder_len": 15},
         "h6-e16": {**H6, "encoder_len": 16},
         "h6-e18": {**H6, "encoder_len": 18}}
WORLDS = {(1, 2): ["e16", "e15"], (1, 4): ["h6-e16", "h6-e18"],
          (2, 2): ["e16", "e15"]}
#: the cases that also train (the cross K/V's cut is the decode's
#: alone: one encoder length a world trains)
TRAINS = ("e16", "h6-e16")
#: the dim the cross K/V specs cut over 'model': the frames (dim 1),
#: where the axis divides them and they are the largest such dim, else
#: the head dim (dim 3)
CROSS_CUT = {"e16": 1, "e15": 3, "h6-e16": 1, "h6-e18": 3}
ITEMS = [(shape, cid) for shape, cids in WORLDS.items() for cid in cids]
TRAIN_ITEMS = [(shape, cid) for shape, cid in ITEMS if cid in TRAINS]


def _cfg(cid: str):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(ARCH), **CASES[cid])


def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return float(num / den if den > 0 else num)


def _decode_batch(cfg) -> dict:
    rng = np.random.default_rng(4)
    return {"tokens": rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
            "audio_emb": rng.standard_normal(
                (BATCH, cfg.encoder_len, cfg.d_model)).astype(np.float32)}


def _data(cfg):
    from repro_torch.data.pipeline import SyntheticLM
    return SyntheticLM(cfg.vocab, SEQ, BATCH, seed=3, audio_dim=cfg.d_model,
                       audio_len=cfg.encoder_len)


def _spec_dim(spec: tuple, axis: str = "model") -> int | None:
    """The dim a spec cuts over ``axis``, or None."""
    for d, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return d
    return None


# ---------------------------------------------------------------------------
# the ranks' work (runs in spawned processes: imports no jax)
# ---------------------------------------------------------------------------

def _spy(log: dict):
    """Patch the blocks to log what a rank computes with: the local
    shapes of the attention and MLP weights (train and prefill) and of
    the decode's attention weights, the heads of each attention core,
    the vocab rows of the lookup and the loss, the cross K/V a decode
    step reads; returns the undo."""
    from repro_torch.dist import collectives as C
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L

    names = ("attention_train", "apply_mlp", "attention_decode")
    orig = {n: getattr(L, n) for n in names}
    orig_ed = {n: getattr(ED, n) for n in ("_cross_attention", "_cross_core",
                                            "_cross_decode")}
    orig_c = {n: getattr(C, n) for n in ("vocab_embed", "vocab_gold")}
    orig_flash = L.ops.flash_attention

    def add(key, value):
        log.setdefault(key, set()).add(value)

    def weights(prefix, names_):
        def wrap(fn):
            def call(p, *a, **k):
                for n in names_:
                    add(f"{prefix}.{n}", tuple(p[n].shape))
                return fn(p, *a, **k)
            return call
        return wrap

    L.attention_train = weights("attn", ("wq", "wk", "wv", "wo"))(
        orig["attention_train"])
    L.apply_mlp = weights("mlp", ("wi", "wo"))(orig["apply_mlp"])
    L.attention_decode = weights("decode.attn", ("wq", "wk", "wv", "wo"))(
        orig["attention_decode"])
    ED._cross_attention = weights("cross", ("wq", "wo"))(
        orig_ed["_cross_attention"])

    def cross_decode(p, x, cross, *a, **k):
        for n in ("wq", "wo"):
            add(f"decode.cross.{n}", tuple(p[n].shape))
        if isinstance(cross, ED.CrossKV):
            add("decode.cross.kv", (cross.dim, *cross.k.shape))
        else:
            add("decode.cross.kv", (None, *cross[0].shape))
        return orig_ed["_cross_decode"](p, x, cross, *a, **k)

    def cross_core(q, *a, **k):
        add("cross.heads", q.shape[2])
        return orig_ed["_cross_core"](q, *a, **k)

    def flash(q, *a, **k):
        # the flat (B x the rank's heads) of the core, by attention kind
        add("core.causal" if k.get("causal") else "core.full", q.shape[0])
        return orig_flash(q, *a, **k)

    def vocab_embed(w, ids, tp, lo=None):
        add("vocab.embed", (tuple(w.shape), lo))
        return orig_c["vocab_embed"](w, ids, tp, lo)

    def vocab_gold(logits, labels, tp, lo=None):
        add("vocab.loss", (logits.shape[-1], lo))
        return orig_c["vocab_gold"](logits, labels, tp, lo)

    ED._cross_decode, ED._cross_core = cross_decode, cross_core
    C.vocab_embed, C.vocab_gold = vocab_embed, vocab_gold
    L.ops.flash_attention = flash

    def undo():
        for n, f in orig.items():
            setattr(L, n, f)
        for n, f in orig_ed.items():
            setattr(ED, n, f)
        for n, f in orig_c.items():
            setattr(C, n, f)
        L.ops.flash_attention = orig_flash
    return undo


def _local_shapes(cache) -> list:
    """The local shape of every DTensor of a decode cache, in order."""
    from repro_torch.serve.step import _map_arrays

    out = []
    _map_arrays(lambda t: out.append(list(t.to_local().shape)), cache)
    return out


def _leaves(cache) -> list:
    from repro_torch.serve.step import _map_arrays

    out = []
    _map_arrays(out.append, cache)
    return out


def _train(mesh, tmp, cid, params, cfg, model) -> dict:
    """The sharded step's first gradients (saved whole), STEPS steps
    against the single-device step, the first one watched."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.dist.collectives import distribute
    from repro_torch.dist.sharding import to_placements
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.train.optim import AdamWConfig, adamw_update, \
        init_state
    from repro_torch.train.step import build_train_step

    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=20)
    state1 = init_state(tree_map(lambda t: t.clone(), params), opt)
    shape = ShapeSpec("t", SEQ, BATCH, "train")
    step, s_specs, b_specs = build_train_step(model, cfg, opt, shape=shape,
                                              mesh=mesh)
    one, _, _ = build_train_step(model, cfg, opt)
    spec_leaves = {k: tree_leaves(v, is_leaf=is_spec)
                   for k, v in s_specs.items()}
    sharded = {}
    for k, v in state1.items():
        it = iter(spec_leaves[k]) if k != "step" else iter([()])
        sharded[k] = tree_map(lambda t: distribute(t.clone(), mesh,
                                                   next(it)), v)
    data = _data(cfg)
    _, grads = step.value_and_grad(
        sharded, make_global_batch(data.batch_at(0), mesh, b_specs))
    whole = [DTensor.from_local(g, mesh, to_placements(sp, mesh),
                                run_check=False).full_tensor()
             for g, sp in zip(tree_leaves(grads), spec_leaves["params"])]
    log: dict = {}
    losses, losses1 = [], []
    own_diff = own_norm = 0.0
    for i in range(STEPS):
        batch = data.batch_at(i)
        gb = make_global_batch(batch, mesh, b_specs)
        _, g_own = step.value_and_grad(sharded, gb)
        it = iter([DTensor.from_local(g, mesh, t.placements,
                                      run_check=False).full_tensor()
                   for g, t in zip(tree_leaves(g_own),
                                   tree_leaves(sharded["params"]))])
        g_whole = tree_map(lambda _: next(it), sharded["params"])
        own, _ = adamw_update(tree_map(lambda t: t.full_tensor().clone(),
                                       sharded), g_whole, opt)
        if i == 0:
            undo = _spy(log)
            try:
                with CommDebugMode() as comm:
                    sharded, m = step(sharded, gb)
            finally:
                undo()
            counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        else:
            sharded, m = step(sharded, gb)
        for a, b in zip(tree_leaves(sharded["params"]),
                        tree_leaves(own["params"])):
            own_diff += float((a.full_tensor() - b).double().square().sum())
            own_norm += float(b.double().square().sum())
        losses.append(float(m["loss"]))
        state1, m1 = one(state1, make_global_batch(batch, None,
                                                   device="cpu"))
        losses1.append(float(m1["loss"]))
    diff = sum(float((a.full_tensor() - b).double().square().sum())
               for a, b in zip(tree_leaves(sharded["params"]),
                               tree_leaves(state1["params"])))
    norm = sum(float(b.double().square().sum())
               for b in tree_leaves(state1["params"]))
    np.savez(f"{tmp}/grads_{cid}_{mesh.get_rank()}.npz",
             *[g.numpy() for g in whole])
    return {
        "losses": losses, "losses1": losses1,
        "params_err": (diff / norm) ** 0.5,
        "own_update_err": (own_diff / own_norm) ** 0.5,
        "train_log": {k: sorted(v) for k, v in log.items()},
        "train_redistributions": sum(v for k, v in counts.items()
                                     if "functional" in k),
    }


def _serve(mesh, tmp, cid, params, cfg, model) -> dict:
    """The built prefill against the single-device one; STEPS greedy
    steps of the built mesh decode from the single-device prefill's
    caches, the first one watched."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.dist.collectives import distribute, row_index
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.serve.step import _map_arrays, build_decode, \
        build_prefill, shard_cache
    from repro_torch.train.step import make_ctx

    batch = _decode_batch(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pctx = make_ctx("prefill", cache_len=CACHE_LEN)
    # -- the built prefill against the single-device one ------------------
    prefill, p_specs, pb_specs = build_prefill(
        model, cfg, ShapeSpec("p", CACHE_LEN, BATCH, "prefill"), mesh)
    it = iter(tree_leaves(p_specs, is_leaf=is_spec))
    on_mesh = tree_map(lambda t: distribute(t, mesh, next(it)), params)
    log: dict = {}
    with torch.no_grad():
        undo = _spy(log)
        try:
            logits_m, cache_m = prefill(on_mesh, make_global_batch(
                batch, mesh, pb_specs))
        finally:
            undo()
        logits, whole = model.prefill(params, tb, pctx)
    i = row_index(mesh, ("data",))
    b_loc = BATCH // mesh.size(0)
    rows = slice(i * b_loc, (i + 1) * b_loc)
    got, want = _leaves(cache_m), _leaves(whole)
    out = {"prefill_log": {k: sorted(v) for k, v in log.items()},
           "prefill_logits_shape": list(logits_m.shape),
           # the largest |diff| - rtol |single| (assert_allclose's rule)
           "prefill_logits_over": float(
               ((logits_m - logits[rows]).abs()
                - PREFILL_TOL * logits[rows].abs()).max()),
           "prefill_cache_leaves": [len(got), len(want)],
           "prefill_cache_err": max(float((a - b[rows]).abs().max())
                                    for a, b in zip(got, want))}
    # -- the mesh decode from the prefill's caches ------------------------
    decode, d_specs, (_, c_specs, _) = build_decode(
        model, cfg, ShapeSpec("d", CACHE_LEN, BATCH, "decode"), mesh)
    it = iter(tree_leaves(d_specs, is_leaf=is_spec))
    sharded = tree_map(lambda t: distribute(t, mesh, next(it)), params)
    with torch.no_grad():
        cache = shard_cache(_map_arrays(lambda t: t[rows].clone(), whole),
                            mesh, c_specs)
        before = _local_shapes(cache)
        tok = logits[rows].argmax(-1, keepdim=True)
        first = tok[:, 0].tolist()
        steps, tokens, log = [], [], {}
        for s in range(STEPS):
            if s == 0:
                undo = _spy(log)
                try:
                    with CommDebugMode() as comm:
                        step_logits, cache = decode(sharded, tok, cache,
                                                    PROMPT)
                finally:
                    undo()
                counts = {str(k): v
                          for k, v in comm.get_comm_counts().items()}
            else:
                step_logits, cache = decode(sharded, tok, cache, PROMPT + s)
            steps.append(step_logits.numpy())
            tok = step_logits.argmax(-1, keepdim=True)
            tokens.append(tok[:, 0].tolist())
    np.save(f"{tmp}/logits_{cid}_{mesh.get_rank()}.npy", np.stack(steps))
    out.update({
        "rows": [rows.start, rows.stop], "first": first, "tokens": tokens,
        "cross_spec_dims": sorted({_spec_dim(c[k]) for c in c_specs
                                   for k in ("cross_k", "cross_v")},
                                  key=str),
        "self_spec_dims": sorted({_spec_dim(getattr(c["self"], f))
                                  for c in c_specs for f in ("k", "v")},
                                 key=str),
        "slots_before": before, "slots_after": _local_shapes(cache),
        "all_dtensors": all(isinstance(t, DTensor) for t in _leaves(cache)),
        "decode_log": {k: sorted(v, key=str) for k, v in log.items()},
        "decode_redistributions": sum(v for k, v in counts.items()
                                      if "functional" in k)})
    return out


def _case(mesh, tmp: str, cid: str) -> dict:
    from repro_torch.configs import build_model

    cfg = _cfg(cid)
    model = build_model(cfg)
    params = torch.load(f"{tmp}/../ref_{cid}.pt")
    out = _serve(mesh, tmp, cid, params, cfg, model)
    if cid in TRAINS:
        out.update(_train(mesh, tmp, cid, params, cfg, model))
    return out


def _world(rank, world, shape, tmp):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        res = {"coord": list(mesh.get_coordinate())}
        for cid in WORLDS[shape]:
            res[cid] = _case(mesh, tmp, cid)
        with open(f"{tmp}/res_{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _start(shape, tmp):
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    return mp.start_processes(_world, args=(world, shape, tmp),
                              nprocs=world, join=False,
                              start_method="spawn")


def _join(shape, ctx, deadline: float) -> None:
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {shape} world did not finish")


def _run_worlds(root, errors: list) -> None:
    """Each world in turn (at most 4 ranks at once beside the reference,
    which runs meanwhile)."""
    try:
        for shape in WORLDS:
            tmp = root / f"w{shape[0]}x{shape[1]}"
            tmp.mkdir()
            _join(shape, _start(shape, str(tmp)), time.monotonic() + 300)
    except BaseException as e:  # noqa: BLE001 - re-raised by the fixture
        errors.append(e)


# ---------------------------------------------------------------------------
# the reference (this process), then the worlds
# ---------------------------------------------------------------------------

def _reference_model(cid):
    import jax

    from repro.configs import build_model as jax_build_model
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.train import optim as jopt
    from repro.train.step import init_train_state as jax_init_train_state

    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **CASES[cid])
    jm = jax_build_model(jcfg)
    jstate = jax_init_train_state(jm, jcfg, jopt.AdamWConfig(),
                                  jax.random.PRNGKey(0))
    return jcfg, jm, jstate["params"]


def _reference_grads(jcfg, jm, jp) -> tuple:
    """The reference's loss and gradients on step 0's batch."""
    import jax
    import jax.numpy as jnp

    from repro.train.step import make_ctx as jax_make_ctx

    batch = _data(jcfg).batch_at(0)
    return jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch),
                          jax_make_ctx(None, "train")))(jp)


def _reference_decode(jcfg, jm, jp) -> dict:
    """The reference's prefill's greedy tokens and its decode steps'
    logits and greedy tokens on the whole batch."""
    import jax.numpy as jnp

    from repro.train.step import make_ctx as jax_make_ctx

    db = _decode_batch(jcfg)
    logits, cache = jm.prefill(
        jp, {"tokens": jnp.asarray(db["tokens"], jnp.int32),
             "audio_emb": jnp.asarray(db["audio_emb"])},
        jax_make_ctx(None, "prefill", cache_len=CACHE_LEN, remat=False))
    dctx = jax_make_ctx(None, "decode", cache_len=CACHE_LEN)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    first = np.asarray(tok[:, 0])
    steps, tokens = [], []
    for s in range(STEPS):
        logits, cache = jm.decode_step(jp, tok, cache,
                                       jnp.int32(PROMPT + s), dctx)
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok[:, 0]))
    return {"first": first, "logits": np.stack(steps),
            "tokens": np.stack(tokens)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's weights saved for the ranks, the worlds run one
    after another in a thread while the reference's loss, gradients and
    decode run here, then the ranks' results read back."""
    import threading

    import jax

    from repro_torch.convert import params_from_jax
    from repro_torch.models.params import tree_leaves

    root = tmp_path_factory.mktemp("tp_encdec")
    models = {}
    for cid in CASES:
        models[cid] = _reference_model(cid)
        torch.save(params_from_jax(jax.tree.map(np.asarray, models[cid][2])),
                   root / f"ref_{cid}.pt")
    errors: list = []
    runner = threading.Thread(target=_run_worlds, args=(root, errors),
                              daemon=True)
    runner.start()
    out = {"ref": {}}
    for cid in CASES:
        out["ref"][cid] = _reference_decode(*models[cid])
        if cid in TRAINS:
            loss, grads = _reference_grads(*models[cid])
            out["ref"][cid].update(
                loss=float(loss), grads=[np.asarray(g) for g in tree_leaves(
                    params_from_jax(jax.tree.map(np.asarray, grads)))])
    runner.join(timeout=len(WORLDS) * 300)
    assert not runner.is_alive(), "the worlds did not finish"
    if errors:
        raise errors[0]
    for shape, cids in WORLDS.items():
        tmp = root / f"w{shape[0]}x{shape[1]}"
        res = []
        for r in range(shape[0] * shape[1]):
            with open(tmp / f"res_{r}.json") as f:
                got = json.load(f)
            for cid in cids:
                got[cid]["logits"] = np.load(tmp / f"logits_{cid}_{r}.npy")
                if cid not in TRAINS:
                    continue
                with np.load(tmp / f"grads_{cid}_{r}.npz") as z:
                    got[cid]["grads"] = [z[f"arr_{i}"]
                                         for i in range(len(z.files))]
            res.append(got)
        out[shape] = res
    return out


def _ids(item):
    shape, cid = item
    return f"{shape[0]}x{shape[1]}-{cid}"


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("item", TRAIN_ITEMS, ids=_ids)
def test_encdec_first_step_matches_reference_gradients(worlds, item):
    """The sharded step's loss (averaged over the data axes) and
    gradients (partial sums reduced into the stored layout, averaged
    over the data axes, gathered whole) against ``jax.value_and_grad``
    of the reference's loss on the whole batch: every leaf within
    GRAD_TOL normwise, a leaf under NOISE_FRACTION of the whole gradient
    only inside the whole vector."""
    shape, cid = item
    ref = worlds["ref"][cid]
    norms = [np.linalg.norm(np.asarray(g, np.float64)) for g in ref["grads"]]
    full = np.sqrt(sum(n * n for n in norms))
    noise = {i for i, n in enumerate(norms) if n < NOISE_FRACTION * full}
    for r in worlds[shape]:
        c = r[cid]
        np.testing.assert_allclose(c["losses"][0], ref["loss"],
                                   rtol=LOSS_TOL)
        assert len(c["grads"]) == len(ref["grads"])
        errs = [_normwise(a, b) for a, b in zip(c["grads"], ref["grads"])]
        assert max(e for i, e in enumerate(errs) if i not in noise) \
            < GRAD_TOL, errs
        assert _normwise(
            np.concatenate([a.ravel() for a in c["grads"]]),
            np.concatenate([b.ravel() for b in ref["grads"]])) < GRAD_TOL


@pytest.mark.parametrize("item", TRAIN_ITEMS, ids=_ids)
def test_encdec_train_steps_match_single_device(worlds, item):
    """STEPS sharded steps: the first loss against the single-device
    step's (the same weights), each step's update against the whole
    state's on its own gradients, the later losses and the parameters
    after the steps against the single device's within STEP_TOL (AdamW's
    sign of a near-zero gradient element, see there); every rank holds
    the same losses."""
    shape, cid = item
    first = worlds[shape][0][cid]["losses"]
    for r in worlds[shape]:
        c = r[cid]
        np.testing.assert_allclose(c["losses"][0], c["losses1"][0],
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        np.testing.assert_allclose(c["losses"], c["losses1"], rtol=STEP_TOL)
        assert c["own_update_err"] < PARAM_TOL
        assert c["params_err"] < STEP_TOL
        assert c["losses"] == first


@pytest.mark.parametrize("item", ITEMS, ids=_ids)
def test_encdec_prefill_matches_single_device(worlds, item):
    """The built prefill's logits (the rank's rows, every column of the
    vocab; atol = rtol = PREFILL_TOL: whisper's logits reach ~50) and
    its caches (the self-attention K/V and the cross K/V of every layer,
    whole) against the single-device prefill."""
    shape, cid = item
    cfg = _cfg(cid)
    for r in worlds[shape]:
        c = r[cid]
        assert c["prefill_logits_shape"] == [BATCH // shape[0], cfg.vocab]
        assert c["prefill_logits_over"] <= PREFILL_TOL
        assert c["prefill_cache_leaves"] == [4 * cfg.n_layers] * 2
        assert c["prefill_cache_err"] < PREFILL_TOL


@pytest.mark.parametrize("item", ITEMS, ids=_ids)
def test_encdec_mesh_decode_matches_reference(worlds, item):
    """STEPS greedy steps of the built mesh decode against the
    reference's ``decode_step`` on the whole batch: every step's logits
    within LOGIT_TOL (fp32), the prefill's and every step's greedy
    tokens equal."""
    shape, cid = item
    ref = worlds["ref"][cid]
    for r in worlds[shape]:
        got = r[cid]
        rows = slice(*got["rows"])
        assert got["first"] == ref["first"][rows].tolist()
        for s in range(STEPS):
            np.testing.assert_allclose(got["logits"][s],
                                       ref["logits"][s][rows],
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
            assert got["tokens"][s] == ref["tokens"][s][rows].tolist()


@pytest.mark.parametrize("item", ITEMS, ids=_ids)
def test_encdec_mesh_decode_reads_its_caches_in_place(worlds, item):
    """The cache specs cut the self-attention cache on its sequence and
    the cross K/V on the case's dim (frames or head dim); a decode step
    reads the cross K/V in place as a CrossKV cut on that dim (its local
    piece), returns every cache as DTensors of the same local shapes,
    and moves no DTensor (no weight, no cache row) in a step."""
    shape, cid = item
    cfg = _cfg(cid)
    tp = shape[1]
    dim = CROSS_CUT[cid]
    hd = cfg.d_model // cfg.n_heads
    local = [BATCH // shape[0], cfg.encoder_len, cfg.n_heads, hd]
    local[dim] //= tp
    for r in worlds[shape]:
        c = r[cid]
        assert c["cross_spec_dims"] == [dim]
        assert c["self_spec_dims"] == [1]
        assert c["decode_log"]["decode.cross.kv"] == [[dim, *local]]
        assert c["all_dtensors"]
        assert c["slots_after"] == c["slots_before"]
        assert [BATCH // shape[0], CACHE_LEN // tp, cfg.n_kv_heads, hd] \
            in c["slots_before"]
        assert c["decode_redistributions"] == 0


@pytest.mark.parametrize("item", ITEMS, ids=_ids)
def test_encdec_rank_computes_on_its_shards(worlds, item):
    """Train and prefill: each attention (the encoder's, the decoder's
    self- and cross-attention) is given the weights of the layout (the
    stored column and row cut where the axis divides the heads, else the
    whole weights, of which it takes its heads) and computes on the
    rank's ⌈H / tp⌉ heads, none on a rank past the last head (no flash
    core and no cross scores there but an empty one); the MLP its FF
    slice; the lookup and the loss the rank's vocab rows (V / tp of the
    stored cut, or its range of the whole embedding: 63, 63, 63, 62 of
    251).  A decode step: every attention on the stored columns and
    rows (H x Dh / tp), the MLP on its slice."""
    shape, cid = item
    cfg = _cfg(cid)
    tp, d, h, v = shape[1], cfg.d_model, cfg.n_heads, cfg.vocab
    hd, ff, b = d // h, cfg.d_ff, BATCH // shape[0]
    per = -(-h // tp)
    even = h % tp == 0
    cut = h * hd // tp
    att = {f"attn.{n}": (d, cut if even else h * hd)
           for n in ("wq", "wk", "wv")}
    att["attn.wo"] = (cut if even else h * hd, d)
    vper = -(-v // tp)
    for r in worlds[shape]:
        rank = r["coord"][1]
        heads = min(h, per * (rank + 1)) - per * rank
        lo = rank * vper
        rows = min(v, lo + vper) - lo
        want = {**att, "cross.wq": (d, att["attn.wq"][1]),
                "cross.wo": att["attn.wo"],
                "mlp.wi": (d, ff // tp), "mlp.wo": (ff // tp, d),
                "cross.heads": heads,
                "vocab.embed": ((rows, d), None if v % tp == 0 else lo)}
        c = r[cid]
        for log in [c["prefill_log"]] + [c.get("train_log")] * (cid in TRAINS):
            for k, s in want.items():
                got = [tuple(x) if isinstance(x, list) else x
                       for x in log[k]]
                if k == "vocab.embed":
                    got = [(tuple(x[0]), x[1]) for x in log[k]]
                assert got == [s], (k, log[k])
            if heads:
                assert log["core.full"] == [b * heads]
                assert log["core.causal"] == [b * heads]
            else:
                assert "core.full" not in log and "core.causal" not in log
        if cid in TRAINS:
            assert [tuple(x) for x in c["train_log"]["vocab.loss"]] == [
                (rows, None if v % tp == 0 else lo)]
        dec = {k: [(tuple(x[0]), x[1]) if k == "vocab.embed" else tuple(x)
                   for x in s] for k, s in c["decode_log"].items()
               if k != "decode.cross.kv"}
        assert dec == {
            "decode.attn.wq": [(d, cut)], "decode.attn.wk": [(d, cut)],
            "decode.attn.wv": [(d, cut)], "decode.attn.wo": [(cut, d)],
            "decode.cross.wq": [(d, cut)], "decode.cross.wo": [(cut, d)],
            "mlp.wi": [(d, ff // tp)], "mlp.wo": [(ff // tp, d)],
            "vocab.embed": [((rows, d), None if v % tp == 0 else lo)]}
        # where the axis divides the heads and V a train step moves the
        # batch's frame embeddings only (their spec cuts them over 'model'
        # too: taken with their rows whole); the uneven heads' weights
        # are gathered whole besides
        if cid in TRAINS:
            assert (c["train_redistributions"] == 1) == (even
                                                         and v % tp == 0)


def test_production_layout_of_whisper():
    """whisper-tiny on the (16, 16) production mesh's 'model' axis: its
    6 heads (one on ranks 0-5) from the whole ``wq``, ``wk``, ``wv`` and
    ``wo`` of all three attentions in train and prefill (partial
    gradients), their stored 24 columns and rows in a decode step, the
    MLPs on their 96 of 1536, the embedding whole with each rank's range
    of 3242 rows (3235 on the last; a partial gradient); every weight of
    the encoder-decoder keyed; a decode step gathers no weight."""
    import os
    import sys

    from repro_torch.configs import build_model, get_config
    from repro_torch.dist.collectives import vocab_range
    from repro_torch.dist.sharding import MeshShape, partition_params
    from repro_torch.models.params import is_spec, tree_leaves, tree_paths
    from repro_torch.models.transformer import dense_mesh_layout, \
        dense_weight_key

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from decode_weight_moves import moves

    cfg = get_config(ARCH)
    mesh = MeshShape({"data": 16, "model": 16})
    m = "model"
    cols, rows = ((None, m), False), ((m, None), False)
    lay = dense_mesh_layout(cfg, mesh)
    dec = dense_mesh_layout(cfg, mesh, decode=True)
    attn = {f"attn.{n}": ((), True) for n in (
        "wq", "wo", "wk", "wv", "q_norm", "k_norm")}
    assert lay == {**attn, "embed": ((), True), "mlp.wi": cols,
                   "mlp.wg": cols, "mlp.wo": rows}
    assert dec == {"attn.wq": cols, "attn.wk": cols, "attn.wv": cols,
                   "attn.wo": rows, "embed": ((), True), "mlp.wi": cols,
                   "mlp.wg": cols, "mlp.wo": rows}
    assert [vocab_range(cfg.vocab, 16, r) for r in (0, 14, 15)] == [
        (0, 3242), (45388, 48630), (48630, 51865)]
    model = build_model(cfg)
    stored = dict(zip(tree_paths(model.defs), tree_leaves(
        partition_params(model, cfg, mesh), is_leaf=is_spec)))
    keys = {path: dense_weight_key(model, path) for path in stored}
    for block in ("attn", "self_attn", "cross_attn"):
        side = "encoder" if block == "attn" else "decoder"
        for n in ("wq", "wk", "wv", "wo"):
            assert keys[side, 0, block, n] == f"attn.{n}"
            assert stored[side, 0, block, n] == dec[f"attn.{n}"][0]
    assert keys["decoder", 3, "mlp", "wi"] == "mlp.wi"
    assert stored["decoder", 3, "mlp", "wi"] == cols[0]
    assert keys["embed",] == "embed" and stored["embed",] == (None, None)
    assert keys["pos_dec",] is None and keys["encoder", 0, "ln1",
                                             "scale"] is None
    assert moves(ARCH, mesh) == {}
