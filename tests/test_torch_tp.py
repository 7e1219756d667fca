"""Tensor-parallel dense compute on multi-rank gloo worlds on the CPU.

Two worlds, meshes (1, 2) and (1, 4) over ("data", "model"), each
spawned once (``init_method=file://``: no port) and running every case
in one go; the tests below read what the ranks wrote.  The kernels'
plain versions run (CPU tensors).

* (1, 2): stablelm-1.6b's smoke config (4 heads, 4 KV heads: both
  cut), granite-8b's (2 KV heads: one a rank), chameleon-34b's (qk
  norms applied to each rank's heads: their gradient is a partial sum),
  recurrentgemma-2b's (the RG-LRU on its W / 2 channels, its gates'
  partial products reduce-scattered, beside local attention on 2 heads
  a rank) and xlstm-125m's (the mLSTM's and sLSTM's projections on
  their widths, the sLSTM's input product on its columns of ``w_in``
  and gathered, the mLSTM's chunked core on its key dims with its
  (num, den) summed; only the sLSTM recurrence, h @ w_rec, whole);
* (1, 4): granite-8b's (2 KV heads on 4 ranks: each rank picks the KV
  head its query head reads, and that gradient is a partial sum),
  starcoder2-3b's cut to 6 heads (6 % 4: ranks 0-2 compute 2 whole
  heads each, rank 3 none; each takes its heads' columns and rows of
  the whole weights, whose gradients are partial sums),
  mixtral-8x22b's with 6 experts (picked KV heads beside the MoE's
  expert-TP path; with 4 experts the MoE would take its expert-parallel
  path, whose per-shard capacity drops other tokens than one device
  does, as the reference's) and deepseek-v2-236b's with 6 experts (MLA
  on one whole head a rank, its latents whole; the routed experts on
  the expert-TP path for the same reason, the shared experts whole),
  recurrentgemma-2b's cut to 2 heads (2 % 4: one head on ranks 0 and
  1, none on ranks 2 and 3, beside the cut RG-LRU, as its 10 heads on
  the production mesh's 16) and xlstm-125m's.

For each case: the reference's ``model.loss`` and its gradients by
``jax.value_and_grad`` on the reference's weights, carried across by
``convert.params_from_jax`` in this process; on the ranks, the sharded
step's first loss and gradients against them (1e-5 and 1e-4
normwise; the mLSTM's input-gate bias, whose gradient is rounding noise,
only inside the whole gradient, by ``NOISE_FRACTION``), 3 sharded steps
against the single-device port step (losses within 1e-5) and each
step's update against the single-device ``adamw_update`` of the whole
state on the sharded step's own gradients (the parameter vector within
1e-5) and the parameter vector of the single-device steps (1e-5; for
recurrentgemma and xlstm 1e-4, ``REC_PARAM_TOL``, in a test of their
own: AdamW's first steps are lr x g / (|g| + eps), and those two archs
have gradient elements near 1e-9 whose sign the summation order of a
cut product flips, 3.7e-6 to 4.6e-5 normwise after 3 steps, as
tests/test_torch_train_families.py found for their single-device
steps), the weights a rank computes with
(their local shapes; the heads a rank's attention core is given), the
all-gathers of a step counted by ``CommDebugMode`` (DTensor's: only the
weights computed whole and stored cut, and the gradients of those
computed cut and stored whole, the RG-LRU gates' biases; the model's
own: the xLSTM blocks' up-projections and the sLSTM's input product,
and the backward of the RG-LRU gates' reduce-scatter), and the built
prefill's logits and caches against the single-device prefill (1e-5).
Each world also holds ``collectives.reduce_scatter`` on its 'model'
group: the forward each rank's block of the sum, the backward every
rank's gradient joined.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.timeout(400)

SEQ, BATCH, STEPS = 16, 4, 3
LOSS_TOL, PARAM_TOL, GRAD_TOL, PREFILL_TOL = 1e-5, 1e-5, 1e-4, 1e-5
#: a leaf whose reference gradient norm is below this fraction of the
#: whole gradient's is rounding noise (the mLSTM's input-gate bias:
#: tests/test_torch_train_families.py), compared only inside the whole
#: gradient vector
NOISE_FRACTION = 1e-6
#: the archs whose parameters after STEPS steps are held against the
#: single device's at REC_PARAM_TOL, in a test of their own (see the
#: module's docstring): read at 3.7e-6 to 4.6e-5 normwise; a sharded
#: step that drops the RG-LRU gates' or the mLSTM output's ``copy_to``
#: before the rank's slice reads 1.8e-2 to 6.6e-2 (and passes the
#: own-update check at 3e-8 to 7e-7)
REC_PARAM_ARCHS = ("recurrentgemma-2b", "xlstm-125m")
REC_PARAM_TOL = 1e-4
WORLDS = {
    (1, 2): [("stablelm-1.6b", {}), ("granite-8b", {}),
             ("chameleon-34b", {}), ("recurrentgemma-2b", {}),
             ("xlstm-125m", {})],
    (1, 4): [("granite-8b", {}), ("starcoder2-3b", {"n_heads": 6}),
             ("mixtral-8x22b", {"n_experts": 6}),
             ("deepseek-v2-236b", {"n_experts": 6}),
             ("recurrentgemma-2b", {"n_heads": 2}), ("xlstm-125m", {})],
}
CASES = [(shape, arch, over) for shape, cases in WORLDS.items()
         for arch, over in cases]


def _case_id(arch: str, over: dict) -> str:
    return arch + "".join(f"-{k}{v}" for k, v in sorted(over.items()))


#: the MLA weights whose local shapes a rank logs: the four on 'heads'
#: and two latent projections
MLA_LOGGED = ("wq_b", "wk_b", "wv_b", "wo", "wq_a", "wkv_a")
#: the recurrent mixers' weights a rank logs, by the mixer's kind
RECURRENT_LOGGED = {
    "rglru": ("wx", "wy", "conv_w", "lam", "w_input_gate", "w_rec_gate",
              "wo"),
    "mlstm": ("w_up", "wq", "w_igate", "w_down", "norm"),
    "slstm": ("w_in", "w_rec", "b", "w_up", "w_down")}


def _normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    num = np.linalg.norm(got - want)
    return float(num / den if den > 0 else num)


# ---------------------------------------------------------------------------
# the ranks' work (runs in spawned processes: imports no jax)
# ---------------------------------------------------------------------------

def _spy(log: dict):
    """Patch the dense blocks to log the shapes of the weights they are
    given; returns the undo."""
    from repro_torch.dist import collectives as C
    from repro_torch.models import layers as L
    from repro_torch.models import mla as MLA
    from repro_torch.models import recurrent as REC
    from repro_torch.models import xlstm as XL

    orig = (L.attention_train, L.apply_mlp, C.vocab_embed, MLA.mla_train,
            L.ops.flash_attention)
    mixers = {"rglru": (REC, "rglru_block_train"),
              "mlstm": (XL, "mlstm_train"), "slstm": (XL, "slstm_train")}
    orig_mixers = {k: getattr(m, n) for k, (m, n) in mixers.items()}

    def logged(kind):
        def call(p, *a, **k):
            for n in RECURRENT_LOGGED[kind]:
                log.setdefault(f"{kind}.{n}", set()).add(tuple(p[n].shape))
            return orig_mixers[kind](p, *a, **k)
        return call

    for kind, (module, name) in mixers.items():
        setattr(module, name, logged(kind))

    def attention_train(p, *a, **k):
        for n in ("wq", "wk", "wv", "wo"):
            log.setdefault(f"attn.{n}", set()).add(tuple(p[n].shape))
        return orig[0](p, *a, **k)

    def mla_train(p, *a, **k):
        for n in MLA_LOGGED:
            log.setdefault(f"mla.{n}", set()).add(tuple(p[n].shape))
        return orig[3](p, *a, **k)

    def apply_mlp(p, *a, **k):
        for n in ("wi", "wo"):
            log.setdefault(f"mlp.{n}", set()).add(tuple(p[n].shape))
        return orig[1](p, *a, **k)

    def vocab_embed(w, *a, **k):
        log.setdefault("embed", set()).add(tuple(w.shape))
        return orig[2](w, *a, **k)

    def flash_attention(q, *a, **k):
        # the heads the core is given: B x the rank's heads
        log.setdefault("attn.core", set()).add((q.shape[0] // BATCH,))
        return orig[4](q, *a, **k)

    L.attention_train, L.apply_mlp, C.vocab_embed, MLA.mla_train, \
        L.ops.flash_attention = attention_train, apply_mlp, vocab_embed, \
        mla_train, flash_attention

    def undo():
        L.attention_train, L.apply_mlp, C.vocab_embed, MLA.mla_train, \
            L.ops.flash_attention = orig
        for kind, (module, name) in mixers.items():
            setattr(module, name, orig_mixers[kind])
    return undo


def _gathered(model, cfg, mesh, s_specs) -> list[str]:
    """The weights a step gathers: stored cut over 'model', computed
    whole (the MoE experts' layout is their own)."""
    from repro_torch.models.moe import is_expert_weight
    from repro_torch.models.params import is_spec, tree_leaves, tree_paths
    from repro_torch.models.transformer import dense_mesh_layout, \
        dense_weight_key

    dense = dense_mesh_layout(cfg, mesh)
    out = []
    for path, spec in zip(tree_paths(model.defs),
                          tree_leaves(s_specs["params"], is_leaf=is_spec)):
        stored_cut = any(e == "model" or (isinstance(e, tuple)
                                          and "model" in e) for e in spec)
        key = dense_weight_key(model, path)
        whole = key not in dense or dense[key][0] == ()
        if stored_cut and whole and not is_expert_weight(path):
            out.append("/".join(map(str, path)))
    return out


def _assembled(model, cfg, mesh, s_specs) -> list[str]:
    """The weights stored whole and computed cut over 'model' (not
    partial): each rank's gradient is its piece, assembled into the
    stored whole by an all-gather."""
    from repro_torch.models.params import is_spec, tree_leaves, tree_paths
    from repro_torch.models.transformer import dense_mesh_layout, \
        dense_weight_key

    dense = dense_mesh_layout(cfg, mesh)
    out = []
    for path, spec in zip(tree_paths(model.defs),
                          tree_leaves(s_specs["params"], is_leaf=is_spec)):
        stored_cut = any(e == "model" or (isinstance(e, tuple)
                                          and "model" in e) for e in spec)
        compute, partial = dense.get(dense_weight_key(model, path),
                                     ((), False))
        if not stored_cut and "model" in compute and not partial:
            out.append("/".join(map(str, path)))
    return out


#: reduce_scatter's output shape a rank, and the dims it scatters
RS_SHAPE, RS_DIMS = (3, 4, 5), (0, 1, -1)


def _reduce_scatter_case(mesh) -> dict:
    """``collectives.reduce_scatter`` on the rank's 'model' group along
    each of RS_DIMS: the largest |error| of the forward against the
    rank's block of the sum of every rank's input (each made here from
    its rank's seed) and of the backward against every rank's output
    gradient joined along the dim."""
    from repro_torch.dist.collectives import TPGroup, reduce_scatter

    tp = TPGroup.of(mesh, "model")
    errs = {}
    for dim in RS_DIMS:
        shape = list(RS_SHAPE)
        shape[dim] *= tp.size
        xs = [torch.from_numpy(np.random.default_rng(r).standard_normal(
            shape).astype(np.float32)) for r in range(tp.size)]
        gs = [torch.from_numpy(np.random.default_rng(100 + r)
                               .standard_normal(RS_SHAPE).astype(np.float32))
              for r in range(tp.size)]
        x = xs[tp.rank].clone().requires_grad_(True)
        y = reduce_scatter(x, tp.group, dim)
        y.backward(gs[tp.rank])
        want = sum(xs).chunk(tp.size, dim=dim)[tp.rank]
        errs[str(dim)] = {
            "shape": list(y.shape),
            "forward": float((y - want).abs().max()),
            "backward": float((x.grad - torch.cat(gs, dim=dim)).abs().max())}
    return errs


def _case(mesh, tmp_ref: str, arch: str, over: dict) -> dict:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM, make_global_batch
    from repro_torch.dist.collectives import distribute
    from repro_torch.dist.sharding import to_placements
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.serve.step import build_prefill
    from repro_torch.train.optim import AdamWConfig, adamw_update, \
        init_state
    from repro_torch.train.step import build_train_step, make_ctx

    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    model = build_model(cfg)
    ref = torch.load(tmp_ref)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=20)
    state1 = init_state(tree_map(lambda t: t.clone(), ref["params"]), opt)
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
    data = SyntheticLM(cfg.vocab, SEQ, BATCH, seed=3)
    # -- the first loss and gradients against the reference's -------------
    batch0 = make_global_batch(data.batch_at(0), mesh, b_specs)
    loss0, grads = step.value_and_grad(sharded, batch0)
    whole = [DTensor.from_local(g, mesh, to_placements(sp, mesh),
                                run_check=False).full_tensor()
             for g, sp in zip(tree_leaves(grads), spec_leaves["params"])]
    ref_grads = tree_leaves(ref["grads"])
    grad_errs = [_normwise(a.numpy(), b.numpy())
                 for a, b in zip(whole, ref_grads)]
    norms = [float(b.double().norm()) for b in ref_grads]
    full = sum(n * n for n in norms) ** 0.5
    noise = [i for i, n in enumerate(norms) if n < NOISE_FRACTION * full]
    grad_err_whole = _normwise(
        np.concatenate([a.numpy().ravel() for a in whole]),
        np.concatenate([b.numpy().ravel() for b in ref_grads]))
    # -- steps against the single-device step; the first one watched ------
    log: dict = {}
    losses, losses1 = [], []
    own_diff = own_norm = 0.0
    for i in range(STEPS):
        batch = data.batch_at(i)
        gb = make_global_batch(batch, mesh, b_specs)
        # the whole state's update on this step's own gradients
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
    # -- the built prefill against the single-device one --------------------
    params = ref["params"]
    pshape = ShapeSpec("p", 12, BATCH, "prefill")        # cache_len 12
    prefill, p_specs, pb_specs = build_prefill(model, cfg, pshape, mesh)
    it = iter(tree_leaves(p_specs, is_leaf=is_spec))
    on_mesh = tree_map(lambda t: distribute(t, mesh, next(it)), params)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (BATCH, 8))
    with torch.no_grad():
        logits, cache = prefill(on_mesh, make_global_batch(
            {"tokens": tokens}, mesh, pb_specs))
        want, cache1 = model.prefill(params, torch.from_numpy(tokens),
                                     make_ctx("prefill", cache_len=12))
    cache_err = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(_tensors(cache)), tree_leaves(_tensors(cache1))))
    return {
        "loss0": float(loss0), "ref_loss": ref["loss"],
        "grad_errs": grad_errs, "grad_err_whole": grad_err_whole,
        "noise": noise,
        "losses": losses, "losses1": losses1,
        "params_err": (diff / norm) ** 0.5,
        "own_update_err": (own_diff / own_norm) ** 0.5,
        "shapes": {k: sorted(v) for k, v in log.items()},
        "all_gathers": sum(v for k, v in counts.items()
                           if "functional" in k and "all_gather" in k),
        "model_gathers": sum(v for k, v in counts.items()
                             if "functional" not in k and "allgather" in k),
        "gathered": _gathered(model, cfg, mesh, s_specs),
        "assembled": _assembled(model, cfg, mesh, s_specs),
        "logits_shape": list(logits.shape),
        "logits_err": float((logits - want).abs().max()),
        "cache_err": cache_err,
        "cache_leaves": len(tree_leaves(_tensors(cache))),
        "cache_leaves1": len(tree_leaves(_tensors(cache1))),
    }


def _tensors(cache) -> list:
    """Every tensor of a cache list, in order."""
    out = []
    for c in cache:
        out += [getattr(c, f.name) for f in dataclasses.fields(c)
                if isinstance(getattr(c, f.name), torch.Tensor)]
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
        res = {"coord": list(mesh.get_coordinate()),
               "reduce_scatter": _reduce_scatter_case(mesh)}
        for arch, over in WORLDS[shape]:
            cid = _case_id(arch, over)
            res[cid] = _case(mesh, f"{tmp}/../ref_{cid}.pt", arch, over)
        with open(f"{tmp}/res_{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _spawn(shape, tmp, timeout=300):
    import torch.multiprocessing as mp

    world = shape[0] * shape[1]
    ctx = mp.start_processes(_world, args=(world, shape, tmp), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {shape} world did not finish")


# ---------------------------------------------------------------------------
# the reference (this process), then the worlds
# ---------------------------------------------------------------------------

def _reference(arch: str, over: dict, path: str) -> None:
    """The reference's weights, loss and gradients on step 0's batch, in
    the port's layout, saved for the ranks."""
    import jax
    import jax.numpy as jnp

    from repro.configs import build_model as jax_build_model
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.train import optim as jopt
    from repro.train.step import init_train_state as jax_init_train_state
    from repro.train.step import make_ctx as jax_make_ctx
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import SyntheticLM

    jcfg = dataclasses.replace(jax_smoke_config(arch), **over)
    jm = jax_build_model(jcfg)
    jstate = jax_init_train_state(jm, jcfg, jopt.AdamWConfig(),
                                  jax.random.PRNGKey(0))
    batch = SyntheticLM(jcfg.vocab, SEQ, BATCH, seed=3).batch_at(0)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch),
                          jax_make_ctx(None, "train")))(jstate["params"])

    def to_np(tree):
        return jax.tree.map(np.asarray, tree)
    torch.save({"params": params_from_jax(to_np(jstate["params"])),
                "grads": params_from_jax(to_np(jgrads)),
                "loss": float(jloss)}, path)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    for arch, over in {(_case_id(a, o), a): o for _, a, o in CASES}.items():
        cid, name = arch
        _reference(name, over, str(root / f"ref_{cid}.pt"))
    out = {}
    for shape in WORLDS:
        tmp = root / f"w{shape[0]}x{shape[1]}"
        tmp.mkdir()
        _spawn(shape, str(tmp))
        res = []
        for r in range(shape[0] * shape[1]):
            with open(tmp / f"res_{r}.json") as f:
                res.append(json.load(f))
        out[shape] = res
    return out


def _ids(case):
    shape, arch, over = case
    return f"{shape[0]}x{shape[1]}-{_case_id(arch, over)}"


def _cfg(arch, over):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), **over)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tp_first_step_matches_reference_gradients(worlds, case):
    """The sharded step's loss and gradients (summed into the stored
    layout, gathered whole) against ``jax.value_and_grad`` of the
    reference's loss on the same weights and batch: every leaf, but a
    leaf under NOISE_FRACTION of the whole gradient (an mLSTM's
    input-gate bias), which is held only inside the whole vector."""
    from repro_torch.configs import build_model
    from repro_torch.models.params import tree_paths

    shape, arch, over = case
    paths = tree_paths(build_model(_cfg(arch, over)).defs)
    for r in worlds[shape]:
        c = r[_case_id(arch, over)]
        np.testing.assert_allclose(c["loss0"], c["ref_loss"], rtol=LOSS_TOL)
        noise = c["noise"]
        assert all(paths[i][-1] == "b_igate" for i in noise), noise
        leaves = [e for i, e in enumerate(c["grad_errs"]) if i not in noise]
        assert max(leaves) < GRAD_TOL, c["grad_errs"]
        assert c["grad_err_whole"] < GRAD_TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tp_train_steps_match_single_device(worlds, case):
    """STEPS sharded steps: the losses against the single-device step's,
    each step's update against the whole state's on its own gradients,
    and the parameters against the single-device steps' but for
    REC_PARAM_ARCHS (test_tp_recurrent_params_near_single_device)."""
    shape, arch, over = case
    for r in worlds[shape]:
        c = r[_case_id(arch, over)]
        np.testing.assert_allclose(c["losses"], c["losses1"], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        assert c["own_update_err"] < PARAM_TOL
        if arch not in REC_PARAM_ARCHS:
            assert c["params_err"] < PARAM_TOL


@pytest.mark.parametrize(
    "case", [c for c in CASES if c[1] in REC_PARAM_ARCHS], ids=_ids)
def test_tp_recurrent_params_near_single_device(worlds, case):
    """recurrentgemma's and xlstm's parameter vectors after STEPS
    sharded steps against the single-device steps', normwise within
    REC_PARAM_TOL: AdamW's first steps are lr x g / (|g| + eps), and
    their gradient elements near 1e-9 change sign with a cut product's
    summation order (see the module's docstring)."""
    shape, arch, over = case
    for r in worlds[shape]:
        assert r[_case_id(arch, over)]["params_err"] < REC_PARAM_TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tp_prefill_matches_single_device(worlds, case):
    from repro_torch.configs import build_model

    shape, arch, over = case
    for r in worlds[shape]:
        c = r[_case_id(arch, over)]
        cfg = _cfg(arch, over)
        assert c["logits_shape"] == [BATCH, cfg.vocab]
        assert c["logits_err"] < PREFILL_TOL
        # K and V an attention layer, h and conv an RG-LRU layer, the
        # mLSTM's c, n, m and the sLSTM's c, n, h, m
        assert c["cache_leaves"] == sum(
            {"mlstm": 3, "slstm": 4}.get(s.kind, 2) for s in
            build_model(cfg).plan) == c["cache_leaves1"]
        assert c["cache_err"] < PREFILL_TOL


def recurrent_shapes(cfg, tp: int, rows: int | None = None) -> dict:
    """The local shapes of the recurrent mixers' logged weights
    (RECURRENT_LOGGED) on a ``tp``-way axis, for the kinds ``cfg`` has:
    the RG-LRU on its W / tp channels, the xLSTM blocks' projections on
    their widths (the sLSTM's ``w_in`` on its stored columns), the
    sLSTM's recurrence weights whole.  With ``rows``, a decode step's on
    a rank's ``rows`` rows: the sLSTM's ``w_rec`` and ``b`` on their
    stored columns too, and the state a mixer
    is given (``state.<field>``): the RG-LRU's on its channels, the
    mLSTM's ``c`` and ``n`` on their key dim, the rest whole."""
    from repro_torch.configs import build_model

    d, w, h = cfg.d_model, cfg.lru_width, cfg.n_heads
    di, dh = 2 * d, 2 * d // h
    g = 4 * d if rows is None else 4 * d // tp
    table = {
        "rglru": {"wx": (d, w // tp), "wy": (d, w // tp),
                  "conv_w": (cfg.conv_width, w // tp), "lam": (w // tp,),
                  "w_input_gate": (w // tp, w), "w_rec_gate": (w // tp, w),
                  "wo": (w // tp, d)},
        "mlstm": {"w_up": (d, 2 * di // tp), "wq": (di // tp, di),
                  "w_igate": (di // tp, h), "w_down": (di // tp, d),
                  "norm": (di,)},
        "slstm": {"w_in": (d, 4 * d // tp), "w_rec": (d, g), "b": (g,),
                  "w_up": (d, 2 * d // tp), "w_down": (d // tp, d)}}
    if rows is not None:
        table["rglru"].update({
            "state.h": (rows, w // tp),
            "state.conv": (rows, cfg.conv_width - 1, w // tp)})
        table["mlstm"].update({"state.c": (rows, h, dh // tp, dh),
                               "state.n": (rows, h, dh // tp),
                               "state.m": (rows, h)})
        table["slstm"].update({f"state.{n}": (rows, d) for n in "cnhm"})
    kinds = {s.kind for s in build_model(cfg).plan}
    return {f"{k}.{n}": shape for k in table if k in kinds
            for n, shape in table[k].items()}


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tp_rank_computes_on_its_shards(worlds, case):
    """The weights each dense block is given have the local widths of
    the layout, the attention core of a rank is given its range of
    ⌈H / tp⌉ heads (none past the last head: no call), and a step
    all-gathers (DTensor's redistribution) only
    the weights computed whole and stored cut: never ``wq``, ``wo``,
    ``wi`` or ``embed`` where the 'model' axis cuts their heads, FF
    width or vocab, nor MLA's ``wq_b``, ``wk_b``, ``wv_b`` or ``wo``
    (MLA's latent projections stay whole), nor an RG-LRU weight, nor an
    xLSTM weight but the sLSTM's ``w_rec`` and ``b`` (its recurrence,
    h @ w_rec, runs whole; its input product on ``w_in``'s columns) —
    and the gradients of the weights computed cut and stored whole (the
    RG-LRU gates' biases), assembled.  The model's own all-gathers are
    the xLSTM blocks' up-projections and the sLSTM's input product, one
    each a layer in the forward and one in the remat's recompute, and
    the backward of each RG-LRU layer's gates' reduce-scatter; the
    mLSTM core, on its key dims, gathers nothing in a train step."""
    from repro_torch.configs import build_model

    shape, arch, over = case
    tp = shape[1]
    cfg = _cfg(arch, over)
    plan = build_model(cfg).plan
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hk, v = cfg.n_heads, cfg.n_kv_heads, cfg.vocab
    heads_cut = h % tp == 0
    want = {"embed": (v // tp, d)}
    if cfg.attn_kind == "mla":
        want.update({
            "mla.wq_b": (cfg.q_lora_rank, h // tp * hd),
            "mla.wk_b": (cfg.kv_lora_rank, h // tp * cfg.qk_nope_dim),
            "mla.wv_b": (cfg.kv_lora_rank, h // tp * cfg.v_head_dim),
            "mla.wo": (h // tp * cfg.v_head_dim, d),
            "mla.wq_a": (d, cfg.q_lora_rank),
            "mla.wkv_a": (d, cfg.kv_lora_rank)})
    elif any(s.kind in ("attn", "local") for s in plan):
        kv = hk * hd // tp if heads_cut and hk % tp == 0 else hk * hd
        want.update({"attn.wq": (d, h * hd // tp if heads_cut else h * hd),
                     "attn.wk": (d, kv), "attn.wv": (d, kv),
                     "attn.wo": (h * hd // tp if heads_cut else h * hd, d)})
    ffs = {s.d_ff for s in plan if s.mlp == "mlp"}
    for ff in ffs:
        want.update({"mlp.wi": (d, ff // tp), "mlp.wo": (ff // tp, d)})
    want.update(recurrent_shapes(cfg, tp))
    recurrent = {i for i, s in enumerate(plan)
                 if s.kind in ("rglru", "mlstm", "slstm")}
    slstm = {f"layers/{i}/mixer/{n}" for i, s in enumerate(plan)
             if s.kind == "slstm" for n in ("w_rec", "b")}
    kinds = [s.kind for s in plan]
    up = 2 * sum(k in ("mlstm", "slstm") for k in kinds) \
        + 2 * kinds.count("slstm") + kinds.count("rglru")
    biases = {f"layers/{i}/mixer/{n}" for i, s in enumerate(plan)
              if s.kind == "rglru" for n in ("b_input_gate", "b_rec_gate")}
    attn = cfg.attn_kind != "mla" and any(s.kind in ("attn", "local")
                                          for s in plan)
    per = -(-h // tp)
    for r in worlds[shape]:
        c = r[_case_id(arch, over)]
        mine = dict(want)
        heads = min(h, per * (r["coord"][1] + 1)) - per * r["coord"][1]
        if attn and heads > 0:
            mine["attn.core"] = (heads,)
        assert set(c["shapes"]) == set(mine)
        for name, s in mine.items():
            assert c["shapes"][name] == [list(s)], name
        assert set(c["assembled"]) == biases, c["assembled"]
        assert c["all_gathers"] == len(c["gathered"]) + len(biases), \
            c["gathered"]
        assert c["model_gathers"] == up
        for name in c["gathered"]:
            leaf = name.split("/")[-1]
            # the vocab and the FF width are cut in every case here
            assert leaf not in ("embed", "unembed", "wi", "wg"), name
            if heads_cut:
                assert leaf not in ("wq", "wo", "wq_b", "wk_b",
                                    "wv_b"), name
                assert leaf not in ("wk", "wv") or hk % tp, name
            # no recurrent mixer's weight but the sLSTM recurrence's
            assert int(name.split("/")[1]) not in recurrent \
                or name in slstm, name
        assert slstm <= set(c["gathered"])
    if arch == "deepseek-v2-236b":
        # the shared experts, whole in a train step as the reference's
        # shard_map takes them; no MLA weight
        assert worlds[shape][0][_case_id(arch, over)]["gathered"] == [
            f"layers/{i}/moe/{n}" for i in range(1, cfg.n_layers)
            for n in ("shared_wg", "shared_wi", "shared_wo")]
    if (arch, tp) == ("granite-8b", 4):
        # the picked KV heads: each layer's wk and wv, nothing else
        assert worlds[shape][0][_case_id(arch, over)]["gathered"] == [
            f"layers/{i}/mixer/{n}" for i in range(cfg.n_layers)
            for n in ("wk", "wv")]


@pytest.mark.parametrize("shape", list(WORLDS), ids=str)
def test_reduce_scatter_sums_and_gathers(worlds, shape):
    """``collectives.reduce_scatter`` over the 'model' group of 2 and of 4
    ranks, along dims 0, 1 and -1: each rank's output is its block of
    the sum of every rank's input (fp32, summed in another order:
    1e-6), and its input's gradient is every rank's output gradient
    joined along the dim, exactly (the all-gather copies)."""
    tp = shape[1]
    for r in worlds[shape]:
        for dim, got in r["reduce_scatter"].items():
            assert got["shape"] == list(RS_SHAPE), dim
            assert got["forward"] <= 1e-6 * tp, (dim, got)
            assert got["backward"] == 0.0, (dim, got)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tp_ranks_hold_the_same_loss(worlds, case):
    shape, arch, over = case
    first = worlds[shape][0][_case_id(arch, over)]["losses"]
    for r in worlds[shape][1:]:
        assert r[_case_id(arch, over)]["losses"] == first


def test_dense_mesh_layout_of_the_production_archs():
    """The layout on the (16, 16) production mesh's 'model' axis, read
    from the full configs: whole heads where H divides, picked KV heads
    where Hkv does not (a decode step: the stored columns), a range of
    heads taken from the whole weights for starcoder2's 24 and
    recurrentgemma's 10 (their decode on the stored columns), the vocab and FF cut, the RG-LRU on its W
    channels (the gates' biases too), the xLSTM blocks' projections on
    their widths (the sLSTM's input weight ``w_in`` on its columns, its
    recurrence weights on theirs in a decode step only), the
    encoder-decoder's attentions on its uneven heads, its MLPs on their
    cut and its odd vocabulary on ranges of the whole embedding."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import dense_mesh_layout

    class _Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return 16

    lay = {a: dense_mesh_layout(get_config(a), _Mesh()) for a in (
        "stablelm-1.6b", "granite-8b", "starcoder2-3b", "whisper-tiny",
        "recurrentgemma-2b", "deepseek-v2-236b", "xlstm-125m")}
    dec = {a: dense_mesh_layout(get_config(a), _Mesh(), decode=True)
           for a in lay}
    m = "model"
    cols, rows, chans = ((None, m), False), ((m, None), False), \
        ((m,), False)
    assert lay["stablelm-1.6b"]["attn.wk"] == ((None, m), False)
    assert lay["stablelm-1.6b"]["embed"] == ((m, None), False)
    assert lay["granite-8b"]["attn.wq"] == ((None, m), False)
    assert lay["granite-8b"]["attn.wk"] == ((), True)
    assert lay["granite-8b"]["mlp.wo"] == ((m, None), False)
    # starcoder2's 24 heads and recurrentgemma's 10: each rank takes its
    # range of 2 or 1 whole heads from the whole weights (partial
    # gradients); a decode step projects on the stored columns (192 of
    # wq's 3072, 1.5 heads; 160 of 2560) and leaves through wo's rows
    uneven = {f"attn.{n}": ((), True) for n in (
        "wq", "wo", "wk", "wv", "q_norm", "k_norm")}
    stored = {"attn.wq": cols, "attn.wk": cols, "attn.wv": cols,
              "attn.wo": rows}
    for a in ("starcoder2-3b", "recurrentgemma-2b"):
        assert {k: v for k, v in lay[a].items()
                if k.startswith("attn.")} == uneven
        assert {k: v for k, v in dec[a].items()
                if k.startswith("attn.")} == stored
    assert lay["starcoder2-3b"]["mlp.wi"] == ((None, m), False)
    # whisper's three attentions on its 6 heads as starcoder2's, its MLPs
    # on 96 of 1536, its odd vocabulary on ranges of the whole embedding
    # (tests/test_torch_tp_encdec.py runs them)
    assert {k: v for k, v in lay["whisper-tiny"].items()
            if k.startswith("attn.")} == uneven
    assert {k: v for k, v in dec["whisper-tiny"].items()
            if k.startswith("attn.")} == stored
    assert lay["whisper-tiny"]["embed"] == dec["whisper-tiny"]["embed"] \
        == ((), True)
    assert lay["whisper-tiny"]["mlp.wi"] == ((None, m), False)
    # recurrentgemma's MLP, vocab and RG-LRU (W 2560: 160 channels a
    # rank) are cut
    assert "mlp.wg" in lay["recurrentgemma-2b"]
    assert {k: v for k, v in lay["recurrentgemma-2b"].items()
            if k.startswith("rglru.")} == {
        "rglru.wx": cols, "rglru.wy": cols, "rglru.conv_w": cols,
        "rglru.conv_b": chans, "rglru.lam": chans,
        "rglru.w_input_gate": rows, "rglru.w_rec_gate": rows,
        "rglru.b_input_gate": chans, "rglru.b_rec_gate": chans,
        "rglru.wo": rows}
    # deepseek's mixer is MLA, not GQA; its dense MLP is cut
    assert "attn.wq" not in lay["deepseek-v2-236b"]
    assert "mlp.wi" in lay["deepseek-v2-236b"]
    # its MLA on whole heads (128 on 16: 8 a rank), the latents whole
    assert {k: v for k, v in lay["deepseek-v2-236b"].items()
            if k.startswith("mla.")} == {
        "mla.wq_b": ((None, m), False), "mla.wk_b": ((None, m), False),
        "mla.wv_b": ((None, m), False), "mla.wo": ((m, None), False)}
    assert not any(k.startswith("mla.") for a, t in lay.items()
                   if a != "deepseek-v2-236b" for k in t)
    # xlstm's projections on their widths (D 768, Di 1536, Dh 384)
    assert lay["xlstm-125m"] == {
        "embed": rows, "unembed": cols, "mlstm.w_up": cols,
        "mlstm.wq": rows, "mlstm.wk": rows, "mlstm.wv": rows,
        "mlstm.w_igate": rows, "mlstm.w_fgate": rows,
        "mlstm.w_down": rows, "slstm.w_up": cols, "slstm.w_down": rows,
        "slstm.w_in": cols}
    assert dec["xlstm-125m"] == {
        **lay["xlstm-125m"], "slstm.w_rec": cols, "slstm.b": chans}
    assert not any(k.startswith(("rglru.", "mlstm.", "slstm."))
                   for a, t in dec.items()
                   if a not in ("recurrentgemma-2b", "xlstm-125m")
                   for k in t)
    # a decode step's layout differs only by the sLSTM's recurrence
    # weights and
    # the attention of uneven heads or KV heads (granite's 8 KV heads on
    # 16: the stored columns of wk and wv, 128 of 1024, and wq's, wo's)
    assert dec["granite-8b"]["attn.wk"] == cols
    assert {k: v for k, v in dec["granite-8b"].items()
            if k.startswith("attn.")} == stored
    assert all(dec[a] == lay[a] for a in lay if a not in (
        "xlstm-125m", "starcoder2-3b", "recurrentgemma-2b", "whisper-tiny",
        "granite-8b"))
    assert all({k: v for k, v in dec[a].items() if not k.startswith(
        "attn.")} == {k: v for k, v in lay[a].items()
                      if not k.startswith("attn.")}
        for a in ("starcoder2-3b", "recurrentgemma-2b", "whisper-tiny",
                  "granite-8b"))
