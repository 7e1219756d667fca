"""Tensor-parallel dense compute on multi-rank gloo worlds on the CPU.

Two worlds, meshes (1, 2) and (1, 4) over ("data", "model"), each
spawned once (``init_method=file://``: no port) and running every case
in one go; the tests below read what the ranks wrote.  The kernels'
plain versions run (CPU tensors).

* (1, 2): stablelm-1.6b's smoke config (4 heads, 4 KV heads: both
  cut), granite-8b's (2 KV heads: one a rank) and chameleon-34b's (qk
  norms applied to each rank's heads: their gradient is a partial sum);
* (1, 4): granite-8b's (2 KV heads on 4 ranks: each rank picks the KV
  head its query head reads, and that gradient is a partial sum),
  starcoder2-3b's cut to 6 heads (6 % 4: attention whole on every rank),
  mixtral-8x22b's with 6 experts (picked KV heads beside the MoE's
  expert-TP path; with 4 experts the MoE would take its expert-parallel
  path, whose per-shard capacity drops other tokens than one device
  does, as the reference's) and deepseek-v2-236b's with 6 experts (MLA
  on one whole head a rank, its latents whole; the routed experts on
  the expert-TP path for the same reason, the shared experts whole).

For each case: the reference's ``model.loss`` and its gradients by
``jax.value_and_grad`` on the reference's weights, carried across by
``convert.params_from_jax`` in this process; on the ranks, the sharded
step's first loss and gradients against them (1e-5 and 1e-4
normwise), 3 sharded steps against the single-device port step (losses
and the parameter vector within 1e-5), the weights a rank computes
with (their local shapes), the all-gathers of a step counted by
``CommDebugMode`` (only the weights computed whole and stored cut), and
the built prefill's logits and caches against the single-device
prefill (1e-5).
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
WORLDS = {
    (1, 2): [("stablelm-1.6b", {}), ("granite-8b", {}),
             ("chameleon-34b", {})],
    (1, 4): [("granite-8b", {}), ("starcoder2-3b", {"n_heads": 6}),
             ("mixtral-8x22b", {"n_experts": 6}),
             ("deepseek-v2-236b", {"n_experts": 6})],
}
CASES = [(shape, arch, over) for shape, cases in WORLDS.items()
         for arch, over in cases]


def _case_id(arch: str, over: dict) -> str:
    return arch + "".join(f"-{k}{v}" for k, v in sorted(over.items()))


#: the MLA weights whose local shapes a rank logs: the four on 'heads'
#: and two latent projections
MLA_LOGGED = ("wq_b", "wk_b", "wv_b", "wo", "wq_a", "wkv_a")


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

    orig = (L.attention_train, L.apply_mlp, C.vocab_embed, MLA.mla_train)

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

    L.attention_train, L.apply_mlp, C.vocab_embed, MLA.mla_train = \
        attention_train, apply_mlp, vocab_embed, mla_train

    def undo():
        L.attention_train, L.apply_mlp, C.vocab_embed, MLA.mla_train = orig
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
    from repro_torch.train.optim import AdamWConfig, init_state
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
    grad_errs = [_normwise(a.numpy(), b.numpy())
                 for a, b in zip(whole, tree_leaves(ref["grads"]))]
    # -- steps against the single-device step; the first one watched ------
    log: dict = {}
    losses, losses1 = [], []
    for i in range(STEPS):
        batch = data.batch_at(i)
        gb = make_global_batch(batch, mesh, b_specs)
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
        "grad_errs": grad_errs,
        "losses": losses, "losses1": losses1,
        "params_err": (diff / norm) ** 0.5,
        "shapes": {k: sorted(v) for k, v in log.items()},
        "all_gathers": sum(v for k, v in counts.items()
                           if "all_gather" in k or "allgather" in k),
        "gathered": _gathered(model, cfg, mesh, s_specs),
        "logits_shape": list(logits.shape),
        "logits_err": float((logits - want).abs().max()),
        "cache_err": cache_err,
        "cache_leaves": len(tree_leaves(_tensors(cache))),
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
        res = {"coord": list(mesh.get_coordinate())}
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
    reference's loss on the same weights and batch."""
    shape, arch, over = case
    for r in worlds[shape]:
        c = r[_case_id(arch, over)]
        np.testing.assert_allclose(c["loss0"], c["ref_loss"], rtol=LOSS_TOL)
        assert max(c["grad_errs"]) < GRAD_TOL, c["grad_errs"]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tp_train_steps_match_single_device(worlds, case):
    shape, arch, over = case
    for r in worlds[shape]:
        c = r[_case_id(arch, over)]
        np.testing.assert_allclose(c["losses"], c["losses1"], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        assert c["params_err"] < PARAM_TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tp_prefill_matches_single_device(worlds, case):
    shape, arch, over = case
    for r in worlds[shape]:
        c = r[_case_id(arch, over)]
        cfg = _cfg(arch, over)
        assert c["logits_shape"] == [BATCH, cfg.vocab]
        assert c["logits_err"] < PREFILL_TOL
        assert c["cache_leaves"] == 2 * cfg.n_layers
        assert c["cache_err"] < PREFILL_TOL


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tp_rank_computes_on_its_shards(worlds, case):
    """The weights each dense block is given have the local widths of
    the layout, and a step all-gathers only the weights computed whole
    and stored cut: never ``wq``, ``wo``, ``wi`` or ``embed`` where the
    'model' axis cuts their heads, FF width or vocab, nor MLA's
    ``wq_b``, ``wk_b``, ``wv_b`` or ``wo`` (MLA's latent projections
    stay whole)."""
    from repro_torch.configs import build_model

    shape, arch, over = case
    tp = shape[1]
    cfg = _cfg(arch, over)
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
    else:
        kv = hk * hd // tp if heads_cut and hk % tp == 0 else hk * hd
        want.update({"attn.wq": (d, h * hd // tp if heads_cut else h * hd),
                     "attn.wk": (d, kv), "attn.wv": (d, kv),
                     "attn.wo": (h * hd // tp if heads_cut else h * hd, d)})
    ffs = {s.d_ff for s in build_model(cfg).plan if s.mlp == "mlp"}
    for ff in ffs:
        want.update({"mlp.wi": (d, ff // tp), "mlp.wo": (ff // tp, d)})
    for r in worlds[shape]:
        c = r[_case_id(arch, over)]
        assert set(c["shapes"]) == set(want)
        for name, s in want.items():
            assert c["shapes"][name] == [list(s)], name
        assert c["all_gathers"] == len(c["gathered"]), c["gathered"]
        for name in c["gathered"]:
            leaf = name.split("/")[-1]
            # the vocab and the FF width are cut in every case here
            assert leaf not in ("embed", "unembed", "wi", "wg"), name
            if heads_cut:
                assert leaf not in ("wq", "wo", "wq_b", "wk_b",
                                    "wv_b"), name
                assert leaf not in ("wk", "wv") or hk % tp, name
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


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tp_ranks_hold_the_same_loss(worlds, case):
    shape, arch, over = case
    first = worlds[shape][0][_case_id(arch, over)]["losses"]
    for r in worlds[shape][1:]:
        assert r[_case_id(arch, over)]["losses"] == first


def test_dense_mesh_layout_of_the_production_archs():
    """The layout on the (16, 16) production mesh's 'model' axis, read
    from the full configs: whole heads where H divides, picked KV heads
    where Hkv does not, whole attention for starcoder2's 24 heads, the
    vocab and FF cut, nothing of the encoder-decoder."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import dense_mesh_layout

    class _Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return 16

    lay = {a: dense_mesh_layout(get_config(a), _Mesh()) for a in (
        "stablelm-1.6b", "granite-8b", "starcoder2-3b", "whisper-tiny",
        "recurrentgemma-2b", "deepseek-v2-236b", "xlstm-125m")}
    m = "model"
    assert lay["stablelm-1.6b"]["attn.wk"] == ((None, m), False)
    assert lay["stablelm-1.6b"]["embed"] == ((m, None), False)
    assert lay["granite-8b"]["attn.wq"] == ((None, m), False)
    assert lay["granite-8b"]["attn.wk"] == ((), True)
    assert lay["granite-8b"]["mlp.wo"] == ((m, None), False)
    assert "attn.wq" not in lay["starcoder2-3b"]
    assert lay["starcoder2-3b"]["mlp.wi"] == ((None, m), False)
    assert lay["whisper-tiny"] == {}
    # recurrentgemma's 10 heads stay whole; its MLP and vocab are cut
    assert "attn.wq" not in lay["recurrentgemma-2b"]
    assert "mlp.wg" in lay["recurrentgemma-2b"]
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
    assert set(lay["xlstm-125m"]) == {"embed", "unembed"}
