"""The distribution layer on multi-rank gloo worlds on the CPU.

Two 2-rank worlds, meshes (1, 2) and (2, 1) over ("data", "model"),
each spawned once (``init_method=file://`` in a temporary directory:
no port) and running every case in one go; the tests below read what
the ranks wrote.  The reference runs in this process and in one
``JAX_PLATFORMS=cpu`` subprocess with 2 host devices (its ``shard_map``
paths), as tests/test_distributed.py does.

* expert-parallel and expert-TP MoE (``_moe_apply`` and
  ``apply_moe_tp``) against the reference's dense ``apply_moe`` on the
  same weights within 1e-4, no drops; with drops, against the
  reference's own ``shard_map`` EP / TP result;
* their gradients (the collectives' replicated-loss convention,
  averaged over the data axis as the sharded step does) against the
  single-device path's over every weight and the input, within 1e-4;
* ``_moe_apply``'s choice of path;
* the sharded train step of stablelm-1.6b's smoke config against the
  port's single-device step: losses within 1e-5 over 3 steps, the
  state the same; deepseek-v2's smoke config (MoE on the mesh) steps
  with its replicated weights equal on both ranks;
* ``make_global_batch``, mesh-aware ``build_prefill`` / ``build_decode``
  (the prefill's caches laid out by ``shard_cache``) against the
  single-device path;
* a checkpoint saved on (1, 2) restored onto (2, 1) bit for bit, the
  host copies made on the writing rank only.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.timeout(400)

D, E, F_FF, TOP_K = 32, 8, 64, 2
SHAPES = [(1, 2), (2, 1)]


def _moe_weights(seed: int, e: int = E) -> dict:
    rng = np.random.default_rng(seed)
    w = {"router": 0.5 * rng.standard_normal((D, e)),
         "wi": rng.standard_normal((e, D, F_FF)) / np.sqrt(D),
         "wg": rng.standard_normal((e, D, F_FF)) / np.sqrt(D),
         "wo": rng.standard_normal((e, F_FF, D)) / np.sqrt(F_FF),
         "shared_wi": rng.standard_normal((D, F_FF)) / np.sqrt(D),
         "shared_wg": rng.standard_normal((D, F_FF)) / np.sqrt(D),
         "shared_wo": rng.standard_normal((F_FF, D)) / np.sqrt(F_FF)}
    return {k: v.astype(np.float32) for k, v in w.items()}


def _x(seed: int, s: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (4, s, D)).astype(np.float32)


# ---------------------------------------------------------------------------
# the ranks' work (runs in spawned processes: imports no jax)
# ---------------------------------------------------------------------------

def _spec(cf: float, e: int = E, shared: int = 1):
    from repro_torch.models.moe import MoESpec
    return MoESpec(d_model=D, n_experts=e, top_k=TOP_K, d_ff=F_FF,
                   n_shared=shared, capacity_factor=cf)


def _moe_cfg(spec):
    """An ArchConfig whose MoE layer is ``spec``."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(
        get_smoke_config("deepseek-v2-236b"), d_model=spec.d_model,
        n_experts=spec.n_experts, top_k=spec.top_k,
        d_ff_expert=spec.d_ff, n_shared_experts=spec.n_shared)


def _moe_case(mesh, rank_rows, w_np, x_np, spec, c_aux):
    """Output rows and dp-averaged gradients of the mesh path, and the
    single-device path's on the same loss."""
    import torch.distributed as dist

    from repro_torch.dist import collectives as C
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_ctx

    cfg = _moe_cfg(spec)
    orig = T._moe_spec
    T._moe_spec = lambda c: spec
    try:
        w = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in w_np.items()}
        x = torch.from_numpy(x_np)[rank_rows].clone().requires_grad_(True)
        wgt = torch.from_numpy(np.cos(np.arange(x_np.size)).reshape(
            x_np.shape).astype(np.float32))
        ctx = make_ctx("train", mesh=mesh)
        path = T.moe_mesh_layout(cfg, mesh, x.shape[1])[0]
        out, aux = T._moe_apply(w, x, cfg, ctx)
        loss = (out * wgt[rank_rows]).sum() + c_aux * aux
        grads = torch.autograd.grad(loss, [*w.values(), x])
        n_dp = C.axis_size(mesh, "data")
        g_w = [g.clone() for g in grads[:-1]]
        for g in g_w:
            dist.all_reduce(g, group=mesh.get_group("data"))
            g.div_(n_dp)
        # the single-device loss: the rows' sums averaged over the data
        # groups, the aux averaged over every (data, model) shard
        w1 = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in w_np.items()}
        x1 = torch.from_numpy(x_np).clone().requires_grad_(True)
        dense, _ = MOE.apply_moe(w1, x1, spec)
        tp = C.axis_size(mesh, "model")
        b_loc = x_np.shape[0] // n_dp
        auxes = []
        for d in range(n_dp):
            rows = slice(d * b_loc, (d + 1) * b_loc)
            if path == "ep":
                for chunk in x1[rows].chunk(tp, dim=1):
                    auxes.append(MOE.apply_moe(w1, chunk, spec)[1])
            else:
                auxes.append(MOE.apply_moe(w1, x1[rows], spec)[1])
        ref_loss = (dense * wgt).sum() / n_dp \
            + c_aux * torch.stack(auxes).mean()
        ref = torch.autograd.grad(ref_loss, [*w1.values(), x1])
        return {
            "path": path,
            "out": out.detach().numpy(),
            "aux": float(aux),
            "aux_ref": float(torch.stack(auxes).mean()),
            "grad_err": max(float((a - b).abs().max()) for a, b in zip(
                g_w, ref[:-1])),
            # a rank's input gradient is its own group's: n_dp times
            # the averaged loss's
            "grad_x_err": float((grads[-1] - n_dp * ref[-1][rank_rows])
                                .abs().max()),
            "grad_scale": max(float(r.abs().max()) for r in ref),
        }
    finally:
        T._moe_spec = orig


def _tp_direct(mesh, rank_rows, w_np, x_np, spec):
    """apply_moe_tp called directly on each rank's FF slice."""
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import to_placements
    from repro_torch.models import moe as MOE

    tp = "model"
    specs = {"wi": (None, None, tp), "wg": (None, None, tp),
             "wo": (None, tp, None)}
    p = {k: C.local_at(torch.from_numpy(v), mesh, to_placements(
        specs.get(k, ()), mesh)) for k, v in w_np.items()}
    x = torch.from_numpy(x_np)[rank_rows]
    with torch.no_grad():
        out, _ = MOE.apply_moe_tp(p, x, spec, mesh=mesh)
    return out.numpy()


def _ep_direct(mesh, rank, rank_rows, w_np, x_np, spec):
    """apply_moe_ep called directly: this rank's experts and sequence
    shard (the reference's shard_map in_specs)."""
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import to_placements
    from repro_torch.models import moe as MOE

    tp = "model"
    p = {k: C.local_at(torch.from_numpy(v), mesh, to_placements(
        (tp, None, None) if k in ("wi", "wg", "wo") else (), mesh))
        for k, v in w_np.items()}
    x = C.local_at(torch.from_numpy(x_np)[rank_rows], mesh, to_placements(
        (None, tp, None), mesh))
    with torch.no_grad():
        out, _ = MOE.apply_moe_ep(p, x, spec, mesh=mesh)
    return out.numpy()


def _train_case(mesh, arch, steps):
    """``steps`` sharded steps against the single-device step from the
    same state and batches."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM, make_global_batch
    from repro_torch.dist.collectives import distribute
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import build_train_step, init_train_state

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=20)
    gen = torch.Generator().manual_seed(0)
    state1 = init_train_state(model, cfg, opt, gen)
    shape = ShapeSpec("t", 16, 4, "train")
    step, s_specs, b_specs = build_train_step(model, cfg, opt,
                                              shape=shape, mesh=mesh)
    one, _, _ = build_train_step(model, cfg, opt)
    spec_leaves = {k: tree_leaves(v, is_leaf=is_spec)
                   for k, v in s_specs.items()}
    sharded = {}
    for k, v in state1.items():
        it = iter(spec_leaves[k]) if k != "step" else iter([()])
        sharded[k] = tree_map(lambda t: distribute(t.clone(), mesh,
                                                   next(it)), v)
    data = SyntheticLM(cfg.vocab, 16, 4, seed=3)
    losses, losses1 = [], []
    for i in range(steps):
        batch = data.batch_at(i)
        gb = make_global_batch(batch, mesh, b_specs)
        sharded, m = step(sharded, gb)
        losses.append(float(m["loss"]))
        state1, m1 = one(state1, make_global_batch(batch, None,
                                                   device="cpu"))
        losses1.append(float(m1["loss"]))
    # the whole parameter vector, normwise: AdamW's early steps move a
    # weight by about lr x sign(g), and a gradient 1e-7 from zero may
    # take either sign on either side
    diff = sum(float((a.full_tensor() - b).double().square().sum())
               for a, b in zip(tree_leaves(sharded["params"]),
                               tree_leaves(state1["params"])))
    norm = sum(float(b.double().square().sum())
               for b in tree_leaves(state1["params"]))
    params_err = (diff / norm) ** 0.5
    # every rank holds the same whole parameters
    whole = [a.full_tensor() for a in tree_leaves(sharded["params"])]
    return {"losses": losses, "losses1": losses1, "params_err": params_err,
            "step": int(sharded["step"].to_local()),
            "whole_sum": float(sum(w.double().sum() for w in whole)),
            "is_dtensor": all(isinstance(t, DTensor) for t in tree_leaves(
                sharded["params"]))}


def _serve_case(mesh, rank_rows):
    """Mesh-aware prefill (deepseek's MoE on its EP path, no drops at
    this size), its caches laid out by the decode's cache specs
    (``shard_cache``) and one decode step against the single-device
    path."""
    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.dist.collectives import distribute
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.serve.step import build_decode, build_prefill, \
        shard_cache
    from repro_torch.train.step import make_ctx

    cfg = get_smoke_config("deepseek-v2-236b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    shape = ShapeSpec("p", 12, 4, "prefill")   # cache_len 12
    prefill, p_specs, b_specs = build_prefill(model, cfg, shape, mesh)
    decode, _, (t_spec, c_specs, _) = build_decode(
        model, cfg, ShapeSpec("d", 12, 4, "decode"), mesh)
    it = iter(tree_leaves(p_specs, is_leaf=is_spec))
    sharded = tree_map(lambda t: distribute(t, mesh, next(it)), params)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 8)))
    from repro_torch.data.pipeline import make_global_batch
    batch = make_global_batch({"tokens": tokens.numpy()}, mesh, b_specs)
    with torch.no_grad():
        logits, cache = prefill(sharded, batch)
        ctx = make_ctx("prefill", cache_len=12)
        want, cache1 = model.prefill(params, tokens, ctx)
        tok = logits.argmax(-1, keepdim=True)
        step_logits, _ = decode(sharded, tok,
                                shard_cache(cache, mesh, c_specs), 8)
        want_step, _ = model.decode_step(
            params, want.argmax(-1, keepdim=True), cache1, 8,
            make_ctx("decode", cache_len=12))
    return {"prefill_err": float((logits - want[rank_rows]).abs().max()),
            "decode_err": float((step_logits - want_step[rank_rows])
                                .abs().max()),
            "same_tokens": bool(torch.equal(
                tok[:, 0], want.argmax(-1)[rank_rows])),
            "batch_rows": bool(torch.equal(
                batch["tokens"].to_local(), tokens[rank_rows])),
            "t_spec": list(t_spec)}


def _world(rank, world, shape, tmp, drop_npz):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.ckpt import checkpoint as CK
        from repro_torch.ckpt.checkpoint import restore_checkpoint, \
            save_checkpoint
        from repro_torch.dist.collectives import distribute

        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        d_idx = mesh.get_coordinate()[0]
        b_loc = 4 // shape[0]
        rows = slice(d_idx * b_loc, (d_idx + 1) * b_loc)
        res = {"coord": list(mesh.get_coordinate())}
        w = _moe_weights(0)
        # no drops: EP (S 16) and, where tp > 1, TP (S 15) via _moe_apply
        res["ep"] = _moe_case(mesh, rows, w, _x(1, 16), _spec(8.0), 0.1)
        if shape[1] > 1:
            res["tp"] = _moe_case(mesh, rows, w, _x(1, 15), _spec(8.0), 0.1)
        res["tp_direct"] = _tp_direct(mesh, rows, w, _x(1, 16), _spec(8.0))
        # capacity drops: the reference's shard_map layout
        z = np.load(drop_npz)
        wd = {k[2:]: z[k] for k in z.files if k.startswith("w_")}
        wt = {k[3:]: z[k] for k in z.files if k.startswith("tw_")}
        tag = f"{shape[0]}x{shape[1]}"
        res["drop_ep"] = _ep_direct(mesh, rank, rows, wd, z["x"],
                                    _spec(1.0, shared=0))
        res["drop_tp"] = _tp_direct(mesh, rows, wt, z["x"],
                                    _spec(1.0, e=6, shared=0))
        res["drop_tag"] = tag
        res["train"] = _train_case(mesh, "stablelm-1.6b", 3)
        res["train_moe"] = _train_case(mesh, "deepseek-v2-236b", 2)
        res["serve"] = _serve_case(mesh, rows)
        # checkpoint: saved on (1, 2), restored onto (2, 1)
        full = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        specs = {"params": {"w": ("data", "model")}}
        if shape == (1, 2):
            # every rank gathers; only the writer makes host copies
            copies, host = [], CK._host
            CK._host = lambda t, copy: (copies.append(copy), host(t, copy))[1]
            try:
                w_dt = distribute(full, mesh, ("data", "model"))
                save_checkpoint(f"{tmp}/../ckpt", 1, {"params": {"w": w_dt}})
                ck = CK.AsyncCheckpointer(f"{tmp}/../ckpt")
                ck.save(2, {"params": {"w": distribute(
                    2 * full, mesh, ("data", "model"))}})
                ck.wait()
            finally:
                CK._host = host
            res["save"] = {"host_copies": copies, "last_saved": ck.last_saved}
        else:
            like = {"params": {"w": torch.empty(8, 8, device="meta")}}
            res["restore"] = {}
            for step, want in ((1, full), (2, 2 * full)):
                got = restore_checkpoint(f"{tmp}/../ckpt", step, like,
                                         mesh=mesh, specs=specs)["params"]["w"]
                res["restore"][str(step)] = {
                    "local_shape": list(got.to_local().shape),
                    "whole_equal": bool(torch.equal(got.full_tensor(), want)),
                    "local_equal": bool(torch.equal(
                        got.to_local(), want[d_idx * 4:(d_idx + 1) * 4]))}
        dist.barrier()
        for k in ("ep", "tp"):
            if k in res:
                np.save(f"{tmp}/{k}_out_{rank}.npy", res[k].pop("out"))
        for k in ("tp_direct", "drop_ep", "drop_tp"):
            np.save(f"{tmp}/{k}_{rank}.npy", res.pop(k))
        with open(f"{tmp}/res_{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _spawn(shape, tmp, drop_npz, timeout=240):
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_world, args=(2, shape, tmp, drop_npz),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the {shape} world did not finish")


# ---------------------------------------------------------------------------
# the reference (this process and one 2-device JAX subprocess)
# ---------------------------------------------------------------------------

_REF_SHARD_MAP = """
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.models.moe import MoESpec, apply_moe_ep, apply_moe_tp
z = dict(np.load(sys.argv[1]))
out = {}
for shape in ((1, 2), (2, 1)):
    mesh = jax.make_mesh(shape, ("data", "model"))
    tag = f"{shape[0]}x{shape[1]}"
    x = jnp.asarray(z["x"])
    for kind, fn, pre in (("ep", apply_moe_ep, "w_"),
                          ("tp", apply_moe_tp, "tw_")):
        p = {k[len(pre):]: jnp.asarray(v) for k, v in z.items()
             if k.startswith(pre)}
        e = p["wi"].shape[0]
        s = MoESpec(d_model=x.shape[-1], n_experts=e, top_k=2,
                    d_ff=p["wi"].shape[-1], capacity_factor=1.0,
                    ep_axis="model")
        if kind == "ep":
            w_specs = {k: P() if k == "router" else P("model", None, None)
                       for k in p}
            x_spec = P("data", "model", None)
        else:
            w_specs = {k: P() if k == "router" else (
                P(None, "model", None) if k == "wo"
                else P(None, None, "model")) for k in p}
            x_spec = P("data", None, None)

        def f(pl, xl, fn=fn, s=s):
            return fn(pl, xl, s)[0]
        out[f"{kind}_{tag}"] = np.asarray(jax.jit(shard_map(
            f, mesh=mesh, in_specs=(w_specs, x_spec), out_specs=x_spec,
            check_rep=False))(p, x))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    w = _moe_weights(5)
    wt = _moe_weights(6, e=6)
    drop = {"x": _x(7, 16)}
    drop.update({f"w_{k}": v for k, v in w.items()
                 if not k.startswith("shared")})
    drop.update({f"tw_{k}": v for k, v in wt.items()
                 if not k.startswith("shared")})
    drop_npz = str(root / "drop.npz")
    np.savez(drop_npz, **drop)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
           "PYTHONPATH": os.pathsep.join(
               [os.path.join(os.path.dirname(__file__), "..", "src"),
                os.environ.get("PYTHONPATH", "")])}
    ref = subprocess.run([sys.executable, "-c", _REF_SHARD_MAP, drop_npz,
                          str(root / "ref.npz")], env=env,
                         capture_output=True, text=True, timeout=240)
    assert ref.returncode == 0, ref.stderr
    out = {}
    for shape in SHAPES:
        tmp = root / f"w{shape[0]}x{shape[1]}"
        tmp.mkdir()
        _spawn(shape, str(tmp), drop_npz)
        res = []
        for r in range(2):
            with open(tmp / f"res_{r}.json") as f:
                res.append(json.load(f))
            for k in ("ep", "tp"):
                if k in res[r]:
                    res[r][k]["out"] = np.load(tmp / f"{k}_out_{r}.npy")
            for k in ("tp_direct", "drop_ep", "drop_tp"):
                res[r][k] = np.load(tmp / f"{k}_{r}.npy")
        out[shape] = res
    out["ref"] = dict(np.load(root / "ref.npz"))
    out["drop"] = drop
    return out


def _dense_reference(w_np, x_np, cf):
    """The reference's dense one-hot ``apply_moe`` on the same weights."""
    import jax.numpy as jnp

    from repro.models.moe import MoESpec, apply_moe

    s = MoESpec(d_model=D, n_experts=w_np["wi"].shape[0], top_k=TOP_K,
                d_ff=F_FF, n_shared=1 if "shared_wi" in w_np else 0,
                capacity_factor=cf)
    out, _ = apply_moe({k: jnp.asarray(v) for k, v in w_np.items()},
                       jnp.asarray(x_np), s)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("kind,seq", [("ep", 16), ("tp", 15)])
def test_moe_mesh_paths_match_dense(worlds, shape, kind, seq):
    if kind == "tp" and shape[1] == 1:
        kind, seq = "tp_direct", 16
    want = _dense_reference(_moe_weights(0), _x(1, seq), 8.0)
    b_loc = 4 // shape[0]
    for r in worlds[shape]:
        d = r["coord"][0]
        got = r[kind]["out"] if kind in ("ep", "tp") else r[kind]
        np.testing.assert_allclose(got, want[d * b_loc:(d + 1) * b_loc],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
def test_moe_tp_direct_call_matches_dense(worlds, shape):
    want = _dense_reference(_moe_weights(0), _x(1, 16), 8.0)
    b_loc = 4 // shape[0]
    for r in worlds[shape]:
        d = r["coord"][0]
        np.testing.assert_allclose(r["tp_direct"],
                                   want[d * b_loc:(d + 1) * b_loc],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("kind", ["ep", "tp"])
def test_moe_drops_match_reference_shard_map(worlds, shape, kind):
    """Capacity 1.0: tokens dropped per shard exactly as the reference's
    shard_map drops them."""
    ref = worlds["ref"][f"{kind}_{shape[0]}x{shape[1]}"]
    pre = "w_" if kind == "ep" else "tw_"
    drop = worlds["drop"]
    dense = _dense_reference({k[len(pre):]: v for k, v in drop.items()
                              if k.startswith(pre)}, drop["x"], 1.0)
    if kind == "ep" or shape[0] > 1:
        # each shard routes fewer tokens: its capacity, and so its drops,
        # differ from the single device's
        assert np.abs(ref - dense).max() > 1e-3
    b_loc, s_loc = 4 // shape[0], 16 // shape[1]
    for r in worlds[shape]:
        d, t = r["coord"]
        got = r[f"drop_{kind}"]
        if kind == "ep":
            want = ref[d * b_loc:(d + 1) * b_loc, t * s_loc:(t + 1) * s_loc]
        else:
            want = ref[d * b_loc:(d + 1) * b_loc]
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("kind", ["ep", "tp"])
def test_moe_mesh_gradients_match_single_device(worlds, shape, kind):
    """The collectives' gradients: every weight's (averaged over the
    data axis) and the input rows', against the single-device path's on
    the same loss, aux included."""
    for r in worlds[shape]:
        if kind not in r:
            assert shape[1] == 1 and kind == "tp"
            continue
        c = r[kind]
        assert c["path"] == (kind if shape[1] > 1 else "ep")
        assert abs(c["aux"] - c["aux_ref"]) < 1e-5
        assert c["grad_err"] < 1e-4 * max(1.0, c["grad_scale"])
        assert c["grad_x_err"] < 1e-4 * max(1.0, c["grad_scale"])


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
def test_sharded_train_step_matches_single_device(worlds, shape):
    for r in worlds[shape]:
        t = r["train"]
        assert t["is_dtensor"] and t["step"] == 3
        np.testing.assert_allclose(t["losses"], t["losses1"], atol=1e-5,
                                   rtol=1e-5)
        assert t["params_err"] < 1e-5
    assert worlds[shape][0]["train"]["whole_sum"] == \
        worlds[shape][1]["train"]["whole_sum"]


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
def test_sharded_moe_train_step_keeps_ranks_consistent(worlds, shape):
    """deepseek's smoke config: the MoE on its mesh path inside the
    sharded step; every rank ends with the same whole parameters.  The
    first loss is the single-device one but for the aux term, which is
    averaged over the shards' own aux losses (as the reference's
    ``pmean``): 0.01 x their difference."""
    a, b = (r["train_moe"] for r in worlds[shape])
    assert a["whole_sum"] == b["whole_sum"]
    assert a["losses"] == b["losses"]
    assert all(np.isfinite(a["losses"]))
    assert abs(a["losses"][0] - a["losses1"][0]) < 0.01


@pytest.mark.parametrize("shape", SHAPES, ids=["1x2", "2x1"])
def test_mesh_prefill_and_decode_match_single_device(worlds, shape):
    for r in worlds[shape]:
        s = r["serve"]
        assert s["batch_rows"]
        assert s["prefill_err"] < 1e-5 and s["decode_err"] < 1e-5
        assert s["same_tokens"]
        assert s["t_spec"] == ["data", None]       # 4 rows divide


def test_checkpoint_saved_on_1x2_restores_onto_2x1(worlds):
    for r in worlds[(2, 1)]:
        for step in ("1", "2"):     # written by save_checkpoint, async
            assert r["restore"][step] == {"local_shape": [4, 8],
                                          "whole_equal": True,
                                          "local_equal": True}


def test_checkpoint_host_copy_on_the_writing_rank_only(worlds):
    """Both ranks take part in each leaf's gather; rank 1 keeps no host
    copy, in the synchronous save and in the async snapshot."""
    r0, r1 = (r["save"] for r in worlds[(1, 2)])
    assert r0 == {"host_copies": [False, True], "last_saved": 2}
    assert r1 == {"host_copies": [], "last_saved": 2}


def test_moe_path_choice():
    """``_moe_apply``'s choice: expert parallelism where the tp size
    divides E and S, else expert TP; a decode step or no mesh takes the
    single-device path (checked on the worlds above by output)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import moe_mesh_layout

    class _Mesh:
        def __init__(self, shape):
            self.mesh_dim_names = tuple(shape)
            self.shape = tuple(shape.values())
            self._sizes = list(shape.values())

        def size(self, i):
            return self._sizes[i]

    ds, mx = get_config("deepseek-v2-236b"), get_config("mixtral-8x22b")
    prod = _Mesh({"data": 16, "model": 16})
    path, w, x = moe_mesh_layout(ds, prod, 4096)
    assert path == "ep" and w["wi"] == ("model", None, None)
    assert w["router"] == () and w["shared_wo"] == ()
    assert x == ("data", "model", None)
    path, w, x = moe_mesh_layout(mx, prod, 4096)
    assert path == "tp" and w["wo"] == (None, "model", None)
    assert w["wg"] == (None, None, "model") and x == ("data", None, None)
    path, _, x = moe_mesh_layout(ds, prod, 4095)            # S % tp
    assert path == "tp"
    path, _, x = moe_mesh_layout(ds, _Mesh({"pod": 2, "data": 16,
                                            "model": 16}), 4096)
    assert path == "ep" and x == (("pod", "data"), "model", None)
