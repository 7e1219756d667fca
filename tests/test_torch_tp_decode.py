"""The decode step on the reference's cache layout, on multi-rank gloo
worlds on the CPU.

A decode step on a mesh takes its caches as DTensors laid out by
``serve.step.cache_specs`` (``shard_cache`` lays a prefill's out so):
a GQA or MLA latent cache cut on its sequence over 'model' is read
split-KV (each rank attends over its own slots, ``softmax_combine``
merges them), any other cut is gathered whole for its layer; the dense
blocks compute on their 'model' shards; the MoE routes the whole batch
onto the experts where they are stored.

Four worlds over ("data", "model"), each spawned once
(``init_method=file://``: no port) and running every case in one go,
one world after another while the reference runs in this process; the
tests below read what the ranks wrote.  The kernels' plain
versions run (CPU tensors).

* (1, 2), (2, 2) and (1, 4): smoke stablelm-1.6b (MHA), granite-8b (2
  KV heads, fewer than 4 ranks), mixtral-8x22b (a ring cache of 32
  slots seeded past its window by a 47-token prompt, so that the
  written slot crosses a shard boundary; MoE), deepseek-v2-236b (MLA's
  latent cache, routed and shared experts), stablelm with the int8
  cache, all with 48 cache slots and an 8-token prompt (positions below
  ``cap / tp``: ranks with no valid slot), and stablelm with 12 slots,
  where the cache specs cut the head dim (16 > 12) and the layer reads
  its cache gathered whole; recurrentgemma-2b (the RG-LRU on its W / tp
  channels, its state read in place where the specs cut it on W; local
  attention over a ring of 32 slots) and xlstm-125m (the mLSTM's matrix
  memory read in place on its key dim, (num, den) summed over 'model';
  the sLSTM on its stored columns of ``w_in``, ``w_rec`` and ``b``, its
  state gathered whole) and starcoder2-3b with 3 heads, 1 KV head and
  D 96 (heads the axis does not divide: the decode projects on the
  stored columns of ``wq``, ``wk`` and ``wv``, 1.5 query heads and half
  the KV head a rank on 2 ranks, gathers the projections and applies
  RoPE after the gather, and leaves through ``wo``'s stored rows), and
  granite with 1 KV head (4 heads the axis divides, a KV head it does
  not: the decode projects on the stored columns of ``wk`` and ``wv``,
  half or a quarter of the KV head a rank, as granite's 2 and mixtral's
  2 KV heads on 4 ranks and recurrentgemma's 1 do);
  (1, 4) also recurrentgemma-2b with 2 heads (fewer than the ranks: its
  local attention on the stored columns beside the RG-LRU); (2, 2) also
  mixtral with 3 experts, which 2 'data' ranks do not divide: each
  data rank runs the grouped GEMMs on its half of every expert's slot
  rows (``moe.slot_block``) and the halves are gathered;
* (2, 1): the MoE's decode capacity over the global batch: smoke
  deepseek at batch 16, ten rows with one prompt (five a rank), so that
  an expert takes ten (token, choice) pairs at the global capacity 8
  (the reference drops two) while a rank's eight rows cannot overflow
  its own;
* (4, 1): mixtral with 2 experts on 4 'data' ranks (gcd 2: a rank runs
  one expert on half its slot rows), at batch 4 (a row a rank) and at
  batch 1 (the batch whole on every rank).

Each rank: the port's single-device prefill of the whole batch on the
reference's weights (carried across by ``convert.params_from_jax``),
its rows of the caches through ``shard_cache``, then ``STEPS`` greedy
steps of the built mesh decode (for deepseek, recurrentgemma, xlstm,
the uneven heads and KV heads and the split MoE the first one watched:
the local shapes of the MLA and shared-expert weights, of the recurrent
mixers' weights and states, or of the attention weights, the rank
computes with, the all-gathers of a layer's q, k and v, the MoE's
buckets and the grouped GEMMs' inputs, and the step's collectives by
``CommDebugMode``).  Held against
the JAX reference's ``prefill`` and ``decode_step`` on the whole batch:
logits within ``LOGIT_TOL`` (1e-5, fp32) at every step, the greedy
tokens equal, and each rank holding ``cap / tp`` slots of every split
cache.

Without a world: ``softmax_combine_local`` over 1 to 8 chunks of a
cache, some with no valid slot, against one softmax (``COMBINE_TOL``);
the production cache specs on the (16, 16) mesh: every decoder LM's
decode_32k and long_500k GQA, ring and MLA latent caches cut their
sequence over 'model', K, V and the int8 scales alike, and the RG-LRU's
state its W and the mLSTM's matrix memory its key dim; the slot-row
blocks of ``moe.slot_block`` and mixtral's production buckets a rank;
the decode layout of the four archs whose KV heads 16 does not divide,
and no weight a production decode step gathers whole.
"""

import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import pytest
import torch
from test_torch_tp import RECURRENT_LOGGED, recurrent_shapes

pytestmark = pytest.mark.timeout(400)

BATCH, PROMPT, CACHE_LEN, STEPS = 4, 8, 48, 3
LOGIT_TOL = 1e-5
COMBINE_TOL = 1e-6
#: (case id, arch, config overrides, prompt, cache_len, int8 cache)
CASES = [
    ("stablelm", "stablelm-1.6b", {}, PROMPT, CACHE_LEN, False),
    ("granite", "granite-8b", {}, PROMPT, CACHE_LEN, False),
    ("mixtral", "mixtral-8x22b", {}, 47, 56, False),
    ("deepseek", "deepseek-v2-236b", {}, PROMPT, CACHE_LEN, False),
    ("stablelm-int8", "stablelm-1.6b", {}, PROMPT, CACHE_LEN, True),
    ("stablelm-dh-cut", "stablelm-1.6b", {}, PROMPT, 12, False),
    ("recurrentgemma", "recurrentgemma-2b", {}, PROMPT, CACHE_LEN, False),
    ("xlstm", "xlstm-125m", {}, PROMPT, CACHE_LEN, False),
    ("starcoder2-split", "starcoder2-3b",
     {"n_heads": 3, "n_kv_heads": 1, "d_model": 96}, PROMPT, CACHE_LEN,
     False),
    ("granite-kv1", "granite-8b", {"n_kv_heads": 1}, PROMPT, CACHE_LEN,
     False),
]
#: recurrentgemma with fewer heads than the (1, 4) world's ranks
FEW_HEADS = ("recurrentgemma-h2", "recurrentgemma-2b", {"n_heads": 2},
             PROMPT, CACHE_LEN, False)
#: the cases whose heads the 'model' axis does not divide
UNEVEN = ("starcoder2-split", "recurrentgemma-h2")
#: the overflow case: batch 16, rows with one prompt
OVERFLOW = ("overflow", "deepseek-v2-236b", {}, PROMPT, CACHE_LEN, False)
OVERFLOW_BATCH = 16
OVERFLOW_SAME = (0, 1, 2, 3, 4, 8, 9, 10, 11, 12)
#: the MoE's slot rows split over 'data' ranks that do not cut the
#: experts: 3 experts on 2 (2, 2), 2 experts on 4 (4, 1) with the batch
#: cut and whole
SPLIT_E3 = ("mixtral-e3", "mixtral-8x22b", {"n_experts": 3}, 47, 56, False)
SPLIT_E2 = ("mixtral-e2", "mixtral-8x22b", {"n_experts": 2}, 47, 56, False)
SPLIT_B1 = ("mixtral-e2-b1", "mixtral-8x22b", {"n_experts": 2}, 47, 56,
            False)
MOE_SPLIT = ("mixtral-e3", "mixtral-e2", "mixtral-e2-b1")
WORLDS = {(1, 2): CASES, (2, 2): CASES + [SPLIT_E3],
          (1, 4): CASES + [FEW_HEADS], (2, 1): [OVERFLOW],
          (4, 1): [SPLIT_E2, SPLIT_B1]}
ALL_CASES = CASES + [FEW_HEADS, OVERFLOW, SPLIT_E3, SPLIT_E2, SPLIT_B1]


#: the weights a deepseek rank's decode step logs: MLA's four on 'heads',
#: two of its latent projections, the shared experts
MLA_LOGGED = ("wq_b", "wk_b", "wv_b", "wo", "wq_a", "wkv_a")
SHARED_LOGGED = ("shared_wi", "shared_wg", "shared_wo")
#: the archs whose recurrent mixers a rank's first decode step logs: the
#: weights of RECURRENT_LOGGED by the mixer's kind, and the state it is
#: given
RECURRENT = ("recurrentgemma-2b", "xlstm-125m")


def _batch(case) -> int:
    return {"overflow": OVERFLOW_BATCH, "mixtral-e2-b1": 1}.get(case[0],
                                                               BATCH)


def _rows_of(case, n_dp: int, i: int) -> slice:
    """The rows a rank at data index ``i`` holds: its block where the
    'data' axis divides the batch, else every row."""
    b = _batch(case)
    if b % n_dp:
        return slice(0, b)
    return slice(i * (b // n_dp), (i + 1) * (b // n_dp))


def _kv_cols(cfg, tp: int) -> bool:
    """Does a GQA decode step on a ``tp``-way 'model' axis take the stored
    columns of ``wk`` and ``wv`` where the axis divides the heads but not
    the KV heads?"""
    return cfg.attn_kind != "mla" and tp > 1 and cfg.n_heads % tp == 0 \
        and cfg.n_kv_heads % tp != 0


def _tokens(case) -> np.ndarray:
    cid, arch, over, prompt, _, _ = case
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 256, (_batch(case), prompt))
    if cid == "overflow":
        tokens[list(OVERFLOW_SAME)] = tokens[0]
    return tokens


# ---------------------------------------------------------------------------
# the ranks' work (runs in spawned processes: imports no jax)
# ---------------------------------------------------------------------------

class _Int8:
    """``ADSALA_KV_INT8`` set (or not) while the contexts are made."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.old = os.environ.pop("ADSALA_KV_INT8", None)
        if self.on:
            os.environ["ADSALA_KV_INT8"] = "1"

    def __exit__(self, *exc):
        os.environ.pop("ADSALA_KV_INT8", None)
        if self.old is not None:
            os.environ["ADSALA_KV_INT8"] = self.old


def _local_slots(cache, states: bool = False) -> list:
    """Per attention layer (with ``states``, per recurrent layer):
    {field: local shape} of its DTensors."""
    from repro_torch.models.layers import KVCache
    from repro_torch.models.mla import MLACache

    out = []
    for c in cache:
        if isinstance(c, (KVCache, MLACache)) != states:
            out.append({f.name: list(getattr(c, f.name).to_local().shape)
                        for f in dataclasses.fields(c)
                        if isinstance(getattr(c, f.name), torch.Tensor)})
    return out


def _spec_dim(spec: tuple, axis: str = "model") -> int | None:
    """The dim a spec cuts over ``axis``, or None."""
    for d, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return d
    return None


def _decode_gathers(model, cfg, mesh, p_specs, c_specs) -> list[str]:
    """What a decode step all-gathers through DTensor: the weights
    stored cut over 'model' and computed whole (``forward_specs``), and
    the cache tensors cut over 'model' that it does not read in place
    (an attention cache cut on its sequence, a cut mixer's state on the
    dim the layer computes on: ``state_slices``)."""
    from repro_torch.models.moe import is_expert_weight
    from repro_torch.models.params import is_spec, tree_leaves, tree_paths
    from repro_torch.models.transformer import state_slices
    from repro_torch.serve.step import forward_specs

    paths = tree_paths(model.defs)
    out = ["/".join(map(str, path)) for path, stored, at in zip(
        paths, tree_leaves(p_specs, is_leaf=is_spec),
        forward_specs(paths, mesh, keep_experts=True, model=model,
                      decode=True))
        if at == () and _spec_dim(stored) is not None
        and not is_expert_weight(path)]
    tp = mesh.size(1)
    for i, (spec, s) in enumerate(zip(c_specs, model.plan)):
        cuts = state_slices(cfg, s.kind, tp)
        dims = {f.name: _spec_dim(getattr(spec, f.name))
                for f in dataclasses.fields(spec)
                if isinstance(getattr(spec, f.name), tuple)}
        split = s.kind in ("attn", "local") and set(dims.values()) == {1}
        out += [f"cache/{i}/{name}" for name, d in dims.items()
                if d is not None and not split and cuts.get(name) != d]
    return out


def _spy(log: dict):
    """Patch GQA's and MLA's decode, the MoE's shared experts and the
    recurrent mixers' decode steps to log the local shapes of the
    weights (and a mixer's state) they are given; returns the undo."""
    from repro_torch.models import layers as L
    from repro_torch.models import mla as MLA
    from repro_torch.models import moe as MOE
    from repro_torch.models import recurrent as REC
    from repro_torch.models import xlstm as XL

    mixers = {"rglru": (REC, "rglru_block_decode", 2),
              "mlstm": (XL, "mlstm_decode", 3),
              "slstm": (XL, "slstm_decode", 3)}
    orig_mixers = {k: getattr(m, n) for k, (m, n, _) in mixers.items()}

    def logged(kind):
        def call(p, *a, **k):
            for n in RECURRENT_LOGGED[kind]:
                log.setdefault(f"{kind}.{n}", set()).add(tuple(p[n].shape))
            state = a[mixers[kind][2] - 1]
            for f in dataclasses.fields(state):
                log.setdefault(f"{kind}.state.{f.name}", set()).add(
                    tuple(getattr(state, f.name).shape))
            return orig_mixers[kind](p, *a, **k)
        return call

    for kind, (module, name, _) in mixers.items():
        setattr(module, name, logged(kind))
    orig = (MLA.mla_decode, MOE._shared_ffn, L.attention_decode)

    def attention_decode(p, *a, **k):
        for n in ("wq", "wk", "wv", "wo"):
            log.setdefault(f"attn.{n}", set()).add(tuple(p[n].shape))
        return orig[2](p, *a, **k)

    def mla_decode(p, *a, **k):
        for n in MLA_LOGGED:
            log.setdefault(f"mla.{n}", set()).add(tuple(p[n].shape))
        return orig[0](p, *a, **k)

    def shared_ffn(p, *a, **k):
        for n in SHARED_LOGGED:
            log.setdefault(n, set()).add(tuple(p[n].shape))
        return orig[1](p, *a, **k)

    MLA.mla_decode, MOE._shared_ffn, L.attention_decode = \
        mla_decode, shared_ffn, attention_decode
    undo_qkv = spy_qkv(log)

    def undo():
        MLA.mla_decode, MOE._shared_ffn, L.attention_decode = orig
        for kind, (module, name, _) in mixers.items():
            setattr(module, name, orig_mixers[kind])
        undo_qkv()
    return undo


def spy_qkv(log: dict):
    """Patch a decode layer's q, k, v projection to log how many
    all-gathers it makes (``qkv_gathers``); returns the undo."""
    from repro_torch.dist import collectives as C
    from repro_torch.models import layers as L

    orig_qkv, orig_gather = L._decode_qkv, C.all_gather

    def decode_qkv(*a, **k):
        n = [0]

        def gather(*ga, **gk):
            n[0] += 1
            return orig_gather(*ga, **gk)
        C.all_gather = gather
        try:
            return orig_qkv(*a, **k)
        finally:
            C.all_gather = orig_gather
            log.setdefault("qkv_gathers", set()).add(n[0])

    L._decode_qkv = decode_qkv

    def undo():
        L._decode_qkv = orig_qkv
    return undo


def spy_moe(seen: list):
    """Patch the MoE's dispatch and the grouped GEMM to append, per MoE
    layer, [the dispatched buckets (E, C, D), the ``moe.wi`` product's
    input and its weight's local shape]; returns the undo."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE

    orig_dispatch, orig_gm = MOE._dispatch, ops.grouped_matmul

    def dispatch(*a, **k):
        out = orig_dispatch(*a, **k)
        seen.append([out[0].clone()])
        return out

    def grouped_matmul(x, w, *a, **k):
        if k.get("site") == "moe.wi":
            seen[-1] += [x.clone(), list(w.shape)]
        return orig_gm(x, w, *a, **k)

    MOE._dispatch, ops.grouped_matmul = dispatch, grouped_matmul

    def undo():
        MOE._dispatch, ops.grouped_matmul = orig_dispatch, orig_gm
    return undo


def save_moe(seen: list, path: str) -> list:
    """The buckets and blocks of :func:`spy_moe` saved to ``path``
    (npz); returns the weights' local shapes, a layer each."""
    arrays = {}
    for i, (buckets, block, _) in enumerate(seen):
        arrays[f"buckets_{i}"] = buckets.numpy()
        arrays[f"block_{i}"] = block.numpy()
    np.savez(path, **arrays)
    return [w for _, _, w in seen]


def check_moe_blocks(ranks: list, n_experts: int, tp: int, load) -> None:
    """Each rank's ``moe.wi`` input (``load(rank)``: its npz of
    :func:`save_moe`) is its :func:`~repro_torch.models.moe.slot_block`
    of the buckets every rank dispatched alike, the 'data' axis (the
    ranks of one 'model' index) splitting the slot rows over its n
    ranks where it does not cut the experts; over those ranks the
    blocks cover every slot row of every layer once."""
    from repro_torch.models.moe import slot_block

    n = len(ranks) // tp
    n = n if n_experts % n else 1
    seen = [load(r) for r in range(len(ranks))]
    n_layers = len([k for k in seen[0].files if k.startswith("block_")])
    assert n_layers > 0
    for i in range(n_layers):
        buckets = seen[0][f"buckets_{i}"]
        e, cap, d = buckets.shape
        for z in seen:
            np.testing.assert_array_equal(z[f"buckets_{i}"], buckets)
        rows = slot_block(e, cap, n, 0)[3]
        padded = np.zeros((e, rows * (n // math.gcd(e, n)), d),
                          buckets.dtype)
        padded[:, :cap] = buckets
        count = np.zeros(padded.shape[:2], int)
        for r, z in enumerate(seen):
            e_lo, e_hi, c_lo, c_hi = slot_block(e, cap, n,
                                                ranks[r][0] if n > 1 else 0)
            block = z[f"block_{i}"]
            assert block.shape == (e_hi - e_lo, c_hi - c_lo, d)
            np.testing.assert_array_equal(block,
                                          padded[e_lo:e_hi, c_lo:c_hi])
            if ranks[r][1] == 0:
                count[e_lo:e_hi, c_lo:c_hi] += 1
        assert (count == 1).all(), count


def _case(mesh, tmp: str, case) -> dict:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.dist.collectives import distribute, row_index
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.serve.step import _map_arrays, build_decode, \
        shard_cache
    from repro_torch.train.step import make_ctx

    cid, arch, over, prompt, cache_len, int8 = case
    batch = _batch(case)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    model = build_model(cfg)
    params = torch.load(f"{tmp}/../ref_{cid}.pt")["params"]
    with _Int8(int8):
        decode, p_specs, (t_spec, c_specs, _) = build_decode(
            model, cfg, ShapeSpec("d", cache_len, batch, "decode"), mesh)
        pctx = make_ctx("prefill", cache_len=cache_len)
        dctx = make_ctx("decode", cache_len=cache_len)
    it = iter(tree_leaves(p_specs, is_leaf=is_spec))
    sharded = tree_map(lambda t: distribute(t, mesh, next(it)), params)
    rows = _rows_of(case, mesh.size(0), row_index(mesh, ("data",)))
    spied = cfg.attn_kind == "mla" or arch in RECURRENT or cid in UNEVEN \
        or _kv_cols(cfg, mesh.size(1)) or cid in MOE_SPLIT
    moe_seen, moe_w = [], None
    with torch.no_grad():
        logits, whole = model.prefill(
            params, torch.from_numpy(_tokens(case)), pctx)
        mine = _map_arrays(lambda t: t[rows].clone(), whole)
        cache = shard_cache(mine, mesh, c_specs)
        before = _local_slots(cache)
        states_before = _local_slots(cache, states=True)
        tok = logits[rows].argmax(-1, keepdim=True)
        first = tok[:, 0].tolist()
        plain = None
        if arch in RECURRENT:
            # the rows-whole caches as plain tensors: each cut state is
            # narrowed to the rank's slice and its update gathered back
            plain = decode(sharded, tok, _map_arrays(
                lambda t: t.clone(), mine), prompt)[0]
        out_logits, out_tokens, own_rows = [], [], None
        log, comm = {}, None
        for s in range(STEPS):
            if cid == "overflow" and s == 0:
                # a decode whose MoE counts the rank's rows only: the
                # single-device path on them
                own = _map_arrays(lambda t: t.clone(), mine)
                own_rows = model.decode_step(params, tok, own, prompt,
                                           dctx)[0].numpy()
            if spied and s == 0:
                undo, undo_moe = _spy(log), spy_moe(moe_seen)
                try:
                    with CommDebugMode() as mode:
                        step_logits, cache = decode(sharded, tok, cache,
                                                    prompt)
                finally:
                    undo()
                    undo_moe()
                comm = {str(k): v for k, v in mode.get_comm_counts().items()}
                if cid in MOE_SPLIT:
                    moe_w = save_moe(moe_seen, f"{tmp}/moe_{cid}_"
                                     f"{mesh.get_rank()}.npz")
            else:
                step_logits, cache = decode(sharded, tok, cache,
                                            prompt + s)
            out_logits.append(step_logits.numpy())
            tok = step_logits.argmax(-1, keepdim=True)
            out_tokens.append(tok[:, 0].tolist())
    leaves = []
    _map_arrays(leaves.append, cache)
    np.save(f"{tmp}/logits_{cid}_{mesh.get_rank()}.npy",
            np.stack(out_logits))
    if own_rows is not None:
        np.save(f"{tmp}/own_rows_{cid}_{mesh.get_rank()}.npy", own_rows)
    return {"rows": [rows.start, rows.stop], "first": first,
            "tokens": out_tokens, "t_spec": list(t_spec),
            "slots_before": before, "slots_after": _local_slots(cache),
            "states_before": states_before,
            "states_after": _local_slots(cache, states=True),
            "expect_gathered": _decode_gathers(model, cfg, mesh, p_specs,
                                               c_specs),
            "all_dtensors": all(isinstance(t, DTensor) for t in leaves),
            "weights": {k: sorted(v) for k, v in log.items()},
            "comm": comm, "moe_weights": moe_w,
            "plain_err": None if plain is None else
            float((plain.numpy() - out_logits[0]).__abs__().max())}


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
        for case in WORLDS[shape]:
            res[case[0]] = _case(mesh, tmp, case)
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


# ---------------------------------------------------------------------------
# the reference (this process), then the worlds
# ---------------------------------------------------------------------------

def _reference_model(case):
    import jax

    from repro.configs import build_model as jax_build_model
    from repro.configs import get_smoke_config as jax_smoke_config

    cid, arch, over, prompt, cache_len, int8 = case
    jcfg = dataclasses.replace(jax_smoke_config(arch), **over)
    jm = jax_build_model(jcfg)
    return jm, jm.init(jax.random.PRNGKey(0))


def _reference(case, jm, jp) -> dict:
    """The reference's prefill's greedy tokens and its decode steps'
    logits and greedy tokens on the whole batch."""
    import jax.numpy as jnp

    from repro.train.step import make_ctx as jax_make_ctx

    cid, arch, over, prompt, cache_len, int8 = case
    with _Int8(int8):
        pctx = jax_make_ctx(None, "prefill", cache_len=cache_len,
                            remat=False)
        dctx = jax_make_ctx(None, "decode", cache_len=cache_len)
    logits, cache = jm.prefill(jp, jnp.asarray(_tokens(case), jnp.int32),
                               pctx)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    first = np.asarray(tok[:, 0])
    steps, tokens = [], []
    for s in range(STEPS):
        logits, cache = jm.decode_step(jp, tok, cache, jnp.int32(prompt + s),
                                       dctx)
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok[:, 0]))
    return {"first": first, "logits": np.stack(steps),
            "tokens": np.stack(tokens)}


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


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's weights saved for the ranks, the worlds run one
    after another in a thread while the reference's decode runs here,
    then the ranks' results read back."""
    import threading

    import jax

    from repro_torch.convert import params_from_jax

    root = tmp_path_factory.mktemp("tp_decode")
    models = {}
    for case in ALL_CASES:
        jm, jp = models[case[0]] = _reference_model(case)
        torch.save({"params": params_from_jax(jax.tree.map(np.asarray, jp))},
                   root / f"ref_{case[0]}.pt")
    errors: list = []
    runner = threading.Thread(target=_run_worlds, args=(root, errors),
                              daemon=True)
    runner.start()
    out = {"ref": {case[0]: _reference(case, *models[case[0]])
                   for case in ALL_CASES}, "root": root}
    runner.join(timeout=len(WORLDS) * 300)
    assert not runner.is_alive(), "the worlds did not finish"
    if errors:
        raise errors[0]
    for shape in WORLDS:
        tmp = root / f"w{shape[0]}x{shape[1]}"
        res = []
        for r in range(shape[0] * shape[1]):
            with open(tmp / f"res_{r}.json") as f:
                got = json.load(f)
            for case in WORLDS[shape]:
                cid = case[0]
                got[cid]["logits"] = np.load(tmp / f"logits_{cid}_{r}.npy")
                if cid == "overflow":
                    got[cid]["own_rows"] = np.load(
                        tmp / f"own_rows_{cid}_{r}.npy")
            res.append(got)
        out[shape] = res
    return out


def _ids(item):
    shape, case = item
    return f"{shape[0]}x{shape[1]}-{case[0]}"


ITEMS = [(shape, case) for shape, cases in WORLDS.items()
         for case in cases]


def _cap(case) -> int:
    """The slots of the case's attention caches: mixtral's and
    recurrentgemma's rings hold their window of 32."""
    return 32 if case[1] in ("mixtral-8x22b", "recurrentgemma-2b") \
        else case[4]


def _cut(case, tp: int) -> str:
    """Which dim the cache specs cut over a ``tp``-way 'model' axis."""
    return "head_dim" if case[0] == "stablelm-dh-cut" and tp > 1 \
        else "sequence"


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("item", ITEMS, ids=_ids)
def test_mesh_decode_matches_reference(worlds, item):
    """STEPS greedy steps of the built mesh decode against the
    reference's ``decode_step`` on the whole batch: every step's logits
    within LOGIT_TOL (fp32), the prefill's and every step's greedy
    tokens equal."""
    shape, case = item
    ref = worlds["ref"][case[0]]
    for r in worlds[shape]:
        got = r[case[0]]
        rows = slice(*got["rows"])
        assert got["first"] == ref["first"][rows].tolist()
        for s in range(STEPS):
            np.testing.assert_allclose(got["logits"][s],
                                       ref["logits"][s][rows],
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
            assert got["tokens"][s] == ref["tokens"][s][rows].tolist()


@pytest.mark.parametrize("item", ITEMS, ids=_ids)
def test_mesh_decode_keeps_the_cache_layout(worlds, item):
    """The decode takes and returns the caches as DTensors in the specs'
    layout: each rank holds ``cap / tp`` slots of every GQA and MLA
    cache cut on its sequence (K, V and the int8 scales alike) and its
    rows of the batch; the head-dim cut keeps the sequence whole; the
    recurrent states keep their local shapes, the RG-LRU's h and conv
    cut on W and the mLSTM's c and n on their key dim.  A batch the
    'data' axis does not divide (batch 1) is whole on every rank."""
    from repro_torch.configs import get_smoke_config

    shape, case = item
    n_dp, tp = shape
    cid, arch, over, prompt, cache_len, int8 = case
    cfg = get_smoke_config(arch)
    whole = _batch(case) % n_dp != 0
    b_loc = _batch(case) if whole else _batch(case) // n_dp
    for r in worlds[shape]:
        got = r[cid]
        assert got["all_dtensors"]
        assert got["slots_before"] == got["slots_after"]
        assert got["states_before"] == got["states_after"]
        assert got["t_spec"] == [None if whole else "data", None]
        assert got["slots_after"] or got["states_after"]
        for layer in got["slots_after"]:
            if int8:
                assert set(layer) == {"k", "v", "k_scale", "v_scale"}
            for name, local in layer.items():
                assert local[0] == b_loc, name
                if _cut(case, tp) == "sequence":
                    assert local[1] == _cap(case) // tp, (name, local)
                else:
                    assert local[1] == cache_len, (name, local)
                    assert local[3] == 16 // tp, (name, local)
        dh = 2 * cfg.d_model // cfg.n_heads
        for layer in got["states_after"]:
            assert all(local[0] == b_loc for local in layer.values())
            if "conv" in layer:
                assert layer["h"][1] == cfg.lru_width // tp
                assert layer["conv"][2] == cfg.lru_width // tp
            elif "c" in layer and len(layer["c"]) == 4:
                assert layer["c"][2] == layer["n"][2] == dh // tp


DEEPSEEK_ITEMS = [i for i in ITEMS if i[1][1] == "deepseek-v2-236b"]


@pytest.mark.parametrize("item", DEEPSEEK_ITEMS, ids=_ids)
def test_deepseek_decode_computes_on_its_heads_and_ff(worlds, item):
    """A deepseek rank's mesh decode step computes MLA on its whole
    heads (its columns of ``wq_b``, ``wk_b``, ``wv_b`` and rows of
    ``wo``; the latent projections whole) and the shared experts on its
    FF slice, and gathers no weight: ``CommDebugMode`` sees no DTensor
    redistribution (a functional all-gather) in the step; its all-gathers
    are the model's own, among them each MLA layer's absorbed query
    (and rope) over 'model'."""
    from repro_torch.configs import get_smoke_config

    shape, case = item
    tp = shape[1]
    cfg = get_smoke_config(case[1])
    h, d = cfg.n_heads // tp, cfg.d_model
    ff = cfg.n_shared_experts * cfg.d_ff_expert // tp
    want = {"mla.wq_b": (cfg.q_lora_rank, h * cfg.resolved_head_dim),
            "mla.wk_b": (cfg.kv_lora_rank, h * cfg.qk_nope_dim),
            "mla.wv_b": (cfg.kv_lora_rank, h * cfg.v_head_dim),
            "mla.wo": (h * cfg.v_head_dim, d),
            "mla.wq_a": (d, cfg.q_lora_rank),
            "mla.wkv_a": (d, cfg.kv_lora_rank),
            "shared_wi": (d, ff), "shared_wg": (d, ff),
            "shared_wo": (ff, d)}
    for r in worlds[shape]:
        got = r[case[0]]
        assert got["weights"] == {k: [list(v)] for k, v in want.items()}
        comm = got["comm"]
        assert not any("functional" in k for k in comm), comm
        assert comm.get("c10d._allgather_base_", 0) >= cfg.n_layers, comm


RECURRENT_ITEMS = [i for i in ITEMS if i[1][1] in RECURRENT]


@pytest.mark.parametrize("item", RECURRENT_ITEMS, ids=_ids)
def test_recurrent_decode_computes_on_its_widths(worlds, item):
    """A recurrentgemma or xlstm rank's mesh decode step computes the
    RG-LRU on its W / tp channels (its columns of ``wx``, ``wy`` and the
    conv, its ``lam``, its rows of the gates and ``wo``) on its slice of
    the state, the mLSTM's projections on their widths on its key dims
    of the matrix memory, the sLSTM on its stored columns of ``w_in``,
    ``w_rec`` and ``b`` with its state whole; and ``CommDebugMode`` sees
    DTensor gather only what the layout gathers (``_decode_gathers``):
    no RG-LRU or xLSTM weight, no RG-LRU state, no mLSTM ``c`` or ``n``
    (recurrentgemma's attention weights where its heads stay whole or
    its KV heads are picked; the mLSTM's ``m`` where 'model' cuts its
    heads; the sLSTM's state).  The same first step from the rows-whole
    caches as plain tensors (each cut state narrowed to the rank's
    slice, its update gathered back) gives the same logits."""
    from repro_torch.configs import build_model, get_smoke_config

    shape, case = item
    n_dp, tp = shape
    cfg = get_smoke_config(case[1])
    table = recurrent_shapes(cfg, tp, rows=BATCH // n_dp)
    plan = build_model(cfg).plan
    want = {k: [list(v)] for k, v in table.items()}
    recurrent = {str(i) for i, s in enumerate(plan)
                 if s.kind in RECURRENT_LOGGED}
    in_place = {f"cache/{i}/{n}" for i, s in enumerate(plan)
                for n in {"rglru": ("h", "conv"),
                          "mlstm": ("c", "n")}.get(s.kind, ())}
    for r in worlds[shape]:
        got = r[case[0]]
        assert {k: v for k, v in got["weights"].items()
                if k.split(".")[0] in RECURRENT_LOGGED} == want
        expect = got["expect_gathered"]
        assert in_place and not in_place & set(expect), expect
        for name in expect:
            parts = name.split("/")
            assert parts[0] != "layers" or parts[1] not in recurrent, name
        comm = got["comm"]
        functional = sum(v for k, v in comm.items()
                         if "functional" in k and "all_gather" in k)
        assert functional == len(expect), (comm, expect)
        # the same first step from plain rows-whole caches
        assert got["plain_err"] <= LOGIT_TOL, got["plain_err"]


UNEVEN_ITEMS = [i for i in ITEMS if i[1][0] in UNEVEN]


@pytest.mark.parametrize("item", UNEVEN_ITEMS, ids=_ids)
def test_uneven_heads_decode_takes_the_stored_columns(worlds, item):
    """Where the 'model' axis does not divide the heads, a rank's mesh
    decode step projects on its stored columns of ``wq``, ``wk`` and
    ``wv`` (H x Dh / tp and Hkv x Dh / tp: a cut that ends inside a
    head) and leaves through its stored rows of ``wo``, and
    ``CommDebugMode`` sees DTensor gather no attention weight: only what
    the layout gathers (``_decode_gathers``: nothing at all for
    starcoder2; recurrentgemma's is recurrent_decode's)."""
    from repro_torch.configs import build_model, get_smoke_config

    shape, case = item
    tp = shape[1]
    cfg = dataclasses.replace(get_smoke_config(case[1]), **case[2])
    hd = cfg.resolved_head_dim
    q, kv = cfg.n_heads * hd // tp, cfg.n_kv_heads * hd // tp
    assert cfg.n_heads % tp and q % hd      # the cut ends inside a head
    d = cfg.d_model
    want = {"attn.wq": [[d, q]], "attn.wk": [[d, kv]], "attn.wv": [[d, kv]],
            "attn.wo": [[q, d]]}
    attn = {str(i) for i, s in enumerate(build_model(cfg).plan)
            if s.kind in ("attn", "local")}
    for r in worlds[shape]:
        got = r[case[0]]
        assert {k: v for k, v in got["weights"].items()
                if k.startswith("attn.")} == want
        expect = got["expect_gathered"]
        assert not any(n.split("/")[1] in attn for n in expect
                       if n.startswith("layers/")), expect
        if case[1] == "starcoder2-3b":
            assert expect == []
        functional = sum(v for k, v in got["comm"].items()
                         if "functional" in k and "all_gather" in k)
        assert functional == len(expect), (got["comm"], expect)


def _case_cfg(case):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(case[1]), **case[2])


KV_COLS_ITEMS = [i for i in ITEMS if _kv_cols(_case_cfg(i[1]), i[0][1])]


@pytest.mark.parametrize("item", KV_COLS_ITEMS, ids=_ids)
def test_uneven_kv_heads_decode_takes_the_stored_columns(worlds, item):
    """Where the 'model' axis divides the heads but not the KV heads
    (granite with 1 KV head on 2 and 4 ranks, granite's and mixtral's 2
    and recurrentgemma's 1 on 4), a rank's mesh decode step projects on
    its stored columns of ``wq``, ``wk`` and ``wv`` (Hkv x Dh / tp of
    ``wk`` and ``wv``: a cut inside a KV head) and leaves through its
    stored rows of ``wo``; each layer's q, k and v take three
    all-gathers, as the picked KV heads did; and ``CommDebugMode`` sees
    DTensor gather no attention weight (``_decode_gathers`` lists no
    ``wk`` or ``wv``)."""
    from repro_torch.configs import build_model, get_smoke_config

    shape, case = item
    tp = shape[1]
    cfg = dataclasses.replace(get_smoke_config(case[1]), **case[2])
    hd = cfg.resolved_head_dim
    q, kv = cfg.n_heads * hd // tp, cfg.n_kv_heads * hd // tp
    assert kv % hd                          # the cut ends inside a KV head
    d = cfg.d_model
    want = {"attn.wq": [[d, q]], "attn.wk": [[d, kv]], "attn.wv": [[d, kv]],
            "attn.wo": [[q, d]]}
    attn = {str(i) for i, s in enumerate(build_model(cfg).plan)
            if s.kind in ("attn", "local")}
    for r in worlds[shape]:
        got = r[case[0]]
        assert {k: v for k, v in got["weights"].items()
                if k.startswith("attn.")} == want
        assert got["weights"]["qkv_gathers"] == [3]
        expect = got["expect_gathered"]
        assert not any(n.split("/")[1] in attn for n in expect
                       if n.startswith("layers/")), expect
        functional = sum(v for k, v in got["comm"].items()
                         if "functional" in k and "all_gather" in k)
        assert functional == len(expect), (got["comm"], expect)


@pytest.mark.parametrize("item", ITEMS, ids=_ids)
def test_decode_gathers_no_kv_projection(worlds, item):
    """No case's decode step gathers ``wk`` or ``wv`` whole: each layer
    takes them where they are stored or on its whole KV heads."""
    shape, case = item
    for r in worlds[shape]:
        assert not [n for n in r[case[0]]["expect_gathered"]
                    if n.split("/")[-1] in ("wk", "wv")]


MOE_SPLIT_ITEMS = [i for i in ITEMS if i[1][0] in MOE_SPLIT]


@pytest.mark.parametrize("item", MOE_SPLIT_ITEMS, ids=_ids)
def test_moe_decode_splits_the_slot_rows(worlds, item):
    """Where the 'data' axis does not cut the experts (3 experts on 2
    ranks, 2 on 4, the batch cut and whole), a rank's grouped GEMMs in
    a decode step see its block of the slot rows only: its ``wi``
    input is its ``slot_block`` of the buckets (the same on every rank:
    the whole batch routed at the global capacity), its weights those
    block's experts on its FF slice, and over the 'data' ranks the
    blocks cover every slot row once."""
    shape, case = item
    n_dp, tp = shape
    cfg_e = case[2]["n_experts"]
    ranks = [r["coord"] for r in worlds[shape]]
    root = worlds["root"] / f"w{n_dp}x{tp}"
    check_moe_blocks(ranks, cfg_e, tp,
                     lambda r: np.load(root / f"moe_{case[0]}_{r}.npz"))
    g = math.gcd(cfg_e, n_dp)
    for r in worlds[shape]:
        w = r[case[0]]["moe_weights"]
        assert w and all(s == [cfg_e // g, 64, 128 // tp] for s in w), w


def test_decode_capacity_counts_the_global_batch(worlds):
    """The MoE of a mesh decode keeps the reference's (token, choice)
    pairs at the capacity of the global batch: the rows with one prompt
    give an expert ten pairs at capacity 8, so the reference drops two.
    The single-device path on a rank's own rows (a MoE whose capacity
    counts those rows) drops none and misses the reference there; the
    mesh decode matches it on every rank
    (test_mesh_decode_matches_reference)."""
    ref = worlds["ref"]["overflow"]["logits"][0]
    miss = []
    for r in worlds[(2, 1)]:
        got = r["overflow"]
        rows = slice(*got["rows"])
        np.testing.assert_allclose(got["logits"][0], ref[rows],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        miss.append(float(np.abs(got["own_rows"] - ref[rows]).max()))
    assert max(miss) > 1e-3, miss


@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
@pytest.mark.parametrize("n_chunks", range(1, 9))
def test_softmax_combine_local_matches_one_softmax(n_chunks, ring):
    """The split softmax over ``n_chunks`` uneven chunks of 37 slots,
    only 6 of them valid (a full cache at position 5: the later chunks
    have no valid slot; or a ring written at slot 3 whose 12 valid slots
    wrap round to 29 through 36), against ``torch.softmax`` over the whole
    cache (the single-device decode's arithmetic), within COMBINE_TOL."""
    from repro_torch.dist.collectives import softmax_combine_local
    from repro_torch.models.layers import _decode_scores, _repeat_kv, \
        decode_partial

    rng = np.random.default_rng(n_chunks)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16))).float()
    k = torch.from_numpy(rng.standard_normal((2, 37, 2, 16))).float()
    v = torch.from_numpy(rng.standard_normal((2, 37, 2, 16))).float()
    ids = torch.arange(37)
    valid = ((3 - ids) % 37 < 12) if ring else ids <= 5
    probs = torch.softmax(_decode_scores(q, k, valid[None]), dim=-1)
    want = torch.einsum("bhk,bkhd->bhd", probs, _repeat_kv(v, 4))
    parts = [decode_partial(q, kc, vc, mc[None]) for kc, vc, mc in zip(
        k.tensor_split(n_chunks, 1), v.tensor_split(n_chunks, 1),
        valid.tensor_split(n_chunks))]
    masked = [not bool(mc.any()) for mc in valid.tensor_split(n_chunks)]
    if n_chunks > 1 and not ring:
        assert any(masked)
    for (o, m, l), none in zip(parts, masked):
        if none:
            assert bool((m == -1e30).all())
    got = softmax_combine_local(parts)
    torch.testing.assert_close(got, want, atol=COMBINE_TOL,
                               rtol=COMBINE_TOL)


def test_softmax_combine_refuses_grad():
    from repro_torch.dist.collectives import softmax_combine_local
    from repro_torch.models.layers import decode_partial

    q = torch.ones((1, 1, 2, 4), requires_grad=True)
    k = v = torch.ones((1, 3, 2, 4))
    with pytest.raises(RuntimeError, match="no backward"):
        softmax_combine_local([decode_partial(q, k, v,
                                              torch.ones(1, 3).bool())])


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_production_recurrent_states_cut_their_width(shape):
    """On the (16, 16) production mesh recurrentgemma's RG-LRU states
    cut W over 'model' (h on dim 1, conv on dim 2) and xlstm's mLSTM
    states their key dim (c and n on dim 2), the batch over 'data'
    where it divides: the dims ``state_slices`` says the layer computes
    on, which the decode reads in place."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.dist.sharding import MeshShape
    from repro_torch.models.config import SHAPES
    from repro_torch.models.transformer import state_slices
    from repro_torch.serve.step import cache_sds, cache_specs

    mesh = MeshShape({"data": 16, "model": 16})
    batch = "data" if SHAPES[shape].global_batch % 16 == 0 else None
    seen = {}
    for arch in ("recurrentgemma-2b", "xlstm-125m"):
        cfg = get_config(arch)
        model = build_model(cfg)
        specs = cache_specs(cache_sds(model, cfg, SHAPES[shape]), mesh)
        for s, spec in zip(model.plan, specs):
            cuts = state_slices(cfg, s.kind, 16)
            for name, dim in cuts.items():
                got = getattr(spec, name)
                assert got[0] == batch and _spec_dim(got) == dim, \
                    (arch, name, got)
                seen[s.kind, name] = dim
    assert seen == {("rglru", "h"): 1, ("rglru", "conv"): 2,
                    ("mlstm", "c"): 2, ("mlstm", "n"): 2}


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_production_caches_cut_their_sequence(shape, monkeypatch):
    """On the (16, 16) production mesh every decoder LM's attention
    caches (full, ring, int8 and MLA's latent) cut dim 1, the sequence,
    over 'model', every tensor of a cache alike, and their batch over
    'data' where it divides: the layout the decode reads split-KV."""
    from repro_torch.configs import ARCH_IDS, build_model, get_config
    from repro_torch.dist.sharding import MeshShape
    from repro_torch.launch.dryrun import cell_is_runnable
    from repro_torch.models.config import SHAPES
    from repro_torch.models.layers import KVCache
    from repro_torch.models.mla import MLACache
    from repro_torch.serve.step import cache_sds, cache_specs

    mesh = MeshShape({"data": 16, "model": 16})
    seen = 0
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.family == "audio" or not cell_is_runnable(arch, shape)[0]:
            continue
        model = build_model(cfg)
        for int8 in (False, True):
            monkeypatch.setenv("ADSALA_KV_INT8", "1" if int8 else "0")
            caches = cache_sds(model, cfg, SHAPES[shape])
            specs = cache_specs(caches, mesh)
            for c, spec in zip(caches, specs):
                if not isinstance(c, (KVCache, MLACache)):
                    continue
                names = [f.name for f in dataclasses.fields(c)
                         if isinstance(getattr(c, f.name), torch.Tensor)]
                assert names == (["k", "v", "k_scale", "v_scale"]
                                 if int8 and isinstance(c, KVCache)
                                 else ["c_kv", "k_rope"]
                                 if isinstance(c, MLACache) else ["k", "v"])
                batch = "data" if SHAPES[shape].global_batch % 16 == 0 \
                    else None
                for name in names:
                    got = getattr(spec, name)
                    assert got[:2] == (batch, "model"), (arch, name, got)
                    assert "model" not in got[2:], (arch, name, got)
                seen += 1
    assert seen > 0


@pytest.mark.parametrize("e, cap, n, want", [
    (8, 40, 16, (1, 20)), (8, 8, 16, (1, 4)), (8, 40, 32, (1, 10)),
    (3, 8, 2, (3, 4)), (6, 16, 4, (3, 8))])
def test_slot_block_splits_the_slot_rows(e, cap, n, want):
    """``slot_block`` gives each of n ranks an equal block of the (E, C)
    slot rows, E / g experts by C / (n / g) rows (g = gcd(E, n), C
    padded to a multiple of n / g), and the n blocks cover every padded
    row once: mixtral's 8 experts at decode_32k's capacity 40 and
    long_500k's floor of 8 on 16 and 32 ranks, 3 experts on 2, 6 on 4."""
    from repro_torch.models.moe import slot_block

    count = np.zeros((e, want[1] * n * want[0] // e), int)
    for r in range(n):
        e_lo, e_hi, c_lo, c_hi = slot_block(e, cap, n, r)
        assert (e_hi - e_lo, c_hi - c_lo) == want
        count[e_lo:e_hi, c_lo:c_hi] += 1
    assert count.shape[1] >= cap and (count == 1).all()


@pytest.mark.parametrize("e, cap, n", [(8, 40, 16), (8, 8, 16),
                                       (8, 40, 32), (3, 8, 2), (6, 16, 4)])
def test_slot_block_products_are_rows_of_the_whole(e, cap, n):
    """The grouped product of each rank's ``slot_block`` (padded with
    rows of zeros past the capacity) is, row for row and bit for bit,
    the whole (E, C) product's rows (the plain version, fp32): the split
    decode's partial output, gathered, is the unsplit one's."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.models.moe import slot_block

    rng = np.random.default_rng(e * cap + n)
    x = torch.from_numpy(rng.standard_normal((e, cap, 32))).float()
    w = torch.from_numpy(rng.standard_normal((e, 32, 24))).float()
    whole = ops.grouped_matmul(x, w)
    for r in range(n):
        e_lo, e_hi, c_lo, c_hi = slot_block(e, cap, n, r)
        block = x[e_lo:e_hi, c_lo:c_hi]
        block = F.pad(block, (0, 0, 0, c_hi - c_lo - block.shape[1]))
        y = ops.grouped_matmul(block.contiguous(), w[e_lo:e_hi])
        kept = max(0, min(c_hi, cap) - c_lo)
        assert torch.equal(y[:, :kept], whole[e_lo:e_hi, c_lo:c_lo + kept])
        assert not y[:, kept:].any()


@pytest.mark.parametrize("shape, rows", [("decode_32k", 20),
                                         ("long_500k", 4)])
def test_mixtral_rank_buckets_on_the_production_mesh(shape, rows):
    """On (16, 16) mixtral's 8 experts stay whole over 'data' (8 does not
    divide 16) and cut their FF width over 'model': a decode rank runs
    one expert's slot rows, 20 of decode_32k's global capacity 40 (two
    ranks an expert) or 4 of long_500k's floor of 8, on 1024 FF
    columns: the grouped GEMMs' (1, rows, 6144, 1024) and ``wo``'s
    (1, rows, 1024, 6144)."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.dist.sharding import MeshShape, partition_params
    from repro_torch.models.config import SHAPES
    from repro_torch.models.moe import slot_block
    from repro_torch.models.transformer import _moe_spec

    cfg = get_config("mixtral-8x22b")
    model = build_model(cfg)
    mesh = MeshShape({"data": 16, "model": 16})
    specs = partition_params(model, cfg, mesh)
    moe = next(lay["moe"] for lay in specs["layers"] if "moe" in lay)
    assert moe["wi"] == (None, None, "model")
    assert moe["wo"] == (None, "model", None)
    spec = _moe_spec(cfg)
    cap = spec.capacity(SHAPES[shape].global_batch)
    ff = spec.d_ff // 16
    blocks = {slot_block(spec.n_experts, cap, 16, r) for r in range(16)}
    assert len(blocks) == 16
    for e_lo, e_hi, c_lo, c_hi in blocks:
        assert (e_hi - e_lo, c_hi - c_lo, spec.d_model, ff) \
            == (1, rows, 6144, 1024)


def test_production_decode_takes_the_kv_columns():
    """On (16, 16) the four archs whose KV heads 16 does not divide
    (chameleon 64 / 8, mixtral 48 / 8, granite 32 / 8, chatglm3 32 / 2,
    all at head dim 128) compute a decode step's ``wq``, ``wk``, ``wv``
    on their stored columns and ``wo`` on its stored rows; train and
    prefill keep the whole heads and the picked KV heads."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.dist.sharding import MeshShape, partition_params
    from repro_torch.models.transformer import dense_mesh_layout

    mesh = MeshShape({"data": 16, "model": 16})
    m = "model"
    cols, rows = ((None, m), False), ((m, None), False)
    for arch in ("chameleon-34b", "mixtral-8x22b", "granite-8b",
                 "chatglm3-6b"):
        cfg = get_config(arch)
        assert cfg.n_heads % 16 == 0 and cfg.n_kv_heads % 16
        dec = dense_mesh_layout(cfg, mesh, decode=True)
        lay = dense_mesh_layout(cfg, mesh)
        assert {k: v for k, v in dec.items() if k.startswith("attn.")} \
            == {"attn.wq": cols, "attn.wk": cols, "attn.wv": cols,
                "attn.wo": rows}, arch
        assert lay["attn.wq"] == cols and lay["attn.wk"] == ((), True)
        model = build_model(cfg)
        attn = next(lay["mixer"] for lay in partition_params(
            model, cfg, mesh)["layers"] if "wk" in lay["mixer"])
        assert attn["wk"] == attn["wv"] == (None, m), arch


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_decode_weight_moves_nothing(mesh):
    """``scripts/decode_weight_moves.py``: no arch's decode step gathers
    a weight whole on either production mesh."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.dist.sharding import MeshShape

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "scripts"))
    from decode_weight_moves import moves

    shape = {"data": 16, "model": 16} if mesh == "single" \
        else {"pod": 2, "data": 16, "model": 16}
    assert {a: moves(a, MeshShape(shape)) for a in ARCH_IDS} \
        == {a: {} for a in ARCH_IDS}
