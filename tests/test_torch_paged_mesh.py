"""The paged decode step on a mesh, on multi-rank gloo worlds on the CPU.

``serve.step.build_decode_paged`` on a mesh takes the page pools as
DTensors in ``paged_spec``'s layout (pages over 'data', the head dim,
MLA's latent widths or the KV heads over 'model') and reads each
split-KV over its pages: every slot's rows are gathered, each rank
writes the new rows of the slots whose pages it stores and attends every
slot over its pages, and the partial softmaxes are merged over the page
axes.  The dense blocks compute on their 'model' shards; the MoE routes
the whole batch onto the experts where they are stored.

Three worlds over ("data", "model"), (1, 2), (2, 1) and (2, 2), each
spawned once (``init_method=file://``: no port) and running every case
in one go, one world after another while the reference runs in this
process; the tests below read what the ranks wrote.  The kernels'
plain versions run (CPU tensors).

Every case: SLOTS slots over pools of SLOTS x TABLE_PAGES pages of
PAGE slots, filled with numpy draws from a seed, and a page table
dealing out a permutation of the pages, TABLE_PAGES a slot, so that a
data rank's slots read pages the other data rank stores; one slot has
a hole past its prefix, one a hole inside it (read as page 0, as on
one device), one is inactive (pos -1).  Smoke stablelm-1.6b (MHA: the pool cut on
its head dim over 'model'), granite-8b (2 KV heads), deepseek-v2-236b
(MLA's latent pool, cut on kv_lora_rank and qk_rope_dim; routed and
shared experts), stablelm with 8 heads of 8 (the pool cut on its KV
heads), starcoder2-3b with 3 heads, 1 KV head and D 96 (on 2 ranks of
'model' the decode projects on the stored columns of ``wq``, ``wk`` and
``wv``, 1.5 query heads and half the KV head a rank, RoPE after the
gather; the pool cut on its head dim), granite with 1 KV head (4 heads
the axis divides, a KV head it does not: the stored columns of ``wk``
and ``wv``, half the KV head a rank) and deepseek with 3 experts (on 2
'data' ranks, which do not divide them, each rank runs the grouped
GEMMs on its half of every expert's slot rows).  Each rank: STEPS
greedy steps of the built paged decode (for deepseek, starcoder2 and
granite with 1 KV head the first one watched: the local shapes of the
MLA and shared-expert weights or of the attention weights the rank
computes with, the all-gathers of a layer's q, k and v, the MoE's
buckets and the grouped GEMMs' inputs, and the step's collectives by
``CommDebugMode``), held
against the JAX reference's single-device paged ``decode_step`` over the
whole batch on the same pool and table: logits within LOGIT_TOL (1e-5,
fp32) at every step, the same greedy tokens, the pools returned in
their specs' layout, in place, and equal to the reference's after the
steps.

In (2, 1) the MoE's decode capacity over the global batch: smoke
deepseek at 16 slots, ten of them with one token, one position and
copies of one slot's pages (five a rank), so that an expert takes ten
(token, choice) pairs at the global capacity 8 (the reference drops
two) while a rank's eight slots cannot overflow its own.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from test_torch_tp_decode import check_moe_blocks, save_moe, spy_moe, \
    spy_qkv

pytestmark = pytest.mark.timeout(400)

SLOTS, PAGE, TABLE_PAGES, STEPS = 8, 4, 4, 3
CAP = TABLE_PAGES * PAGE
LOGIT_TOL = 1e-5
#: slots with a hole past their prefix, a hole inside it, no sequence
HOLE_PAST, HOLE_INSIDE, INACTIVE = 1, 3, 6
#: (case id, arch, config overrides)
CASES = [
    ("stablelm", "stablelm-1.6b", {}),
    ("granite", "granite-8b", {}),
    ("deepseek", "deepseek-v2-236b", {}),
    ("stablelm-heads", "stablelm-1.6b", {"n_heads": 8, "n_kv_heads": 8}),
    ("starcoder2-split", "starcoder2-3b",
     {"n_heads": 3, "n_kv_heads": 1, "d_model": 96}),
    ("granite-kv1", "granite-8b", {"n_kv_heads": 1}),
    ("deepseek-e3", "deepseek-v2-236b", {"n_experts": 3}),
]
#: the case whose KV heads 2 ranks of 'model' do not divide, and the one
#: whose experts 2 'data' ranks do not
KV_COLS, MOE_SPLIT = "granite-kv1", "deepseek-e3"
#: the overflow case: 16 slots, ten with one token, position and pages
OVERFLOW = ("overflow", "deepseek-v2-236b", {})
OVERFLOW_SLOTS = 16
OVERFLOW_SAME = (0, 1, 2, 3, 4, 8, 9, 10, 11, 12)
WORLDS = {(1, 2): CASES, (2, 1): CASES + [OVERFLOW], (2, 2): CASES}


#: the weights a deepseek rank's paged step logs: MLA's four on 'heads',
#: two of its latent projections, the shared experts
MLA_LOGGED = ("wq_b", "wk_b", "wv_b", "wo", "wq_a", "wkv_a")
SHARED_LOGGED = ("shared_wi", "shared_wg", "shared_wo")


def _slots(case) -> int:
    return OVERFLOW_SLOTS if case[0] == "overflow" else SLOTS


def _n_pages(case) -> int:
    return _slots(case) * TABLE_PAGES


def _table(case) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(table (slots, TABLE_PAGES), pos (slots,), first tokens (slots,
    1)) from a seed: a permutation of the pages, dealt TABLE_PAGES to
    each slot, then the holes and the inactive slot."""
    b = _slots(case)
    rng = np.random.default_rng(7)
    table = rng.permutation(_n_pages(case)).reshape(b, TABLE_PAGES)
    pos = rng.integers(PAGE + 1, CAP - STEPS, b)
    tokens = rng.integers(0, 256, (b, 1))
    if case[0] == "overflow":
        pos[list(OVERFLOW_SAME)] = pos[0]
        tokens[list(OVERFLOW_SAME)] = tokens[0]
        return table, pos, tokens
    pos[HOLE_PAST] = PAGE - 1          # writes pages 0 and 1: 2, 3 holes
    table[HOLE_PAST, 2:] = -1
    table[HOLE_INSIDE, 0] = -1         # its first page reads page 0
    pos[INACTIVE] = -1
    return table, pos, tokens


def _pools(case, names: list[list[tuple[str, tuple]]]) -> list[dict]:
    """Per layer {field: array (pages, PAGE, ...)} drawn from a seed;
    in the overflow case the same slots' pages copy slot 0's."""
    rng = np.random.default_rng(8)
    table, _, _ = _table(case)
    out = []
    for layer in names:
        pool = {}
        for name, shape in layer:
            a = rng.standard_normal((_n_pages(case), PAGE) + shape
                                    ).astype(np.float32)
            if case[0] == "overflow":
                for i in OVERFLOW_SAME:
                    a[table[i]] = a[table[0]]
            pool[name] = a
        out.append(pool)
    return out


def _pool_fields(model) -> list[list[tuple[str, tuple]]]:
    """Per layer of the port's model: (field, trailing shape) of its
    pool."""
    from repro_torch.train.step import make_ctx

    pools = model.init_paged_cache(1, PAGE, make_ctx("decode"),
                                   device="meta")
    return [[(f.name, tuple(getattr(p, f.name).shape[2:]))
             for f in dataclasses.fields(p)] for p in pools]


def _other_rank_reads(case, n_dp: int) -> int:
    """How many active table entries of each data rank's slots lie on
    pages another data rank stores (the smallest over the ranks)."""
    table, pos, _ = _table(case)
    b_loc, n_loc = _slots(case) // n_dp, _n_pages(case) // n_dp
    counts = []
    for r in range(n_dp):
        rows = slice(r * b_loc, (r + 1) * b_loc)
        t = table[rows][pos[rows] >= 0]
        counts.append(int(((t >= 0) & (t // n_loc != r)).sum()))
    return min(counts)


# ---------------------------------------------------------------------------
# the ranks' work (runs in spawned processes: imports no jax)
# ---------------------------------------------------------------------------

def _spy(log: dict):
    """Patch GQA's and MLA's paged decode and the MoE's shared experts to
    log the local shapes of the weights they are given; returns the
    undo."""
    from repro_torch.models import layers as L
    from repro_torch.models import mla as MLA
    from repro_torch.models import moe as MOE

    orig = (MLA.mla_decode_paged, MOE._shared_ffn, L.attention_decode_paged)

    def attention_decode_paged(p, *a, **k):
        for n in ("wq", "wk", "wv", "wo"):
            log.setdefault(f"attn.{n}", set()).add(tuple(p[n].shape))
        return orig[2](p, *a, **k)

    def mla_decode_paged(p, *a, **k):
        for n in MLA_LOGGED:
            log.setdefault(f"mla.{n}", set()).add(tuple(p[n].shape))
        return orig[0](p, *a, **k)

    def shared_ffn(p, *a, **k):
        for n in SHARED_LOGGED:
            log.setdefault(n, set()).add(tuple(p[n].shape))
        return orig[1](p, *a, **k)

    MLA.mla_decode_paged, MOE._shared_ffn, L.attention_decode_paged = \
        mla_decode_paged, shared_ffn, attention_decode_paged
    undo_qkv = spy_qkv(log)

    def undo():
        MLA.mla_decode_paged, MOE._shared_ffn, L.attention_decode_paged = \
            orig
        undo_qkv()
    return undo


def _case(mesh, tmp: str, case) -> dict:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.dist.collectives import distribute, row_index
    from repro_torch.dist.sharding import to_placements
    from repro_torch.models.params import is_spec, tree_leaves, tree_map
    from repro_torch.serve.kv_cache import PagedKV, PagedLatent
    from repro_torch.serve.step import _map_arrays, build_decode_paged
    from repro_torch.train.step import make_ctx

    cid, arch, over = case
    b = _slots(case)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    model = build_model(cfg)
    params = torch.load(f"{tmp}/../ref_{cid}.pt")["params"]
    decode, p_specs, (t_spec, pool_specs, pos_spec, table_spec) = \
        build_decode_paged(model, cfg, slots=b, n_pages=_n_pages(case),
                           page_size=PAGE, table_pages=TABLE_PAGES,
                           mesh=mesh)
    it = iter(tree_leaves(p_specs, is_leaf=is_spec))
    sharded = tree_map(lambda t: distribute(t, mesh, next(it)), params)
    kind = PagedLatent if cfg.attn_kind == "mla" else PagedKV
    whole = [kind(**{k: torch.from_numpy(a) for k, a in p.items()})
             for p in _pools(case, _pool_fields(model))]
    pools = _map_arrays(lambda t, spec: distribute(t.clone(), mesh, spec),
                        whole, pool_specs)
    taken = []
    _map_arrays(lambda t: taken.append(id(t)), pools)
    table, pos, tok = (torch.from_numpy(a) for a in _table(case))
    n_dp = mesh.size(0)
    b_loc = b // n_dp
    i = row_index(mesh, ("data",))
    rows = slice(i * b_loc, (i + 1) * b_loc)
    tok = tok[rows]
    out_logits, out_tokens, own_rows = [], [], None
    log, comm, moe_seen, moe_w = {}, None, [], None
    with torch.no_grad():
        for s in range(STEPS):
            if cid == "overflow" and s == 0:
                # a decode whose MoE counts the rank's slots only: the
                # single-device path on them, over the whole pools
                own = _map_arrays(lambda t: t.clone(), whole)
                own_rows = model.decode_step(
                    params, tok, own, pos[rows],
                    make_ctx("decode", cache_len=CAP), table[rows])[0]
            args = (distribute(pos, mesh, pos_spec),
                    distribute(table, mesh, table_spec))
            if (cfg.attn_kind == "mla"
                    or cid in ("starcoder2-split", KV_COLS)) and s == 0:
                undo, undo_moe = _spy(log), spy_moe(moe_seen)
                try:
                    with CommDebugMode() as mode:
                        step_logits, out = decode(sharded, tok, pools,
                                                  *args)
                finally:
                    undo()
                    undo_moe()
                comm = {str(k): v for k, v in mode.get_comm_counts().items()}
                if cid == MOE_SPLIT:
                    moe_w = save_moe(moe_seen, f"{tmp}/moe_{cid}_"
                                     f"{mesh.get_rank()}.npz")
            else:
                step_logits, out = decode(sharded, tok, pools, *args)
            assert out is pools
            out_logits.append(step_logits.numpy())
            tok = step_logits.argmax(-1, keepdim=True)
            out_tokens.append(tok[:, 0].tolist())
            pos = torch.where(pos >= 0, pos + 1, pos)
    leaves, layout = [], []
    _map_arrays(leaves.append, pools)
    specs = []
    _map_arrays(specs.append, pool_specs)
    for t, spec in zip(leaves, specs):
        layout.append({"local": list(t.to_local().shape),
                       "placements": str(t.placements),
                       "want": str(to_placements(spec, mesh))})
    final = [t.full_tensor().numpy() for t in leaves]
    if mesh.get_rank() == 0:
        np.savez(f"{tmp}/pools_{cid}.npz", *final)
    np.save(f"{tmp}/logits_{cid}_{mesh.get_rank()}.npy",
            np.stack(out_logits))
    if own_rows is not None:
        np.save(f"{tmp}/own_rows_{cid}_{mesh.get_rank()}.npy",
                own_rows.numpy())
    return {"rows": [rows.start, rows.stop], "tokens": out_tokens,
            "specs": [list(t_spec), list(pos_spec), list(table_spec)],
            "layout": layout,
            "in_place": [id(t) for t in leaves] == taken,
            "all_dtensors": all(isinstance(t, DTensor) for t in leaves),
            "weights": {k: sorted(v) for k, v in log.items()},
            "comm": comm, "moe_weights": moe_w}


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

    cid, arch, over = case
    jm = jax_build_model(dataclasses.replace(jax_smoke_config(arch), **over))
    return jm, jm.init(jax.random.PRNGKey(0))


def _reference_tree(jm, layers: list[dict], kind) -> dict:
    """The port's per-layer pools in the reference's segment tree: the
    scanned unit's pools stacked over its repeats."""
    import jax.numpy as jnp

    n_pre, n_unit = len(jm.prefix), len(jm.unit)

    def pool(arrays):
        return kind(**{k: jnp.asarray(a) for k, a in arrays.items()})

    scan = [pool({k: np.stack([layers[n_pre + r * n_unit + i][k]
                               for r in range(jm.repeats)])
                  for k in layers[n_pre + i]})
            for i in range(n_unit)] if jm.repeats else []
    tail = n_pre + n_unit * jm.repeats
    return {"prefix": [pool(a) for a in layers[:n_pre]], "scan": scan,
            "suffix": [pool(a) for a in layers[tail:]]}


def _reference_layers(jm, tree: dict) -> list[dict]:
    """The reference's segment tree as the port's per-layer pools."""
    def arrays(p, r=None):
        return {f.name: np.asarray(getattr(p, f.name) if r is None else
                                   getattr(p, f.name)[r])
                for f in dataclasses.fields(p)}
    out = [arrays(p) for p in tree["prefix"]]
    for r in range(jm.repeats):
        out += [arrays(p, r) for p in tree["scan"]]
    return out + [arrays(p) for p in tree["suffix"]]


def _reference(case, jm, jp, names) -> dict:
    """The reference's single-device paged decode over the whole batch:
    each step's logits and greedy tokens, the pools after the steps."""
    import jax.numpy as jnp

    from repro.serve import kv_cache as JKV
    from repro.train.step import make_ctx as jax_make_ctx

    kind = JKV.PagedLatent if case[1] == "deepseek-v2-236b" else JKV.PagedKV
    cache = _reference_tree(jm, _pools(case, names), kind)
    table, pos, tok = _table(case)
    ctx = jax_make_ctx(None, "decode", cache_len=CAP)
    tok = jnp.asarray(tok, jnp.int32)
    steps, tokens = [], []
    for _ in range(STEPS):
        logits, cache = jm.decode_step(jp, tok, cache,
                                       jnp.asarray(pos, jnp.int32), ctx,
                                       jnp.asarray(table, jnp.int32))
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        tokens.append(np.asarray(tok[:, 0]))
        pos = np.where(pos >= 0, pos + 1, pos)
    return {"logits": np.stack(steps), "tokens": np.stack(tokens),
            "pools": _reference_layers(jm, cache)}


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

    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.convert import params_from_jax

    root = tmp_path_factory.mktemp("paged_mesh")
    models = {}
    for case in CASES + [OVERFLOW]:
        jm, jp = models[case[0]] = _reference_model(case)
        torch.save({"params": params_from_jax(jax.tree.map(np.asarray, jp))},
                   root / f"ref_{case[0]}.pt")
    errors: list = []
    runner = threading.Thread(target=_run_worlds, args=(root, errors),
                              daemon=True)
    runner.start()
    out = {"ref": {}}
    for case in CASES + [OVERFLOW]:
        cfg = dataclasses.replace(get_smoke_config(case[1]), **case[2])
        out["ref"][case[0]] = _reference(
            case, *models[case[0]], _pool_fields(build_model(cfg)))
    runner.join(timeout=3 * 300)
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
        pools = {}
        for case in WORLDS[shape]:
            with np.load(tmp / f"pools_{case[0]}.npz") as z:
                pools[case[0]] = [z[k] for k in z.files]
        out[shape] = {"ranks": res, "pools": pools, "dir": tmp}
    return out


def _ids(item):
    shape, case = item
    return f"{shape[0]}x{shape[1]}-{case[0]}"


ITEMS = [(shape, case) for shape, cases in WORLDS.items()
         for case in cases]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("item", ITEMS, ids=_ids)
def test_paged_mesh_decode_matches_reference(worlds, item):
    """STEPS greedy steps of the built paged decode on the mesh against
    the reference's single-device paged ``decode_step`` over the whole
    batch: every step's logits within LOGIT_TOL (fp32), the inactive
    slot's and the holes' slots' included, and every greedy token
    equal."""
    shape, case = item
    ref = worlds["ref"][case[0]]
    for r in worlds[shape]["ranks"]:
        got = r[case[0]]
        rows = slice(*got["rows"])
        for s in range(STEPS):
            np.testing.assert_allclose(got["logits"][s],
                                       ref["logits"][s][rows],
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
            assert got["tokens"][s] == ref["tokens"][s][rows].tolist()


@pytest.mark.parametrize("item", ITEMS, ids=_ids)
def test_paged_mesh_decode_writes_the_reference_pools(worlds, item):
    """After the steps the pools, gathered whole, equal the reference's
    (within LOGIT_TOL where a new row was written; the rows no step
    wrote, the inactive slot's pages among them, bit for bit): each new
    row was written once, by the rank storing its page."""
    shape, case = item
    ref = worlds["ref"][case[0]]["pools"]
    mine = worlds[shape]["pools"][case[0]]
    want = [a for layer in ref for a in layer.values()]
    before = [a for layer in _pools(case, [[(k, a.shape[2:])
                                            for k, a in layer.items()]
                                           for layer in ref])
              for a in layer.values()]
    assert len(mine) == len(want)
    for got, w, b in zip(mine, want, before):
        np.testing.assert_allclose(got, w, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        untouched = (w == b).all(axis=tuple(range(2, w.ndim)))
        assert untouched.sum() < untouched.size
        np.testing.assert_array_equal(got[untouched], b[untouched])


@pytest.mark.parametrize("item", ITEMS, ids=_ids)
def test_paged_mesh_decode_keeps_the_pool_layout(worlds, item):
    """The step returns the pools it took, DTensors in ``pool_specs``'
    layout, written in place: each rank holds 1 / n_dp of the pages of
    every pool and the 'model' axis' cut of its head dim (of its KV
    heads for stablelm-heads, of kv_lora_rank and qk_rope_dim for
    deepseek; starcoder2-split's one KV head of 32); the slots,
    positions and table cut over 'data'."""
    shape, case = item
    n_dp, tp = shape
    cid, arch, over = case
    for r in worlds[shape]["ranks"]:
        got = r[cid]
        assert got["all_dtensors"] and got["in_place"]
        assert got["specs"] == [["data", None], ["data"], ["data", None]]
        for leaf in got["layout"]:
            assert leaf["placements"] == leaf["want"]
            local = leaf["local"]
            assert local[:2] == [_n_pages(case) // n_dp, PAGE], leaf
            if arch == "deepseek-v2-236b":
                assert local[2] in (32 // tp, 8 // tp), leaf
            elif cid == "stablelm-heads":
                assert local[2:] == [8 // tp, 8], leaf
            elif cid == "starcoder2-split":
                assert local[2:] == [1, 32 // tp], leaf
            else:
                kv = {"granite-kv1": 1, "granite": 2}.get(cid, 4)
                assert local[2:] == [kv, 16 // tp], leaf


DEEPSEEK_ITEMS = [i for i in ITEMS if i[1][1] == "deepseek-v2-236b"]


@pytest.mark.parametrize("item", DEEPSEEK_ITEMS, ids=_ids)
def test_deepseek_paged_decode_computes_on_its_heads_and_ff(worlds, item):
    """A deepseek rank's paged mesh step computes MLA on its whole heads
    (its columns of ``wq_b``, ``wk_b``, ``wv_b`` and rows of ``wo``; the
    latent projections whole) and the shared experts on its FF slice,
    and gathers no weight: ``CommDebugMode`` sees no DTensor
    redistribution (a functional all-gather) in the step; its
    all-gathers are the model's own, among them each MLA layer's
    absorbed query (and rope) over 'model'."""
    from repro_torch.configs import get_smoke_config

    shape, case = item
    tp = shape[1]
    cfg = dataclasses.replace(get_smoke_config(case[1]), **case[2])
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
    for r in worlds[shape]["ranks"]:
        got = r[case[0]]
        assert got["weights"] == {k: [list(v)] for k, v in want.items()}
        comm = got["comm"]
        assert not any("functional" in k for k in comm), comm
        assert comm.get("c10d._allgather_base_", 0) >= cfg.n_layers, comm


SPLIT_ITEMS = [i for i in ITEMS if i[1][0] == "starcoder2-split"
               and i[0][1] > 1]


@pytest.mark.parametrize("item", SPLIT_ITEMS, ids=_ids)
def test_uneven_heads_paged_decode_takes_the_stored_columns(worlds, item):
    """starcoder2's 3 heads on 2 ranks of 'model': a rank's paged mesh
    step projects on its stored columns of ``wq`` (48 of 96: 1.5 heads),
    ``wk`` and ``wv`` (16 of 32: half the KV head) and leaves through its
    stored rows of ``wo``, a layer's q, k and v taking three
    all-gathers, and gathers no weight (``CommDebugMode`` sees no DTensor
    redistribution in the step)."""
    shape, case = item
    tp = shape[1]
    want = {"attn.wq": [[96, 96 // tp]], "attn.wk": [[96, 32 // tp]],
            "attn.wv": [[96, 32 // tp]], "attn.wo": [[96 // tp, 96]],
            "qkv_gathers": [3]}
    for r in worlds[shape]["ranks"]:
        got = r[case[0]]
        assert got["weights"] == want
        assert not any("functional" in k for k in got["comm"]), got["comm"]


KV_COLS_ITEMS = [i for i in ITEMS if i[1][0] == KV_COLS and i[0][1] > 1]


@pytest.mark.parametrize("item", KV_COLS_ITEMS, ids=_ids)
def test_uneven_kv_heads_paged_decode_takes_the_stored_columns(worlds,
                                                               item):
    """granite with 4 heads and 1 KV head on 2 ranks of 'model': a rank's
    paged mesh step projects on its stored columns of ``wq`` (32 of 64:
    2 heads), ``wk`` and ``wv`` (8 of 16: half the KV head) and leaves
    through its stored rows of ``wo``; a layer's q, k and v take three
    all-gathers; and it gathers no weight (``CommDebugMode`` sees no
    DTensor redistribution in the step)."""
    shape, case = item
    tp = shape[1]
    want = {"attn.wq": [[64, 64 // tp]], "attn.wk": [[64, 16 // tp]],
            "attn.wv": [[64, 16 // tp]], "attn.wo": [[64 // tp, 64]],
            "qkv_gathers": [3]}
    for r in worlds[shape]["ranks"]:
        got = r[case[0]]
        assert got["weights"] == want
        assert not any("functional" in k for k in got["comm"]), got["comm"]


MOE_SPLIT_ITEMS = [i for i in ITEMS if i[1][0] == MOE_SPLIT]


@pytest.mark.parametrize("item", MOE_SPLIT_ITEMS, ids=_ids)
def test_moe_paged_decode_splits_the_slot_rows(worlds, item):
    """deepseek's 3 experts, which 2 'data' ranks do not divide: a rank's
    grouped GEMMs in a paged decode step see its ``slot_block`` of the
    buckets only (with 1 'data' rank, every slot row), its weights the
    block's experts on its FF slice, and over the 'data' ranks the
    blocks cover every slot row once."""
    shape, case = item
    n_dp, tp = shape
    ranks = [r["coord"] for r in worlds[shape]["ranks"]]
    root = worlds[shape]["dir"]
    check_moe_blocks(ranks, 3, tp,
                     lambda r: np.load(root / f"moe_{case[0]}_{r}.npz"))
    for r in worlds[shape]["ranks"]:
        w = r[case[0]]["moe_weights"]
        assert w and all(s == [3, 64, 32 // tp] for s in w), w


@pytest.mark.parametrize("n_dp", [2])
def test_the_table_reads_pages_of_the_other_data_rank(n_dp):
    """The cases' table makes every data rank's active slots read pages
    the other data rank stores, and keeps its holes and inactive slot."""
    for case in CASES + [OVERFLOW]:
        assert _other_rank_reads(case, n_dp) > 0, case[0]
    table, pos, _ = _table(CASES[0])
    assert pos[INACTIVE] == -1 and (table[HOLE_PAST, 2:] == -1).all()
    assert table[HOLE_INSIDE, 0] == -1 and pos[HOLE_INSIDE] >= PAGE


def test_paged_decode_capacity_counts_the_global_batch(worlds):
    """The paged mesh decode's MoE keeps the reference's (token, choice)
    pairs at the capacity of the global batch: the ten slots alike give
    an expert ten pairs at capacity 8, so the reference drops two.  The
    single-device path on a rank's own slots (a MoE whose capacity
    counts those slots) drops none and misses the reference there; the
    paged mesh decode matches it on every rank."""
    ref = worlds["ref"]["overflow"]["logits"][0]
    miss = []
    for r in worlds[(2, 1)]["ranks"]:
        got = r["overflow"]
        rows = slice(*got["rows"])
        np.testing.assert_allclose(got["logits"][0], ref[rows],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        miss.append(float(np.abs(got["own_rows"] - ref[rows]).max()))
    assert max(miss) > 1e-3, miss
