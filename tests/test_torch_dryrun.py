"""Port vs reference: the dry run (``repro_torch.launch.dryrun``), the
per-cell roofline (``roofline_for_cell``), the kernels bound as torch
ops, and the three examples, on the CPU.

* ``roofline_for_cell`` for every arch x shape x mesh against the
  reference's, whose module constants are set to the H100's for the
  call (its bf16 ``PEAK_FLOPS`` to the H100's bf16 rate; relative
  1e-12);
* ``cell_is_runnable`` and the record's keys against the reference's
  source, read with ``ast`` (importing ``repro.launch.dryrun`` would set
  ``XLA_FLAGS`` for 512 host devices in this process);
* one smoke cell per kind traced with ``device="cpu"`` on rank 0 of a
  fake 4-rank (2, 2) world (the kernels' plain versions), its FLOPs
  against the analytic count, its routine mix against the reference's
  prefill lowered under its ``DispatchRecorder``, its records folded by
  ``launch.profile``;
* xlstm's smoke cells (train and prefill) at 256 and 4096 tokens: the
  sLSTM is one op a layer (``repro_torch::slstm_scan``, its backward
  op once), so its layers dispatch the same ops at both lengths, and
  the traced FLOPs at 256 equal ``FlopCounterMode``'s count of the
  plain loop, less the other ranks' share of every cut product (the
  projections, the sLSTM's hoisted input product and the mLSTM core's
  key-dim terms), on the 2-way 'model' axis here and, in a subprocess,
  a 4-way one;
* the kernels' torch ops on fake CUDA tensors: their fake outputs
  against the plain versions' shapes and types, and a fake-CUDA trace
  of stablelm's smoke prefill that dispatches ``repro_torch::
  flash_attention`` once per layer, counted by its formula, without
  building the kernels.  This CPU-only torch has no CUDA device guard,
  which Python indexing takes, so the trace runs indexing on ``meta``
  twins (``_CudaIndexing``);
* the examples at a small size with ``--device cpu``.

FLOP tolerances (``_expected_flops``): a train step and a prefill run
the dense blocks tensor-parallel over 'model', so a rank computes its
data group's rows through its shards: ``step_flops / (dp x tp)``, plus
what the layout leaves whole on every rank, computed here exactly (the
KV heads a rank picks beyond its share where Hkv % tp != 0; the whole
attention where H % tp != 0).  A decode step does the same on its rows
and reads its cache cut on the sequence split-KV, each rank scoring
every head over its own slots, so the attention core has no remainder.
Train and decode count the same einsums as the analytic model, so they
agree to rounding (1e-9).  A prefill differs by two known terms, computed
here exactly: the port's prefill takes the logits of the last position
only, and the plain attention computes every (query, key) score where
the analytic count averages a causal context of S / 2.  One more test
traces stablelm-1.6b at full width (2 layers) on a fake (16, 16) world
in a subprocess: a rank's train FLOPs within x0.95–1.1 of
``step_flops / 256``.
"""

import ast
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_map as pytree_map
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models.config import SHAPES as JSHAPES
from repro.roofline import analytic as JA
from repro_torch.configs import build_model, get_config, get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import grouped_matmul as G
from repro_torch.kernels import matmul as M
from repro_torch.launch import dryrun as D
from repro_torch.models.config import SHAPES
from repro_torch.roofline import analytic as A

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DRYRUN = os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")
EXAMPLES = os.path.join(ROOT, "examples")

#: the smoke cells: (seq_len, global_batch) on the (2, 2) world
SMOKE_SHAPES = {"train_4k": (64, 4), "prefill_32k": (64, 4),
                "decode_32k": (64, 4)}
EXACT = 1e-9


# ---------------------------------------------------------------------------
# roofline_for_cell and the reference's source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_roofline_for_cell_matches_reference(monkeypatch, arch, shape_name,
                                             mesh_name):
    # the cells are bf16: the reference's PEAK_FLOPS is its chip's bf16 rate
    monkeypatch.setattr(JA, "PEAK_FLOPS", A.PEAK_FLOPS_BF16)
    monkeypatch.setattr(JA, "HBM_BW", A.HBM_BW)
    monkeypatch.setattr(JA, "ICI_BW", A.NVLINK_BW)
    record = {"cost": {"flops_per_device": 1.25e15},
              "memory": {"peak_bytes": 3 * 2 ** 30}}
    got = A.roofline_for_cell(get_config(arch), SHAPES[shape_name],
                              mesh_name, record)
    want = JA.roofline_for_cell(jax_get_config(arch), JSHAPES[shape_name],
                                mesh_name, record)
    got_d, want_d = dataclasses.asdict(got), dataclasses.asdict(want)
    assert got_d.keys() == want_d.keys()
    for key, value in want_d.items():
        if isinstance(value, str):
            assert got_d[key] == value, key
        else:
            assert got_d[key] == pytest.approx(value, rel=1e-12), key
    for prop in ("dominant", "total_s", "useful_ratio",
                 "roofline_fraction"):
        assert getattr(got, prop) == pytest.approx(getattr(want, prop),
                                                   rel=1e-12)


def _reference_tree() -> ast.Module:
    with open(REF_DRYRUN) as f:
        return ast.parse(f.read(), REF_DRYRUN)


def test_cell_is_runnable_matches_reference():
    tree = _reference_tree()
    keep = [n for n in tree.body
            if (isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "LONG_OK"
                        for t in n.targets))
            or (isinstance(n, ast.FunctionDef)
                and n.name == "cell_is_runnable")]
    assert len(keep) == 2
    ns: dict = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), REF_DRYRUN,
                 "exec"), ns)
    assert D.LONG_OK == ns["LONG_OK"]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert D.cell_is_runnable(arch, shape) == \
                ns["cell_is_runnable"](arch, shape), (arch, shape)


def _dict_keys(node: ast.Dict) -> dict:
    """{key: nested keys or None} of a dict literal."""
    out = {}
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant):
            out[k.value] = _dict_keys(v) if isinstance(v, ast.Dict) \
                else None
    return out


def reference_record_keys() -> dict:
    """The keys ``run_cell`` of the reference writes for an ok cell:
    the initial record's and ``record.update``'s, nested."""
    fn = next(n for n in _reference_tree().body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys: dict = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.AnnAssign) and isinstance(node.value,
                                                          ast.Dict):
            keys.update(_dict_keys(node.value))
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  None) == "update":
            keys.update(_dict_keys(node.args[0]))
    keys["status"] = None
    return keys


# ---------------------------------------------------------------------------
# smoke cells on a fake (2, 2) world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    D.fake_world(4)
    try:
        yield make_mesh((2, 2), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _smoke_shape(name: str):
    s, b = SMOKE_SHAPES[name]
    return dataclasses.replace(SHAPES[name], seq_len=s, global_batch=b)


@pytest.fixture(scope="module")
def smoke_records(fake_mesh, tmp_path_factory):
    """stablelm's smoke config, one cell per kind, written as the
    launcher writes them."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    cfg = get_smoke_config("stablelm-1.6b")
    recs = {}
    for name in SMOKE_SHAPES:
        rec = D.run_cell("stablelm-1.6b", name, False, device="cpu",
                         cfg=cfg, shape=_smoke_shape(name), mesh=fake_mesh)
        with open(out / f"stablelm-1.6b_{name}_single.json", "w") as f:
            json.dump(rec, f)
        recs[name] = rec
    return out, recs


def _expected_flops(cfg, shape, dp: int = 2, tp: int = 2,
                    remainder: bool = True) -> float:
    """The analytic count for rank 0 of a (dp, tp) world, with the
    prefill's two known differences and (``remainder``) the replicated
    remainder (module docstring), for a config of GQA attention layers
    only."""
    from repro_torch.models.layers import kv_range
    from repro_torch.models.transformer import _attn_spec, _dense_cuts
    from repro_torch.roofline import step_flops

    want = step_flops(cfg, shape) / dp
    rows = shape.global_batch // dp
    s, hd, d = shape.seq_len, cfg.resolved_head_dim, cfg.d_model
    h, hk = cfg.n_heads, cfg.n_kv_heads
    if shape.kind == "prefill":
        want -= rows * (s - 1) * 2 * d * cfg.vocab
        want += rows * s * cfg.n_layers * 4 * h * hd * (s / 2)
    want /= tp
    if not remainder:
        return want
    mult = 4 if shape.kind == "train" else 1       # fwd, remat, 2 x bwd

    def attn(nq: int, nkv: int) -> float:
        """A token's attention FLOPs on ``nq`` query and ``nkv`` KV
        heads: the plain attention computes every score (context s); a
        decode step scores all heads over its own slots of the split
        cache, the share already."""
        out = 2 * d * hd * (nq + 2 * nkv) + 2 * nq * hd * d
        return out + (2 * s * nq * hd * 2 if shape.kind != "decode" else 0)

    per_tok = 0.0
    cols = shape.kind == "decode" and _dense_cuts(cfg, tp)["qkv_cols"]
    if not cols and (h % tp == 0 or shape.kind != "decode"):
        # rank 0's ⌈H / tp⌉ whole heads and the KV heads they read (the
        # picked KV heads where tp does not divide Hkv)
        lo, hi = kv_range(_attn_spec(cfg, "attn"), tp, 0)
        per_tok = attn(-(-h // tp), hi - lo) - attn(h, hk) / tp
    # else a decode step of uneven heads or KV heads projects on the
    # stored columns: its share
    toks = rows if shape.kind == "decode" else rows * s
    return want + mult * toks * cfg.n_layers * per_tok


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
def test_smoke_cell_traces_on_a_fake_world(smoke_records, kind):
    _, recs = smoke_records
    rec = recs[kind]
    assert rec["status"] == "ok" and rec["n_devices"] == 4
    ref = reference_record_keys()
    assert set(rec) == set(ref) | {"kernel_ops", "device"}
    for key, sub in ref.items():
        if sub is not None:
            assert set(rec[key]) == set(sub), key
    assert set(rec["collectives"]) == set(D.COLL_KINDS)
    for v in rec["collectives"].values():
        assert set(v) == {"count", "bytes", "loop_count", "loop_bytes"}
        assert v["loop_count"] == v["loop_bytes"] == 0
    # a train step computes every weight on its stored shard (stablelm's
    # heads, FF width and vocab are cut over 'model'): no gather; its
    # blocks' partial sums and the data average are all-reduces; a
    # prefill gathers each layer's K and V and the last logits; a decode
    # step each layer's q, new K and new V, and the last logits
    gather = rec["collectives"]["all-gather"]
    if kind == "train_4k":
        assert gather["count"] == 0
        assert rec["collectives"]["all-reduce"]["count"] > 0
    else:
        assert gather["count"] > 0 and gather["bytes"] > 0
    if kind == "prefill_32k":
        assert gather["count"] == 2 * 2 + 1
    if kind == "decode_32k":
        assert gather["count"] == 2 * 3 + 1
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert rec["compile_s"] is None and rec["cost"]["bytes_per_device"] \
        is None
    # the plain versions ran: no kernel op on the CPU
    assert rec["kernel_ops"] == {}
    cfg = get_smoke_config("stablelm-1.6b")
    want = _expected_flops(cfg, _smoke_shape(kind))
    assert rec["cost"]["flops_per_device"] == pytest.approx(want,
                                                            rel=EXACT)
    assert rec["loops"] == {"layer_repeats": 2, "prefix_layers": 0,
                            "suffix_layers": 0, "unit_len": 1,
                            "n_layers": 2}


def _whole_but_stored_cut(model, cfg, mesh) -> int:
    """How many weights are stored cut over 'model' and computed whole
    (gathered once a train step)."""
    from repro_torch.dist.sharding import partition_params
    from repro_torch.models.moe import is_expert_weight
    from repro_torch.models.params import is_spec, tree_leaves, tree_paths
    from repro_torch.models.transformer import dense_mesh_layout, \
        dense_weight_key

    dense = dense_mesh_layout(cfg, mesh)
    n = 0
    for path, spec in zip(tree_paths(model.defs), tree_leaves(
            partition_params(model, cfg, mesh), is_leaf=is_spec)):
        key = dense_weight_key(model, path)
        n += ("model" in spec and dense.get(key, ((),))[0] == ()
              and not is_expert_weight(path))
    return n


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_traces_its_smoke_cells(fake_mesh, arch, kind):
    """Each family's built train, prefill and decode function on fake
    DTensors: whisper's frame embeddings are cut over 'model' too, and
    the functions take their rows whole (``collectives.local_rows``).
    A train step gathers the weights computed whole and stored cut, and
    nothing else but for the MoE's expert-parallel exchange (DTensor's
    all-to-all gathers on a CPU mesh), whisper's frame embeddings, the
    xLSTM blocks' up-projections and the sLSTM's input product (one
    gather each a layer, in the forward and in the remat's recompute)
    and, for each RG-LRU layer, the backward of its gates'
    reduce-scatter and the gradients of the gates' biases assembled
    from the ranks' channels; a prefill gathers at least its logits, a
    decode step its logits.  An RG-LRU layer reduce-scatters its gates
    once a forward (twice a train step: the remat's recompute)."""
    cfg = get_smoke_config(arch)
    rec = D.run_cell(arch, kind, False, device="cpu", cfg=cfg,
                     shape=_smoke_shape(kind), mesh=fake_mesh)
    assert rec["status"] == "ok"
    assert rec["cost"]["flops_per_device"] > 0
    gathers = rec["collectives"]["all-gather"]["count"]
    if kind == "train_4k":
        model = build_model(cfg)
        whole = _whole_but_stored_cut(model, cfg, fake_mesh)
        kinds = [s.kind for s in getattr(model, "plan", [])]
        up = 2 * sum(k in ("mlstm", "slstm") for k in kinds) \
            + 2 * kinds.count("slstm") + 3 * kinds.count("rglru")
        if cfg.n_experts or cfg.family == "audio":
            assert gathers >= whole
        else:
            assert gathers == whole + up
    else:
        assert gathers > 0
    n_rglru = sum(s.kind == "rglru" for s in getattr(build_model(cfg),
                                                       "plan", []))
    scatters = rec["collectives"]["reduce-scatter"]["count"]
    assert scatters >= n_rglru * (2 if kind == "train_4k" else 1)
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-v2-236b"])
def test_decode_cell_holds_its_cache_slots(fake_mesh, arch):
    """A decode cell at two cache lengths (64 and 128 slots) on the fake
    (2, 2) world: the inputs a rank holds grow by exactly the whole
    cache's growth / (dp x tp) (its rows and its slots of every GQA or
    MLA latent cache, which the specs cut on the sequence), and its peak
    by less than 3 x that (its slots and one layer's fp32 copies of
    them; gathering its rows whole would add its rows, twice its
    slots, besides); the FLOPs grow by its rows' attention over its new
    slots (MLA's absorbed scores and latent output: 2 H (2 R_kv +
    R_rope) a slot, more than the analytic 2 H (qk + v) a slot)."""
    from repro_torch.serve.step import cache_sds

    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    recs, whole = [], []
    for cap in (64, 128):
        shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=cap,
                                    global_batch=4)
        recs.append(D.run_cell(arch, "decode_32k", False, device="cpu",
                               cfg=cfg, shape=shape, mesh=fake_mesh))
        whole.append(sum(t.numel() * t.element_size() for c in cache_sds(
            model, cfg, shape) for t in vars(c).values()
            if isinstance(t, torch.Tensor)))
    args = [r["memory"]["argument_bytes"] for r in recs]
    peaks = [r["memory"]["peak_bytes"] for r in recs]
    assert args[1] - args[0] == (whole[1] - whole[0]) // 4
    assert peaks[1] - peaks[0] < 3 * (args[1] - args[0])
    h = cfg.n_heads
    slot = 2 * h * (2 * cfg.kv_lora_rank + cfg.qk_rope_dim) \
        if cfg.attn_kind == "mla" else 2 * 2 * h * cfg.resolved_head_dim
    got = [r["cost"]["flops_per_device"] for r in recs]
    assert got[1] - got[0] == pytest.approx(
        2 * cfg.n_layers * (64 // 2) * slot, rel=EXACT)


#: smoke configs whose attention leaves a remainder on a 2-way 'model'
#: axis: one KV head (each rank picks it), one query head (whole)
REMAINDER_CFGS = {"granite-kv1": ("granite-8b", {"n_kv_heads": 1}),
                  "starcoder2-h1": ("starcoder2-3b", {"n_heads": 1,
                                                      "n_kv_heads": 1})}


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("name", list(REMAINDER_CFGS))
def test_tp_flops_count_the_replicated_remainder(fake_mesh, name, kind):
    """A rank's FLOPs where the layout leaves part of attention above
    its share (picked KV heads; starcoder2-h1's one head on rank 0 of
    2): its share of the count plus that part, exactly, and in a decode
    step of the uneven head or KV head cut, which projects on its stored
    columns, its share exactly."""
    arch, over = REMAINDER_CFGS[name]
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    shape = _smoke_shape(kind)
    rec = D.run_cell(arch, kind, False, device="cpu", cfg=cfg, shape=shape,
                     mesh=fake_mesh)
    assert rec["cost"]["flops_per_device"] == pytest.approx(
        _expected_flops(cfg, shape), rel=EXACT)
    even = _expected_flops(cfg, shape, remainder=False)
    if kind == "decode_32k":
        assert rec["cost"]["flops_per_device"] == pytest.approx(
            even, rel=EXACT)
    else:
        # the remainder is there: more than the even share
        assert rec["cost"]["flops_per_device"] > even


_FULL_WIDTH_TRACE = """
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import SHAPES
from repro_torch.roofline import step_flops
D.fake_world(256)
mesh = make_mesh((16, 16), ("data", "model"), device_type="cpu")
cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=2)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=128,
                            global_batch=16)
rec = D.run_cell("stablelm-1.6b", "train_4k", False, device="cpu", cfg=cfg,
                 shape=shape, mesh=mesh)
# step_flops runs the logits 4 times (its remat multiplier); the loss
# is outside the remat, so they run 3 times
logits = 2 * shape.tokens * cfg.d_model * cfg.vocab
print(json.dumps({"status": rec["status"],
                  "flops": rec["cost"]["flops_per_device"],
                  "share": (step_flops(cfg, shape) - logits) / 256,
                  "gathers": rec["collectives"]["all-gather"]["count"]}))
"""


def test_full_width_train_flops_a_rank_on_a_16x16_world():
    """stablelm-1.6b at full width (32 heads, 5632 FF, 100352 vocab),
    cut to 2 layers and 16 x 128 tokens, on rank 0 of a fake (16, 16)
    world (its own process: this module's fixture made a 4-rank world
    here): the rank's FLOPs are its 1/256 share of the analytic count,
    not the whole model's 1/16 (fake tensors: no storage).  At 2 layers
    the logits are most of the count, so the share takes off the fourth
    pass over them that ``step_flops``'s remat multiplier adds (the loss
    is not recomputed)."""
    import subprocess

    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", _FULL_WIDTH_TRACE],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["status"] == "ok" and got["gathers"] == 0
    assert 0.95 <= got["flops"] / got["share"] <= 1.1, got


_MLA_WIDTH_TRACE = """
import dataclasses, json
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import mla as MLA
from repro_torch.models.config import SHAPES
D.fake_world(256)
mesh = make_mesh((16, 16), ("data", "model"), device_type="cpu")
cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=2)
shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=%d,
                            global_batch=16)
modes, mixer, gathered = [], [], []

class Probe(D.TraceMode):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        modes.append(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = getattr(func, "_overloadpacket", None)
        kind = packet and D._COLL_OPS.get((func.namespace, packet.__name__))
        if kind == "all-gather" and out is not NotImplemented:
            written = D._tensors(args[0] if func.namespace == "c10d" else out)
            gathered.append(sum(t.numel() for t in written))
        return out

def counted(p, *args, **kwargs):
    f0 = modes[-1].flops
    out = train(p, *args, **kwargs)
    mixer.append({"flops": modes[-1].flops - f0,
                  "shapes": {k: list(p[k].shape) for k in p}})
    return out

train, MLA.mla_train, D.TraceMode = MLA.mla_train, counted, Probe
rec = D.run_cell("deepseek-v2-236b", "prefill_32k", False, device="cpu",
                 cfg=cfg, shape=shape, mesh=mesh)
print(json.dumps({"status": rec["status"], "mixer": mixer,
                  "gathered": gathered}))
"""
#: the full-width MLA trace's prompt: one query chunk of the chunked core
MLA_TRACE_SEQ = 256


def test_full_width_mla_flops_a_rank_on_a_16x16_world():
    """deepseek-v2-236b at full width (128 heads, kv_lora 512, q_lora
    1536), cut to 2 layers and a 256-token prefill (16 rows: one a data
    rank), traced on rank 0 of a fake (16, 16) world in its own process:
    each MLA mixer's FLOPs a rank are its heads-cut terms over 16 (wq_b,
    wk_b, wv_b, the attention core on its 8 heads, wo) plus the latent
    projections whole (wq_a, wkv_a, wk_rope), exactly; the mixer is given
    its 1 / 16 of the heads' weights, and no all-gather of the step is
    the size of a whole ``wq_b``, ``wk_b``, ``wv_b`` or ``wo``."""
    import subprocess

    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run(
        [sys.executable, "-c", _MLA_WIDTH_TRACE % MLA_TRACE_SEQ], env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["status"] == "ok"
    cfg = get_config("deepseek-v2-236b")
    tp, b, s = 16, 1, MLA_TRACE_SEQ
    t, d, h = b * s, cfg.d_model, cfg.n_heads // tp
    qk, nope, v = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.qk_nope_dim, \
        cfg.v_head_dim
    latents = 2 * t * d * (cfg.q_lora_rank + cfg.kv_lora_rank
                           + cfg.qk_rope_dim)
    # the chunked core scores every key of its one chunk: 2 b h S^2 (qk + v)
    heads = (2 * t * cfg.q_lora_rank * h * qk
             + 2 * t * cfg.kv_lora_rank * h * (nope + v)
             + 2 * b * h * s * s * (qk + v)
             + 2 * t * h * v * d)
    assert len(got["mixer"]) == 2
    for call in got["mixer"]:
        assert call["flops"] == pytest.approx(latents + heads, rel=EXACT)
        assert call["shapes"]["wq_b"] == [cfg.q_lora_rank, h * qk]
        assert call["shapes"]["wk_b"] == [cfg.kv_lora_rank, h * nope]
        assert call["shapes"]["wv_b"] == [cfg.kv_lora_rank, h * v]
        assert call["shapes"]["wo"] == [h * v, d]
        assert call["shapes"]["wq_a"] == [d, cfg.q_lora_rank]
    whole = {cfg.q_lora_rank * cfg.n_heads * qk,
             cfg.kv_lora_rank * cfg.n_heads * nope,
             cfg.kv_lora_rank * cfg.n_heads * v, cfg.n_heads * v * d}
    assert got["gathered"] and not whole & set(got["gathered"]), got


#: xlstm's smoke cells at two lengths: one mLSTM chunk of 256, and 16
XLSTM_LENGTHS = (256, 4096)
XLSTM_KINDS = ("train_4k", "prefill_32k")


@pytest.fixture(scope="module")
def xlstm_traces(fake_mesh):
    """xlstm's smoke config (2 sLSTM and 2 mLSTM layers) traced on the
    fake (2, 2) world at each length and kind: the trace's record, ops
    dispatched, and the ops dispatched inside each sLSTM and mLSTM mixer
    call (read from the trace mode's counter around the call)."""
    from repro_torch.models import xlstm as X

    modes = []

    class Probe(D.TraceMode):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            modes.append(self)

    def counted(fn, log):
        def call(*args, **kwargs):
            n0 = modes[-1].ops
            out = fn(*args, **kwargs)
            log.append(modes[-1].ops - n0)
            return out
        return call

    cfg = get_smoke_config("xlstm-125m")
    model = build_model(cfg)
    out = {}
    for kind in XLSTM_KINDS:
        for s in XLSTM_LENGTHS:
            shape = dataclasses.replace(SHAPES[kind], seq_len=s,
                                        global_batch=4)
            logs = {"slstm": [], "mlstm": []}
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(D, "TraceMode", Probe)
                mp.setattr(X, "slstm_train",
                           counted(X.slstm_train, logs["slstm"]))
                mp.setattr(X, "mlstm_train",
                           counted(X.mlstm_train, logs["mlstm"]))
                with FakeTensorMode(allow_non_fake_inputs=True):
                    fn, args = D.build_cell(model, cfg, shape, fake_mesh,
                                            "cpu")
                    seen = D.trace_cell(fn, args, "cpu")
            out[kind, s] = {**seen, **logs}
    return cfg, model, out


@pytest.mark.parametrize("kind", XLSTM_KINDS)
def test_xlstm_trace_does_not_grow_with_the_sequence(xlstm_traces, kind):
    """The sLSTM is one op a layer (and one backward op), so its layers
    dispatch the same ops at 256 and 4096 tokens; what grows is the
    mLSTM's chunk loop (and, in training, its backward and the loss's
    512-token chunks)."""
    cfg, model, traces = xlstm_traces
    n_slstm = sum(s.kind == "slstm" for s in model.plan)
    short, long = (traces[kind, s] for s in XLSTM_LENGTHS)
    if kind == "train_4k":
        # the forward and the remat's recompute, then the backward
        want = {"repro_torch::slstm_scan": 2 * n_slstm,
                "repro_torch::slstm_scan_backward": n_slstm}
    else:
        want = {"repro_torch::slstm_scan": n_slstm}
    for seen in (short, long):
        assert seen["kernel_ops"] == want
        # the calls that return: the remat's recompute stops once it
        # has its last saved tensor
        assert len(seen["slstm"]) == n_slstm
    assert long["slstm"] == short["slstm"]
    grown = long["ops"] - short["ops"]
    mlstm_grown = sum(long["mlstm"]) - sum(short["mlstm"])
    assert mlstm_grown > 0
    if kind == "prefill_32k":
        assert grown == mlstm_grown
    # below what the sLSTM's token loop alone would add: 15 ops a token
    # a layer in the forward
    chunks = (XLSTM_LENGTHS[1] - XLSTM_LENGTHS[0]) // 256
    assert grown < chunks * 256 * 15 * n_slstm


def _xlstm_other_half(cfg, n: int, kind: str, tp: int = 2,
                      rows: int = 2, cores: bool = True) -> int:
    """The FLOPs of the xLSTM blocks' products that a ``tp``-way 'model'
    axis leaves to the other ranks, (tp - 1) / tp of each, on rank 0's
    ``n`` tokens in ``rows`` rows of one mLSTM chunk each: every
    projection (the mLSTM's w_up, wq, wk, wv, its gates' and w_down, the
    sLSTM's w_up, w_down and its hoisted input product x @ w_in: each
    on its columns or rows) and the mLSTM core's key-dim terms (the
    scores q·k, the inter-chunk q·C and q·n, the state's C and n; the
    intra-chunk product of the scores with v runs on every rank).  In
    training the forward's, the remat's recompute but for w_down (the
    recompute stops at its last saved tensor) and the backward's: two
    products each projection, and in the core the gradients of q and k
    through the scores and of q through q·C and q·n (one chunk: the
    initial state is a constant and the final one unused).  Without
    ``cores``, a layout that computes the sLSTM's input product and the
    mLSTM core whole on every rank."""
    d, h = cfg.d_model, cfg.n_heads
    di = 2 * d
    dh = di // h
    ch = n // rows
    scores, inter, vec = 2 * n * h * ch * dh, 2 * n * h * dh * dh, \
        2 * n * h * dh
    core_fwd = scores + 2 * inter + 2 * vec
    core_bwd = 2 * scores + inter + vec
    whole = {"mlstm": (2 * n * d * 2 * di + 6 * n * di * di
                       + 4 * n * di * h, 2 * n * di * d),
             "slstm": (2 * n * d * 2 * d + cores * 2 * n * d * 4 * d,
                       2 * n * d * d)}
    total = 0
    for s in build_model(cfg).plan:
        body, down = whole[s.kind]
        total += 4 * (body + down) - down if kind == "train_4k" \
            else body + down
        if s.kind == "mlstm" and cores:
            total += 2 * core_fwd + core_bwd if kind == "train_4k" \
                else core_fwd
    return total * (tp - 1) // tp


def _xlstm_loop_flops(model, cfg, kind: str, s: int, rows: int) -> int:
    """``FlopCounterMode``'s count of ``rows`` rows of ``s`` tokens
    through the single-device train step or prefill with the sLSTM's
    plain loop (fake tensors)."""
    from torch.utils._pytree import tree_map as tmap
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import xlstm as X
    from repro_torch.models.params import abstract_params
    from repro_torch.serve.step import build_prefill, prefill_batch_sds
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import (abstract_state, build_train_step,
                                        train_batch_sds)

    shape = dataclasses.replace(SHAPES[kind], seq_len=s, global_batch=rows)
    if kind == "train_4k":
        fn, _, _ = build_train_step(model, cfg, AdamWConfig())
        tree = (abstract_state(model, cfg, AdamWConfig(), D.DTYPE),
                train_batch_sds(cfg, shape, D.DTYPE))
    else:
        fn, _, _ = build_prefill(model, cfg, shape, None)
        tree = (abstract_params(model.defs, D.DTYPE),
                prefill_batch_sds(cfg, shape, D.DTYPE))
    with pytest.MonkeyPatch.context() as mp, \
            FakeTensorMode(allow_non_fake_inputs=True):
        mp.setattr(X, "slstm_train", X.slstm_train_loop)
        args = tmap(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)
        with FlopCounterMode(display=False) as fc:
            fn(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", XLSTM_KINDS)
def test_xlstm_trace_flops_equal_the_loop(xlstm_traces, kind):
    """At 256 tokens the trace's FLOPs on rank 0 (the op's formulas)
    equal ``FlopCounterMode``'s count of the same rows through the
    single-device function with the sLSTM's plain loop, less the half
    of the logits that the vocab cut over the 2-way 'model' axis leaves
    to the other rank (the forward's and, in training, the backward's
    two products: three times the forward's) and the half of the
    blocks' cut products that the axis leaves there
    (:func:`_xlstm_other_half`)."""
    cfg, model, traces = xlstm_traces
    s = XLSTM_LENGTHS[0]
    rows = 2 * (s if kind == "train_4k" else 1)    # the logits' rows
    passes = 3 if kind == "train_4k" else 1
    other_half = passes * 2 * rows * cfg.d_model * cfg.vocab // 2 \
        + _xlstm_other_half(cfg, 2 * s, kind)
    assert traces[kind, s]["flops"] == _xlstm_loop_flops(
        model, cfg, kind, s, 2) - other_half


_XLSTM_4WAY = """
import dataclasses, json, sys
sys.path.insert(0, %r)
import test_torch_dryrun as T
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import SHAPES
D.fake_world(4)
mesh = make_mesh((1, 4), ("data", "model"), device_type="cpu")
cfg = get_smoke_config("xlstm-125m")
out = {}
for kind in T.XLSTM_KINDS:
    shape = dataclasses.replace(SHAPES[kind], seq_len=256, global_batch=2)
    rec = D.run_cell("xlstm-125m", kind, False, device="cpu", cfg=cfg,
                     shape=shape, mesh=mesh)
    out[kind] = {"status": rec["status"],
                 "flops": rec["cost"]["flops_per_device"],
                 "loop": T._xlstm_loop_flops(build_model(cfg), cfg, kind,
                                             256, 2)}
print(json.dumps(out))
"""


def test_xlstm_flops_a_rank_fall_on_a_4_way_axis():
    """xlstm's smoke cells at 256 tokens on rank 0 of a fake (1, 4) world
    (its own process: this module's fixture made a 4-rank (2, 2) world
    here): the trace's FLOPs are the loop's less the other three ranks'
    3/4 of the logits and of every cut product (:func:`_xlstm_other_half`
    at tp 4), so they fall below a layout that computes the sLSTM's
    input product and the mLSTM core whole on every rank by 3/4 of
    those terms, the rank computing 1/4 of them."""
    import subprocess

    from repro_torch.configs import build_model

    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", _XLSTM_4WAY % os.path.join(
        ROOT, "tests")], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    cfg = get_smoke_config("xlstm-125m")
    d, n, s = cfg.d_model, 512, 256
    for kind in XLSTM_KINDS:
        rec = got[kind]
        rows = 2 * (s if kind == "train_4k" else 1)
        passes = 3 if kind == "train_4k" else 1
        logits = passes * 2 * rows * d * cfg.vocab * 3 // 4
        other = _xlstm_other_half(cfg, n, kind, tp=4)
        whole_cores = rec["loop"] - logits - _xlstm_other_half(
            cfg, n, kind, tp=4, cores=False)
        assert rec["status"] == "ok"
        assert rec["flops"] == rec["loop"] - logits - other, (kind, rec)
        # at 256 tokens the cut terms are a third of the loop's count or
        # more; a rank keeps a quarter of them
        assert rec["flops"] < 0.75 * whole_cores, (kind, rec, whole_cores)


def test_skipped_cell_writes_its_reason():
    rec = D.run_cell("stablelm-1.6b", "long_500k", False, device="cpu")
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]


def test_smoke_prefill_routine_mix_matches_reference(smoke_records,
                                                     monkeypatch):
    import jax
    import jax.numpy as jnp

    from repro.configs import build_model as jax_build_model
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.kernels.recorder import DispatchRecorder as JaxRecorder
    from repro.models.params import abstract_params as jax_abstract
    from repro.serve.step import build_prefill as jax_build_prefill
    from repro.serve.step import prefill_batch_sds as jax_prefill_sds

    _, recs = smoke_records
    jcfg = jax_smoke_config("stablelm-1.6b")
    jmodel = jax_build_model(jcfg)
    shape = _smoke_shape("prefill_32k")
    # rank 0's rows: a mix by events weighs attention by its batch-heads
    jshape = dataclasses.replace(JSHAPES["prefill_32k"],
                                 seq_len=shape.seq_len,
                                 global_batch=shape.global_batch // 2)
    fn, _, _ = jax_build_prefill(jmodel, jcfg, jshape, None)
    with monkeypatch.context() as env:
        # the reference's kernel path: its xla backend records the
        # SYRK-scores events the port never makes
        env.setenv("ADSALA_BACKEND", "pallas")
        with JaxRecorder() as jrec:
            jax.jit(fn).lower(jax_abstract(jmodel.defs, jnp.bfloat16),
                              jax_prefill_sds(jcfg, jshape, jnp.bfloat16))
    got = recs["prefill_32k"]["dispatch"]
    for by, want in (("routine_mix", jrec.routine_mix()),
                     ("routine_mix_events",
                      jrec.routine_mix(by="events"))):
        assert got[by].keys() == want.keys()
        for r in want:
            assert got[by][r] == pytest.approx(want[r], rel=1e-9), (by, r)
    # the port records every layer, the reference's scan its unit once
    assert got["events"] == len(jrec.events) * jcfg.n_layers


def test_profile_folds_the_port_records(smoke_records, tmp_path):
    from repro_torch.core.workload import WorkloadProfile
    from repro_torch.launch import profile

    out_dir, recs = smoke_records
    dest = tmp_path / "profile.json"
    profile.main(["--dryrun-dir", str(out_dir), "--out", str(dest)])
    prof = WorkloadProfile.load(str(dest))
    parts = [WorkloadProfile.from_dispatch_block(r["dispatch"])
             for r in recs.values()]
    want = WorkloadProfile.merge(parts)
    assert prof.total == pytest.approx(want.total, rel=1e-12)
    assert prof.routine_weights == pytest.approx(want.routine_weights,
                                                 rel=1e-12)
    assert prof.routine_weights["gemm"] > 0 \
        and prof.routine_weights["attn"] > 0


# ---------------------------------------------------------------------------
# the kernels' torch ops on fake CUDA tensors
# ---------------------------------------------------------------------------

def _meta_twin(x):
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    return x


class _CudaIndexing(TorchFunctionMode):
    """Python indexing of fake CUDA tensors on a CPU-only torch: the
    index computed on ``meta`` twins, a fresh fake CUDA tensor of its
    shape returned (a write is a no-op: fake tensors hold no data)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__) \
                and args[0].device.type == "cuda":
            out = func(*pytree_map(_meta_twin, args))
            if func is torch.Tensor.__setitem__:
                return None
            return torch.empty_strided(out.shape, out.stride(),
                                       dtype=out.dtype,
                                       device=args[0].device)
        return func(*args, **(kwargs or {}))


OP_CASES = [
    ("matmul", (96, 40), (40, 72), torch.float32, torch.float32),
    ("matmul", (64, 64), (64, 32), torch.bfloat16, torch.float32),
    ("grouped", (4, 24, 40), (4, 40, 72), torch.float32, torch.float32),
    ("grouped", (8, 3, 64), (8, 64, 48), torch.bfloat16, torch.bfloat16),
    ("flash", (6, 40, 64), "dense", torch.float32, None),
    ("flash", (6, 40, 80), "tri", torch.bfloat16, None),
    ("flash", (4, 33, 192), "dense", torch.float16, None),
]


@pytest.mark.parametrize("case", OP_CASES, ids=lambda c: c[0])
def test_op_fake_output_matches_plain_version(case):
    name, xs, ws, dt, out_dt = case
    gen = torch.Generator().manual_seed(0)

    def real(shape):
        return torch.randn(shape, generator=gen).to(dt)

    if name == "flash":
        plain = FA.flash_attention_torch(real(xs), real(xs), real(xs),
                                         bq=16, bkv=16, grid=ws)
    elif name == "matmul":
        plain = M.matmul_torch(real(xs), real(ws), out_dtype=out_dt)
    else:
        plain = G.grouped_matmul_torch(real(xs), real(ws), out_dtype=out_dt)
    before = (M.matmul_cuda.launches, G.grouped_matmul_cuda.launches,
              FA.flash_attention_cuda.launches)
    with FakeTensorMode():
        def fake(shape):
            return torch.empty(shape, dtype=dt, device="cuda")
        if name == "flash":
            q = fake(xs)
            out = FA.flash_attention_cuda(q, fake(xs), fake(xs), bq=16,
                                          bkv=16, grid=ws)
        elif name == "matmul":
            out = M.matmul_cuda(fake(xs), fake(ws), out_dtype=out_dt)
        else:
            out = G.grouped_matmul_cuda(fake(xs), fake(ws),
                                        out_dtype=out_dt)
    assert out.shape == plain.shape and out.dtype == plain.dtype
    assert out.device.type == "cuda"
    # a traced call is not a launch, and builds nothing
    assert (M.matmul_cuda.launches, G.grouped_matmul_cuda.launches,
            FA.flash_attention_cuda.launches) == before
    assert _build._lib is None


def test_op_flop_formulas():
    """Each op counted under ``FlopCounterMode`` by the function
    ``chip_smoke.py``'s bounds use."""
    with FakeTensorMode(), FlopCounterMode(display=False) as fc:
        M.matmul_cuda(torch.empty((96, 40), device="cuda"),
                      torch.empty((40, 72), device="cuda"))
        G.grouped_matmul_cuda(torch.empty((4, 24, 40), device="cuda"),
                              torch.empty((4, 40, 72), device="cuda"))
        q = torch.empty((6, 40, 80), device="cuda")
        FA.flash_attention_cuda(q, q, q, window=7, grid="tri")
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert counts["repro_torch.matmul"] == M.matmul_flops(96, 40, 72) \
        == 2 * 96 * 40 * 72
    assert counts["repro_torch.grouped_matmul"] == \
        G.grouped_flops(4, 24, 40, 72) == 2 * 4 * 24 * 40 * 72
    # the true head dim (80, not the padded 128), visible pairs only
    pairs = sum(min(i + 1, 7) for i in range(40))
    assert counts["repro_torch.flash_attention"] == \
        FA.flash_flops(6, 40, 40, 80, True, 7) == 4 * 6 * 80 * pairs


@pytest.mark.parametrize("sq,skv,causal,window", [
    (37, 37, True, None), (37, 37, False, None), (50, 50, True, 9),
    (20, 12, True, 5), (12, 20, False, 4), (9, 9, True, 1)])
def test_visible_pairs_count_the_plain_mask(sq, skv, causal, window):
    i = np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    mask = np.ones((sq, skv), bool)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    assert FA.visible_pairs(sq, skv, causal, window) == int(mask.sum())


def test_fake_cuda_prefill_traces_the_flash_op():
    from repro_torch.models.params import abstract_params, tree_map
    from repro_torch.serve.step import build_prefill

    cfg = get_smoke_config("stablelm-1.6b")
    model = build_model(cfg)
    b, s = 2, 64
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=s,
                                global_batch=b)
    fn, _, _ = build_prefill(model, cfg, shape, None)
    launches = FA.flash_attention_cuda.launches
    with FakeTensorMode(allow_non_fake_inputs=True), _CudaIndexing():
        params = tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device="cuda"),
            abstract_params(model.defs, torch.bfloat16))
        batch = {"tokens": torch.zeros((b, s), dtype=torch.int32,
                                       device="cuda")}
        seen = D.trace_cell(fn, (params, batch), "cuda")
        with FlopCounterMode(display=False) as fc:
            fn(params, batch)
    assert seen["kernel_ops"] == {"repro_torch::flash_attention":
                                  cfg.n_layers}
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert by_op["repro_torch.flash_attention"] == cfg.n_layers * \
        FA.flash_flops(b * cfg.n_heads, s, s, cfg.resolved_head_dim, True,
                       None)
    # no DTensor here, so the dry run's count is FlopCounterMode's
    assert seen["flops"] == fc.get_total_flops()
    assert seen["peak_bytes"] > 0
    assert FA.flash_attention_cuda.launches == launches
    assert _build._lib is None


# ---------------------------------------------------------------------------
# the examples, on the CPU
# ---------------------------------------------------------------------------

def _example(name: str):
    sys.path.insert(0, EXAMPLES)
    try:
        import importlib
        return importlib.import_module(name)
    finally:
        sys.path.remove(EXAMPLES)


#: the runtime model's evaluation latency (µs) both installs are given,
#: by model class: each install measures it on the host clock
#: (``_measure_eval_time``) and selects its model by the estimated
#: speedup it enters, so two installs under load could pick differently
T_EVAL_US = {"LinearRegression": 30.0, "BayesianRidgeRegression": 40.0,
             "DecisionTreeRegressor": 60.0, "XGBRegressor": 400.0}


def _fixed_eval_time(model, pipe, n_candidates, **kwargs) -> float:
    return T_EVAL_US[type(model).__name__]


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    from repro_torch.core import installer

    art = tmp_path_factory.mktemp("quickstart")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(installer, "_measure_eval_time", _fixed_eval_time)
        out = _example("quickstart_torch").main(
            ["--backend", "simulated", "--device", "cpu", "--artifact",
             str(art), "--samples", "40"])
    return art, out


def test_quickstart_picks_match_the_reference(quickstart, tmp_path,
                                              monkeypatch):
    """The reference quickstart's logic (examples/quickstart.py) at the
    same budget and seed makes the same picks, both installs given the
    same evaluation latency per model class (T_EVAL_US)."""
    from repro.core import AdsalaTuner, InstallConfig, SimulatedBackend, \
        gather_data, install
    from repro.core import installer

    monkeypatch.setattr(installer, "_measure_eval_time", _fixed_eval_time)
    _, out = quickstart
    cfg = InstallConfig(
        n_samples=40, repeats=2, tile_ids=(0, 3),
        models=("linear_regression", "bayesian_regression",
                "decision_tree", "xgboost"),
        grid_budget="small", cv_splits=3, seed=0)
    backend = SimulatedBackend(seed=0)
    report = install(backend, cfg, data=gather_data(backend, cfg),
                     artifact_dir=str(tmp_path))
    tuner = AdsalaTuner.from_artifact(str(tmp_path))
    assert out["selected"] == report.selected
    for (m, k, n), pick in out["picks"].items():
        want = tuner.select(m, k, n)
        assert (pick.n_chips, pick.partition, pick.tile) == \
            (want.n_chips, want.partition, want.tile), (m, k, n)
    assert out["speedup"] > 0


def test_serve_with_tuner_example(quickstart):
    art, _ = quickstart
    res = _example("serve_with_tuner_torch").main(
        ["--device", "cpu", "--artifact", str(art)])
    assert tuple(res.tokens.shape) == (4, 12)
    assert torch.isfinite(res.prefill_logits).all()


def test_train_e2e_example_loss_falls(tmp_path):
    out = _example("train_e2e_torch").main(
        ["--device", "cpu", "--steps", "10", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path)])
    assert out["summary"]["step"] == 10
    assert out["losses"][-1] < out["losses"][0]
    assert os.path.isdir(tmp_path / "step_00000010")


def test_examples_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("quickstart_torch", "serve_with_tuner_torch",
                 "train_e2e_torch"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            _example(name).main([])


# ---------------------------------------------------------------------------
# the entry-point helpers fall back to the CPU nowhere
# ---------------------------------------------------------------------------

def test_mesh_and_batch_helpers_raise_without_a_card(monkeypatch):
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="device_type='cpu'"):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="device_type='cpu'"):
        make_production_mesh()
    batch = {"tokens": np.zeros((2, 4), np.int32)}
    with pytest.raises(ValueError, match="device='cpu'"):
        make_global_batch(batch, None)
    got = make_global_batch(batch, None, device="cpu")
    assert got["tokens"].device.type == "cpu"


def test_dryrun_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        D.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                "--out", str(tmp_path)])
