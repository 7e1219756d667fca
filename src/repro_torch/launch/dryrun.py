"""Dry run of the port: trace every (arch x shape) cell on the production
meshes and record memory, FLOPs, collectives and the dispatch mix.

MUST be executed as its own process (``python -m
repro_torch.launch.dryrun``): the ``fake`` process group it creates is
global to the process.

The reference (``repro.launch.dryrun``) lowers and compiles each cell
with XLA on 512 placeholder devices.  Here rank 0 of a ``fake`` world of
256 (``--mesh single``, (16, 16) ``("data", "model")``) or 512 ranks
(``multi``, (2, 16, 16) with ``"pod"``) traces the cell under
``FakeTensorMode``: the state, parameters, batch and caches are fake
DTensors laid out by the specs of ``repro_torch.dist`` (no storage, no
data), the built train, prefill or decode function runs on them, the
collectives go to the fake process group, and the Hopper kernels'
torch ops (``repro_torch::matmul``, ``::grouped_matmul``,
``::flash_attention``) return their fake outputs and are counted by
their FLOP formulas.  Nothing is compiled, built or launched, so
``--device cuda`` needs a card only for the device's type, and
``--device cpu`` traces the kernels' plain versions.

Per cell this writes ``results/dryrun_torch/<arch>_<shape>_<mesh>.json``
with the reference's record keys, each filled with its torch
counterpart (:func:`run_cell`):

  lower_s       the trace's seconds
  compile_s     None: there is no compile step
  memory        rank 0's local bytes of the inputs and outputs, the
                peak of the bytes alive on the device during the trace
                (inputs included), and temp = peak - argument
  cost          FLOPs on rank 0 by ``torch.utils.flop_counter``'s
                formulas (the kernels' ops by their own); bytes: None
  collectives   per kind: count and rank 0's output bytes of every
                collective dispatched, checked against
                ``CommDebugMode``'s count; the loop keys are 0 (the
                layer loop is unrolled in Python)
  dispatch      the ``DispatchRecorder`` block, as the reference's
  model, loops  the reference's arithmetic
  kernel_ops    how many times each ``repro_torch::*`` op was traced
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import weakref
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.kernels.recorder import DispatchRecorder
from repro_torch.models.config import SHAPES, ArchConfig, ShapeSpec

__all__ = ["LONG_OK", "cell_is_runnable", "build_cell", "trace_cell",
           "run_cell", "fake_world", "fake_dtensor", "lay_out",
           "TraceMode", "COLL_KINDS", "main"]

DTYPE = torch.bfloat16

#: long_500k eligibility (DESIGN.md §Arch-applicability): sub-quadratic
#: state only — recurrent or window-bounded caches.
LONG_OK = {"mixtral-8x22b", "recurrentgemma-2b", "xlstm-125m"}


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_OK:
        return False, ("full-attention arch: 524288-token dense KV cache "
                       "is quadratic-cost; skipped per DESIGN.md")
    return True, ""


COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")

#: collective ops (namespace, name) -> the reference's kind
_COLL_OPS = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_c10d_functional_autograd", "all_reduce"): "all-reduce",
    ("_c10d_functional_autograd", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional_autograd", "reduce_scatter_tensor"):
        "reduce-scatter",
    ("_c10d_functional_autograd", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allreduce_coalesced_"): "all-reduce",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "allgather_into_tensor_coalesced_"): "all-gather",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "reduce_scatter_tensor_coalesced_"): "reduce-scatter",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
    ("c10d", "recv_"): "collective-permute",
}


def _tensors(tree: Any) -> list[torch.Tensor]:
    """The tensors of a pytree (an op's arguments or outputs; a
    DTensor's local piece in its place)."""
    from torch.utils._pytree import tree_leaves

    out = []
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            out.append(t)
    return out


def _cell_tensors(tree: Any) -> list[torch.Tensor]:
    """The local tensors of a cell's inputs or outputs, the fields of
    the cache dataclasses included."""
    from repro_torch.serve.step import _map_arrays

    out: list[torch.Tensor] = []
    _map_arrays(lambda t: out.append(
        t.to_local() if isinstance(t, DTensor) else t), tree)
    return out


def _nbytes(tensors: list[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class TraceMode(TorchDispatchMode):
    """What one trace dispatches, seen below DTensor (rank 0's local
    tensors): FLOPs, collectives, the port's kernel ops, the ops
    dispatched (``ops``, decompositions' ops included), and the bytes
    alive on ``device_type``.

    An op on DTensors returns ``NotImplemented``, so that DTensor runs it
    on the local pieces, which the mode then sees (``CommDebugMode`` does
    the same).  FLOPs are counted with ``torch.utils.flop_counter``'s
    registry as ``FlopCounterMode`` counts them (an op without a formula
    is decomposed first); memory by each storage the first time an op
    returns it, until the storage is freed.
    """

    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.flops = 0
        self.collectives = {k: {"count": 0, "bytes": 0, "loop_count": 0,
                                "loop_bytes": 0} for k in COLL_KINDS}
        self.kernel_ops: dict[str, int] = {}
        self.ops = 0
        self.live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def track(self, tensors: list[torch.Tensor]) -> None:
        """Count each new storage of ``tensors`` on the mode's device as
        alive until it is freed."""
        for t in tensors:
            if t.device.type != self.device_type:
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.live_bytes += st.nbytes()
            weakref.finalize(st, _free, weakref.ref(self), key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        self.ops += 1
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        ns, name = func.namespace, packet.__name__
        kind = _COLL_OPS.get((ns, name))
        if kind is not None:
            # rank 0's output: the result of a functional collective,
            # the buffers an in-place c10d collective writes (its first
            # argument)
            written = _tensors(args[0] if ns == "c10d" else out)
            self.collectives[kind]["count"] += 1
            self.collectives[kind]["bytes"] += _nbytes(written)
        if ns == "repro_torch":
            key = f"repro_torch::{name}"
            self.kernel_ops[key] = self.kernel_ops.get(key, 0) + 1
        self.track(_tensors(out))
        return out


def _free(mode_ref, key: int) -> None:
    mode = mode_ref()
    if mode is not None and key in mode.live:
        mode.live_bytes -= mode.live.pop(key)


def fake_dtensor(shape, dtype: torch.dtype, spec: tuple, mesh,
                 device: str):
    """A fake DTensor of global ``shape`` laid out by ``spec`` on
    ``mesh``: only this rank's local piece is made (inside
    ``FakeTensorMode``, without storage)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.dist.sharding import to_placements

    placements = to_placements(spec, mesh)
    with unset_fake_temporarily():
        local_shape, _ = compute_local_shape_and_global_offset(
            tuple(shape), mesh, placements)
    local = torch.empty(local_shape, dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def lay_out(tree: Any, specs: Any, mesh, device: str) -> Any:
    """``meta`` stand-ins -> fake DTensors laid out by the spec tree."""
    from repro_torch.serve.step import _map_arrays

    return _map_arrays(lambda t, spec: fake_dtensor(t.shape, t.dtype, spec,
                                                    mesh, device),
                       tree, specs)


def build_cell(model, cfg: ArchConfig, shape: ShapeSpec, mesh,
               device: str, dtype: torch.dtype = DTYPE) -> tuple:
    """(fn, args) of one cell: the built train, prefill or decode
    function and its inputs as fake DTensors on ``device``, parameters
    in ``dtype`` (call inside ``FakeTensorMode``), as the reference's
    ``build_cell``."""
    from repro_torch.models.params import abstract_params
    from repro_torch.serve.step import (build_decode, build_prefill,
                                        decode_inputs_sds,
                                        prefill_batch_sds)
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import (abstract_state, build_train_step,
                                        train_batch_sds)

    if shape.kind == "train":
        fn, s_specs, b_specs = build_train_step(
            model, cfg, AdamWConfig(), shape=shape, mesh=mesh)
        args = (lay_out(abstract_state(model, cfg, AdamWConfig(), dtype),
                        s_specs, mesh, device),
                lay_out(train_batch_sds(cfg, shape, dtype), b_specs, mesh,
                        device))
    elif shape.kind == "prefill":
        fn, p_specs, b_specs = build_prefill(model, cfg, shape, mesh)
        args = (lay_out(abstract_params(model.defs, dtype), p_specs, mesh,
                        device),
                lay_out(prefill_batch_sds(cfg, shape, dtype), b_specs,
                        mesh, device))
    else:
        fn, p_specs, (t_spec, c_specs, _) = build_decode(
            model, cfg, shape, mesh)
        token, cache, _ = decode_inputs_sds(model, cfg, shape, dtype)
        # the port's decode reads its position on the host: the stand-in
        # is the cache's last slot
        args = (lay_out(abstract_params(model.defs, dtype), p_specs, mesh,
                        device),
                lay_out(token, t_spec, mesh, device),
                lay_out(cache, c_specs, mesh, device),
                shape.seq_len - 1)
    return fn, args


def trace_cell(fn, args: tuple, device: str) -> dict:
    """Run ``fn(*args)`` once on the fake inputs under the trace mode,
    ``CommDebugMode`` and a ``DispatchRecorder``; return what they saw
    (call inside ``FakeTensorMode``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    mode = TraceMode(torch.device(device).type)
    inputs = _cell_tensors(args)
    mode.track(inputs)
    argument_bytes = mode.live_bytes
    t0 = time.perf_counter()
    with DispatchRecorder() as rec, CommDebugMode() as comm, mode:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    outs = [t for t in _cell_tensors(out)
            if t.device.type == mode.device_type]
    output_bytes = sum(
        st.nbytes() for st in {id(t.untyped_storage()): t.untyped_storage()
                               for t in outs}.values())
    comm_count = comm.get_total_counts()
    traced = sum(v["count"] for v in mode.collectives.values())
    if comm_count != traced:
        raise RuntimeError(f"collectives: traced {traced}, CommDebugMode "
                           f"counted {comm_count}")
    return {"trace_s": trace_s, "argument_bytes": argument_bytes,
            "output_bytes": output_bytes, "peak_bytes": mode.peak_bytes,
            "flops": mode.flops, "collectives": mode.collectives,
            "kernel_ops": dict(sorted(mode.kernel_ops.items())),
            "ops": mode.ops, "recorder": rec}


def _loops(model, cfg: ArchConfig) -> dict:
    """The reference's layer grouping (its scan's trip counts); the port
    runs the same layers one by one."""
    from repro_torch.models.transformer import _segments

    plan = getattr(model, "plan", None)
    prefix, unit, repeats, suffix = (_segments(plan) if plan
                                     else ([], [], 0, []))
    return {"layer_repeats": repeats, "prefix_layers": len(prefix),
            "suffix_layers": len(suffix), "unit_len": len(unit),
            "n_layers": cfg.n_layers}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             device: str = "cuda", cfg: ArchConfig | None = None,
             shape: ShapeSpec | None = None, mesh=None) -> dict:
    """Trace one cell on rank 0 of the current (fake) world and return
    its record.  ``cfg``, ``shape`` and ``mesh`` default to the
    registry's config, :data:`SHAPES` and the production mesh (which
    needs a world of 256 or 512 ranks)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_production_mesh

    mesh_name = "multi" if multi_pod else "single"
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "n_devices": 512 if multi_pod else 256,
                    "device": device}
    ok, why = cell_is_runnable(arch, shape_name)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = why
        return record
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=torch.device(device).type)
    record["n_devices"] = int(mesh.size())
    model = build_model(cfg)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = build_cell(model, cfg, shape, mesh, device)
        seen = trace_cell(fn, args, device)
        del fn, args
    rec = seen["recorder"]
    n_tok = shape.tokens if shape.kind != "decode" else shape.global_batch
    flops_factor = 6 if shape.kind == "train" else 2
    record.update({
        "status": "ok",
        "lower_s": round(seen["trace_s"], 2),
        "compile_s": None,
        "memory": {
            "argument_bytes": seen["argument_bytes"],
            "output_bytes": seen["output_bytes"],
            "temp_bytes": seen["peak_bytes"] - seen["argument_bytes"],
            "peak_bytes": seen["peak_bytes"],
        },
        "cost": {
            "flops_per_device": float(seen["flops"]),
            "bytes_per_device": None,
        },
        "collectives": seen["collectives"],
        "dispatch": {
            "events": len(rec.events),
            "routine_mix": rec.routine_mix(),
            "routine_mix_events": rec.routine_mix(by="events"),
            "summary": rec.summary(),
            "shapes": rec.shape_table(),
        },
        "model": {
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count(),
            "tokens": n_tok,
            "model_flops": flops_factor * cfg.active_param_count() * n_tok,
        },
        "loops": _loops(model, cfg),
        "kernel_ops": seen["kernel_ops"],
    })
    return record


def fake_world(world_size: int) -> None:
    """Make this process rank 0 of a ``fake`` world of ``world_size``
    ranks (no communication: every collective returns at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def main(argv: list[str] | None = None) -> None:
    import torch.distributed as dist

    ap = argparse.ArgumentParser(
        description="trace every (arch x shape) cell of the port on a "
                    "fake 256/512-rank world")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell for --mesh")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device type of the mesh and the fake "
                         "tensors: 'cuda' (the default) traces the "
                         "kernels' ops and needs a card; 'cpu' traces "
                         "their plain versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("[dryrun] --device cuda needs a CUDA device; pass "
                 "--device cpu to trace on the CPU")

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None \
        else [args.shape]
    meshes = [False, True] if args.mesh == "both" \
        else [args.mesh == "multi"]

    failures = 0
    for multi in meshes:
        mesh_name = "multi" if multi else "single"
        fake_world(512 if multi else 256)
        try:
            for arch in archs:
                for shape in shapes:
                    path = os.path.join(
                        args.out, f"{arch}_{shape}_{mesh_name}.json")
                    if os.path.exists(path):
                        print(f"[dryrun] cached {path}")
                        continue
                    print(f"[dryrun] {arch} x {shape} x {mesh_name} ...",
                          flush=True)
                    try:
                        rec = run_cell(arch, shape, multi,
                                       device=args.device)
                    except Exception as e:  # noqa: BLE001 - report, go on
                        rec = {"arch": arch, "shape": shape,
                               "mesh": mesh_name, "status": "error",
                               "error": f"{type(e).__name__}: {e}"}
                        failures += 1
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    extra = ""
                    if rec["status"] == "ok":
                        gib = rec["memory"]["peak_bytes"] / 2 ** 30
                        extra = (f" trace={rec['lower_s']}s "
                                 f"peak={gib:.2f}GiB/dev")
                    print(f"[dryrun]   -> {rec['status']}{extra}",
                          flush=True)
        finally:
            dist.destroy_process_group()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
