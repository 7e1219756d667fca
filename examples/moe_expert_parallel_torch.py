"""Expert-parallel MoE on a torch mesh: the deepseek-style path (route ->
all_to_all -> grouped GEMM -> all_to_all) of ``repro_torch``, on a gloo
world of CPU processes, or on one NCCL rank on the card.

Run:  PYTHONPATH=src python examples/moe_expert_parallel_torch.py
      PYTHONPATH=src python examples/moe_expert_parallel_torch.py --cuda

On the CPU it spawns 8 ranks on a (2, 4) ("data", "model") mesh, the
reference example's; with ``--cuda`` it runs one rank on a (1, 1) mesh,
where the grouped GEMM is the Hopper kernel behind a one-rank
all_to_all.  Each rank checks its rows against the single-device path.
"""

import argparse
import os
import sys
import tempfile

import torch
import torch.distributed as dist


def run(rank: int, world: int, shape: tuple, device: str, init: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import to_placements
    from repro_torch.models import moe as MOE
    from repro_torch.models.params import init_params

    backend = "nccl" if device == "cuda" else "gloo"
    if init:
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        mesh = init_device_mesh(device, shape,
                                mesh_dim_names=("data", "model"))
        spec = MOE.MoESpec(d_model=64, n_experts=8, top_k=2, d_ff=128,
                       capacity_factor=2.0, ep_axis="model")
        # the same weights and batch on every rank, from one seed
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(MOE.moe_defs(spec), gen)
        x = torch.randn((8, 32, 64), generator=gen, device=device)
        d, t = mesh.get_coordinate()
        b, s = 8 // shape[0], 32 // shape[1]
        rows = x[d * b:(d + 1) * b, t * s:(t + 1) * s]
        local = {k: C.local_at(w, mesh, to_placements(
            ("model", None, None) if k in MOE.EXPERT_WEIGHTS else (),
            mesh))
            for k, w in params.items()}
        with torch.no_grad():
            out, aux = MOE.apply_moe_ep(local, rows.contiguous(), spec,
                                        mesh=mesh)
            for axis in ("data", "model"):
                aux = C.pmean(aux, mesh.get_group(axis))
            ref, _ = MOE.apply_moe(params, x, spec)
        err = float((out - ref[d * b:(d + 1) * b, t * s:(t + 1) * s])
                    .abs().max())
        if rank == 0:
            print(f"[moe-ep] mesh {shape} on {device}: out "
                  f"{tuple(out.shape)} a rank, aux={float(aux):.4f}, "
                  f"max|EP - dense| = {err:.2e}")
            print("[moe-ep] OK" if err < 1e-3 else "[moe-ep] MISMATCH")
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cuda", action="store_true",
                    help="one NCCL rank on the card (default: 8 gloo "
                    "ranks on the CPU)")
    args = ap.parse_args()
    if args.cuda:
        run(0, 1, (1, 1), "cuda", "")
        return
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run, args=(8, (2, 4), "cpu",
                            f"file://{os.path.join(tmp, 'init')}"),
                 nprocs=8)


if __name__ == "__main__":
    sys.exit(main())
