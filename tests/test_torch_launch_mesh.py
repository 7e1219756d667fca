"""The training launcher on a mesh, on the CPU.

A spawned gloo world of 2 ranks (``init_method=file://``: no port) runs
``launch.train.train_config`` on a (1, 2) ("data", "model") mesh at
stablelm-1.6b's smoke config: an uninterrupted run of STEPS steps with a
checkpoint at step CKPT_EVERY, its final checkpoint restored onto the
mesh, then a ``--resume`` run from the step-CKPT_EVERY checkpoint alone.
This process runs the one-device launcher on the same batches: the mesh
run's losses within LOSS_TOL of it, the resumed run's too (it continues
the uninterrupted run), and the restored state bitwise the state in
memory.  Without a world: the mesh ``run`` builds from ``WORLD_SIZE``
and ``ADSALA_TP`` on fake worlds, and the refusal of a tp that does not
divide the world.
"""

import json
import shutil
import time

import pytest
import torch

pytestmark = pytest.mark.timeout(300)

ARCH, SEQ, BATCH, STEPS, CKPT_EVERY = "stablelm-1.6b", 16, 4, 5, 3
LOSS_TOL = 1e-5


def _args(ckpt: str, resume: bool = False):
    from repro_torch.launch.train import parse_args

    return parse_args(["--scale", "smoke", "--device", "cpu", "--steps",
                       str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
                       "--ckpt-dir", ckpt, "--ckpt-every", str(CKPT_EVERY)]
                      + (["--resume"] if resume else []))


def _world(rank, world, tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.ckpt.checkpoint import restore_checkpoint
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import train_config
    from repro_torch.models.params import tree_leaves

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (1, world),
                                mesh_dim_names=("data", "model"))
        cfg = get_smoke_config(ARCH)
        whole = train_config(cfg, _args(f"{tmp}/whole"), mesh=mesh)
        live = whole.driver.state
        back = restore_checkpoint(f"{tmp}/whole", STEPS, live, mesh=mesh,
                                  specs=whole.driver.specs)
        pairs = list(zip(tree_leaves(live), tree_leaves(back)))
        restored = all(isinstance(b, DTensor) and b.placements
                       == a.placements and torch.equal(b.to_local(),
                                                       a.to_local())
                       for a, b in pairs)
        if rank == 0:
            step = f"step_{CKPT_EVERY:08d}"
            shutil.copytree(f"{tmp}/whole/{step}", f"{tmp}/resume/{step}")
        dist.barrier()
        resumed = train_config(cfg, _args(f"{tmp}/resume", resume=True),
                               mesh=mesh)
        res = {"losses": whole.losses, "resumed_from": resumed.resumed_from,
               "resumed_losses": resumed.losses, "restored": restored,
               "leaves": len(pairs),
               "cut": sum(any(p.is_shard() for p in a.placements)
                          for a, _ in pairs),
               "all_dtensors": all(isinstance(a, DTensor)
                                   for a, _ in pairs),
               "ckpt_bytes": whole.ckpt_bytes}
        with open(f"{tmp}/res_{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank world's results and the one-device launcher's."""
    import torch.multiprocessing as mp

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import train_config

    tmp = tmp_path_factory.mktemp("launch_mesh")
    ctx = mp.start_processes(_world, args=(2, str(tmp)), nprocs=2,
                             join=False, start_method="spawn")
    single = train_config(get_smoke_config(ARCH), _args(str(tmp / "one")))
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("the 2-rank world did not finish")
    ranks = []
    for r in range(2):
        with open(tmp / f"res_{r}.json") as f:
            ranks.append(json.load(f))
    return single, ranks


def test_mesh_launcher_matches_the_one_device_launcher(runs):
    """STEPS steps on the (1, 2) mesh: the state DTensors, the stored
    cuts on 'model', and every rank's losses within LOSS_TOL of the
    one-device launcher's on the same batches."""
    single, ranks = runs
    assert len(single.losses) == STEPS
    for r in ranks:
        assert r["all_dtensors"] and r["cut"] > 0
        assert r["losses"] == pytest.approx(single.losses, abs=LOSS_TOL,
                                            rel=LOSS_TOL)
        assert r["ckpt_bytes"] > 0
    assert ranks[0]["losses"] == ranks[1]["losses"]


def test_mesh_launcher_checkpoint_restores_onto_the_mesh(runs):
    """The final checkpoint, which rank 0 wrote, restored onto the mesh
    by the state specs: every leaf bitwise the state in memory, in its
    layout."""
    _, ranks = runs
    for r in ranks:
        assert r["restored"] and r["leaves"] > 0


def test_mesh_launcher_resumes_the_uninterrupted_run(runs):
    """``--resume`` from the step-CKPT_EVERY checkpoint alone continues
    at that step, restored onto the mesh, with the losses of the
    uninterrupted runs' later steps."""
    single, ranks = runs
    for r in ranks:
        assert r["resumed_from"] == CKPT_EVERY
        assert len(r["resumed_losses"]) == STEPS - CKPT_EVERY
        assert r["resumed_losses"] == pytest.approx(
            r["losses"][CKPT_EVERY:], abs=LOSS_TOL, rel=LOSS_TOL)
        assert r["resumed_losses"] == pytest.approx(
            single.losses[CKPT_EVERY:], abs=LOSS_TOL, rel=LOSS_TOL)


@pytest.mark.parametrize("world, tp, want", [
    (2, None, (1, 2)), (8, None, (1, 8)), (8, "4", (2, 4)),
    (32, None, (2, 16)), (256, None, (16, 16)), (256, "8", (32, 8))])
def test_run_builds_its_mesh_from_the_world(monkeypatch, world, tp, want):
    """Under ``torchrun`` (``WORLD_SIZE`` set) ``--scale full`` trains on
    a mesh of the whole world (rank 0 of a fake world here): tp from
    ``ADSALA_TP``, by default min(16, world); 256 ranks give the
    reference's production mesh."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.train import launch_mesh, parse_args

    monkeypatch.setenv("WORLD_SIZE", str(world))
    if tp is None:
        monkeypatch.delenv("ADSALA_TP", raising=False)
    else:
        monkeypatch.setenv("ADSALA_TP", tp)
    dryrun.fake_world(world)
    try:
        mesh = launch_mesh(parse_args(["--scale", "full", "--device",
                                       "cpu"]))
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == want
        assert mesh.device_type == "cpu"
    finally:
        dist.destroy_process_group()


def test_run_refuses_a_tp_that_does_not_divide_the_world(monkeypatch):
    from repro_torch.launch.train import launch_mesh, mesh_shape, parse_args

    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("ADSALA_TP", "3")
    with pytest.raises(ValueError, match="does not divide"):
        launch_mesh(parse_args(["--scale", "full", "--device", "cpu"]))
    with pytest.raises(ValueError, match="does not divide"):
        mesh_shape(256)


def test_run_trains_on_one_device_without_a_world(monkeypatch):
    """Without ``WORLD_SIZE`` (or at ``--scale smoke``) there is no mesh,
    whether or not a process group exists: the one-card launcher."""
    from repro_torch.launch.train import launch_mesh, parse_args

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert launch_mesh(parse_args(["--scale", "full", "--device",
                                   "cpu"])) is None
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert launch_mesh(parse_args(["--scale", "smoke", "--device",
                                   "cpu"])) is None
