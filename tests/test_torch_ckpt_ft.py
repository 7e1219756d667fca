"""Port of tests/test_ckpt_ft.py: checkpointing and the fault-tolerant
driver against the port's functions, plus what the port's mutable state
adds — a tensor changed in place after ``AsyncCheckpointer.save`` does
not reach the file — and the layout: the reference's directory
protocol, bfloat16 leaves, restore onto a ``meta`` template."""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.ft.driver import DriverConfig, TrainDriver
from repro_torch.models.params import tree_leaves, tree_map

torch.set_num_threads(1)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.standard_normal((8, 4))),
                   "b": torch.from_numpy(rng.standard_normal(4))},
        "m": {"w": torch.zeros((8, 4)), "b": torch.zeros(4)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 7, state)
    assert latest_step(str(tmp_path)) == 7
    restored = restore_checkpoint(str(tmp_path), 7, state)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_uncommitted_checkpoint_ignored(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 5, state)
    # a crashed write: directory without COMMIT
    os.makedirs(tmp_path / "step_00000009")
    assert latest_step(str(tmp_path)) == 5
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), 9, state)


def test_checkpoint_dtype_cast_on_restore(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 1, state)
    like = tree_map(
        lambda x: torch.empty(x.shape, dtype=torch.float16, device="meta")
        if x.dtype == torch.float64 else x, state)
    restored = restore_checkpoint(str(tmp_path), 1, like)
    assert restored["params"]["w"].dtype == torch.float16
    assert restored["params"]["w"].device.type == "cpu"
    assert restored["step"].dtype == torch.int32
    # dtype= casts every floating leaf, and only those
    cast = restore_checkpoint(str(tmp_path), 1, state, dtype=torch.float32)
    assert cast["m"]["b"].dtype == torch.float32
    assert cast["step"].dtype == torch.int32


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(3, _state())
    ck.wait()
    assert latest_step(str(tmp_path)) == 3
    assert ck.last_saved == 3


def test_async_save_snapshots_before_returning(tmp_path):
    """The port's train state is updated in place: a change after
    ``save`` returns must not reach the file."""
    state = _state()
    want = tree_map(torch.clone, state)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(7, state)
    state["params"]["w"].add_(1.0)       # the next step, in place
    state["step"].add_(1)
    ck.wait()
    restored = restore_checkpoint(str(tmp_path), 7, state)
    for a, b in zip(tree_leaves(want), tree_leaves(restored)):
        assert torch.equal(a, b)


def test_async_checkpointer_reports_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, _state())
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                            # reported once


def test_checkpoint_layout_and_bfloat16(tmp_path):
    state = {"params": {"layers": [{"w": torch.randn(3, 2).bfloat16()},
                                   {"w": torch.randn(3, 2).bfloat16()}]},
             "step": torch.tensor(2, dtype=torch.int32)}
    path = save_checkpoint(str(tmp_path), 2, state)
    assert sorted(os.listdir(path)) == ["COMMIT", "arrays.npz", "meta.json"]
    assert not os.path.exists(path + ".tmp")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 2 and meta["n_leaves"] == 3
    key = "['params']//['layers']//[1]//['w']"
    assert meta["dtypes"][key] == "bfloat16"
    restored = restore_checkpoint(str(tmp_path), 2, state)
    assert restored["params"]["layers"][1]["w"].dtype == torch.bfloat16
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _toy_step(state, batch):
    new = dict(state)
    new["step"] = state["step"] + 1
    loss = torch.sum(batch["x"]) * 0.0 + 1.0 / (1 + state["step"])
    return new, {"loss": loss}


def _data():
    while True:
        yield {"x": torch.ones(3)}


def test_driver_runs_and_checkpoints(tmp_path):
    driver = TrainDriver(
        DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=4, max_steps=10),
        _toy_step, _state(), _data())
    summary = driver.run()
    assert summary["step"] == 10
    assert latest_step(str(tmp_path)) == 10   # final sync checkpoint
    assert driver.final_ckpt_s is not None


def test_driver_resume(tmp_path):
    d1 = TrainDriver(
        DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=5, max_steps=6),
        _toy_step, _state(), _data())
    d1.run()
    d2 = TrainDriver(
        DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=5, max_steps=9),
        _toy_step, _state(), _data(), state_template=_state())
    resumed = d2.maybe_resume()
    assert resumed == 6
    assert int(d2.state["step"]) == 7 + 6
    summary = d2.run()
    assert summary["step"] == 9


def test_driver_straggler_detection(tmp_path):
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 12:
            time.sleep(0.25)          # injected straggler
        else:
            time.sleep(0.002)
        return _toy_step(state, batch)

    flagged = []
    driver = TrainDriver(
        DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=100, max_steps=15,
                     straggler_factor=3.0,
                     on_straggler=lambda s, dt: flagged.append(s)),
        slow_step, _state(), _data())
    summary = driver.run()
    assert 12 in summary["stragglers"]
    assert flagged


def test_driver_preemption_checkpoint(tmp_path):
    """SIGTERM mid-run -> driver stops and leaves a final checkpoint."""
    def slowish(state, batch):
        time.sleep(0.01)
        return _toy_step(state, batch)

    driver = TrainDriver(
        DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=1000,
                     max_steps=500),
        slowish, _state(), _data())
    killer = threading.Timer(0.15, lambda: os.kill(os.getpid(),
                                                   signal.SIGTERM))
    killer.start()
    summary = driver.run()
    assert summary["preempted"]
    assert 0 < summary["step"] < 500
    assert latest_step(str(tmp_path)) == summary["step"]


def test_driver_heartbeat(tmp_path):
    from repro_torch.ft.heartbeat import read_heartbeat

    hb = str(tmp_path / "hb")
    driver = TrainDriver(
        DriverConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=100,
                     max_steps=3, heartbeat_path=hb),
        _toy_step, _state(), _data())
    driver.run()
    tag, _ = read_heartbeat(hb)
    assert tag == "3"
