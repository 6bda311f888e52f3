"""``CheckpointManager``'s asynchronous saves on the CPU: the file holds the
state as it was at ``save()`` whatever the caller does after it returns, a
writer's error surfaces at ``wait()``, retention and the manifest wait for
the write, one save is pending at a time, and ``async_save=False`` writes
before ``save`` returns. A gate held in front of the writer's file write
stands in for a slow disk."""

import json
import threading

import pytest
import torch

from vit_tpu_torch import train as tt
from vit_tpu_torch.models import ViT
from vit_tpu_torch.utils import checkpoint as ck
from vit_tpu_torch.utils.checkpoint import CheckpointManager, save_checkpoint

torch.set_num_threads(2)


def _state(seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = ViT(image_size=16, patch_size=8, num_classes=4, dim=16, depth=1, heads=2,
                dim_head=8, mlp_dim=32, device="cpu")
    state = tt.create_train_state(model, tt.make_optimizer(1e-2), gen)
    images = torch.randn(4, 16, 16, 3, generator=gen)
    tt.make_train_step(model)(state, images, torch.arange(4) % 4)  # fills the moments
    return state


@pytest.fixture
def gate(monkeypatch):
    """Hold every file write of the writer thread until ``gate.set()``."""
    opened = threading.Event()
    write = ck._write

    def gated(path, ckpt):
        assert opened.wait(timeout=30), "the gate was never opened"
        write(path, ckpt)

    monkeypatch.setattr(ck, "_write", gated)
    return opened


def _params(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_save_snapshots_before_it_returns(tmp_path, gate):
    state = _state()
    want = _params(state)
    moments = {k: v.clone() for k, v in state.optimizer.state_dict()["state"][0].items()}
    with CheckpointManager(tmp_path) as mgr:
        assert mgr.save(1, state)
        assert not mgr.path(1).exists() and mgr.latest_step() == 1  # pending, counted
        assert not mgr.should_save(1)
        with torch.no_grad():  # the caller goes on training
            for p in state.model.parameters():
                p.add_(1.0)
        state.optimizer.state_dict()["state"][0]["exp_avg"].add_(1.0)
        gate.set()
        mgr.wait()
        saved = _load(mgr.path(1))
    for k, v in want.items():
        assert torch.equal(saved["model"][k], v), k
    assert torch.equal(saved["optimizer"]["state"][0]["exp_avg"], moments["exp_avg"])


def test_async_file_equals_the_synchronous_one(tmp_path):
    state = _state(1)
    save_checkpoint(tmp_path / "sync.pt", state)
    with CheckpointManager(tmp_path / "run") as mgr:
        mgr.save(3, state, metrics={"loss": 0.5})
    a, b = _load(tmp_path / "sync.pt"), _load(tmp_path / "run" / "step_3.pt")
    assert a.keys() == b.keys() and a["step"] == b["step"] and a["scheduler"] == b["scheduler"]
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k])
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k])
    assert torch.equal(a["generator"], b["generator"]) and torch.equal(a["cpu_rng"], b["cpu_rng"])
    assert json.loads((tmp_path / "run" / "metrics.json").read_text()) == {"3": {"loss": 0.5}}


def test_writer_error_surfaces_at_wait(tmp_path, monkeypatch):
    def full_disk(path, ckpt):
        raise OSError("no space left on device")

    state = _state()
    mgr = CheckpointManager(tmp_path)
    monkeypatch.setattr(ck, "_write", full_disk)
    assert mgr.save(1, state)
    with pytest.raises(OSError, match="no space"):
        mgr.wait()
    mgr.wait()  # the error is raised once
    monkeypatch.undo()
    assert mgr.save(2, state) and mgr.all_steps() == [2]
    mgr.close()


def test_retention_and_manifest_wait_for_the_write(tmp_path, gate):
    state = _state()
    mgr = CheckpointManager(tmp_path, max_to_keep=2)
    gate.set()
    for step in (1, 2):
        mgr.save(step, state, metrics={"loss": float(step)})
    mgr.wait()
    gate.clear()
    mgr.save(3, state, metrics={"loss": 3.0})
    # step 3 is not on disk yet, so nothing is dropped for it
    assert mgr._disk_steps() == [1, 2]
    assert set(json.loads((tmp_path / "metrics.json").read_text())) == {"1", "2"}
    gate.set()
    assert mgr.all_steps() == [2, 3]
    assert json.loads((tmp_path / "metrics.json").read_text()) == {"2": {"loss": 2.0},
                                                                   "3": {"loss": 3.0}}
    mgr.close()


def test_a_second_save_waits_for_the_first(tmp_path, gate):
    state = _state()
    mgr = CheckpointManager(tmp_path, max_to_keep=None)
    first = _params(state)
    assert mgr.save(1, state)
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(2.0)
    second = _params(state)
    threading.Timer(0.3, gate.set).start()
    assert mgr.save(2, state)  # blocks until the first is written
    assert mgr.path(1).exists()
    mgr.close()
    for step, want in ((1, first), (2, second)):
        got = _load(mgr.path(step))["model"]
        assert all(torch.equal(got[k], v) for k, v in want.items()), step
    assert mgr._writer is None


def test_close_stops_the_writer_and_sync_mode_writes_at_once(tmp_path):
    state = _state()
    before = set(threading.enumerate())
    with CheckpointManager(tmp_path / "a") as mgr:
        mgr.save(1, state)
        (writer,) = set(threading.enumerate()) - before
    assert mgr._writer is None and mgr.path(1).exists() and not writer.is_alive()
    sync = CheckpointManager(tmp_path / "b", async_save=False)
    assert sync.save(1, state) and sync.path(1).exists() and sync._writer is None
    restored = _state(5)
    CheckpointManager(tmp_path / "a").restore(restored)
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v)
