"""PyTorch port: training checkpoints (ckpt/io.py, the counterpart of
mmde_tpu/ckpt/orbax_io.py).

A save / restore round trip is bitwise for everything a TrainState carries
(model with its BatchNorm buffers, optimizer moments and update count, the
step, the drop-path generator), so one train step from the restored state
equals one from the saved state, bit for bit on the CPU; `latest_epoch`,
the best-first `restore_eval`, `BestTracker`'s one best file, and the
atomic write.
"""
import os

import pytest
import torch

from mmde_tpu_torch import config as tcfg
from mmde_tpu_torch.ckpt import io
from mmde_tpu_torch.tools import train_steps
from mmde_tpu_torch.train import optim as topt
from mmde_tpu_torch.train import step as tstep

from mmde_tpu_torch.testing import set_test_threads

set_test_threads()

_CFG = tcfg.Config(
    model=tcfg.ModelConfig(
        backbone="swin_nano_v2", decoder="decoder_v2", model_scale=32,
        swin=tcfg.SwinConfig(depths=(2, 2, 1, 1), window_size=(4, 4, 4, 2),
                             pretrain_window_size=(4, 4, 4, 2),
                             drop_path_rate=0.3)),
    train=tcfg.TrainConfig(batch_size=2, epochs=4))


def _trainer(seed=0):
    return train_steps.build_trainer(_CFG, device="cpu", seed=seed,
                                     steps_per_epoch=3)


def _batch(seed):
    return train_steps.synthetic_batch(2, 64, 64, seed=seed)


def _tensors(state):
    """Every tensor the state carries, by name."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, (p, st) in enumerate(state.optimizer.state.items()):
        for k, v in st.items():
            out[f"opt.{i}.{k}"] = v
    out["generator"] = state.generator.get_state()
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A state after two train-mode steps (drop path and dropout drawing
    from its generator, BatchNorm statistics moving), saved as epoch 1."""
    state, step = _trainer()
    for i in range(2):
        state, _ = step(state, _batch(i))
    d = str(tmp_path_factory.mktemp("run") / "ckpt")
    path = io.save_epoch(d, state, 1)
    return state, step, d, path


def test_round_trip_is_bitwise(trained):
    state, _, d, path = trained
    assert os.path.basename(path) == "epoch_1.pt"
    fresh, _ = _trainer(seed=5)
    assert fresh.step == 0 and fresh.optimizer.count == 0
    got, epoch = io.restore(d, fresh)
    assert epoch == 1 and got.step == state.step == 2
    assert got.optimizer.count == state.optimizer.count == 2
    assert got.model is fresh.model and got.generator is fresh.generator
    want, have = _tensors(state), _tensors(got)
    assert sorted(want) == sorted(have)
    assert any(".running_var" in k for k in want)      # BatchNorm buffers
    assert any(k.endswith(".m") for k in want)         # Adam moments
    for k in want:
        assert have[k].dtype == want[k].dtype, k
        assert torch.equal(have[k], want[k]), k


def test_a_step_from_the_restored_state_equals_one_from_the_saved(trained):
    """Train mode, drop path 0.3, pose dropout: the next step's losses and
    every tensor afterwards are bitwise those of the run that saved."""
    state, step, d, _ = trained
    fresh, fresh_step = _trainer(seed=9)
    fresh, _ = io.restore(d, fresh)
    batch = _batch(7)
    s1, a1 = fresh_step(fresh, batch)
    s0, a0 = step(state, batch)
    for k in a0:
        assert torch.equal(a1[k], a0[k]), k
    want, have = _tensors(s0), _tensors(s1)
    for k in want:
        assert torch.equal(have[k], want[k]), k
    assert s1.step == s0.step == 3 and fresh.optimizer.count == 3


def _small_state():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                torch.nn.BatchNorm1d(3))
    opt = topt.LayerDecayAdamW(model, lambda c: 1e-2, weight_decay=0.05)
    return tstep.TrainState.create(model, opt, torch.Generator())


def test_latest_epoch(tmp_path):
    d = str(tmp_path / "ckpt")
    assert io.latest_epoch(d) is None
    state = _small_state()
    for e in (1, 2, 10):
        io.save_epoch(d, state, e)
    os.makedirs(os.path.join(d, "best"))
    open(os.path.join(d, "best", "epoch_99.pt"), "wb").close()
    open(os.path.join(d, ".epoch_11.pt.x.tmp"), "wb").close()
    open(os.path.join(d, "epoch_12.pt.bak"), "wb").close()
    assert io.latest_epoch(d) == 10
    with pytest.raises(FileNotFoundError):
        io.restore(str(tmp_path / "none"), state)


def test_restore_eval_prefers_the_best_checkpoint(tmp_path):
    """The best-RMSE file wins over a newer epoch (the JAX package's eval
    once restored the latest); prefer_best=False or an explicit epoch take
    the epoch files."""
    d = str(tmp_path / "ckpt")
    state = _small_state()
    best = io.BestTracker(d)
    for epoch, rmse in ((1, 2.0), (2, 1.5), (3, 1.7)):
        with torch.no_grad():
            state.model[0].weight.fill_(float(epoch))
        io.save_epoch(d, state, epoch)
        best.update(state, epoch, rmse)
    model = _small_state().model
    assert io.restore_eval(d, model) == (2, "best")
    assert float(model[0].weight.detach()[0, 0]) == 2.0
    assert io.restore_eval(d, model, prefer_best=False) == (3, "epoch")
    assert float(model[0].weight.detach()[0, 0]) == 3.0
    assert io.restore_eval(d, model, epoch=1) == (1, "epoch")
    assert float(model[0].weight.detach()[0, 0]) == 1.0
    with pytest.raises(FileNotFoundError):
        io.restore_eval(str(tmp_path / "none"), model)


def test_best_tracker_keeps_one_best_and_prunes(tmp_path):
    d = str(tmp_path / "ckpt")
    state = _small_state()
    tracker = io.BestTracker(d)
    assert tracker.update(state, 1, 3.0)
    assert not tracker.update(state, 2, 3.5)
    assert tracker.update(state, 3, 1.0)
    assert sorted(os.listdir(os.path.join(d, "best"))) == ["epoch_3.pt"]
    # a tracker over the same directory (a resumed run) keeps that best
    again = io.BestTracker(d)
    assert again.best == 1.0
    assert not again.update(state, 4, 1.2)
    assert again.update(state, 5, 0.5)
    assert sorted(os.listdir(os.path.join(d, "best"))) == ["epoch_5.pt"]


def test_a_failed_write_leaves_no_partial_file(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    state = _small_state()
    io.save_epoch(d, state, 1)
    real = torch.save

    def broken(obj, f, *a, **kw):
        f.write(b"partial")
        raise OSError("no space left on device")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="no space"):
        io.save_epoch(d, state, 2)
    tracker = io.BestTracker(d)
    with pytest.raises(OSError, match="no space"):
        tracker.update(state, 2, 0.1)
    assert tracker.best == 1e9          # nothing kept, nothing claimed
    monkeypatch.setattr(torch, "save", real)
    assert sorted(os.listdir(d)) == ["best", "epoch_1.pt"]
    assert os.listdir(os.path.join(d, "best")) == []
    assert io.latest_epoch(d) == 1
    io.restore(d, _small_state())
