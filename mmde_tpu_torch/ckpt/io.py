"""Training checkpoints: per-epoch save, best-RMSE tracking, resume.

Counterpart of mmde_tpu/ckpt/orbax_io.py on `torch.save` /
`torch.load(weights_only=True)`: `save_epoch`, `latest_epoch`, `restore`,
`restore_eval` and `BestTracker`. Layout, under a run's `ckpt/`:

    ckpt/epoch_N.pt         the TrainState after epoch N
    ckpt/best/epoch_N.pt    the best validation RMSE so far (one file)

Each file holds what the JAX package's TrainState carries: the model's
state_dict (BatchNorm buffers included), the optimizer's state_dict (its
`count` drives the poly LR schedule), `step`, `epoch`, and the state of
the generator drop-path and dropout draw from, so that a restored run goes
on exactly as the saved one would have. Writes are atomic, as Orbax's are:
the file is written under a temporary name in the same directory and
renamed over the final one (`os.replace`), so a failed write leaves no
partial `epoch_N.pt`.
"""
from __future__ import annotations

import dataclasses
import os
import re
import tempfile
from typing import Optional, Tuple

import torch

_EPOCH_FILE = re.compile(r"^epoch_(\d+)\.pt$")


def _path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch_{epoch}.pt")


def _epochs(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_EPOCH_FILE.match,
                                               os.listdir(ckpt_dir)) if m)


def state_dict(state, epoch: int) -> dict:
    """What a checkpoint holds for `state` (a train.step.TrainState) after
    `epoch`."""
    gen = state.generator
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step), "epoch": int(epoch),
            "generator": None if gen is None else gen.get_state()}


def write_atomic(obj, path: str) -> None:
    """torch.save `obj` to `path` through a temporary file in the same
    directory, flushed to disk, then renamed over `path`."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="." + os.path.basename(path) + ".",
                               suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.chmod(tmp, 0o644)            # mkstemp's 0600 is not a save's
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_epoch(ckpt_dir: str, state, epoch: int) -> str:
    """Save the whole TrainState as ckpt_dir/epoch_N.pt. Returns the
    path."""
    path = _path(ckpt_dir, epoch)
    write_atomic(state_dict(state, epoch), path)
    return path


def latest_epoch(ckpt_dir: str) -> Optional[int]:
    """The newest epoch saved in ckpt_dir (best/ not included), or None."""
    epochs = _epochs(ckpt_dir)
    return epochs[-1] if epochs else None


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore(ckpt_dir: str, state, epoch: Optional[int] = None
            ) -> Tuple[object, int]:
    """Restore a TrainState from ckpt_dir (epoch None: the latest): the
    model, the optimizer (moments and update count) and the generator are
    loaded in place. Returns (state with the saved step, epoch)."""
    if epoch is None:
        epoch = latest_epoch(ckpt_dir)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    obj = _load(_path(ckpt_dir, epoch))
    state.model.load_state_dict(obj["model"], strict=True)
    state.optimizer.load_state_dict(obj["optimizer"])
    if state.generator is not None and obj["generator"] is not None:
        state.generator.set_state(obj["generator"])
    return dataclasses.replace(state, step=int(obj["step"])), epoch


def restore_eval(ckpt_dir: str, model: torch.nn.Module,
                 epoch: Optional[int] = None, prefer_best: bool = True
                 ) -> Tuple[int, str]:
    """Load the model's state only, for evaluation or serving. When
    `prefer_best` and `epoch` is None the best-RMSE checkpoint
    (ckpt_dir/best/epoch_N.pt) wins over the latest epoch. Returns (epoch,
    kind), kind "best" or "epoch"."""
    best = _epochs(os.path.join(ckpt_dir, "best"))
    if prefer_best and epoch is None and best:
        path, epoch, kind = _path(os.path.join(ckpt_dir, "best"),
                                  best[-1]), best[-1], "best"
    else:
        if epoch is None:
            epoch = latest_epoch(ckpt_dir)
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        path, kind = _path(ckpt_dir, epoch), "epoch"
    model.load_state_dict(_load(path)["model"], strict=True)
    return epoch, kind


class BestTracker:
    """Keep the checkpoint of the best (lowest) validation `metric` in
    ckpt_dir/best/, one file: an improvement writes the new one, then
    removes the others. The file also holds the metric's value
    (`best_value`), and a tracker made over a directory that has one starts
    from it, so a resumed run keeps a better best of the run it resumes
    (the JAX package's tracker starts from `initial` every time)."""

    def __init__(self, ckpt_dir: str, metric: str = "rmse",
                 initial: float = 1e9):
        self.dir = os.path.join(ckpt_dir, "best")
        self.metric = metric
        self.best = initial
        kept = _epochs(self.dir)
        if kept:
            obj = torch.load(_path(self.dir, kept[-1]), map_location="cpu",
                             weights_only=True, mmap=True)
            self.best = min(initial, float(obj.get("best_value", initial)))

    def update(self, state, epoch: int, value: float) -> bool:
        if value >= self.best:
            return False
        write_atomic(dict(state_dict(state, epoch), best_value=float(value)),
                     _path(self.dir, epoch))
        self.best = value
        for old in _epochs(self.dir):
            if old != epoch:
                os.unlink(_path(self.dir, old))
        return True
