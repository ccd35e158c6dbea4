"""Torch-native checkpoints with the semantics of
``objgan_tpu/core/checkpoint.py`` (its Orbax ``CheckpointManager``):

* one directory per step, ``<dir>/<step>/state.pt``, written under a
  temporary name and renamed into place, so a save is atomic;
* keep-N: the newest ``max_to_keep`` (3) steps stay, older ones go;
* ``latest_step_in`` scans bare-integer directory names only, so the
  leftovers of an interrupted save are ignored;
* ``save`` never writes a step that is already saved (the collision guard);
* ``restore_latest`` loads with ``torch.load(weights_only=True)``. A saved
  tree that no longer matches the module (keys missing or unexpected, a
  shape changed) gets a loud warning and ``None``, so the caller starts
  fresh; an I/O error or a truncated file raises, since starting fresh
  would rotate the good checkpoints out.

What is saved is a module's ``state_dict()``: for the trainers, every
network's parameters and buffers, the Adam moments and the step
(``train/common.py``). It is kept on the CPU in the file and copied onto
the module's own device on restore.

Under data parallelism (``parallel/sharding.py``) rank 0 writes and the
other ranks wait for it; every rank restores, and the caller then
broadcasts rank 0's state (``broadcast_module_``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.nn as nn

from objgan_tpu_torch.parallel.sharding import barrier, is_main

STATE_FILE = "state.pt"


def latest_step_in(directory: str) -> Optional[int]:
    """Newest completed step in ``directory`` by a scan of its bare-integer
    entries, with no model built; ``None`` when there is none."""
    if not os.path.isdir(directory):
        return None
    steps = [int(n) for n in os.listdir(directory) if n.isdigit()]
    return max(steps) if steps else None


def mismatch(want, saved) -> Optional[str]:
    """What keeps the state dict ``saved`` from loading into a module whose
    state dict is ``want`` (missing or unexpected keys, changed shapes), or
    None when it fits."""
    missing = sorted(set(want) - set(saved))
    extra = sorted(set(saved) - set(want))
    shapes = sorted(k for k in set(want) & set(saved)
                    if tuple(want[k].shape) != tuple(saved[k].shape))
    if not (missing or extra or shapes):
        return None
    return (f"missing keys {missing[:5]}, unexpected keys {extra[:5]}, "
            f"shape changed at {shapes[:5]}")


def load_latest(directory: str):
    """(step, saved state dict on the CPU) of the newest checkpoint in
    ``directory``, or ``(None, None)`` when there is none."""
    step = latest_step_in(directory)
    if step is None:
        return None, None
    path = os.path.join(directory, str(step), STATE_FILE)
    return step, torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """Keep-N step directories under ``directory`` (created here)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit())

    def latest_step(self) -> Optional[int]:
        return latest_step_in(self.directory)

    def save(self, step: int, module: nn.Module) -> bool:
        """Write ``module.state_dict()`` as step ``step``, unless that step
        is already saved; rank 0 writes, and every rank returns once it
        has. Returns whether this process wrote."""
        wrote = is_main() and self._write(step, module)
        barrier()
        return wrote

    def _write(self, step: int, module: nn.Module) -> bool:
        final = os.path.join(self.directory, str(int(step)))
        if os.path.isdir(final):
            return False
        state = {k: v.detach().cpu() for k, v in module.state_dict().items()}
        tmp = tempfile.mkdtemp(prefix=f"{int(step)}.tmp-",
                               dir=self.directory)
        path = os.path.join(tmp, STATE_FILE)
        with open(path, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore_latest(self, module: nn.Module) -> Optional[int]:
        """Load the newest step into ``module`` and return that step, or
        ``None`` when there is no checkpoint or it no longer matches."""
        step, saved = load_latest(self.directory)
        if step is None:
            return None
        path = os.path.join(self.directory, str(step), STATE_FILE)
        why = mismatch(module.state_dict(), saved)
        if why is not None:
            print("=" * 72
                  + f"\nWARNING: checkpoint at step {step} ({path}) is "
                  f"INCOMPATIBLE with the\ncurrent model and was NOT "
                  f"restored: {why}.\nTraining "
                  "will start from fresh parameters. Delete or migrate the\n"
                  "checkpoint directory if this is unexpected.\n" + "=" * 72,
                  flush=True)
            return None
        module.load_state_dict(saved)
        return step
