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

``convert_torch_state_dict``, ``export_torch_state_dict`` and
``apply_converted`` carry lineage AttnGAN/Obj-GAN ``.pth`` state dicts onto
the port's modules and back, by the name maps of ``core/name_maps.py``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict, Mapping, Optional

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


# -- lineage state dicts (core/name_maps.py) ---------------------------------
#
# The port keeps torch layouts for Linear, Conv and Embedding weights, so a
# lineage tensor carries over unchanged onto them. The LSTM keeps the JAX
# layout (ops/lstm.py: w_ih (D, 4H), w_hh (H, 4H), one bias b), so torch's
# weight_ih / weight_hh transpose, and its two bias vectors are summed onto
# b. (The JAX package's converter transposes every Linear and Conv weight
# into flax layouts; these rules are the port's own.)


def _lstm_bias_kind(name: str) -> Optional[str]:
    leaf = name.rsplit(".", 1)[-1]
    for kind in ("bias_ih", "bias_hh"):
        if kind in leaf:
            return kind
    return None


def _is_lstm_weight(name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    return "weight_ih" in leaf or "weight_hh" in leaf


def to_port_layout(torch_name: str, value) -> torch.Tensor:
    """A lineage tensor (or array) in the port's layout, on the CPU: the
    LSTM's 2-D ``weight_ih`` / ``weight_hh`` transposed, anything else as
    it is."""
    t = torch.as_tensor(value).detach().cpu()
    if _is_lstm_weight(torch_name) and t.dim() == 2:
        return t.t().contiguous()
    return t


def convert_torch_state_dict(state_dict: Mapping[str, Any],
                             name_map: Mapping[str, str]
                             ) -> Dict[str, torch.Tensor]:
    """``{lineage name: tensor}`` -> ``{port state-dict name: tensor}`` by
    ``name_map`` (lineage name -> port name), in the port's layouts
    (``to_port_layout``). An LSTM's ``bias_ih`` and ``bias_hh`` may share a
    target and are SUMMED (the port's cell adds one bias); any other shared
    target raises ValueError, and a lineage name the map lacks KeyError."""
    out: Dict[str, torch.Tensor] = {}
    src: Dict[str, str] = {}
    for tname, value in state_dict.items():
        if tname not in name_map:
            raise KeyError(f"no mapping for torch param {tname!r}")
        key = name_map[tname]
        t = to_port_layout(tname, value)
        if key not in out:
            out[key], src[key] = t, tname
        elif {_lstm_bias_kind(src[key]), _lstm_bias_kind(tname)} == {
                "bias_ih", "bias_hh"}:
            out[key] = out[key] + t
        else:
            raise ValueError(
                f"both {src[key]!r} and {tname!r} map to port name {key!r} "
                "(only LSTM bias_ih/bias_hh pairs may share a target)")
    return out


def export_torch_state_dict(module: nn.Module, name_map: Mapping[str, str]
                            ) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_torch_state_dict``: ``module``'s state dict
    read out as ``{lineage name: tensor}`` in torch layouts (CPU copies),
    driven by the same lineage -> port map. The LSTM bias pair, imported
    summed, exports as ``bias_ih = b`` and ``bias_hh = 0``: torch's cell
    only ever adds the two, so the export computes the same."""
    state = module.state_dict()
    by_target: Dict[str, list] = {}
    for tname, key in name_map.items():
        by_target.setdefault(key, []).append(tname)
    out: Dict[str, torch.Tensor] = {}
    for key, tnames in by_target.items():
        if key not in state:
            raise KeyError(f"port parameter {key!r} not found")
        t = state[key].detach().cpu()
        if len(tnames) == 1:
            out[tnames[0]] = to_port_layout(tnames[0], t).clone()
            continue
        kinds = {_lstm_bias_kind(n): n for n in tnames}
        if len(tnames) != 2 or set(kinds) != {"bias_ih", "bias_hh"}:
            raise ValueError(
                f"lineage params {tnames!r} all map to port name {key!r} "
                "(only LSTM bias_ih/bias_hh pairs may share a target)")
        out[kinds["bias_ih"]] = t.clone()
        out[kinds["bias_hh"]] = torch.zeros_like(t)
    return out


def apply_converted(module: nn.Module,
                    converted: Mapping[str, torch.Tensor]) -> nn.Module:
    """Write ``converted`` into ``module``'s state dict by name, cast to
    each entry's dtype on its device; every name must exist and every shape
    match exactly. Returns ``module``."""
    state = module.state_dict()
    for key, value in converted.items():
        if key not in state:
            raise KeyError(f"port parameter {key!r} not found in "
                           f"{type(module).__name__}")
        if tuple(state[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(state[key].shape)} vs "
                             f"{tuple(value.shape)}")
    with torch.no_grad():
        for key, value in converted.items():
            state[key].copy_(value)
    return module
