"""Torch-native checkpoints with the semantics of
``objgan_tpu/core/checkpoint.py`` (its Orbax ``CheckpointManager``), and
the restore of the steps that the JAX package wrote:

* one directory per step. The port writes ``<dir>/<step>/state.pt`` under
  a temporary name and renames it into place, so a save is atomic; the
  JAX package's Orbax steps (``<dir>/<step>/_CHECKPOINT_METADATA`` and
  ``default/``) are read, never written;
* ``latest_step_in`` and ``CheckpointManager.latest_step`` see the newest
  step of either kind (any bare-integer directory, as the JAX package's
  ``latest_step_in``), so the leftovers of an interrupted save
  (``<step>.tmp-*``, ``<step>.orbax-checkpoint-tmp-*``) are ignored;
  ``step_kind`` tells a port step (``state.pt``) from an Orbax one
  (``_CHECKPOINT_METADATA`` or ``default/manifest.ocdbt``);
* keep-N: the newest ``max_to_keep`` (3) of the PORT's steps stay, older
  ones go; an Orbax step is never counted or removed;
* ``save`` never writes a step that is already there (the collision
  guard), and warns when that step is an Orbax one;
* ``restore_latest`` loads a port step with
  ``torch.load(weights_only=True)``, and an Orbax step with ``read_orbax``
  and ``core/bridge.py::jax_state_dict`` (the JAX train state as the
  trainer's own state dict, Adam moments and step included). A tree that
  no longer matches the module (keys missing or unexpected, a shape
  changed) gets a loud warning and ``None``, so the caller starts fresh;
  an I/O error or a truncated file raises, since starting fresh would
  rotate the good checkpoints out. keep-N never removes an Orbax step, so
  past one that does not match, the port's newest step is restored (after
  the warning), lest the misfit stay the newest step for good.

What is saved is a module's ``state_dict()``: for the trainers, every
network's parameters and buffers, the Adam moments and the step
(``train/common.py``). It is kept on the CPU in the file and copied onto
the module's own device on restore.

``read_orbax`` reads an Orbax step without orbax, tensorstore or zstandard
(``core/ocdbt.py``, ``core/zarr.py``, ``core/zstd.py``): the tree of
``default/_METADATA`` with dicts for dict keys and named fields
(``OrbaxNode``, whose keys also read as attributes: ``state.g_params``,
``adam.mu``), tuples for sequence indices, ``None`` where a state is empty
(``optax.EmptyState``, ``optax.masked``'s ``MaskedNode``), and numpy
arrays (bf16 ones as ``torch.bfloat16`` tensors) at the leaves.

Under data parallelism (``parallel/sharding.py``) rank 0 writes and the
other ranks wait for it; every rank restores, and the caller then
broadcasts rank 0's state (``broadcast_module_``).

``convert_torch_state_dict``, ``export_torch_state_dict`` and
``apply_converted`` carry lineage AttnGAN/Obj-GAN ``.pth`` state dicts onto
the port's modules and back, by the name maps of ``core/name_maps.py``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from objgan_tpu_torch.core import zarr
from objgan_tpu_torch.core.ocdbt import OcdbtStore
from objgan_tpu_torch.parallel.sharding import barrier, is_main

STATE_FILE = "state.pt"
PORT, ORBAX = "port", "orbax"
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA",
                  os.path.join("default", "manifest.ocdbt"))


def step_kind(step_dir: str) -> Optional[str]:
    """``PORT`` for a directory holding ``state.pt``, ``ORBAX`` for an Orbax
    step, else None."""
    if os.path.isfile(os.path.join(step_dir, STATE_FILE)):
        return PORT
    if any(os.path.exists(os.path.join(step_dir, m))
           for m in _ORBAX_MARKERS):
        return ORBAX
    return None


def steps_in(directory: str) -> Dict[int, Optional[str]]:
    """{step: kind} of the bare-integer directories in ``directory``: kind
    ``PORT``, ``ORBAX``, or None for one holding neither (a step written
    by neither package, or damaged)."""
    if not os.path.isdir(directory):
        return {}
    return {int(n): step_kind(os.path.join(directory, n))
            for n in os.listdir(directory) if n.isdigit()}


def latest_step_in(directory: str) -> Optional[int]:
    """Newest step in ``directory`` by a scan of its bare-integer entries,
    as the JAX package's ``latest_step_in``, with no model built; ``None``
    when there is none."""
    steps = steps_in(directory)
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


class OrbaxNode(dict):
    """A dict node of a tree read by ``read_orbax``: a dict's keys or a
    struct's fields, which also read as attributes."""

    __slots__ = ()

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


class _Seq(dict):
    """A sequence node while the tree is built (keys are indices)."""


def _finish(node):
    if isinstance(node, _Seq):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"sequence indices {sorted(node)} have gaps")
        return tuple(_finish(node[i]) for i in range(len(node)))
    if isinstance(node, OrbaxNode):
        return OrbaxNode((k, _finish(v)) for k, v in node.items())
    return node


def read_orbax(step_dir: str):
    """The tree of the Orbax (``StandardSave``, OCDBT + zarr v2) step in
    ``step_dir``. Raises on a missing, truncated or corrupt file."""
    item = os.path.join(step_dir, "default")
    with open(os.path.join(item, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{item}: only OCDBT + zarr v2 Orbax steps are "
                         "read (use_ocdbt true, use_zarr3 false)")
    store = OcdbtStore(item)
    every = bool(meta.get("store_array_data_equal_to_fill_value"))
    empty = {"None": None, "Dict": OrbaxNode, "Tuple": tuple, "List": tuple}
    entries = list(meta["tree_metadata"].values())
    top_seq = bool(entries) and entries[0]["key_metadata"][0]["key_type"] == 1
    root = _Seq() if top_seq else OrbaxNode()
    for entry in entries:
        keys = entry["key_metadata"]
        vtype = entry["value_metadata"]["value_type"]
        if vtype in empty:
            leaf = empty[vtype]() if empty[vtype] else None
        else:
            leaf = zarr.read_array(store.read,
                                   ".".join(k["key"] for k in keys), every)
        node = root
        for i, k in enumerate(keys):
            key = int(k["key"]) if isinstance(node, _Seq) else k["key"]
            if i == len(keys) - 1:
                node[key] = leaf
                break
            child_seq = keys[i + 1]["key_type"] == 1
            child = node.setdefault(key, _Seq() if child_seq else OrbaxNode())
            if isinstance(child, _Seq) != child_seq:
                raise ValueError(f"{item}: inconsistent key types under "
                                 f"{[k['key'] for k in keys[:i + 1]]}")
            node = child
    return _finish(root)


def load_step(directory: str, step: int, kind: Optional[str]) -> Any:
    """The saved state of ``step`` in ``directory`` (of ``step_kind``
    ``kind``): the state dict on the CPU for a port step, ``read_orbax``'s
    tree (an ``OrbaxNode``) for an Orbax step."""
    path = os.path.join(directory, str(step))
    if kind == ORBAX:
        return read_orbax(path)
    if kind is None:
        raise FileNotFoundError(f"{path} holds neither {STATE_FILE} nor an "
                                "Orbax step")
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def load_latest(directory: str) -> Tuple[Optional[int], Any]:
    """(step, ``load_step``'s state) of the newest checkpoint in
    ``directory``; ``(None, None)`` when there is none."""
    steps = steps_in(directory)
    if not steps:
        return None, None
    step = max(steps)
    return step, load_step(directory, step, steps[step])


def _warn(lines: str) -> None:
    print("=" * 72 + f"\nWARNING: {lines}\n" + "=" * 72, flush=True)


class CheckpointManager:
    """Keep-N step directories under ``directory`` (created here)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        """The port's own steps, oldest first (what keep-N rotates)."""
        return sorted(s for s, kind in steps_in(self.directory).items()
                      if kind == PORT)

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
            if step_kind(final) == ORBAX:
                _warn(f"step {step} was NOT saved: {final} holds a JAX "
                      "run's Orbax step,\nwhich the port never "
                      "overwrites. Move it out of the directory\nto save "
                      "there.")
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
        """Load the newest step (the port's or an Orbax one) into
        ``module`` and return that step, or ``None`` when there is no
        checkpoint or it no longer matches. keep-N never removes an Orbax
        step, so one that does not match would stay the newest for good:
        past it, the port's newest step is restored instead."""
        steps = steps_in(self.directory)
        if not steps:
            return None
        step = max(steps)
        if self._restore(step, steps[step], module):
            return step
        ports = [s for s, kind in steps.items() if kind == PORT]
        if steps[step] != ORBAX or not ports:
            return None
        step = max(ports)
        print(f"restoring the port's newest step {step} instead", flush=True)
        return step if self._restore(step, PORT, module) else None

    def _restore(self, step: int, kind: Optional[str],
                 module: nn.Module) -> bool:
        """Load ``step`` into ``module``; False (with a loud warning) when
        it does not match the module."""
        from objgan_tpu_torch.core import bridge

        saved = load_step(self.directory, step, kind)
        path = os.path.join(self.directory, str(step))
        why = None
        if kind == ORBAX:
            try:
                saved = bridge.jax_state_dict(module, saved)
            except (KeyError, ValueError, TypeError, AttributeError) as e:
                why = f"{type(e).__name__}: {e}"
        else:
            path = os.path.join(path, STATE_FILE)
        why = why or mismatch(module.state_dict(), saved)
        if why is None:
            module.load_state_dict(saved)
            return True
        _warn(f"checkpoint at step {step} ({path}) is INCOMPATIBLE with "
              f"the\ncurrent model and was NOT restored: {why}.\n" + (
                  "It is a JAX run's Orbax step, which the port never "
                  "removes: move it out\nof the directory. The port's "
                  "newest step below it, if any, is restored\ninstead; "
                  "else training starts from fresh parameters."
                  if kind == ORBAX else
                  "Training will start from fresh parameters. Delete or "
                  "migrate the\ncheckpoint directory if this is "
                  "unexpected."))
        return False


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
