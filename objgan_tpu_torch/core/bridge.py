"""Param bridge: a JAX (Linen) param tree (nested dicts of numpy arrays) onto a
ported module.

The ported modules name their submodules after the Linen modules, so a JAX
path ``a/b/kernel`` lands on the torch parameter ``a.b.weight``. Layouts
follow ``objgan_tpu/core/checkpoint.py:162-220`` (that module
imports JAX, so the rules are restated here):

* Dense ``kernel`` (in, out)          -> ``weight`` (out, in)
* Conv ``kernel`` (kh, kw, in, out)   -> ``weight`` (out, in, kh, kw)
* GroupNorm ``scale`` / ``bias``      -> ``weight`` / ``bias``
* Embed ``embedding`` (num, features) -> ``weight``, unchanged
* LSTM ``w_ih``, ``w_hh``, ``b`` (and ``fwd_*`` / ``bwd_*``) keep their
  names and the JAX layout, single bias included.

The same names carry the Inception-v3 (``models/inception_v3.py``: the
``bn_*`` statistics keep their names), VGG-16 (``models/vgg.py``) and the
frozen lite-IS artifact's encoder (``freeze_probe.py``) across.
``torch_to_jax`` is the inverse: a module's parameters as a JAX tree.

``jax_state_dict`` reads a whole JAX train state (``GanTrainState``,
``DamsmTrainState``, ``BoxTrainState``, ``ShapeTrainState``) as the port
trainer's own state dict (``train/common.py::Trainer.state_dict``): every
network's parameters, the label table, optax Adam's ``count``, ``mu`` and
``nu`` as each optimiser's ``step``, ``exp_avg`` and ``exp_avg_sq``, and
the trainer's ``step``. ``load_jax_state`` checks that it fits and loads
it into the trainer of any of the four stages. optax's ``masked``
state of an inception DAMSM backbone has moments for the projections only;
its masked leaves (``MaskedNode``, or ``None`` in a tree read from Orbax)
carry nothing. The state may hold numpy or JAX arrays, or come from
``core/checkpoint.py::read_orbax``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        elif val is None or (isinstance(val, tuple) and not val):
            continue  # optax.masked's MaskedNode: a leaf with no state
        elif isinstance(val, torch.Tensor):  # bf16, from read_orbax
            out[path] = val.float().numpy()
        else:
            out[path] = np.asarray(val)
    return out


def _to_torch(leaf: str, arr: np.ndarray):
    if leaf == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim} has no torch layout")
    if leaf in ("scale", "embedding"):
        return "weight", arr
    return leaf, arr


def jax_to_torch(tree: Mapping) -> Dict[str, np.ndarray]:
    """{torch state_dict name: array in torch layout} for a JAX param tree
    (with or without its top-level ``params`` collection)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, arr in _flatten(tree).items():
        *mods, leaf = path.split("/")
        name, val = _to_torch(leaf, arr)
        out[".".join([*mods, name])] = np.ascontiguousarray(val)
    return out


def torch_to_jax(module: nn.Module) -> Dict:
    """``module``'s parameters as a JAX (Linen) param tree of numpy arrays,
    without the ``params`` collection: the inverse of ``jax_to_torch`` for
    the port's ``Dense``, ``Conv``, ``Embed`` and ``FusedGroupNorm``; any
    other parameter keeps its name and layout."""
    from objgan_tpu_torch.core.layers import Conv, Dense, Embed
    from objgan_tpu_torch.models.common import FusedGroupNorm

    tree: Dict = {}
    for mod_name, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            arr = p.detach().cpu().float().numpy()
            if isinstance(mod, (Dense, Conv)) and name == "weight":
                name = "kernel"
                arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
            elif isinstance(mod, Embed) and name == "weight":
                name = "embedding"
            elif isinstance(mod, FusedGroupNorm) and name == "weight":
                name = "scale"
            node = tree
            for part in filter(None, mod_name.split(".")):
                node = node.setdefault(part, {})
            node[name] = np.ascontiguousarray(arr)
    return tree


def load_jax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy a JAX param tree into ``module``'s parameters. Every parameter
    must be covered exactly once, with the exact shape."""
    converted = jax_to_torch(tree)
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(converted))
    extra = sorted(set(converted) - set(params))
    if missing or extra:
        raise KeyError(f"JAX tree does not match {type(module).__name__}: "
                       f"missing {missing[:8]}, unexpected {extra[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            arr = converted[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"shape mismatch at {name}: JAX "
                                 f"{arr.shape} vs torch {tuple(p.shape)}")
            p.copy_(torch.tensor(arr))


def _scale_by_adam(opt_state):
    """optax's ScaleByAdamState (``count``, ``mu``, ``nu``) inside a
    (possibly chained or masked) optimiser state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    parts = (opt_state.values() if isinstance(opt_state, Mapping)
             else opt_state if isinstance(opt_state, (tuple, list)) else ())
    for part in parts:
        found = _scale_by_adam(part)
        if found is not None:
            return found
    return None


def _adam_entries(prefix: str, opt_state) -> Dict[str, torch.Tensor]:
    """optax Adam's ``count``, ``mu`` and ``nu`` of the parameters under
    ``prefix`` as the state-dict entries ``optim.<name>.{step, exp_avg,
    exp_avg_sq}``."""
    adam = _scale_by_adam(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState in the optimiser state")
    count = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    nu = jax_to_torch(adam.nu)
    out = {}
    for name, mu in jax_to_torch(adam.mu).items():
        key = f"optim.{prefix}{name}."
        out[key + "step"] = count.clone()
        out[key + "exp_avg"] = torch.tensor(mu)
        out[key + "exp_avg_sq"] = torch.tensor(nu[name])
    return out


def _state_parts(trainer: nn.Module, state):
    """(module prefix, JAX param tree, its optimiser state or None) for each
    network of ``trainer``'s JAX train state, and its buffers."""
    from objgan_tpu_torch.train.box import BoxTrainer
    from objgan_tpu_torch.train.damsm import DamsmTrainer
    from objgan_tpu_torch.train.gan import GanTrainer
    from objgan_tpu_torch.train.shape import ShapeTrainer

    if isinstance(trainer, GanTrainer):
        if len(state.d_params) != len(trainer.d_nets):
            raise ValueError(f"{len(state.d_params)} D param trees for "
                             f"{len(trainer.d_nets)} DNets")
        return ([("g_net.", state.g_params, state.g_opt),
                 ("ema_g.", state.ema_g_params, None),
                 ("obj_d.", state.objd_params, state.objd_opt),
                 ("text_enc.", state.text_params, None),
                 ("img_enc.", state.img_params, None)]
                + [(f"d_nets.{i}.", p, o) for i, (p, o) in enumerate(
                    zip(state.d_params, state.d_opt))],
                {"label_table": state.label_table})
    if isinstance(trainer, DamsmTrainer):
        return ([("text_enc.", state.text_params, state.text_opt),
                 ("img_enc.", state.img_params, state.img_opt)], {})
    if isinstance(trainer, BoxTrainer):
        return [("model.", state.params, state.opt)], {}
    if isinstance(trainer, ShapeTrainer):
        parts = [("g.", state.g_params, state.g_opt),
                 ("d.", state.d_params, state.d_opt)]
        if trainer.vgg is not None:
            parts.append(("vgg.", state.vgg_params, None))
        return parts, {"label_table": state.label_table}
    raise TypeError(f"no JAX train state for {type(trainer).__name__}")


def jax_state_dict(trainer: nn.Module, state) -> Dict[str, torch.Tensor]:
    """The JAX train state ``state`` of ``trainer``'s stage as ``trainer``'s
    own state dict (CPU tensors in the port's layouts), ready for
    ``trainer.load_state_dict`` once ``core/checkpoint.py::mismatch`` finds
    nothing. Raises TypeError for a trainer with no JAX counterpart,
    ValueError for a malformed state."""
    parts, buffers = _state_parts(trainer, state)
    sd: Dict[str, torch.Tensor] = {}
    for prefix, params, opt_state in parts:
        for name, arr in jax_to_torch(params).items():
            sd[prefix + name] = torch.tensor(arr)
        if opt_state is not None:
            sd.update(_adam_entries(prefix, opt_state))
    for name, arr in buffers.items():
        sd[name] = torch.from_numpy(np.array(arr))
    sd["step"] = torch.tensor(int(np.asarray(state.step)), dtype=torch.int64)
    return sd


def load_jax_state(trainer: nn.Module, state) -> None:
    """Load a JAX train state into the port trainer of its stage: every
    network, the label table, each optimiser's Adam moments and count, and
    the step. Raises KeyError or ValueError, loading nothing, when the state
    does not fit the trainer."""
    from objgan_tpu_torch.core.checkpoint import mismatch

    sd = jax_state_dict(trainer, state)
    why = mismatch(trainer.state_dict(), sd)
    if why is not None:
        raise KeyError(f"JAX state does not match {type(trainer).__name__}: "
                       f"{why}")
    trainer.load_state_dict(sd)

