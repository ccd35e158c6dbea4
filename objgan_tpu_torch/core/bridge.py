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

``load_gan_state`` loads a whole Stage-C train state into the port's
trainer (with fresh optimisers); ``load_damsm_state``, ``load_box_state``
and ``load_shape_state`` a DAMSM, Stage-A and Stage-B state with their
Adam moments and step (optax's ``masked`` state of an inception DAMSM
backbone included: only the projections have moments).
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
        elif isinstance(val, tuple) and not val:
            continue  # optax.masked's MaskedNode: a leaf with no state
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


def load_gan_state(trainer: nn.Module, state) -> None:
    """Load a JAX ``GanTrainState`` (its ``g_params``, ``ema_g_params``,
    ``d_params``, ``objd_params``, ``text_params``, ``img_params`` and
    ``label_table``, as numpy or JAX arrays) into a
    ``train.gan.GanTrainer``. The optimiser state starts fresh, as in JAX's
    ``init_state``."""
    if len(state.d_params) != len(trainer.d_nets):
        raise ValueError(f"{len(state.d_params)} D param trees for "
                         f"{len(trainer.d_nets)} DNets")
    load_jax_params(trainer.g_net, state.g_params)
    load_jax_params(trainer.ema_g, state.ema_g_params)
    for dnet, tree in zip(trainer.d_nets, state.d_params):
        load_jax_params(dnet, tree)
    load_jax_params(trainer.obj_d, state.objd_params)
    load_jax_params(trainer.text_enc, state.text_params)
    load_jax_params(trainer.img_enc, state.img_params)
    with torch.no_grad():
        trainer.label_table.copy_(torch.tensor(np.asarray(state.label_table)))
    trainer.reset_optimizers()


def load_damsm_state(trainer: nn.Module, state) -> None:
    """Load a JAX ``DamsmTrainState`` (``text_params``, ``img_params``,
    their optimiser states and ``step``) into a
    ``train.damsm.DamsmTrainer``."""
    trainer.reset_optimizers()
    load_jax_params(trainer.text_enc, state.text_params)
    load_jax_params(trainer.img_enc, state.img_params)
    _load_adam(trainer.text_enc, trainer.text_opt, state.text_opt)
    _load_adam(trainer.img_enc, trainer.img_opt, state.img_opt)
    trainer.step = int(np.asarray(state.step))


def _scale_by_adam(opt_state):
    """optax's ScaleByAdamState (``count``, ``mu``, ``nu``) inside a
    (possibly chained) optimiser state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _scale_by_adam(part)
            if found is not None:
                return found
    return None


def _load_adam(module: nn.Module, opt: torch.optim.Optimizer,
               opt_state) -> None:
    """optax Adam's ``count``, ``mu`` and ``nu`` of ``module``'s params
    into ``opt``'s state (``step``, ``exp_avg``, ``exp_avg_sq``)."""
    adam = _scale_by_adam(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState in the optimiser state")
    mu, nu = jax_to_torch(adam.mu), jax_to_torch(adam.nu)
    count = float(np.asarray(adam.count))
    names = {p: n for n, p in module.named_parameters()}
    for group in opt.param_groups:
        for p in group["params"]:
            name = names[p]
            opt.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": torch.tensor(mu[name]).to(p),
                "exp_avg_sq": torch.tensor(nu[name]).to(p)}


def load_box_state(trainer: nn.Module, state) -> None:
    """Load a JAX ``BoxTrainState`` (``params``, the clip+Adam ``opt``
    state and ``step``) into a ``train.box.BoxTrainer``."""
    trainer.reset_optimizers()
    load_jax_params(trainer.model, state.params)
    _load_adam(trainer.model, trainer.opt, state.opt)
    trainer.step = int(np.asarray(state.step))


def load_shape_state(trainer: nn.Module, state) -> None:
    """Load a JAX ``ShapeTrainState`` (``g_params``, ``d_params``, their
    Adam states, ``label_table``, ``step`` and, in ``vgg`` mode,
    ``vgg_params``) into a ``train.shape.ShapeTrainer``."""
    trainer.reset_optimizers()
    load_jax_params(trainer.g, state.g_params)
    load_jax_params(trainer.d, state.d_params)
    if trainer.vgg is not None:
        load_jax_params(trainer.vgg, state.vgg_params)
    _load_adam(trainer.g, trainer.g_opt, state.g_opt)
    _load_adam(trainer.d, trainer.d_opt, state.d_opt)
    with torch.no_grad():
        trainer.label_table.copy_(torch.tensor(np.asarray(state.label_table)))
    trainer.step = int(np.asarray(state.step))
