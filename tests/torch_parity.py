"""Shared helpers of the ``test_torch_*.py`` parity tests: JAX-side params
for each stage at ``tiny_test_config`` size, JAX's key chain of the composed
pipeline replayed as explicit noise tensors, and numpy <-> torch glue.

Inputs and noise are made with numpy or by JAX and handed to both packages
as numpy arrays; the port's modules get the JAX params through
``objgan_tpu_torch.core.bridge``. JAX modules take the JAX package's
``Config``, the port's modules the port's own copy (``port_cfg``,
``ttiny``).
"""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from objgan_tpu.core.config import tiny_test_config
from objgan_tpu_torch.core import config as port_config

torch.set_num_threads(2)


def tiny(dtype: str = "float32", **overrides):
    """tiny_test_config in the given compute dtype (+ nested overrides)."""
    return tiny_test_config().merged({"DTYPE": dtype, **overrides})


def port_cfg(cfg):
    """The port's ``Config`` holding the same values as a JAX-package one."""
    return port_config.Config().merged(dataclasses.asdict(cfg))


def ttiny(dtype: str = "float32", **overrides):
    """``tiny`` as the port's own config."""
    return port_config.tiny_test_config().merged({"DTYPE": dtype,
                                                  **overrides})


def t(x, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> torch tensor (fp32/int64 unless told)."""
    a = np.asarray(x)
    out = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None:
        return out.to(dtype)
    if a.dtype.kind in "iu":
        return out.long()
    if a.dtype.kind == "b":
        return out
    return out.float()


def n(x) -> np.ndarray:
    """torch tensor / JAX array -> fp32 (or int) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == \
        "bfloat16" else a


def assert_bf16_images_close(got, want, want_fp32, atol=5e-2):
    """bf16 image parity. Many bf16 convs deep, the two frameworks' rounding
    sites make a few pixels drift past ``atol``; JAX's own bf16 output
    drifts from its fp32 output by as much (up to ~0.09 on these tiny random
    models). So per scale: at most 0.5% of pixels beyond ``atol``, a mean
    difference under atol / 5, and the port's bf16 error against JAX's fp32
    output no larger on average than 1.5x JAX's own bf16 error."""
    for g, w, w32 in zip(got, want, want_fp32):
        d = np.abs(n(g) - n(w))
        assert (d > atol).mean() <= 5e-3, (d > atol).mean()
        assert d.mean() <= atol / 5, d.mean()
        own = np.abs(n(w) - n(w32)).mean()
        assert np.abs(n(g) - n(w32)).mean() <= 1.5 * own, own


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), jax.device_get(tree))


def torch_to_jax(module, template):
    """``module``'s parameters as a JAX param tree shaped like
    ``template``: the inverse of ``core.bridge.load_jax_params``."""
    from objgan_tpu_torch.core import bridge

    params = dict(module.named_parameters())

    def walk(tree, mods):
        out = {}
        for key, leaf in tree.items():
            if not hasattr(leaf, "shape"):
                out[key] = walk(leaf, mods + [key])
                continue
            name, _ = bridge._to_torch(key, np.asarray(leaf))
            w = n(params[".".join(mods + [name])])
            if key == "kernel":
                w = w.T if w.ndim == 2 else w.transpose(2, 3, 1, 0)
            assert w.shape == leaf.shape, (mods, key)
            out[key] = np.ascontiguousarray(w)
        return out

    if set(template) == {"params"}:
        return {"params": walk(template["params"], [])}
    return walk(template, [])


def example_batch(cfg, batch: int = 2, seed: int = 0):
    """Caption ids and lengths made with numpy (the last row shorter)."""
    r = np.random.default_rng(seed)
    tw = cfg.TEXT.WORDS_NUM
    lens = np.array([tw] + [max(1, tw - 3)] * (batch - 1), np.int32)
    caps = r.integers(1, cfg.TEXT.VOCAB_SIZE, (batch, tw)).astype(np.int32)
    caps[np.arange(tw)[None] >= lens[:, None]] = 0
    return caps, lens


def jax_stage_params(cfg, seed: int = 0, batch: int = 2):
    """Fresh JAX params of the three stages (the parts sampling reads), as
    numpy trees. The two label tables are different random tables, as the
    JAX trainers draw them at a class count other than 81."""
    from objgan_tpu.pipeline_e2e import ObjGanPipeline

    pipe = ObjGanPipeline(cfg)
    b, tw = batch, cfg.TEXT.WORDS_NUM
    o, s = cfg.OBJ.MAX_OBJECTS, cfg.OBJ.SHAPE_SIZE
    caps = jnp.ones((b, tw), jnp.int32)
    lens = jnp.full((b,), tw, jnp.int32)
    labels = jnp.ones((b, o), jnp.int32)
    boxes = jnp.full((b, o, 4), 0.2)
    valid = jnp.ones((b, o))
    k = jax.random.split(jax.random.PRNGKey(seed), 8)
    shape_lt = jax.random.normal(k[1], (cfg.OBJ.NUM_CLASSES,
                                        cfg.OBJ.LABEL_DIM)) * 0.02
    gan_lt = jax.random.normal(k[7], (cfg.OBJ.NUM_CLASSES,
                                      cfg.OBJ.LABEL_DIM)) * 0.02
    box = jax.jit(pipe.box.model.init)(k[0], caps, lens, labels, boxes,
                                       valid)
    shape_g = jax.jit(pipe.shape.g.init)(k[2], boxes, shape_lt[labels],
                                         valid, k[3])
    text = jax.jit(pipe.gan.text_enc.init)(k[4], caps, lens)
    words, sent = pipe.gan.text_enc.apply(text, caps, lens)
    gan_g = jax.jit(pipe.gan.g_net.init)(
        {"params": k[5]}, jnp.zeros((b, cfg.GAN.Z_DIM)), sent, words,
        jnp.zeros((b, tw), bool), gan_lt[labels], boxes,
        jnp.ones((b, o, s, s)), valid, k[6])
    return to_numpy_tree({
        "box": box, "shape_g": shape_g, "shape_label_table": shape_lt,
        "gan_g": gan_g, "text": text, "gan_label_table": gan_lt,
    })


def jax_states(p):
    """Duck-typed stage states for objgan_tpu.pipeline_e2e.generate."""
    ns = types.SimpleNamespace
    return {
        "box": ns(params=p["box"]),
        "shape": ns(g_params=p["shape_g"],
                    label_table=jnp.asarray(p["shape_label_table"])),
        "gan": ns(ema_g_params=p["gan_g"], text_params=p["text"],
                  label_table=jnp.asarray(p["gan_label_table"])),
    }


def replay_noise(cfg, rng, batch: int):
    """The draws ``ObjGanPipeline.generate(states, ..., rng)`` makes, from
    JAX's own key chain, in the layout of the port's ``draw_noise``:

    split(rng, 3) -> (k_box, k_shape, k_gan)                 pipeline_e2e
    k_box: split(k_box, MAX_SEQ_LENGTH), per step split(step, 2) -> (k1, k2)
        label = categorical(k1, .) -> gumbel(k1, (B, C))     box_generator
        gmm.sample: split(k2) -> (k_rng, g_rng): gumbel(k_rng, (B, K)),
        normal(g_rng, (B, 4))                                 ops/gmm
    k_shape: normal(k_shape, (B, O, 1, 1, gf))             shape_generator
    k_gan: split(k_gan) -> (k_z, k_ca): normal (B, Z), normal (B, COND)
    """
    b = batch
    k_box, k_shape, k_gan = jax.random.split(rng, 3)
    k_z, k_ca = jax.random.split(k_gan)
    noise = {
        "shape_z": replay_shape_z(cfg, k_shape, b),
        "z": t(jax.random.normal(k_z, (b, cfg.GAN.Z_DIM))),
        "ca_eps": t(jax.random.normal(k_ca, (b, cfg.GAN.CONDITION_DIM),
                                      jnp.float32)),
    }
    return {**replay_box_noise(cfg, k_box, b), **noise}


def replay_box_noise(cfg, rng, batch: int):
    """The draws of ``BoxGenerator.sample(..., rng)`` in the layout of the
    port's ``train/box.py::box_noise`` (see ``replay_noise``)."""
    lg, cg, bn = [], [], []
    for step in jax.random.split(rng, cfg.BOX.MAX_SEQ_LENGTH):
        k1, k2 = jax.random.split(step)
        lg.append(jax.random.gumbel(k1, (batch, cfg.OBJ.NUM_CLASSES)))
        k_rng, g_rng = jax.random.split(k2)
        cg.append(jax.random.gumbel(k_rng, (batch, cfg.OBJ.GMM_COMPONENTS)))
        bn.append(jax.random.normal(g_rng, (batch, 4)))
    return {"label_gumbel": t(jnp.stack(lg)),
            "comp_gumbel": t(jnp.stack(cg)), "box_normal": t(jnp.stack(bn))}


def replay_shape_z(cfg, rng, batch: int):
    """The noise ``ShapeGenerator`` draws from ``rng``:
    (B, O, 1, 1, SHAPE.GF_DIM)."""
    return t(jax.random.normal(
        rng, (batch, cfg.OBJ.MAX_OBJECTS, 1, 1, cfg.SHAPE.GF_DIM),
        jnp.float32))
