"""The Stage-C train step of the port against the JAX package: the losses
(adversarial, object, DAMSM, KL), the synthetic feed and the wire format,
one whole step at the tiny fp32 config (metrics and every parameter's
gradient, ``GAN.REMAT`` none and stages), Adam + EMA against optax on given
gradients, the param bridge of a whole train state, and
``python -m objgan_tpu_torch.gan_main`` in a subprocess that imports
neither JAX nor the JAX package.

One JAX step (``GanTrainer.init_state`` and the gradient of
``GanTrainer._losses``) is built once for the module; the port takes its
params, batch and noise (``z`` and the CA-net ``eps`` drawn from the same
JAX keys ``_losses`` splits).

Tolerances: losses fp32 atol 1e-5 rtol 1e-5; the step's metrics rtol 1e-4
(the DAMSM term sums ~300 through a conv stack and two softmaxes); every
gradient a relative norm error of at most 1e-3 (measured ~1e-5: the convs
sum in another order); Adam + EMA 1e-6."""

import dataclasses
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from objgan_tpu.data import synthetic as jsyn
from objgan_tpu.data import wire as jwire
from objgan_tpu.losses import gan_loss as jgl
from objgan_tpu.models.generator import kl_loss as j_kl_loss
from objgan_tpu.train.gan import GanTrainer as JGanTrainer
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.data import synthetic as tsyn
from objgan_tpu_torch.data import wire as twire
from objgan_tpu_torch.losses import damsm_loss as tdl
from objgan_tpu_torch.losses import gan_loss as tgl
from objgan_tpu_torch.models.generator import kl_loss
from objgan_tpu_torch.train.gan import GanTrainer
from tests.test_torch_data import FORBIDDEN_MODULES
from tests.torch_parity import n, t, tiny, ttiny

# the JAX package's losses/__init__.py exports a function of this name
jdl = importlib.import_module("objgan_tpu.losses.damsm_loss")

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)


def _d_out(r, b=3, cond=True):
    out = {"uncond": r.normal(size=(b, 4, 4)).astype(np.float32)}
    if cond:
        out["cond"] = r.normal(size=(b, 4, 4)).astype(np.float32)
    return out


def _tt(tree):
    return {k: t(v) for k, v in tree.items()}


def _jj(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_patch_d_losses():
    r = np.random.default_rng(0)
    real, fake, wrong = _d_out(r), _d_out(r), _d_out(r)
    want, w_aux = jgl.discriminator_loss(_jj(real), _jj(fake), _jj(wrong))
    got, g_aux = tgl.discriminator_loss(_tt(real), _tt(fake), _tt(wrong))
    np.testing.assert_allclose(n(got), n(want), **TOL)
    assert set(g_aux) == set(w_aux)
    for k in w_aux:
        np.testing.assert_allclose(n(g_aux[k]), n(w_aux[k]), **TOL)
    np.testing.assert_allclose(n(tgl.generator_adv_loss(_tt(fake))),
                               n(jgl.generator_adv_loss(_jj(fake))), **TOL)


def test_object_losses_mask_padding():
    """Padded objects never count, and the class term of the D reads the
    real objects only."""
    r = np.random.default_rng(1)
    b, o, c = 2, 4, 7
    outs = [{"obj": r.normal(size=(b, o)).astype(np.float32),
             "cls": r.normal(size=(b, o, c)).astype(np.float32)}
            for _ in range(2)]
    labels = r.integers(1, c, (b, o)).astype(np.int32)
    valid = np.array([[1, 1, 0, 0], [1, 0, 0, 0]], np.float32)
    want, w_aux = jgl.object_d_loss(_jj(outs[0]), _jj(outs[1]),
                                    jnp.asarray(labels), jnp.asarray(valid))
    got, g_aux = tgl.object_d_loss(_tt(outs[0]), _tt(outs[1]), t(labels),
                                   t(valid))
    np.testing.assert_allclose(n(got), n(want), **TOL)
    for k in w_aux:
        np.testing.assert_allclose(n(g_aux[k]), n(w_aux[k]), **TOL)
    np.testing.assert_allclose(
        n(tgl.object_g_loss(_tt(outs[1]), t(labels), t(valid))),
        n(jgl.object_g_loss(_jj(outs[1]), jnp.asarray(labels),
                            jnp.asarray(valid))), **TOL)
    # changing a padded object's logits changes nothing
    outs[0]["obj"][0, 3] += 50.0
    outs[0]["cls"][1, 2] -= 50.0
    again, _ = tgl.object_d_loss(_tt(outs[0]), _tt(outs[1]), t(labels),
                                 t(valid))
    np.testing.assert_allclose(n(again), n(got), **TOL)


def test_roll_sent():
    s = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(n(tgl.roll_sent(t(s))),
                                  n(jgl.roll_sent(jnp.asarray(s))))
    with pytest.raises(ValueError, match="batch size >= 2"):
        tgl.roll_sent(torch.zeros(1, 4))


def _damsm_inputs(seed=2, b=4, t_len=6, regions=16, d=8):
    r = np.random.default_rng(seed)
    return (r.normal(size=(b, regions, d)).astype(np.float32),
            r.normal(size=(b, d)).astype(np.float32),
            r.normal(size=(b, t_len, d)).astype(np.float32),
            r.normal(size=(b, d)).astype(np.float32),
            np.array([6, 3, 4, 2], np.int32))


@pytest.mark.parametrize("class_ids", [None, [0, 1, 2, 3], [5, 1, 5, 2]])
def test_damsm_losses(class_ids):
    """Words and sentence terms, with no class ids, unique ones, and a
    collision (pair 0-2 dropped as a negative)."""
    reg, glob, words, sent, lens = _damsm_inputs()
    ids = None if class_ids is None else np.array(class_ids, np.int32)
    smooth = tiny().TRAIN.SMOOTH
    want, w_parts = jdl.damsm_loss(
        jnp.asarray(reg), jnp.asarray(glob), jnp.asarray(words),
        jnp.asarray(sent), jnp.asarray(lens),
        None if ids is None else jnp.asarray(ids), smooth)
    got, g_parts = tdl.damsm_loss(t(reg), t(glob), t(words), t(sent),
                                  t(lens), None if ids is None else t(ids),
                                  ttiny().TRAIN.SMOOTH)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    for k in w_parts:
        np.testing.assert_allclose(n(g_parts[k]), n(w_parts[k]), **TOL)
    *_, w_attn = jdl.words_loss(jnp.asarray(reg), jnp.asarray(words),
                                jnp.asarray(lens), None, 4.0, 5.0, 10.0)
    *_, g_attn = tdl.words_loss(t(reg), t(words), t(lens), None, 4.0, 5.0,
                                10.0)
    assert g_attn.shape == w_attn.shape == (4, 4, 6, 16)
    np.testing.assert_allclose(n(g_attn), n(w_attn), **TOL)


def test_damsm_helpers_at_zero():
    """``_safe_norm`` keeps the gradient finite at a zero vector."""
    x = torch.zeros(2, 3, requires_grad=True)
    (g,) = torch.autograd.grad(tdl._safe_norm(x).sum(), x)
    assert torch.isfinite(g).all()
    a = np.random.default_rng(3).normal(size=(3, 5)).astype(np.float32)
    np.testing.assert_allclose(
        n(tdl._cosine(t(a), t(a[::-1].copy()))),
        n(jdl._cosine(jnp.asarray(a), jnp.asarray(a[::-1]))), **TOL)
    mask = tdl._class_mask(t(np.array([1, 2, 1])), 3)
    np.testing.assert_array_equal(
        n(mask), n(jdl._class_mask(jnp.array([1, 2, 1]), 3)))


def test_kl_loss():
    r = np.random.default_rng(4)
    mu, logvar = (r.normal(size=(3, 16)).astype(np.float32) for _ in "ab")
    np.testing.assert_allclose(
        n(kl_loss(t(mu), t(logvar))),
        n(j_kl_loss(jnp.asarray(mu), jnp.asarray(logvar))), **TOL)


def test_synthetic_layout_batch_matches_jax():
    """``synthetic_layout_batch``: JAX's five layout keys, with their
    shapes, dtypes and value ranges, drawn from an explicit generator."""
    want = jsyn.synthetic_layout_batch(tiny(), jax.random.PRNGKey(0),
                                       batch=5)
    gen = torch.Generator().manual_seed(3)
    got = tsyn.synthetic_layout_batch(ttiny(), gen, batch=5)
    assert list(got) == list(want) == ["captions", "cap_lens", "labels",
                                       "boxes", "obj_valid"]
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert n(got[k]).dtype == np.asarray(w).dtype, k
    cfg = ttiny()
    lens = n(got["cap_lens"])
    assert (3 <= lens).all() and (lens <= cfg.TEXT.WORDS_NUM).all()
    caps = n(got["captions"])
    assert (caps < cfg.TEXT.VOCAB_SIZE).all() and (caps >= 0).all()
    boxes = n(got["boxes"])
    assert (boxes[..., :2] >= 0).all() and (boxes[..., :2] < 0.7).all()
    again = tsyn.synthetic_layout_batch(
        ttiny(), torch.Generator().manual_seed(3), batch=5)
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_synthetic_batch_matches_jax_layout():
    """The same keys, shapes, dtypes and value ranges as the JAX feed."""
    cfg = tiny()
    want = jsyn.synthetic_batch(cfg, jax.random.PRNGKey(0), batch=8)
    got = tsyn.synthetic_batch(ttiny(), torch.Generator().manual_seed(0),
                               batch=8)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, list):
            assert [tuple(x.shape) for x in g] == [x.shape for x in w]
            assert all(x.dtype == torch.float32 for x in g)
            assert all(-1.0 <= float(x.min()) and float(x.max()) < 1.0
                       for x in g)
            continue
        assert tuple(g.shape) == w.shape, k
        assert n(g).dtype == np.asarray(w).dtype, k
    valid = n(got["obj_valid"])
    assert set(np.unique(valid)) <= {0.0, 1.0} and (valid[:, 0] == 1).all()
    assert (np.diff(valid, axis=1) <= 0).all()  # valid objects first
    labels = n(got["labels"])
    assert (labels[valid == 1] >= 1).all() and (labels[valid == 0] == 0).all()
    boxes = n(got["boxes"])
    assert (boxes[..., :2] >= 0).all() and (boxes[..., :2] < 0.7).all()
    assert (boxes[..., 2:] >= 0.1).all() and (boxes[..., 2:] < 0.3).all()
    lens = n(got["cap_lens"])
    caps = n(got["captions"])
    assert ((caps > 0) == (np.arange(cfg.TEXT.WORDS_NUM)[None]
                           < lens[:, None])).all()
    np.testing.assert_array_equal(n(got["class_ids"]), np.arange(8))
    assert set(np.unique(n(got["shapes"]))) <= {0.0, 1.0}


def test_from_wire_matches_jax():
    cfg = tiny()
    r = np.random.default_rng(5)
    img = r.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    shp = r.integers(0, 256, (2, 3, 16, 16)).astype(np.uint8)
    batch = {"image_u8": img, "shapes_u8": shp,
             "labels": np.ones((2, 3), np.int32)}
    want = jwire.from_wire(cfg, {k: jnp.asarray(v) for k, v in
                                 batch.items()})
    got = twire.from_wire(ttiny(), {k: torch.from_numpy(v) for k, v in
                                    batch.items()})
    assert set(got) == set(want) == {"images", "shapes", "labels"}
    for g, w in zip(got["images"], want["images"]):
        np.testing.assert_allclose(n(g), n(w), **TOL)
    np.testing.assert_allclose(n(got["shapes"]), n(want["shapes"]), **TOL)
    classic = {"labels": torch.ones(2, 3)}
    assert twire.from_wire(ttiny(), classic) is classic
    with pytest.raises(ValueError, match="finest scale"):
        twire.from_wire(ttiny(), {"image_u8": torch.zeros(
            2, 32, 32, 3, dtype=torch.uint8)})


# -- the whole step -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_step():
    """One JAX step at tiny fp32: the state, the batch, the noise and the
    gradients and metrics of ``GanTrainer._losses``."""
    cfg = tiny("float32")
    jt = JGanTrainer(cfg)
    batch = jax.device_get(jsyn.synthetic_batch(cfg, jax.random.PRNGKey(1)))
    state = jax.jit(jt.init_state)(jax.random.PRNGKey(0), batch)
    rng = jax.random.PRNGKey(3)

    def loss_fn(g, d, o):
        return jt._losses(g, d, o, state, batch, rng)

    (gg, dg, og), metrics = jax.jit(jax.grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True))(
        state.g_params, state.d_params, state.objd_params)
    # the noise _losses draws: z from k_z, the CA-net eps inside GNet from
    # k_ca
    b = batch["captions"].shape[0]
    k_z, k_ca = jax.random.split(rng)
    noise = (jax.random.normal(k_z, (b, cfg.GAN.Z_DIM)),
             jax.random.normal(k_ca, (b, cfg.GAN.CONDITION_DIM)))
    grads = {}
    for prefix, tree in [("g_net.", gg), ("obj_d.", og)] + [
            (f"d_nets.{i}.", d) for i, d in enumerate(dg)]:
        grads.update({prefix + k: v for k, v in
                      bridge.jax_to_torch(jax.device_get(tree)).items()})
    return {
        "state": jax.device_get(state), "batch": batch,
        "noise": [t(x) for x in noise], "grads": grads,
        "metrics": {k: float(v) for k, v in metrics.items()},
    }


def _port_batch(batch):
    return {k: ([t(x) for x in v] if isinstance(v, list) else t(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=["none", "stages"])
def port_step(request, jax_step):
    """The port's gradients and metrics on the JAX step's params, batch and
    noise. jax.checkpoint recomputes the same values, so the JAX step at
    REMAT none is the reference for both settings."""
    cfg = ttiny("float32", GAN={"REMAT": request.param})
    trainer = GanTrainer(cfg)
    bridge.load_jax_state(trainer, jax_step["state"])
    grads, metrics = trainer.grads(_port_batch(jax_step["batch"]),
                                   *jax_step["noise"])
    return grads, metrics


def test_step_metrics_match_jax(jax_step, port_step):
    _, metrics = port_step
    want = jax_step["metrics"]
    assert set(metrics) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(float(metrics[k]), w, rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_step_gradients_match_jax(jax_step, port_step):
    """Every G, patch-D and object-D gradient; the D terms saw the fakes
    detached and the G terms no D parameter, as JAX's stop-gradients."""
    grads, _ = port_step
    want = jax_step["grads"]
    assert set(grads) == set(want)
    for k, w in want.items():
        g = n(grads[k])
        assert g.shape == w.shape, k
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 1e-3, (k, err)
        assert np.linalg.norm(w) > 0, k  # every parameter gets a gradient


def test_load_gan_state_copies_every_network(jax_step):
    trainer = GanTrainer(ttiny("float32"))
    state = jax_step["state"]
    bridge.load_jax_state(trainer, state)
    sd = {k: v.numpy() for k, v in trainer.state_dict().items()}
    for prefix, tree in [("g_net.", state.g_params),
                         ("ema_g.", state.ema_g_params),
                         ("obj_d.", state.objd_params),
                         ("text_enc.", state.text_params),
                         ("img_enc.", state.img_params)] + [
            (f"d_nets.{i}.", d) for i, d in enumerate(state.d_params)]:
        for k, v in bridge.jax_to_torch(tree).items():
            np.testing.assert_array_equal(sd[prefix + k], v)
    np.testing.assert_array_equal(sd["label_table"], state.label_table)
    assert trainer.step == 0
    with pytest.raises(ValueError, match="D param trees"):
        bridge.load_jax_state(trainer, dataclasses.replace(
            state, d_params=state.d_params[:2]))


def test_layout_pyramid_matches_jax(jax_step):
    """The per-scale layout canvases: rasterised at 64 px, average-pooled
    to 32 and 16 (JAX reduce_window)."""
    from objgan_tpu.ops import rasterize as jras

    batch = jax_step["batch"]
    trainer = GanTrainer(ttiny("float32"))
    got = trainer.layouts(_port_batch(batch))
    top = jras.layout_map(jras.paste_masks(
        jnp.asarray(batch["shapes"]), jnp.asarray(batch["boxes"]), 64, 64),
        jnp.asarray(batch["obj_valid"]))
    np.testing.assert_allclose(n(got[64]), n(top), **TOL)
    for size in (32, 16):
        f = 64 // size
        want = jax.lax.reduce_window(top, 0.0, jax.lax.add, (1, f, f, 1),
                                     (1, f, f, 1), "VALID") / (f * f)
        np.testing.assert_allclose(n(got[size]), n(want), **TOL)


def test_adam_and_ema_match_optax():
    """Two updates on given gradients: every network's Adam (b1 0.5, b2
    0.999, eps 1e-8, bias-corrected) and the EMA of G (decay 0.999)
    against optax, to 1e-6."""
    cfg = ttiny("float32")
    trainer = GanTrainer(cfg).init_state(torch.Generator().manual_seed(0))
    names = list(trainer.g_parameters()) + list(trainer.d_parameters())
    params = {k: v.detach().numpy().copy()
              for k, v in trainer.named_parameters() if k in names}
    ema = {k: v.detach().numpy().copy()
           for k, v in trainer.ema_g.named_parameters()}
    r = np.random.default_rng(0)
    tx = optax.adam(cfg.TRAIN.GENERATOR_LR, b1=0.5, b2=0.999)
    opt = tx.init(params)

    @jax.jit
    def update(grads, opt, params):
        upd, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, upd), opt

    for _ in range(2):
        grads = {k: r.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        trainer.apply_grads({k: t(v) for k, v in grads.items()})
        params, opt = update(grads, opt, params)
        params = jax.device_get(params)
        ema = {k: v * 0.999 + params["g_net." + k] * (1 - 0.999)
               for k, v in ema.items()}
    assert trainer.step == 2
    got = dict(trainer.named_parameters())
    for k, v in params.items():
        np.testing.assert_allclose(n(got[k]), v, rtol=0, atol=1e-6,
                                   err_msg=k)
    for k, v in trainer.ema_g.named_parameters():
        np.testing.assert_allclose(n(v), ema[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def _tiny_yml(path, train):
    cfg = {
        "OUTPUT_DIR": str(path.parent / "out"),
        "TRAIN": {"FLAG": train, "BATCH_SIZE": 2},
        "TREE": {"BASE_SIZE": 16},
        "GAN": {"DF_DIM": 8, "GF_DIM": 8, "Z_DIM": 16, "CONDITION_DIM": 16},
        "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6, "VOCAB_SIZE": 50,
                 "HIDDEN_DIM": 16, "GLOVE_DIM": 16},
        "OBJ": {"MAX_OBJECTS": 3, "NUM_CLASSES": 7, "ROI_SIZE": 4,
                "LABEL_DIM": 16, "GMM_COMPONENTS": 4, "SHAPE_SIZE": 16},
        "BOX": {"RNN_SIZE": 32, "INPUT_ENCODING_SIZE": 16,
                "ATT_HID_SIZE": 16, "MAX_SEQ_LENGTH": 4},
        "SHAPE": {"GF_DIM": 8, "DF_DIM": 8, "HIDDEN_DIM": 8},
    }
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_gan_main_trains_without_jax(tmp_path):
    yml = _tiny_yml(tmp_path / "tiny.yml", True)
    code = (
        "import runpy, sys\n"
        "sys.argv = ['gan_main', '--cfg', sys.argv[1], '--max_steps', '2',"
        " '--log_every', '1', '--device', 'cpu']\n"
        "runpy.run_module('objgan_tpu_torch.gan_main', run_name='__main__')\n"
        + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code, str(yml)], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[step")]
    assert [ln.split("]")[0] for ln in lines] == ["[step 1", "[step 2"]
    for ln in lines:
        vals = dict(kv.split("=") for kv in ln.split("] ")[1].split())
        assert {"d_loss", "g_loss", "objd_cls", "damsm", "kl"} <= set(vals)
        assert all(np.isfinite(float(v)) for v in vals.values())
    assert "UNTRAINED" in proc.stderr


def test_gan_main_under_torchrun_without_jax(tmp_path):
    """``gan_main`` launched by torchrun (one gloo rank on the CPU): it
    joins the group, trains, writes its checkpoint, leaves the group, and
    loads neither JAX nor the JAX package."""
    yml = _tiny_yml(tmp_path / "tiny.yml", True)
    code = (
        "import runpy, sys\n"
        "import torch.distributed as dist\n"
        "joined, init = [], dist.init_process_group\n"
        "def spy(backend, **kw):\n"
        "    joined.append(backend)\n"
        "    init(backend, **kw)\n"
        "dist.init_process_group = spy\n"
        "sys.argv = ['gan_main', '--cfg', sys.argv[1], '--max_steps', '2',"
        " '--log_every', '1', '--device', 'cpu']\n"
        "runpy.run_module('objgan_tpu_torch.gan_main', run_name='__main__')\n"
        "assert joined == ['gloo'] and not dist.is_initialized(), joined\n"
        + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "--no-python", sys.executable, "-c", code,
         str(yml)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert [ln.split("]")[0] for ln in proc.stdout.splitlines()
            if ln.startswith("[step")] == ["[step 1", "[step 2"]
    assert os.listdir(tmp_path / "out" / "objgan_gan" / "ckpt") == ["2"]


def test_gan_main_samples_when_not_training(tmp_path, capsys):
    from objgan_tpu_torch import gan_main

    yml = _tiny_yml(tmp_path / "tiny.yml", False)
    gan_main.main(["--cfg", str(yml), "--num_batches", "1", "--device",
                   "cpu"])
    out = tmp_path / "out" / "objgan_gan_samples"
    assert sorted(os.listdir(out)) == ["s0_0.png", "s0_1.png"]
    assert "wrote 2 samples" in capsys.readouterr().out


def test_gan_main_help_names_what_waits():
    from objgan_tpu_torch import gan_main

    with pytest.raises(SystemExit):
        gan_main.main(["--help"])


def test_train_step_updates_and_counts():
    """A step on the CPU moves every trained network, leaves the frozen
    ones alone, and runs no kernel."""
    from objgan_tpu_torch.ops import groupnorm, roi_align

    cfg = ttiny("float32")
    trainer = GanTrainer(cfg).init_state(torch.Generator().manual_seed(1))
    frozen = {k: v.clone() for k, v in trainer.state_dict().items()
              if k.startswith(("text_enc.", "img_enc.", "label_table"))}
    before = {k: v.detach().clone() for k, v in trainer.named_parameters()
              if k.startswith(("g_net.", "d_nets.", "obj_d."))}
    gen = torch.Generator().manual_seed(2)
    batch = tsyn.synthetic_batch(cfg, gen)
    k1, k23 = groupnorm.launches, dict(roi_align.launches)
    metrics = trainer.train_step(batch, torch.randn(2, 16, generator=gen),
                                 torch.randn(2, 16, generator=gen))
    assert groupnorm.launches == k1 and roi_align.launches == k23
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert trainer.step == 1
    after = dict(trainer.named_parameters())
    assert all(not torch.equal(after[k], v) for k, v in before.items())
    sd = trainer.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in frozen.items())
