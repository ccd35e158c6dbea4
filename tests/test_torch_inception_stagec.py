"""Stage C with ``TEXT.CNN_BACKBONE: inception`` in the port against the
benchmark's plain reference (``h100bench/reference/inception.py``: plain
torch, no JAX, nothing of the port), on the same seeded weights
(``h100bench/drivers/train_loop_inception.py::draw``), batch and noise, in
float32 at the tiny config:

* ``InceptionEncoder`` against the reference encoder at batch 2 from 64 px:
  regions, global feature and the images' gradient for a seeded
  cotangent, each within 1e-4 of the tensor's largest magnitude (two
  float32 graphs of ~94 convolutions, the port's BatchNorm folded into an
  affine, the reference's ``F.batch_norm``: rounding apart);
* one Stage-C step: both losses within 1e-5 relative, every trained
  leaf's gradient within 1e-4 of its largest magnitude, plus 1e-7 for
  leaves at rounding's scale (another summation order through the
  ~100 layers of G, the Ds and the encoder; measured ≤ 1.01e-5);
* the DAMSM term alone gives G a nonzero gradient equal to the
  reference's: the gradient passes through the frozen backbone to the
  fake image, as in the lineage (the JAX package stops it, a difference
  that ``ROADMAP.md`` pins);
* the backbone takes no gradient, no Adam state and no move, in
  ``GanTrainer`` and ``DamsmTrainer``, and real images build no autograd
  graph through it;
* the encoder's spans of device time (``profiling.device_timed``) are
  recorded under a profiler, and without one leave no mark in the graph.
"""

import dataclasses

import pytest
import torch

from h100bench import harness
from h100bench.reference import inception as iref
from objgan_tpu_torch.core.config import tiny_test_config
from objgan_tpu_torch.data.synthetic import synthetic_batch
from objgan_tpu_torch.models.inception_v3 import InceptionEncoder
from objgan_tpu_torch.train.damsm import DamsmTrainer
from objgan_tpu_torch.train.gan import GanTrainer, train_noise
from objgan_tpu_torch.utils import profiling

torch.set_num_threads(2)

SEED = 2 ** 31 + 1717
DRIVER = harness.driver("train_loop_inception")


def _cfg():
    return tiny_test_config().merged({"DTYPE": "float32",
                                      "TEXT": {"CNN_BACKBONE": "inception"}})


@pytest.fixture(scope="module")
def pair():
    """(port trainer, reference, batch, z, ca_eps) on one set of
    weights."""
    iref.no_tf32()
    cfg = _cfg()
    flat = iref.flat_config(dataclasses.asdict(cfg))
    with torch.device("meta"):
        shape = iref.StageC(flat, iref.Numerics())
    w = DRIVER.draw(shape, SEED, "cpu")
    model = iref.StageC(flat, iref.Numerics())
    DRIVER.weights.load_into(model, w)
    trainer = GanTrainer(cfg)
    DRIVER.weights.load_into(trainer, w, lambda n: (
        "g_net." + n[len("ema_g."):] if n.startswith("ema_g.") else n))
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(1))
    noise = train_noise(cfg, cfg.TRAIN.BATCH_SIZE,
                        torch.Generator().manual_seed(2), "cpu")
    return trainer, model, batch, noise["z"], noise["ca_eps"]


def _close(got, want, rel, atol=0.0, what=""):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale + atol, (what, err, scale)


def test_encoder_matches_reference(pair):
    trainer, model, _, _, _ = pair
    port = InceptionEncoder(trainer.cfg.TEXT.EMBEDDING_DIM)
    port.load_state_dict(trainer.img_enc.state_dict())
    port.requires_grad_(False)
    g = torch.Generator().manual_seed(3)
    images = torch.rand(2, 64, 64, 3, generator=g) * 2 - 1
    outs, grads = [], []
    for enc in (port, model.img_enc):
        x = images.clone().requires_grad_()
        regions, global_f = enc(x)
        cot = (torch.randn(regions.shape, generator=torch.Generator()
                           .manual_seed(4)),
               torch.randn(global_f.shape, generator=torch.Generator()
                           .manual_seed(5)))
        (gx,) = torch.autograd.grad((regions, global_f), x, cot)
        outs.append((regions, global_f))
        grads.append(gx)
    assert outs[0][0].shape == (2, 289, trainer.cfg.TEXT.EMBEDDING_DIM)
    for got, want, what in ((outs[0][0], outs[1][0], "regions"),
                            (outs[0][1], outs[1][1], "global"),
                            (grads[0], grads[1], "images' gradient")):
        assert float(want.abs().max()) > 0, what
        _close(got, want, 1e-4, what=what)


def test_stage_c_step_matches_reference(pair):
    trainer, model, batch, z, eps = pair
    grads, metrics = trainer.grads(batch, z, eps)
    d, g, want = model.grads(batch, z, eps)
    assert float(metrics["d_loss"]) == pytest.approx(d, rel=1e-5, abs=0)
    assert float(metrics["g_loss"]) == pytest.approx(g, rel=1e-5, abs=0)
    assert set(grads) == set(want) == set(trainer.trained_parameters())
    for name, w in want.items():
        _close(grads[name], w, 1e-4, 1e-7, name)


def test_damsm_term_reaches_g_as_in_the_reference(pair):
    """G's DAMSM term alone: a nonzero gradient of every G leaf it reaches,
    equal to the reference's (zero throughout where the backbone detaches
    its features)."""
    trainer, model, batch, z, eps = pair
    _, _, metrics = trainer.losses(batch, z, eps)
    params = trainer.g_parameters()
    got = torch.autograd.grad(metrics["damsm"], list(params.values()),
                              allow_unused=True)
    got = {n: torch.zeros_like(p) if gr is None else gr
           for (n, p), gr in zip(params.items(), got)}
    term = model.damsm_term(batch, z, eps)
    assert float(metrics["damsm"]) == pytest.approx(float(term), rel=1e-5)
    ref_params = {n: p for n, p in model.named_parameters()
                  if n.startswith("g_net.")}
    want = dict(zip(ref_params, torch.autograd.grad(
        term, list(ref_params.values()), allow_unused=True)))
    total = torch.stack([g.norm() for g in got.values()]).norm()
    assert float(total) > 0
    reached = [n for n, w in want.items() if w is not None]
    assert "g_net.img64.img.weight" in reached
    for name in params:
        w = want[name] if want[name] is not None else torch.zeros_like(
            got[name])
        _close(got[name], w, 1e-4, 1e-7, name)


def _backbone_untouched(trainer, before):
    backbone = dict(trainer.img_enc.backbone.named_parameters())
    held = {id(p) for opt in trainer.optimizers()
            for group in opt.param_groups for p in group["params"]}
    for name, p in backbone.items():
        assert not p.requires_grad and p.grad is None, name
        assert id(p) not in held, name
        assert torch.equal(p, before[name]), name
        assert not any(p is q for opt in trainer.optimizers()
                       for q in opt.state), name
    assert not any(n.startswith("img_enc.backbone.")
                   for n in trainer.trained_parameters())


def test_backbone_frozen_in_gan_trainer(pair):
    trainer, _, batch, z, eps = pair
    stepped = GanTrainer(trainer.cfg)
    stepped.load_state_dict(trainer.state_dict())
    before = {n: p.clone() for n, p in
              stepped.img_enc.backbone.named_parameters()}
    g0 = stepped.g_net.img64.img.weight.clone()
    stepped.train_step(batch, z, eps)
    assert not torch.equal(stepped.g_net.img64.img.weight, g0)
    _backbone_untouched(stepped, before)


def test_backbone_frozen_in_damsm_trainer_without_a_graph():
    """DAMSM pretraining on real images: the backbone's outputs need no
    gradient, so no autograd graph is built through it; its step trains
    the projections and leaves the backbone as it was."""
    cfg = _cfg()
    trainer = DamsmTrainer(cfg).init_state(torch.Generator().manual_seed(0))
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(1))
    keep = trainer.text_enc.keep_mask(batch["captions"],
                                      torch.Generator().manual_seed(2))
    seen = []
    trainer.img_enc.backbone.register_forward_hook(
        lambda mod, args, out: seen.append(
            [v.requires_grad for v in out.values()]))
    before = {n: p.clone() for n, p in
              trainer.img_enc.backbone.named_parameters()}
    proj = trainer.img_enc.emb_cnn_code.weight.clone()
    trainer.train_step(batch, keep)
    assert seen == [[False, False, False]]
    assert not torch.equal(trainer.img_enc.emb_cnn_code.weight, proj)
    _backbone_untouched(trainer, before)


def _marks(loss):
    """The identity marks of ``device_timed`` in ``loss``'s graph."""
    seen, todo, found = set(), [loss.grad_fn], 0
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        found += type(fn).__name__.startswith("_OnGrad")
        todo.extend(f for f, _ in fn.next_functions)
    return found


def test_encoder_spans_recorded_under_a_profiler(pair):
    from torch.profiler import ProfilerActivity, profile

    trainer, _, batch, z, eps = pair
    profiling.restart()
    before = len(profiling.recorded()["spans"])
    _, g_total, _ = trainer.losses(batch, z, eps)
    assert _marks(g_total) == 0
    assert len(profiling.recorded()["spans"]) == before
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.restart()
        _, g_total, _ = trainer.losses(batch, z, eps)
        assert _marks(g_total) == 2
        torch.autograd.grad(g_total, list(trainer.g_parameters().values()),
                            allow_unused=True)
        spans = profiling.recorded()["spans"]
    assert [(s["name"], s["steps"], s["device_ms"]) for s in spans] == [
        ("damsm.img_enc", 1, None), ("damsm.img_enc.grad", 1, None)]
    fwd, back = spans
    assert fwd["start_ns"] <= fwd["end_ns"] <= back["start_ns"] \
        <= back["end_ns"]
