"""Driver of the paper's Stage C as ``gan_main --wire`` runs it with
``TEXT.CNN_BACKBONE: inception``: G's DAMSM term backpropagated through the
frozen Inception-v3 encoder on the K-step path.

The run is ``train_loop``'s, from a private copy of that module whose
reference is ``reference/inception.py`` (Stage C with AttnGAN's
Inception-v3 ``CNN_ENCODER``) and whose weights are drawn here: every leaf
``weights.py`` knows as it draws it, and the backbone's from the run's
seed on a stream of their own: He-normal conv kernels (std sqrt(2 / fan
in), so that the ReLU stack keeps unit scale), BatchNorm at identity
(scale 1, bias 0, mean 0, variance 1), the classifier, which neither
output reads, lecun-normal with a zero bias.

Beside ``train_loop``'s numbers, two of the encoder on the program's own
step-1 fake image, as the eager set-up produced it (``EncoderTap``):
``img_enc_gap``, the worse relative gap (the norm of the difference over
the reference's norm) of its regions and of its global feature against
the reference encoder on the same image; ``img_enc_grad_gap``, that of the
gradient its backward passed to the image, read at the encoder's float32
input before its rounding to the fake's dtype, against the reference's
vector-Jacobian product for the same cotangents, the step's own DAMSM
cotangents of the program. Where no gradient reached the encoder's
outputs, it reads 1. For the controls (``calibrate.py``) each side reads
its encoder on its own step-1 fake and cotangents (``reference_steps``).

A program whose encoder passes no gradient to its images cannot run this
configuration (G would train without its DAMSM term): the run stops
before anything is built, on a probe of the encoder on the meta device.
The planted fault ``img_enc_grad_cut`` detaches the backbone's features.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import math
import os
import types
from typing import Dict

import torch

from h100bench import weights
from h100bench.reference import inception as ref

HERE = os.path.dirname(os.path.abspath(__file__))
ENCODER_LIMITS = ("img_enc_gap", "img_enc_grad_gap")
BACKBONE_STREAM = 1  # the backbone's draw: ref.step_seed(seed, 0, 1)


def draw_backbone(backbone: torch.nn.Module, seed: int, device,
                  prefix: str = "img_enc.backbone.") -> Dict:
    """{name: fp32 tensor on ``device``} of the backbone's leaves, drawn in
    one call of a generator seeded from (``seed``, 0, ``BACKBONE_STREAM``)
    (module docstring)."""
    leaves = []
    for name, p in backbone.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("conv.weight"):
            leaves.append((name, shape, math.sqrt(2.0 / math.prod(shape[1:])),
                           None))
        elif name == "fc.weight":
            leaves.append((name, shape, 1.0 / math.sqrt(shape[1]), None))
        else:
            leaves.append((name, shape, None, 1.0 if name.endswith(
                ("bn_scale", "bn_var")) else 0.0))
    total = sum(math.prod(s) for _, s, std, _ in leaves if std is not None)
    g = torch.Generator(device=device).manual_seed(
        ref.step_seed(seed, 0, BACKBONE_STREAM))
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, std, const in leaves:
        if std is None:
            out[prefix + name] = torch.full(shape, const, device=device)
            continue
        n = math.prod(shape)
        out[prefix + name] = flat[at:at + n].view(shape) * std
        at += n
    return out


def draw(model: torch.nn.Module, seed: int, device) -> Dict:
    """``weights.draw`` of every leaf of ``model`` but its image encoder's
    backbone, whose leaves ``draw_backbone`` adds."""
    enc = model.img_enc
    backbone = enc.backbone
    enc.backbone = None
    try:
        out = weights.draw(model, seed, device)
    finally:
        enc.backbone = backbone
    out.update(draw_backbone(backbone, seed, device))
    return out


class EncoderTap:
    """Wraps an image encoder (the program's or the reference's) for its
    first call: on the host, the image it took, its regions and global
    feature, the cotangents that reached them, and the gradient that its
    backward passed to its float32 input (``got``)."""

    def __init__(self, enc: torch.nn.Module):
        self.enc, self.got = enc, {}
        self.own = "forward" in vars(enc)
        self.inner = enc.forward
        enc.forward = self

    def __call__(self, images):
        if self.own:
            self.enc.forward = self.inner
        else:
            del self.enc.forward  # the class's own method again
        x = images.float().view_as(images)  # the encoder's branch alone
        if x.requires_grad:
            x.register_hook(functools.partial(self._keep, "grad"))
        regions, global_f = self.inner(x)
        self.got.update(image=host(images), regions=host(regions),
                        global_f=host(global_f))
        for name, t in (("cot_regions", regions), ("cot_global", global_f)):
            if t.requires_grad:
                t.register_hook(functools.partial(self._keep, name))
        return regions, global_f

    def _keep(self, name, grad):
        self.got[name] = host(grad)


def _gap(got, want) -> float:
    return float((got - want).norm() / want.norm())


def encoder_gaps(got: Dict, want: Dict) -> Dict[str, float]:
    """``img_enc_gap`` and ``img_enc_grad_gap`` of tap readings ``got``
    against ``want``; the gradient's gap is 1 where ``got`` has none."""
    out = {"img_enc_gap": max(_gap(got["regions"], want["regions"]),
                              _gap(got["global_f"], want["global_f"]))}
    out["img_enc_grad_gap"] = (_gap(got["grad"], want["grad"])
                               if "grad" in got and "grad" in want else 1.0)
    return out


def encoder_check(flat: Dict, seed: int, got: Dict,
                  device) -> Dict[str, float]:
    """The program's tap readings ``got`` against the reference encoder at
    the weights of ``seed`` on the same image, and, where the program's
    cotangents reached the encoder, its vector-Jacobian product for
    them."""
    model, _, _ = reference_model(flat, seed, device)
    image = got["image"].to(device).requires_grad_()
    regions, global_f = model.img_enc(image)
    want = {"regions": host(regions), "global_f": host(global_f)}
    if "cot_regions" in got and "cot_global" in got:
        (grad,) = torch.autograd.grad(
            (regions, global_f), image,
            (got["cot_regions"].to(device), got["cot_global"].to(device)))
        want["grad"] = host(grad)
    return encoder_gaps(got, want)


def reference_steps(flat: Dict, seed: int, batches, device, control=None,
                    count: bool = False):
    """``train_loop.reference_steps``, with the tap readings of the
    reference's own step-1 encoder call as a fourth reading."""
    _TAPS["reference"].clear()
    readings, extra = _T.reference_steps(flat, seed, batches, device,
                                         control, count)
    return (*readings, _TAPS["reference"][0].got), extra


def compare(prog, refr) -> Dict[str, float]:
    """``train_loop.compare``, and ``encoder_gaps`` where both sides hold
    tap readings."""
    got = _T.compare(prog[:3], refr[:3])
    if len(prog) > 3 and len(refr) > 3:
        got.update(encoder_gaps(prog[3], refr[3]))
    return got


def require_image_gradient(cfg) -> None:
    """Raise where the program's image encoder, built as ``cfg`` builds it
    and frozen as Stage C freezes it (on the meta device), passes no
    gradient to its images."""
    from objgan_tpu_torch.models.damsm import build_image_encoder

    with torch.device("meta"):
        enc = build_image_encoder(cfg).requires_grad_(False)  # as Stage C
        images = torch.zeros(1, 64, 64, 3, requires_grad=True)
        regions, global_f = enc(images)
    if not (regions.requires_grad and global_f.requires_grad):
        raise RuntimeError(
            "the program's inception image encoder passes no gradient to "
            "its images: G would train without its DAMSM term, so this "
            "configuration cannot run")


def cut_image_gradient(backbone: torch.nn.Module) -> None:
    """The planted fault ``img_enc_grad_cut``: the backbone's features
    detached."""
    inner = backbone.forward
    backbone.forward = lambda images: {k: v.detach()
                                       for k, v in inner(images).items()}


def _train_loop():
    """The private copy of ``train_loop``: its reference and weights this
    configuration's, the image encoders of the program's trainer and of
    each reference model tapped (``_TAPS``), and the planted fault
    ``img_enc_grad_cut`` beside its own; with its untapped
    ``reference_model``."""
    spec = importlib.util.spec_from_file_location(
        "h100bench.drivers.train_loop_inception.base",
        os.path.join(HERE, "train_loop.py"))
    base = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(base)
    model_of, planted = base.reference_model, base.apply_faults

    def reference_model(*args, **kwargs):
        model, params, w = model_of(*args, **kwargs)
        _TAPS["reference"].append(EncoderTap(model.img_enc))
        return model, params, w

    class FirstSteps(base.FirstSteps):
        def __init__(self, trainer, n):
            super().__init__(trainer, n)
            _TAPS["program"].append(EncoderTap(trainer.img_enc))

    def apply_faults(faults, trainer):
        if faults.get("img_enc_grad_cut"):
            cut_image_gradient(trainer.img_enc.backbone)
        return planted(faults, trainer)

    base.ref = ref
    base.weights_mod = types.SimpleNamespace(draw=draw,
                                             load_into=weights.load_into)
    base.reference_model, base.FirstSteps, base.apply_faults = (
        reference_model, FirstSteps, apply_faults)
    return base, model_of


_TAPS = {"program": [], "reference": []}
_T, reference_model = _train_loop()
merged = _T.merged
kept_leaves = _T.kept_leaves
leaf_table = _T.leaf_table
reference_replay = _T.reference_replay
compare_replay = _T.compare_replay
host = _T.host


def run(ctx) -> Dict:
    from objgan_tpu_torch.core.config import Config

    require_image_gradient(Config().merged(ctx.config["config"]))
    for taps in _TAPS.values():
        taps.clear()
    limits = ctx.traffic["limits"]
    rest = {k: v for k, v in limits.items() if k not in ENCODER_LIMITS}
    rec = _T.run(dataclasses.replace(
        ctx, traffic=dict(ctx.traffic, limits=rest)))
    device = torch.device("cuda" if ctx.require_cuda else "cpu")
    flat = ref.flat_config(merged(ctx.config["config"],
                                  ctx.traffic["config"]))
    got = encoder_check(flat, ctx.seed, _TAPS["program"][0].got, device)
    rec["readings"].update(got)
    rec["checks"] += [(k, got[k], limits[k]) for k in ENCODER_LIMITS]
    return rec
