"""Stage C: sampling (``GanState``, ``sample``) and the adversarial train
step (``GanTrainer``). Port of ``objgan_tpu/train/gan.py``.

The train step keeps the JAX package's Jacobi order: every gradient comes
from the same iterate. The D terms see the fakes detached; the G terms run
through the live discriminators, but only the G parameters are
differentiated. So two ``torch.autograd.grad`` calls, ``d_total`` with
respect to the patch-D and object-D parameters and ``g_total`` with respect
to the G parameters, give exactly the gradients of JAX's one fused
stop-gradient step. Then Adam (b1 0.5, b2 0.999, eps 1e-8; one optimiser
for G, one per ``DNet``, one for ``ObjectDNet``) updates every network, and
the EMA copy of G moves with decay 0.999.

The DAMSM text and image encoders and the label table are frozen: the
encoders run without dropout and without parameter gradients (the image
encoder still passes the gradient on to the fake images, as the lineage's
frozen encoder does; the JAX package's inception backbone stops it);
``init_state`` takes pretrained encoder weights. Under data parallelism
each rank runs the step on its rows of the global batch, and the losses
are its shares of the global batch's (``parallel/sharding.py``): the
mismatched captions roll the global batch, the object terms divide by its
valid objects, and the DAMSM term scores the gathered global batch; the
EMA moves identically on every rank. With ``GAN.REMAT: stages`` every D
and image-encoder forward runs under ``torch.utils.checkpoint``, as do G's
attention stages. ``state_dict`` covers every network, the EMA generator,
the label table, every optimiser and the step (``train/common.py``). The
image encoder's forward and its gradient's way back are the spans
``damsm.img_enc`` and ``damsm.img_enc.grad`` (``utils/profiling.py``).
"""

from __future__ import annotations

import types
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from objgan_tpu_torch.core.config import Config, validate_config
from objgan_tpu_torch.core.layers import init_weights
from objgan_tpu_torch.data.wire import from_wire
from objgan_tpu_torch.losses.damsm_loss import damsm_loss
from objgan_tpu_torch.losses.gan_loss import (discriminator_loss,
                                              generator_adv_loss,
                                              object_d_loss, object_g_loss,
                                              roll_sent)
from objgan_tpu_torch.models.damsm import (build_image_encoder,
                                           build_text_encoder)
from objgan_tpu_torch.models.discriminator import (ObjectDNet,
                                                   build_discriminators)
from objgan_tpu_torch.models.generator import GNet, kl_loss
from objgan_tpu_torch.ops import rasterize
from objgan_tpu_torch.parallel.sharding import global_batch, local_rows
from objgan_tpu_torch.train.common import Trainer, adam
from objgan_tpu_torch.utils import profiling


def _default_label_table(cfg: Config,
                         generator: torch.Generator) -> torch.Tensor:
    """Frozen label-embedding table: the GloVe class-name table for the 81
    COCO classes (random crc32-seeded vectors per word without a GloVe
    file), a random N(0, 0.02^2) table for any other class count."""
    if cfg.OBJ.NUM_CLASSES == 81:
        from objgan_tpu_torch.data.glove import (coco_label_table,
                                                 resolve_glove_path)

        return torch.from_numpy(coco_label_table(
            cfg.OBJ.LABEL_DIM,
            glove_path=resolve_glove_path(cfg, cfg.OBJ.LABEL_DIM)))
    return torch.randn(cfg.OBJ.NUM_CLASSES, cfg.OBJ.LABEL_DIM,
                       generator=generator) * 0.02


class GanState(nn.Module):
    """What Stage-C sampling reads: the EMA generator ``g_net``, the DAMSM
    ``text_enc`` and this stage's own ``label_table`` buffer."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.g_net = GNet(cfg)
        self.text_enc = build_text_encoder(cfg)
        self.register_buffer("label_table", torch.zeros(
            cfg.OBJ.NUM_CLASSES, cfg.OBJ.LABEL_DIM))


def sample(state, batch: Dict[str, torch.Tensor], z: torch.Tensor,
           ca_eps: torch.Tensor) -> Dict[str, object]:
    """Text + layout -> image pyramid. ``state`` has ``g_net``, ``text_enc``
    and ``label_table``; ``batch`` holds captions (B, T), cap_lens (B,),
    labels (B, O), boxes (B, O, 4), shapes (B, O, S, S) and obj_valid
    (B, O); z (B, Z) and ca_eps (B, CONDITION_DIM) are the noise."""
    captions = batch["captions"]
    t = captions.shape[1]
    words, sent = state.text_enc(captions, batch["cap_lens"])
    word_mask = (torch.arange(t, device=captions.device)[None]
                 >= batch["cap_lens"][:, None])
    labels_emb = state.label_table[batch["labels"].long()]
    return state.g_net(z, sent, words, word_mask, labels_emb, batch["boxes"],
                       batch["shapes"], batch["obj_valid"], ca_eps)


def train_noise(cfg: Config, batch: int, generator: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """The train step's noise: z (B, Z_DIM) and the CA-net ca_eps
    (B, CONDITION_DIM), standard normal fp32. Under data parallelism each
    is drawn for the global batch and ``batch`` is this rank's rows of it
    (``parallel.sharding.local_rows``)."""
    rows = global_batch(batch)
    return {
        "z": local_rows(torch.randn(rows, cfg.GAN.Z_DIM, generator=generator,
                                    device=device)),
        "ca_eps": local_rows(torch.randn(rows, cfg.GAN.CONDITION_DIM,
                                         generator=generator, device=device)),
    }


class GanTrainer(Trainer):
    """Every Stage-C network, the optimisers and the EMA generator.

    ``init_state(generator)`` draws fresh weights (call it on the CPU, then
    move the trainer to its device: a seed gives the same weights on every
    device); ``core.bridge.load_jax_state`` loads a JAX state instead.
    ``train_step(batch, z, ca_eps)`` takes one step and returns its metrics
    as 0-d tensors under the JAX package's names; ``multi_train_step(
    batches, (z, ca_eps))`` takes K on stacked inputs
    (``train/common.py::MultiStep``)."""

    EMA_DECAY = 0.999

    def __init__(self, cfg: Config):
        super().__init__()
        validate_config(cfg)
        self.cfg = cfg
        d_dt = (torch.bfloat16 if (cfg.GAN.D_DTYPE == "compute"
                                   and cfg.DTYPE == "bfloat16")
                else torch.float32)
        self.g_net = GNet(cfg)
        self.ema_g = GNet(cfg)
        self.d_nets = nn.ModuleList(build_discriminators(cfg, d_dt))
        self.obj_d = ObjectDNet(cfg, d_dt)
        self.text_enc = build_text_encoder(cfg)
        self.img_enc = build_image_encoder(cfg)
        self.register_buffer("label_table", torch.zeros(
            cfg.OBJ.NUM_CLASSES, cfg.OBJ.LABEL_DIM))
        for frozen in (self.ema_g, self.text_enc, self.img_enc):
            frozen.requires_grad_(False)
        self.reset_optimizers()

    # -- state --------------------------------------------------------------

    def init_state(self, generator: torch.Generator,
                   text_enc: Optional[Dict[str, torch.Tensor]] = None,
                   img_enc: Optional[Dict[str, torch.Tensor]] = None
                   ) -> "GanTrainer":
        """Fresh weights from ``generator``, fresh optimiser state, the EMA
        copy equal to G. ``text_enc`` / ``img_enc``: pretrained encoder
        state dicts (DAMSM pretraining's) that replace the drawn encoders;
        every other network is drawn as without them."""
        for net in (self.text_enc, self.img_enc, self.g_net, self.d_nets,
                    self.obj_d):
            init_weights(net, generator)
        with torch.no_grad():
            self.label_table.copy_(_default_label_table(self.cfg, generator))
        for net, state in ((self.text_enc, text_enc), (self.img_enc,
                                                        img_enc)):
            if state is not None:
                net.load_state_dict(state)
        self.sync_ema()
        self.reset_optimizers()
        return self

    def sync_ema(self) -> None:
        with torch.no_grad():
            for e, p in zip(self.ema_g.parameters(), self.g_net.parameters()):
                e.copy_(p)

    def reset_optimizers(self) -> None:
        """Fresh Adam state for G, each DNet and the object D; step 0."""
        lr_d = self.cfg.TRAIN.DISCRIMINATOR_LR
        self.g_opt = adam(self.g_net.parameters(),
                          self.cfg.TRAIN.GENERATOR_LR)
        self.d_opts = [adam(d.parameters(), lr_d) for d in self.d_nets]
        self.objd_opt = adam(self.obj_d.parameters(), lr_d)
        self.step = 0

    def optimizers(self):
        return [self.g_opt, *self.d_opts, self.objd_opt]

    def _named(self, prefixes) -> Dict[str, nn.Parameter]:
        return {n: p for n, p in self.named_parameters()
                if n.startswith(prefixes)}

    def d_parameters(self) -> Dict[str, nn.Parameter]:
        """Every patch-D and object-D parameter, by name."""
        return self._named(("d_nets.", "obj_d."))

    def g_parameters(self) -> Dict[str, nn.Parameter]:
        return self._named(("g_net.",))

    # -- the step -----------------------------------------------------------

    def _ck(self, fn, *args):
        if self.cfg.GAN.REMAT == "stages" and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def layouts(self, batch: Dict) -> Dict[int, torch.Tensor]:
        """Per-scale layout occupancy canvases (B, s, s, 1): rasterised at
        the finest scale, then average-pooled down the pyramid."""
        sizes = self.cfg.branch_sizes
        top = sizes[-1]
        maps = rasterize.paste_masks(batch["shapes"], batch["boxes"], top, top)
        out = {top: rasterize.layout_map(maps, batch["obj_valid"])}
        for size in reversed(sizes[:-1]):
            prev = out[size * 2]
            f = prev.shape[1] // size
            out[size] = F.avg_pool2d(prev.permute(0, 3, 1, 2), f).permute(
                0, 2, 3, 1)
        return out

    def losses(self, batch: Dict, z: torch.Tensor, ca_eps: torch.Tensor):
        """(d_total, g_total, metrics) of one step; z (B, Z_DIM) and ca_eps
        (B, CONDITION_DIM) are the noise."""
        cfg = self.cfg
        batch = from_wire(cfg, batch)
        caps, lens = batch["captions"], batch["cap_lens"]
        boxes, valid, labels = (batch["boxes"], batch["obj_valid"],
                                batch["labels"])
        t = caps.shape[1]
        with torch.no_grad():
            words, sent = self.text_enc(caps, lens)
            labels_emb = self.label_table[labels.long()]
            layouts = self.layouts(batch)
        word_mask = torch.arange(t, device=caps.device)[None] >= lens[:, None]
        g_out = self.g_net(z, sent, words, word_mask, labels_emb, boxes,
                           batch["shapes"], valid, ca_eps)
        fakes = g_out["images"]
        metrics: Dict[str, torch.Tensor] = {}

        # D terms: the fakes are constants
        d_total = torch.zeros((), device=caps.device)
        wrong_sent = roll_sent(sent)
        for i, dnet in enumerate(self.d_nets):
            lay = layouts[cfg.branch_sizes[i]]

            def real_pair(real, lay, sent, wrong_sent, dnet=dnet):
                # one real trunk shared by the matched and mismatched pairs
                trunk = dnet.trunk(real, lay)
                return dnet.heads(trunk, sent), dnet.heads(trunk, wrong_sent)

            out_real, out_wrong = self._ck(real_pair, batch["images"][i], lay,
                                           sent, wrong_sent)
            out_fake = self._ck(dnet, fakes[i].detach(), sent, lay)
            d_i, aux = discriminator_loss(out_real, out_fake, out_wrong)
            d_total = d_total + d_i
            metrics[f"d_loss{i}"] = d_i
            metrics.update({f"{k}{i}": v for k, v in aux.items()})
        objd_real = self._ck(self.obj_d, batch["images"][-1], boxes,
                             labels_emb)
        objd_fake = self._ck(self.obj_d, fakes[-1].detach(), boxes,
                             labels_emb)
        objd_l, objd_aux = object_d_loss(objd_real, objd_fake, labels, valid)
        d_total = d_total + objd_l
        metrics.update(objd_aux)

        # G terms: only the G parameters are differentiated (grads)
        g_total = torch.zeros((), device=caps.device)
        for i, dnet in enumerate(self.d_nets):
            out_fake_g = self._ck(dnet, fakes[i], sent,
                                  layouts[cfg.branch_sizes[i]])
            g_adv = generator_adv_loss(out_fake_g)
            g_total = g_total + g_adv
            metrics[f"g_adv{i}"] = g_adv
        objd_fake_g = self._ck(self.obj_d, fakes[-1], boxes, labels_emb)
        g_obj = object_g_loss(objd_fake_g, labels, valid)
        g_total = g_total + g_obj
        metrics["g_obj"] = g_obj

        # DAMSM on the finest fake, through the frozen image encoder; its
        # forward and its gradient's way back to the fake are device spans
        regions, global_f = profiling.device_timed(
            "damsm.img_enc", lambda x: self._ck(self.img_enc, x), fakes[-1])
        sm = cfg.TRAIN.SMOOTH
        matching, _ = damsm_loss(regions, global_f, words, sent, lens,
                                 batch["class_ids"], sm)
        damsm = sm.LAMBDA * matching
        kl = kl_loss(g_out["mu"], g_out["logvar"])
        g_total = g_total + damsm + kl
        metrics.update(g_loss=g_total, d_loss=d_total, damsm=damsm, kl=kl)
        return d_total, g_total, metrics

    def grads(self, batch: Dict, z: torch.Tensor, ca_eps: torch.Tensor):
        """Every trained parameter's gradient at the current iterate, by
        parameter name, and the step's metrics (detached)."""
        d_total, g_total, metrics = self.losses(batch, z, ca_eps)
        return self.grads_of([(d_total, self.d_parameters()),
                              (g_total, self.g_parameters())], metrics)

    @torch.no_grad()
    def apply_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """One Adam step of every optimiser on ``grads``, then the EMA."""
        super().apply_grads(grads)
        ema = list(self.ema_g.parameters())
        torch._foreach_mul_(ema, self.EMA_DECAY)
        torch._foreach_add_(ema, list(self.g_net.parameters()),
                            alpha=1.0 - self.EMA_DECAY)

    def train_step(self, batch: Dict, z: torch.Tensor,
                   ca_eps: torch.Tensor) -> Dict[str, torch.Tensor]:
        grads, metrics = self.grads(batch, z, ca_eps)
        self.apply_grads(grads)
        return metrics

    def step_noise(self, batch: Dict, generator: torch.Generator):
        """(z, ca_eps) of ``train_noise``."""
        noise = train_noise(self.cfg, batch["captions"].shape[0], generator,
                            generator.device)
        return noise["z"], noise["ca_eps"]

    @torch.no_grad()
    def sample(self, batch: Dict, z: torch.Tensor, ca_eps: torch.Tensor,
               use_ema: bool = True) -> Dict[str, object]:
        """Text + layout -> image pyramid with the EMA generator, or with
        the raw (last-step) one when not ``use_ema``."""
        view = types.SimpleNamespace(
            g_net=self.ema_g if use_ema else self.g_net,
            text_enc=self.text_enc, label_table=self.label_table)
        return sample(view, from_wire(self.cfg, batch), z, ca_eps)
