"""Adversarial losses of the Stage-B and Stage-C train steps. Port of
``objgan_tpu/losses/gan_loss.py``.

All are fp32 functions of discriminator outputs, sigmoid cross-entropy on
logits (``F.binary_cross_entropy_with_logits``, the same function as
``optax.sigmoid_binary_cross_entropy``). Per scale the patch D sees (real,
matching caption) -> 1, (fake, matching caption) -> 0 and (real,
mismatched caption) -> 0, plus unconditional real/fake terms, weighted
(real + uncond_real) / 2 + (fake + wrong + uncond_fake) / 3. The object D
adds per-object real/fake and class terms, masked by object validity.
Stage B's shape D scores each object real or fake; its G adds feature
matching on the D's trunk features and the masks' reconstruction BCE.

Under data parallelism each loss is a rank's share of the global batch's
loss (``parallel/sharding.py``): a masked mean divides by the count of the
global batch, the mismatched captions roll the global batch, and the plain
means over a rank's rows are shares as they stand.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from objgan_tpu_torch.parallel import sharding


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean sigmoid cross-entropy against a constant target."""
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target))


def _sigmoid_ce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target), reduction="none")


def _class_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy per object: (B, O, C), (B, O) -> (B, O)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(),
                           reduction="none").reshape(labels.shape)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` where ``mask`` is set, over the global batch (this
    rank's share of it under data parallelism)."""
    mask = mask.to(x.dtype)
    return sharding.masked_mean_share((x * mask).sum(), mask.sum())


def discriminator_loss(out_real: Dict[str, torch.Tensor],
                       out_fake: Dict[str, torch.Tensor],
                       out_wrong: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One patch D's loss from its outputs on (real, fake, wrong caption)."""
    aux = {
        "d_cond_real": _bce(out_real["cond"], 1.0),
        "d_cond_fake": _bce(out_fake["cond"], 0.0),
        "d_cond_wrong": _bce(out_wrong["cond"], 0.0),
        "d_uncond_real": _bce(out_real["uncond"], 1.0),
        "d_uncond_fake": _bce(out_fake["uncond"], 0.0),
    }
    loss = (aux["d_cond_real"] + aux["d_uncond_real"]) / 2.0 + (
        aux["d_cond_fake"] + aux["d_cond_wrong"] + aux["d_uncond_fake"]) / 3.0
    return loss, aux


def generator_adv_loss(out_fake: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The generator's adversarial term for one patch D."""
    return _bce(out_fake["cond"], 1.0) + _bce(out_fake["uncond"], 1.0)


def object_d_loss(out_real: Dict[str, torch.Tensor],
                  out_fake: Dict[str, torch.Tensor], labels: torch.Tensor,
                  obj_valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Object D: real/fake on valid objects plus the class cross-entropy on
    the valid REAL objects."""
    aux = {
        "objd_real": _masked_mean(_sigmoid_ce(out_real["obj"], 1.0),
                                  obj_valid),
        "objd_fake": _masked_mean(_sigmoid_ce(out_fake["obj"], 0.0),
                                  obj_valid),
        "objd_cls": _masked_mean(_class_ce(out_real["cls"], labels),
                                 obj_valid),
    }
    return aux["objd_real"] + aux["objd_fake"] + aux["objd_cls"], aux


def object_g_loss(out_fake: Dict[str, torch.Tensor], labels: torch.Tensor,
                  obj_valid: torch.Tensor) -> torch.Tensor:
    """The generator's object terms: fool real/fake, match the class head."""
    return (_masked_mean(_sigmoid_ce(out_fake["obj"], 1.0), obj_valid)
            + _masked_mean(_class_ce(out_fake["cls"], labels), obj_valid))


def roll_sent(sent_emb: torch.Tensor) -> torch.Tensor:
    """Mismatched captions: the global batch rolled by one, this rank's rows
    of it (a rank's first row takes the previous rank's last caption). A
    global batch of 1 would pair each image with its own caption as the
    mismatch, so it raises. ``sent_emb`` is a constant of the step: the
    roll passes no gradient to other ranks."""
    everyone = sharding.all_gather_with_grad(sent_emb)
    if everyone.shape[0] < 2:
        raise ValueError(
            "wrong-pair loss needs batch size >= 2 (a batch of 1 would pair "
            "each image with its own caption as the 'mismatch')")
    return sharding.local_rows(torch.roll(everyone, shifts=1, dims=0))


# -- Stage B (shape GAN) -----------------------------------------------------


def shape_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor,
                 obj_valid: torch.Tensor) -> torch.Tensor:
    """Real objects -> 1, fake -> 0, each averaged over valid objects."""
    return (_masked_mean(_sigmoid_ce(real_logits, 1.0), obj_valid)
            + _masked_mean(_sigmoid_ce(fake_logits, 0.0), obj_valid))


def shape_g_loss(fake_logits: torch.Tensor, real_feats: List[torch.Tensor],
                 fake_feats: List[torch.Tensor], gt_masks: torch.Tensor,
                 mask_logits: torch.Tensor, obj_valid: torch.Tensor,
                 lambda_fm: float, lambda_recon: float = 10.0
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Adversarial + ``lambda_fm`` x feature matching (mean absolute
    difference of each D feature per object) + ``lambda_recon`` x the
    masks' sigmoid BCE (averaged over pixels), each averaged over valid
    objects."""
    adv = _masked_mean(_sigmoid_ce(fake_logits, 1.0), obj_valid)
    fm = torch.zeros((), device=fake_logits.device)
    for rf, ff in zip(real_feats, fake_feats):
        fm = fm + _masked_mean((rf.float() - ff.float()).abs().mean(-1),
                               obj_valid)
    recon = _masked_mean(F.binary_cross_entropy_with_logits(
        mask_logits, gt_masks.float(), reduction="none").mean((-1, -2)),
        obj_valid)
    return adv + lambda_fm * fm + lambda_recon * recon, {
        "shape_adv": adv, "shape_fm": fm, "shape_recon": recon}
