"""DAMSM image-text matching losses (``words_loss``, ``sent_loss``). Port of
``objgan_tpu/losses/damsm_loss.py``.

One batched fp32 computation with validity masks:

* word level: every (caption i, image j) pair gets a gamma2-weighted
  log-sum-exp over the cosine similarities of caption i's valid words to
  their attention-weighted region contexts in image j; the (B, B) match
  matrix feeds a symmetric cross-entropy against the diagonal. The JAX
  package vmaps over captions; here the B*B pairs are one batch.
* sentence level: cosine similarity of sentence and global image
  embeddings, the same symmetric cross-entropy.

Pairs whose class ids collide are excluded as negatives, except the
diagonal.

``words_loss`` and ``sent_loss`` score the batch they are given.
``damsm_loss``, the training loss of DAMSM pretraining and of the Stage-C
generator, scores the global batch under data parallelism: it gathers
every rank's features, lengths and class ids with
``parallel.sharding.all_gather_with_grad``, so each rank computes the
global loss and the gradient reaches every rank's features
(``parallel/sharding.py`` states the convention).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from objgan_tpu_torch.ops.attention import damsm_attention
from objgan_tpu_torch.parallel.sharding import all_gather_with_grad

_NEG_INF = -1e9


def _safe_norm(x: torch.Tensor, dim: int = -1,
               keepdim: bool = False) -> torch.Tensor:
    """sqrt(max(sum x^2, 1e-12)): a finite gradient at x == 0."""
    return torch.sqrt(torch.clamp((x * x).sum(dim=dim, keepdim=keepdim),
                                  min=1e-12))


def _cosine(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    a, b = a.float(), b.float()
    return (a * b).sum(dim=dim) / (_safe_norm(a, dim) * _safe_norm(b, dim))


def _class_mask(class_ids: Optional[torch.Tensor], batch: int,
                device=None) -> torch.Tensor:
    """(B, B) True where the pair must be excluded as a negative."""
    if class_ids is None:
        return torch.zeros((batch, batch), dtype=torch.bool, device=device)
    same = class_ids[:, None] == class_ids[None, :]
    return same & ~torch.eye(batch, dtype=torch.bool, device=same.device)


def _symmetric_ce(scores: torch.Tensor, mask: torch.Tensor):
    """Cross-entropy of the (B_text, B_img) scores against the diagonal, in
    both directions."""
    scores = scores.masked_fill(mask, _NEG_INF)
    loss0 = -torch.diagonal(torch.log_softmax(scores, dim=1)).mean()
    loss1 = -torch.diagonal(torch.log_softmax(scores, dim=0)).mean()
    return loss0, loss1


def words_loss(region_feats: torch.Tensor, words_embs: torch.Tensor,
               cap_lens: torch.Tensor, class_ids: Optional[torch.Tensor],
               gamma1: float, gamma2: float, gamma3: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """region_feats (B, L, D), words_embs (B, T, D), cap_lens (B,) ->
    (w_loss0, w_loss1, attn (B_text, B_img, T, L) fp32)."""
    b, t, d = words_embs.shape
    word_valid = (torch.arange(t, device=cap_lens.device)[None, :]
                  < cap_lens[:, None])  # (B, T)
    # pair (i, j) = caption i against image j, flattened to i * B + j
    w = words_embs[:, None].expand(b, b, t, d).reshape(b * b, t, d)
    v = word_valid[:, None].expand(b, b, t).reshape(b * b, t)
    reg = region_feats[None].expand(b, *region_feats.shape).reshape(
        b * b, *region_feats.shape[1:])
    ctx, attn = damsm_attention(w, reg, gamma1, v)  # (B*B, T, D)
    cos = _cosine(w, ctx)  # (B*B, T)
    cos = torch.where(v, gamma2 * cos, torch.full_like(cos, _NEG_INF))
    sims = (torch.logsumexp(cos, dim=-1) / gamma2).reshape(b, b)
    scores = gamma3 * gamma2 * sims
    mask = _class_mask(class_ids, b, scores.device)
    loss0, loss1 = _symmetric_ce(scores, mask)
    return loss0, loss1, attn.reshape(b, b, t, -1)


def sent_loss(global_feats: torch.Tensor, sent_embs: torch.Tensor,
              class_ids: Optional[torch.Tensor], gamma3: float):
    g = global_feats.float()
    s = sent_embs.float()
    g = g / _safe_norm(g, -1, keepdim=True)
    s = s / _safe_norm(s, -1, keepdim=True)
    scores = gamma3 * (s @ g.t())
    mask = _class_mask(class_ids, scores.shape[0], scores.device)
    return _symmetric_ce(scores, mask)


def damsm_loss(region_feats, global_feats, words_embs, sent_embs, cap_lens,
               class_ids, smooth):
    """Total DAMSM loss of the global batch and its four terms; ``smooth``
    is ``cfg.TRAIN.SMOOTH``."""
    region_feats, global_feats, words_embs, sent_embs, cap_lens = (
        all_gather_with_grad(x) for x in (region_feats, global_feats,
                                          words_embs, sent_embs, cap_lens))
    if class_ids is not None:
        class_ids = all_gather_with_grad(class_ids)
    w0, w1, _ = words_loss(region_feats, words_embs, cap_lens, class_ids,
                           smooth.GAMMA1, smooth.GAMMA2, smooth.GAMMA3)
    s0, s1 = sent_loss(global_feats, sent_embs, class_ids, smooth.GAMMA3)
    total = w0 + w1 + s0 + s1
    return total, {"w_loss0": w0, "w_loss1": w1, "s_loss0": s0,
                   "s_loss1": s1}
