"""Stage A, box generator: caption -> sequence of (class label, box).

Port of ``objgan_tpu/models/box_generator.py``: a bi-LSTM caption
encoder, a two-layer top-down attention LSTM decoder, a label head (class 0
= STOP) and a class-conditioned Gaussian-mixture box head. fp32. Every
decode is a Python loop over the steps:

* ``teacher_forced`` (training): O + 1 steps fed the ground-truth layout
  (BOS = STOP label and zero box), the box parameters conditioned on the
  ground-truth labels; scheduled sampling takes injected per-step flips;
* ``sample``: ``BOX.MAX_SEQ_LENGTH`` steps of temperature sampling with
  STOP masking, its randomness injected as tensors
  (``train/box.py::box_noise``);
* ``beam_sample``: backtracking-free beam search, the histories carried
  with the beams; it draws nothing.

``box_loss`` is the label cross-entropy (with the STOP step) plus the
masked GMM NLL of the ground-truth boxes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core.layers import Dense, Embed
from objgan_tpu_torch.ops import gmm
from objgan_tpu_torch.ops.lstm import BiLSTM, Carry, LSTMCell
from objgan_tpu_torch.parallel.sharding import masked_mean_share

STOP = 0  # class id 0 == STOP / padding


class CaptionEncoder(nn.Module):
    """Token embedding + bi-LSTM; returns (word_states, mean_state, valid)."""

    def __init__(self, vocab_size: int, embed_dim: int, hidden_dim: int):
        super().__init__()
        self.embedding = Embed(vocab_size, embed_dim)
        self.bilstm = BiLSTM(embed_dim, hidden_dim)

    def forward(self, captions: torch.Tensor, cap_lens: torch.Tensor):
        states, _ = self.bilstm(self.embedding(captions), cap_lens)
        t = captions.shape[1]
        valid = (torch.arange(t, device=captions.device)[None]
                 < cap_lens[:, None]).to(states.dtype)
        # padded steps are already zero: the plain sum is the masked sum
        mean_state = states.sum(1) / torch.clamp(
            valid.sum(1, keepdim=True), min=1.0)
        return states, mean_state, valid


class AdditiveAttention(nn.Module):
    """Bahdanau attention over encoder states."""

    def __init__(self, query_dim: int, state_dim: int, att_hid: int):
        super().__init__()
        self.ctx2att = Dense(state_dim, att_hid, bias=False)
        self.h2att = Dense(query_dim, att_hid, bias=False)
        self.alpha_net = Dense(att_hid, 1, bias=False)

    def forward(self, query, states, valid):
        e = self.alpha_net(torch.tanh(self.ctx2att(states)
                                      + self.h2att(query)[:, None, :]))[..., 0]
        e = torch.where(valid > 0, e, torch.full_like(e, -1e9))
        alpha = torch.softmax(e.float(), dim=-1)
        ctx = torch.bmm(alpha.to(states.dtype)[:, None, :], states)[:, 0]
        return ctx, alpha


class BoxDecoder(nn.Module):
    """Two-layer top-down attention decoder with label and GMM box heads."""

    def __init__(self, cfg: Config):
        super().__init__()
        c = cfg
        rnn, ies = c.BOX.RNN_SIZE, c.BOX.INPUT_ENCODING_SIZE
        enc = 2 * (rnn // 2)
        self.rnn_size = rnn
        self.label_embed = Embed(c.OBJ.NUM_CLASSES, ies)
        self.att_lstm = LSTMCell(rnn + enc + ies + 4, rnn)
        self.lang_lstm = LSTMCell(enc + rnn, rnn)
        self.attention = AdditiveAttention(rnn, enc, c.BOX.ATT_HID_SIZE)
        self.label_head = Dense(rnn, c.OBJ.NUM_CLASSES)
        self.box_head = Dense(rnn + ies, gmm.param_size(c.OBJ.GMM_COMPONENTS,
                                                        c.OBJ.GMM_MODE))

    def init_state(self, batch: int,
                   device: torch.device) -> Tuple[Carry, Carry]:
        return (LSTMCell.init_carry(batch, self.rnn_size, device),
                LSTMCell.init_carry(batch, self.rnn_size, device))

    def step(self, state, prev_label, prev_box, enc_states, mean_state,
             enc_valid):
        """One decode step. Returns (state, label_logits, h_lang, the
        attention weights)."""
        att_carry, lang_carry = state
        x_att = torch.cat([lang_carry[0], mean_state,
                           self.label_embed(prev_label), prev_box], dim=-1)
        att_carry, h_att = self.att_lstm(att_carry, x_att)
        ctx, alpha = self.attention(h_att, enc_states, enc_valid)
        lang_carry, h_lang = self.lang_lstm(lang_carry,
                                            torch.cat([ctx, h_att], dim=-1))
        label_logits = self.label_head(h_lang).float()
        return (att_carry, lang_carry), label_logits, h_lang, alpha

    def box_params(self, h_lang: torch.Tensor,
                   label: torch.Tensor) -> torch.Tensor:
        """GMM parameters of the box, conditioned on the step's label."""
        return self.box_head(torch.cat([h_lang, self.label_embed(label)],
                                       dim=-1)).float()


class BoxGenerator(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.encoder = CaptionEncoder(cfg.TEXT.VOCAB_SIZE,
                                      cfg.BOX.INPUT_ENCODING_SIZE,
                                      cfg.BOX.RNN_SIZE // 2)
        self.decoder = BoxDecoder(cfg)

    def teacher_forced(self, captions: torch.Tensor, cap_lens: torch.Tensor,
                       labels: torch.Tensor, boxes: torch.Tensor,
                       flips: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
        """Teacher-forced pass over the ground-truth layout: labels (B, O)
        with 0 padding, boxes (B, O, 4). Returns the label logits
        (B, O + 1, C), the last step predicting STOP after the last object,
        the box parameters (B, O, P) conditioned on the ground-truth labels
        and the attention weights (B, O + 1, T). Padded steps are not
        suppressed here; ``box_loss`` masks them.

        ``flips`` (O + 1, B) bool turns on scheduled sampling: where set,
        step t is fed the decoder's own previous prediction (argmax label,
        mixture-mean box) instead of the ground truth (the JAX package
        draws them as ``bernoulli(SCHEDULED_SAMPLING_PROB)`` per step)."""
        c = self.cfg
        b, o = labels.shape
        labels = labels.long()
        dev = captions.device
        enc_states, mean_state, enc_valid = self.encoder(captions, cap_lens)
        state = self.decoder.init_state(b, dev)
        in_labels = torch.cat([torch.full((b, 1), STOP, dtype=torch.long,
                                          device=dev), labels], dim=1)
        in_boxes = torch.cat([torch.zeros(b, 1, 4, dtype=boxes.dtype,
                                          device=dev), boxes], dim=1)
        pred_lab, pred_box = in_labels[:, 0], in_boxes[:, 0]
        logits_all, h_all, alphas = [], [], []
        for s in range(o + 1):
            lab_in, box_in = in_labels[:, s], in_boxes[:, s]
            if flips is not None:
                flip = flips[s]
                lab_in = torch.where(flip, pred_lab, lab_in)
                box_in = torch.where(flip[:, None], pred_box, box_in)
            state, logits, h_lang, alpha = self.decoder.step(
                state, lab_in, box_in, enc_states, mean_state, enc_valid)
            if flips is not None:
                pred_lab = torch.argmax(logits, dim=-1)
                pred_box = torch.clamp(gmm.mean(
                    self.decoder.box_params(h_lang, pred_lab),
                    c.OBJ.GMM_COMPONENTS, c.OBJ.GMM_MODE), 0.0, 1.0
                ).to(boxes.dtype)
            logits_all.append(logits)
            h_all.append(h_lang)
            alphas.append(alpha)
        h_langs = torch.stack(h_all, dim=1)  # (B, O + 1, H)
        return {
            "label_logits": torch.stack(logits_all, dim=1),
            "box_params": self.decoder.box_params(h_langs[:, :o], labels),
            "alphas": torch.stack(alphas, dim=1),
        }

    def sample(self, captions: torch.Tensor, cap_lens: torch.Tensor,
               label_gumbel: torch.Tensor, comp_gumbel: torch.Tensor,
               box_normal: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Autoregressive decode with STOP masking. Noise per step s:
        label_gumbel[s] (B, NUM_CLASSES), comp_gumbel[s] (B, K),
        box_normal[s] (B, 4). A label is argmax(logits / T + gumbel), i.e.
        ``jax.random.categorical`` given the same Gumbel draw."""
        c = self.cfg
        temp = max(c.BOX.TEMPERATURE, 1e-6)
        b = captions.shape[0]
        dev = captions.device
        enc_states, mean_state, enc_valid = self.encoder(captions, cap_lens)
        state = self.decoder.init_state(b, dev)
        lab = torch.full((b,), STOP, dtype=torch.long, device=dev)
        box = torch.zeros(b, 4, device=dev)
        alive = torch.ones(b, device=dev)
        labels, boxes, valids = [], [], []
        for s in range(c.BOX.MAX_SEQ_LENGTH):
            state, logits, h_lang, _ = self.decoder.step(
                state, lab, box, enc_states, mean_state, enc_valid)
            lab = torch.argmax(label_gumbel[s] + logits / temp, dim=-1)
            params = self.decoder.box_params(h_lang, lab)
            box = gmm.sample(params, comp_gumbel[s], box_normal[s],
                             c.OBJ.GMM_COMPONENTS, c.BOX.GMM_TEMPERATURE,
                             mode=c.OBJ.GMM_MODE)
            box = torch.clamp(box, 0.0, 1.0)
            lab = torch.where(alive > 0, lab, torch.full_like(lab, STOP))
            # the step's validity is the next step's alive mask
            alive = alive * (lab != STOP).float()
            box = box * alive[:, None]
            labels.append(lab)
            boxes.append(box)
            valids.append(alive)
        return {
            "labels": torch.stack(labels, dim=1),  # (B, O)
            "boxes": torch.stack(boxes, dim=1),  # (B, O, 4)
            "obj_valid": torch.stack(valids, dim=1),  # (B, O)
        }

    def beam_sample(self, captions: torch.Tensor, cap_lens: torch.Tensor,
                    beam_size: Optional[int] = None
                    ) -> Dict[str, torch.Tensor]:
        """Beam search over label sequences, ``BOX.MAX_SEQ_LENGTH`` steps;
        deterministic, it draws nothing.

        Beams rank by the GNMT length-normalised label log-probability
        ``score / ((5 + n) / 6) ** BEAM_LENGTH_NORM``, n the emitted tokens
        with STOP; a dead beam may emit only STOP, at zero cost; beams
        1..K-1 start at -1e9, so step 1 fans out from one root. Ties rank
        by the lower candidate index, as ``jax.lax.top_k`` does (a stable
        descending sort). Each kept beam's box is its step's mixture mean.
        The histories ride with the beams. Returns the best beam per
        example, as ``sample`` does, and ``beam_scores`` (B, K), the
        normalised scores of the final beams."""
        c = self.cfg
        k = beam_size or c.BOX.BEAM_SIZE
        alpha = c.BOX.BEAM_LENGTH_NORM
        b, n_cls, t_max = captions.shape[0], c.OBJ.NUM_CLASSES, \
            c.BOX.MAX_SEQ_LENGTH
        dev = captions.device

        def lp(n):  # GNMT length penalty
            return ((5.0 + n) / 6.0) ** alpha

        enc_states, mean_state, enc_valid = (
            x.repeat_interleave(k, dim=0)
            for x in self.encoder(captions, cap_lens))
        state = self.decoder.init_state(b * k, dev)
        scores = torch.full((b, k), -1e9, device=dev)
        scores[:, 0] = 0.0
        prev_lab = torch.full((b * k,), STOP, dtype=torch.long, device=dev)
        prev_box = torch.zeros(b * k, 4, device=dev)
        alive = torch.ones(b * k, device=dev)
        n_tok = torch.zeros(b * k, device=dev)
        hist_lab = torch.zeros(b * k, t_max, dtype=torch.long, device=dev)
        hist_box = torch.zeros(b * k, t_max, 4, device=dev)
        hist_valid = torch.zeros(b * k, t_max, device=dev)
        dead_row = torch.full((n_cls,), -1e9, device=dev)
        dead_row[STOP] = 0.0

        def gather_beams(x, src):  # x (B*K, ...) reordered by src (B, K)
            xs = x.reshape(b, k, *x.shape[1:])
            idx = src.reshape(b, k, *([1] * (x.dim() - 1))).expand_as(xs)
            return xs.gather(1, idx).reshape(x.shape)

        for s in range(t_max):
            state, logits, h_lang, _ = self.decoder.step(
                state, prev_lab, prev_box, enc_states, mean_state, enc_valid)
            logp = torch.log_softmax(logits, dim=-1)  # (B*K, C)
            logp = torch.where(alive[:, None] > 0, logp, dead_row[None])
            cand = scores.reshape(b * k, 1) + logp
            ranked = (cand / lp((n_tok + alive)[:, None])).reshape(
                b, k * n_cls)
            cand = cand.reshape(b, k * n_cls)
            top_idx = torch.sort(ranked, dim=1, descending=True,
                                 stable=True).indices[:, :k]
            scores = cand.gather(1, top_idx)  # raw
            src = torch.div(top_idx, n_cls, rounding_mode="floor")
            new_lab = (top_idx % n_cls).reshape(b * k)
            state = tuple(tuple(gather_beams(x, src) for x in carry)
                          for carry in state)
            alive = gather_beams(alive, src)
            n_tok = gather_beams(n_tok, src) + alive
            h_lang = gather_beams(h_lang, src)
            hist_lab = gather_beams(hist_lab, src)
            hist_box = gather_beams(hist_box, src)
            hist_valid = gather_beams(hist_valid, src)
            box = torch.clamp(gmm.mean(self.decoder.box_params(h_lang,
                                                               new_lab),
                                       c.OBJ.GMM_COMPONENTS,
                                       mode=c.OBJ.GMM_MODE), 0.0, 1.0)
            new_lab = torch.where(alive > 0, new_lab,
                                  torch.full_like(new_lab, STOP))
            # the step's validity is the next step's alive mask
            valid = alive * (new_lab != STOP).float()
            box = box * valid[:, None]
            hist_lab[:, s] = new_lab
            hist_box[:, s] = box
            hist_valid[:, s] = valid
            prev_lab, prev_box, alive = new_lab, box, valid
        final = scores / lp(n_tok.reshape(b, k))
        best = torch.argmax(final, dim=-1)  # the first of equal maxima

        def pick(x):  # (B*K, T, ...) -> (B, T, ...)
            return x.reshape(b, k, *x.shape[1:])[torch.arange(b, device=dev),
                                                  best]

        return {"labels": pick(hist_lab), "boxes": pick(hist_box),
                "obj_valid": pick(hist_valid), "beam_scores": final}


def box_loss(outputs: Dict[str, torch.Tensor], labels: torch.Tensor,
             boxes: torch.Tensor, obj_valid: torch.Tensor,
             num_components: int, gmm_mode: str = "diag"
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Label cross-entropy over the steps up to and with the STOP step,
    plus the GMM NLL of the ground-truth boxes masked by ``obj_valid``;
    both are means over the valid steps of the global batch (a rank's share
    under data parallelism, ``parallel/sharding.py``).

    ``obj_valid`` must be a prefix mask (valid objects first, as the data
    layer orders them): the STOP target sits at step ``sum(obj_valid)``."""
    b, o = labels.shape
    n_obj = obj_valid.sum(1).long()  # (B,)
    tgt = torch.cat([labels.long(), torch.zeros(b, 1, dtype=torch.long,
                                                device=labels.device)], 1)
    steps = torch.arange(o + 1, device=labels.device)[None]
    step_valid = (steps <= n_obj[:, None]).float()  # with the STOP step
    ce = F.cross_entropy(outputs["label_logits"].reshape(b * (o + 1), -1),
                         tgt.reshape(-1), reduction="none").reshape(b, o + 1)
    label_loss = masked_mean_share((ce * step_valid).sum(), step_valid.sum())
    box_nll = gmm.nll(outputs["box_params"], boxes, num_components,
                      obj_valid.float(), mode=gmm_mode)
    return label_loss + box_nll, {"label_loss": label_loss,
                                  "box_nll": box_nll}
