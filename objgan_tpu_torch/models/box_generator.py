"""Stage A, box generator: caption -> sequence of (class label, box).

Port of the sampling path of ``objgan_tpu/models/box_generator.py``: a
bi-LSTM caption encoder, a two-layer top-down attention LSTM decoder, a
label head (class 0 = STOP) and a class-conditioned Gaussian-mixture box
head. fp32. The decode is a Python loop of ``BOX.MAX_SEQ_LENGTH`` steps
with STOP masking. Its randomness comes in as tensors (see
``pipeline_e2e.draw_noise``). Beam search and teacher forcing are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core.layers import Dense, Embed
from objgan_tpu_torch.ops import gmm
from objgan_tpu_torch.ops.lstm import BiLSTM, Carry, LSTMCell

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
        """One decode step. Returns (state, label_logits, h_lang)."""
        att_carry, lang_carry = state
        x_att = torch.cat([lang_carry[0], mean_state,
                           self.label_embed(prev_label), prev_box], dim=-1)
        att_carry, h_att = self.att_lstm(att_carry, x_att)
        ctx, _ = self.attention(h_att, enc_states, enc_valid)
        lang_carry, h_lang = self.lang_lstm(lang_carry,
                                            torch.cat([ctx, h_att], dim=-1))
        label_logits = self.label_head(h_lang).float()
        return (att_carry, lang_carry), label_logits, h_lang

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
            state, logits, h_lang = self.decoder.step(
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
