"""Attention primitives: grid (word -> region) attention, object-driven
attention, the object-context paste, and DAMSM's double-softmax attention.

Port of ``objgan_tpu/ops/attention.py`` with the same layouts, mask polarity
(``word_mask`` True = padded, excluded; ``query_valid`` nonzero = valid,
included) and canonical order: inputs upcast
to fp32, masked with -1e9 (not -inf), softmaxed; attention maps are returned
in fp32 from true fp32 matmuls (the entry points turn TF32 off).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG_INF = -1e9  # the lineage's masked_fill_(-inf) without the nan risk


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int) -> torch.Tensor:
    """Softmax with masked entries (mask True) filled with -1e9."""
    scores = scores.float()
    if mask is not None:
        scores = scores.masked_fill(mask, _NEG_INF)
    return torch.softmax(scores, dim=dim)


def grid_attention(
    query: torch.Tensor,  # (B, L, C) spatial features, L = H*W
    source: torch.Tensor,  # (B, T, C) projected word features
    word_mask: Optional[torch.Tensor] = None,  # (B, T) True where PADDED
    context_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each location attends over words. Returns (context (B, L, C) in the
    query dtype, attn (B, L, T) fp32). ``context_dtype`` moves only the
    map -> context matmul; None keeps it fp32."""
    q = query.float()
    s = source.float()
    scores = torch.bmm(q, s.transpose(1, 2))  # (B, L, T)
    m = word_mask[:, None, :] if word_mask is not None else None
    attn = masked_softmax(scores, m, dim=-1)
    if context_dtype is not None:
        context = torch.bmm(attn.to(context_dtype), source.to(context_dtype))
    else:
        context = torch.bmm(attn, s)
    return context.to(query.dtype), attn


def damsm_attention(
    query: torch.Tensor,  # (B, T, C) word features
    context: torch.Tensor,  # (B, L, C) region features
    gamma1: float,
    query_valid: Optional[torch.Tensor] = None,  # (B, T) nonzero = real word
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DAMSM ``func_attention``: softmax over words (padded words filled
    with -1e9), then a gamma1-scaled softmax over regions. Returns (the
    weighted region context (B, T, C) fp32, attn (B, T, L) fp32)."""
    q = query.float()
    c = context.float()
    scores = torch.bmm(c, q.transpose(1, 2))  # (B, L, T)
    if query_valid is not None:
        scores = scores.masked_fill(~(query_valid[:, None, :] > 0), _NEG_INF)
    attn = torch.softmax(scores, dim=-1)
    attn = torch.softmax(gamma1 * attn.transpose(1, 2), dim=-1)
    return torch.bmm(attn, c), attn


def object_attention(
    obj_query: torch.Tensor,  # (B, O, C)
    words: torch.Tensor,  # (B, T, C)
    word_mask: Optional[torch.Tensor],  # (B, T) True where padded
    obj_valid: torch.Tensor,  # (B, O) 1.0 for real objects
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-object queries attend over words; padded objects get zero
    context. Returns (context (B, O, C) in the words dtype, attn (B, O, T)
    fp32)."""
    q = obj_query.float()
    w = words.float()
    scores = torch.bmm(q, w.transpose(1, 2))
    m = word_mask[:, None, :] if word_mask is not None else None
    attn = masked_softmax(scores, m, dim=-1)
    attn = attn * obj_valid.float()[..., None]
    context = torch.bmm(attn, w)
    return context.to(words.dtype), attn


def paste_object_context(
    obj_context: torch.Tensor,  # (B, O, C)
    obj_maps: torch.Tensor,  # (B, O, L) spatial weights
    obj_valid: torch.Tensor,  # (B, O)
    normalize: bool = True,
    context_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """out[l] = sum_o m_o[l] c_o / max(sum_o m_o[l], 1); returns (B, L, C)
    in the obj_context dtype. The denominator always accumulates in fp32."""
    maps = obj_maps.float() * obj_valid.float()[..., None]
    if context_dtype is not None:
        ctx = torch.bmm(maps.transpose(1, 2).to(context_dtype),
                        obj_context.to(context_dtype))
    else:
        ctx = torch.bmm(maps.transpose(1, 2), obj_context.float())
    if normalize:
        denom = torch.clamp(maps.sum(dim=1), min=1.0)  # (B, L)
        ctx = ctx / denom[..., None].to(ctx.dtype)
    return ctx.to(obj_context.dtype)
