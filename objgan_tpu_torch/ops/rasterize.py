"""Layout rasterization on the device: boxes -> interior maps, object masks
-> canvas pastes. Port of ``objgan_tpu/ops/rasterize.py``.

Boxes are ``(x0, y0, w, h)`` normalised to [0, 1], top-left origin. The mask
paste is separable bilinear resampling: ``R_y @ mask @ R_x^T`` per object.
"""

from __future__ import annotations

import torch


def _pixel_centers(n: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """Normalised pixel-centre coordinates (i + 0.5) / n, shape (n,)."""
    return (torch.arange(n, dtype=dtype, device=device) + 0.5) / n


def box_maps(boxes: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, O, 4) boxes -> hard interior maps (B, O, H, W): a pixel is inside
    iff its centre lies in [x0, x0+w) x [y0, y0+h)."""
    x0, y0, w, h = boxes.unbind(-1)
    ys = _pixel_centers(height, boxes.dtype, boxes.device)
    xs = _pixel_centers(width, boxes.dtype, boxes.device)
    in_y = (ys >= y0[..., None]) & (ys < (y0 + h)[..., None])  # (B, O, H)
    in_x = (xs >= x0[..., None]) & (xs < (x0 + w)[..., None])  # (B, O, W)
    return in_y[..., :, None].to(boxes.dtype) * in_x[..., None, :].to(
        boxes.dtype)


def _interp_matrix(out_n: int, src_n: int, origin: torch.Tensor,
                   extent: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling matrix R (..., out_n, src_n); rows that map outside
    the box are zero."""
    out_c = _pixel_centers(out_n, origin.dtype, origin.device)
    src = (out_c - origin[..., None]) / torch.clamp(extent[..., None],
                                                    min=1e-6)
    src = src * src_n - 0.5
    s_idx = torch.arange(src_n, dtype=origin.dtype, device=origin.device)
    weight = torch.clamp(1.0 - (src[..., None] - s_idx).abs(), min=0.0)
    inside = ((src >= -0.5) & (src <= src_n - 0.5)).to(origin.dtype)
    return weight * inside[..., None]


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, height: int,
                width: int) -> torch.Tensor:
    """Paste each object's (S, S) mask (B, O, S, S) into its box on an
    (H, W) canvas. Returns (B, O, H, W) in the masks dtype."""
    s = masks.shape[-1]
    x0, y0, w, h = boxes.float().unbind(-1)
    r_y = _interp_matrix(height, s, y0, h)  # (B, O, H, S)
    r_x = _interp_matrix(width, s, x0, w)  # (B, O, W, S)
    m = masks.float()
    out = r_y @ m @ r_x.transpose(-1, -2)
    return out.to(masks.dtype)


def layout_map(obj_maps: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Collapse per-object maps (B, O, H, W) to one occupancy canvas
    (B, H, W, 1): the max over valid objects."""
    v = valid.to(obj_maps.dtype)[..., None, None]
    return (obj_maps * v).amax(dim=1)[..., None]
