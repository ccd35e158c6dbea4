"""Fresh weights for a reference model, drawn on the card from the seed.

One generator on the device, seeded from ``--seed``, draws every random
leaf in one call; each leaf takes its slice, scaled as the port's own
initialisers scale it: lecun-normal kernels (std 1/sqrt(fan in)), an
orthogonal recurrent kernel's element scale (1/sqrt(4 H)), Linen's
embedding init (std 1/sqrt(features)), unit GroupNorm scales, zero biases,
and a label table of N(0, 0.3^2) rows with the padding row zero (the
port's random GloVe fallback). The same dict loads into the program and
into the reference.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn as nn

from h100bench.reference import stagec as ref

# (name, shape, kind, value): a "normal" leaf's std, a "const" leaf's
# value, or the label "table"'s std
_Leaf = Tuple[str, Tuple[int, ...], str, float]


def _leaves(model: nn.Module) -> List[_Leaf]:
    out: List[_Leaf] = []
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        for pname, p in mod.named_parameters(recurse=False):
            name, shape = pre + pname, tuple(p.shape)
            if isinstance(mod, (ref.GroupNorm, ref.FlatGroupNorm)):
                out.append((name, shape, "const",
                            1.0 if pname == "weight" else 0.0))
            elif pname == "bias" or pname.endswith("_b"):
                out.append((name, shape, "const", 0.0))
            elif isinstance(mod, ref.Embed):
                out.append((name, shape, "normal", 1 / math.sqrt(shape[1])))
            elif pname.endswith("_w_hh"):
                out.append((name, shape, "normal", 1 / math.sqrt(shape[1])))
            elif pname.endswith("_w_ih"):
                out.append((name, shape, "normal", 1 / math.sqrt(shape[0])))
            elif isinstance(mod, (ref.Conv, ref.Dense)):
                fan_in = math.prod(shape[1:])
                out.append((name, shape, "normal", 1 / math.sqrt(fan_in)))
            else:
                raise ValueError(f"no initialiser for {name}")
    for bname, b in model.named_buffers():
        if bname.endswith("label_table"):
            out.append((bname, tuple(b.shape), "table", 0.3))
    return out


def draw(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on ``device``} for every parameter of ``model``
    and its label table, from ``seed``."""
    leaves = _leaves(model)
    total = sum(math.prod(s) for _, s, kind, _ in leaves if kind != "const")
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind, val in leaves:
        if kind == "const":
            out[name] = torch.full(shape, val, device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape) * val
        at += n
        if kind == "table":
            out[name][0] = 0.0
    return out


def load_into(module: nn.Module, weights: Dict[str, torch.Tensor],
              rename: Callable[[str], str] = lambda n: n) -> None:
    """Copy ``weights`` into every parameter and buffer of ``module`` that
    ``rename`` maps to one of them; every weight must find its tensor."""
    own = dict(module.named_parameters())
    own.update(module.named_buffers())
    used = set()
    with torch.no_grad():
        for name, t in own.items():
            src = rename(name)
            if src in weights:
                t.copy_(weights[src])
                used.add(src)
    missing = sorted(set(weights) - used)
    if missing:
        raise KeyError(f"weights the model has no place for: {missing[:5]}")
