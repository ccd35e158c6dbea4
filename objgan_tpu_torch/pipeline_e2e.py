"""End-to-end composed inference: caption -> layout -> shapes -> image.

Port of ``objgan_tpu/pipeline_e2e.py``. Stage A (boxes), Stage B (masks) and
Stage C (the image pyramid) run back to back on one device with no host
round trip. All randomness of a batch is drawn up front by ``draw_noise``,
on the device, from an explicit ``torch.Generator``; a test hands
``generate`` the draws that JAX's key chain made instead.

``ObjGanPipeline.load_states`` restores each stage from its trainer's newest
checkpoint (``OUTPUT_DIR/<CONFIG_NAME>_{box,shape,gan}/ckpt``), the port's
or the JAX package's (Orbax), so training stays per stage while inference
is composed.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.core.checkpoint import OrbaxNode, load_latest, mismatch
from objgan_tpu_torch.core.layers import init_weights
from objgan_tpu_torch.models.box_generator import BoxGenerator
from objgan_tpu_torch.train import box as box_train
from objgan_tpu_torch.train import gan as gan_train
from objgan_tpu_torch.train import shape as shape_train


def draw_noise(cfg: Config, batch: int, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """Every random draw of one ``generate`` call:

    * Stage A, per decode step s: ``label_gumbel[s]`` (B, NUM_CLASSES),
      ``comp_gumbel[s]`` (B, GMM_COMPONENTS), ``box_normal[s]`` (B, 4);
    * Stage B: ``shape_z`` (B, O, 1, 1, SHAPE.GF_DIM), fp32 (the stage's
      dtype);
    * Stage C: ``z`` (B, Z_DIM) and the CA-net ``ca_eps``
      (B, CONDITION_DIM), fp32.
    """
    return {
        **box_train.box_noise(cfg, batch, generator, device),
        "shape_z": shape_train.shape_noise(cfg, batch, generator, device),
        **gan_train.train_noise(cfg, batch, generator, device),
    }


class ObjGanPipeline(nn.Module):
    """Composed three-stage sampler: ``box`` (Stage A), ``shape`` (Stage B)
    and ``gan`` (Stage C), each with its own weights."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.box = BoxGenerator(cfg)
        self.shape = shape_train.ShapeState(cfg)
        self.gan = gan_train.GanState(cfg)

    @classmethod
    def _drawn(cls, cfg: Config, seed: int) -> "ObjGanPipeline":
        """Fresh weights drawn from ``seed`` on the CPU (a seed gives the
        same weights on every device)."""
        pipe = cls(cfg)
        g = torch.Generator().manual_seed(seed)
        init_weights(pipe, g)
        with torch.no_grad():
            pipe.shape.label_table.copy_(
                gan_train._default_label_table(cfg, g))
            pipe.gan.label_table.copy_(gan_train._default_label_table(cfg, g))
        return pipe

    @classmethod
    def fresh(cls, cfg: Config, seed: int, device) -> "ObjGanPipeline":
        """Freshly initialised weights drawn from ``seed``, moved to
        ``device``, with a warning that every stage is untrained
        (``load_states`` restores trained checkpoints)."""
        print("WARNING: ObjGanPipeline.fresh — the composed pipeline runs "
              "every stage with UNTRAINED random weights (load_states "
              "restores the stages' checkpoints)", file=sys.stderr)
        return cls._drawn(cfg, seed).to(device).eval()

    @classmethod
    def load_states(cls, cfg: Config, output_dir: Optional[str] = None,
                    device="cuda") -> "ObjGanPipeline":
        """Each stage from its trainer's newest checkpoint under
        ``<output_dir or OUTPUT_DIR>/<CONFIG_NAME>_{box,shape,gan}/ckpt``
        (the gan stage from ``TRAIN.NET_G`` when set): ``BoxTrainer``'s
        ``model`` -> ``box``; ``ShapeTrainer``'s ``g`` and ``label_table``
        -> ``shape``; ``GanTrainer``'s EMA generator ``ema_g`` ->
        ``gan.g_net``, with its ``text_enc`` and ``label_table``. From a
        JAX (Orbax) step, as the JAX package's ``load_states``:
        ``BoxTrainState.params`` -> ``box``; ``ShapeTrainState.g_params``
        and ``label_table`` -> ``shape``; ``GanTrainState.ema_g_params``,
        ``text_params`` and ``label_table`` -> ``gan`` (the layouts of
        ``core/bridge.py``). A stage without a checkpoint, or with one that
        does not fit this config, keeps fresh weights from ``RNG_SEED`` and
        says so loudly."""
        pipe = cls._drawn(cfg, cfg.RNG_SEED)
        base = output_dir or cfg.OUTPUT_DIR
        # stage: (module, {checkpoint key prefix: module key prefix})
        maps = {
            "box": (pipe.box, {"model.": ""}),
            "shape": (pipe.shape, {"g.": "g.", "label_table": "label_table"}),
            "gan": (pipe.gan, {"ema_g.": "g_net.", "text_enc.": "text_enc.",
                               "label_table": "label_table"}),
        }
        for name, (module, prefixes) in maps.items():
            d = os.path.join(base, f"{cfg.CONFIG_NAME}_{name}", "ckpt")
            if name == "gan" and cfg.TRAIN.NET_G:
                d = cfg.TRAIN.NET_G
            step, saved = load_latest(d)
            state = why = None
            if isinstance(saved, OrbaxNode):
                try:
                    state = _jax_stage_state(name, saved)
                except (AttributeError, KeyError, ValueError) as e:
                    why = f"{type(e).__name__}: {e}"
            elif saved is not None:
                state = {new + k[len(old):]: v for k, v in saved.items()
                         for old, new in prefixes.items()
                         if k.startswith(old)}
            if saved is not None:
                why = why or mismatch(module.state_dict(), state)
                if why is not None:
                    print(f"WARNING: the {name} checkpoint at step {step} "
                          f"under {d} does not fit this config: {why}",
                          file=sys.stderr)
                    state = None
            if state is None:
                print(f"WARNING: no {name} checkpoint under {d} — the "
                      f"composed pipeline will run this stage with UNTRAINED "
                      f"random weights", file=sys.stderr)
                continue
            module.load_state_dict(state)
            print(f"restored the {name} stage from {d} (step {step})")
        return pipe.to(device).eval()

    def load_jax_params(self, box: Mapping, shape_g: Mapping,
                        shape_label_table, gan_g: Mapping, text: Mapping,
                        gan_label_table) -> None:
        """Weights from the JAX package's stage states, as numpy trees:
        ``BoxTrainState.params``, ``ShapeTrainState.g_params`` and
        ``.label_table``, ``GanTrainState.ema_g_params``, ``.text_params``
        and ``.label_table``."""
        bridge.load_jax_params(self.box, box)
        bridge.load_jax_params(self.shape.g, shape_g)
        bridge.load_jax_params(self.gan.g_net, gan_g)
        bridge.load_jax_params(self.gan.text_enc, text)
        with torch.no_grad():
            self.shape.label_table.copy_(torch.tensor(shape_label_table))
            self.gan.label_table.copy_(torch.tensor(gan_label_table))

    @torch.inference_mode()
    def generate(self, captions: torch.Tensor, cap_lens: torch.Tensor,
                 noise: Dict[str, torch.Tensor]) -> Dict[str, object]:
        """caption ids (B, T) and lengths (B,) -> layout, masks and the
        image pyramid."""
        o = self.cfg.OBJ.MAX_OBJECTS
        layout = box_train.sample(self.box, captions, cap_lens, noise)
        labels, boxes, valid = (layout["labels"], layout["boxes"],
                                layout["obj_valid"])
        # object axis: BOX.MAX_SEQ_LENGTH -> OBJ.MAX_OBJECTS
        pad = o - labels.shape[1]
        if pad > 0:
            labels = nn.functional.pad(labels, (0, pad))
            boxes = nn.functional.pad(boxes, (0, 0, 0, pad))
            valid = nn.functional.pad(valid, (0, pad))
        else:
            labels, boxes, valid = labels[:, :o], boxes[:, :o], valid[:, :o]

        masks = shape_train.sample(self.shape, boxes, labels, valid,
                                   noise["shape_z"])
        batch = {
            "captions": captions, "cap_lens": cap_lens, "labels": labels,
            "boxes": boxes, "shapes": masks, "obj_valid": valid,
        }
        out = gan_train.sample(self.gan, batch, noise["z"], noise["ca_eps"])
        return {
            "labels": labels,
            "boxes": boxes,
            "obj_valid": valid,
            "masks": masks,
            "images": out["images"],
            "grid_attn": out["grid_attn"],
            "obj_attn": out["obj_attn"],
        }


# stage: {its module's state-dict key or prefix: the JAX train state's field}
_JAX_FIELDS = {
    "box": {"": "params"},
    "shape": {"g.": "g_params", "label_table": "label_table"},
    "gan": {"g_net.": "ema_g_params", "text_enc.": "text_params",
            "label_table": "label_table"},
}


def _jax_stage_state(name: str, state) -> Dict[str, torch.Tensor]:
    """A stage's weights in a JAX train state (a tree of
    ``core/checkpoint.py::read_orbax``) as the stage module's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for key, field in _JAX_FIELDS[name].items():
        value = getattr(state, field)
        if field == "label_table":
            out[key] = torch.tensor(np.asarray(value))
        else:
            out.update({key + k: torch.tensor(v) for k, v in
                        bridge.jax_to_torch(value).items()})
    return out
