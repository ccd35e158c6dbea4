"""Lineage DAMSM ``.pth`` files -> a DAMSM checkpoint of the port. Port of
``objgan_tpu/tools/convert_damsm.py``.

The lineage's Stage-C trainer loads ``TRAIN.NET_E`` (``text_encoder.pth``)
and its sibling ``image_encoder.pth``. This tool writes them as step 0 of a
``DamsmTrainer`` checkpoint (``core/checkpoint.py``), which the port's
Stage C loads through ``TRAIN.NET_E`` (``cli.load_damsm_encoders``):

    python -m objgan_tpu_torch.tools.convert_damsm --cfg cfg/damsm_coco.yml \
        --text_pth text_encoder.pth [--image_pth image_encoder.pth] \
        --out ckpts/coco_damsm_converted

then set ``TRAIN.NET_E: ckpts/coco_damsm_converted`` in the GAN yml, with
the text dims this tool prints. The vocabulary size, GloVe dim and hidden
size are read from the text state dict and override the cfg; a lineage
``image_encoder`` needs the Inception-v3 backbone, switched on
(``TEXT.CNN_BACKBONE: inception``) when the state dict has torchvision's
Inception module names, and refused when it has none. Files are loaded
with ``torch.load(weights_only=True)``: one that needs pickle code to load
is refused (the JAX package falls back to the unsafe loader). The
conversion runs on the CPU: it computes nothing.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict, Optional

import torch


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A lineage ``.pth``'s tensor state dict (a ``state_dict`` or ``model``
    wrapper unwrapped); exits with a message for a file that needs pickle
    code to load."""
    from objgan_tpu_torch.cli import load_torch_state_dict

    try:
        return load_torch_state_dict(path)
    except pickle.UnpicklingError as exc:
        raise SystemExit(
            f"{path} is not a plain tensor state dict: it needs pickle code "
            f"to load, which this tool does not run (torch.load "
            f"weights_only=True). Re-save it as a state dict of tensors "
            f"where it is trusted.\n{str(exc).splitlines()[0]}") from None


def convert(cfg, text_pth: str, image_pth: Optional[str], out_dir: str):
    """Build a ``DamsmTrainer`` from lineage ``.pth`` files and save it as
    step 0 under ``out_dir``. Returns the trainer (on the CPU)."""
    from objgan_tpu_torch.core.checkpoint import CheckpointManager
    from objgan_tpu_torch.core.name_maps import (load_cnn_encoder_checkpoint,
                                                 load_rnn_encoder_checkpoint)
    from objgan_tpu_torch.train.damsm import DamsmTrainer

    text_sd = load_state_dict(text_pth)
    vocab, glove_dim = text_sd["encoder.weight"].shape
    hidden = text_sd["rnn.weight_hh_l0"].shape[1]
    overrides = {"TEXT": {"VOCAB_SIZE": int(vocab),
                          "GLOVE_DIM": int(glove_dim),
                          "HIDDEN_DIM": int(hidden),
                          "EMBEDDING_DIM": int(2 * hidden)}}
    img_sd = None
    if image_pth:
        img_sd = load_state_dict(image_pth)
        if not any(k.startswith("Mixed_5b") for k in img_sd):
            raise SystemExit(
                "image_encoder state dict has no torchvision Inception-v3 "
                "module names — only the lineage CNN_ENCODER layout is "
                "convertible (its backbone IS Inception-v3)")
        overrides["TEXT"]["CNN_BACKBONE"] = "inception"
    cfg = cfg.merged(overrides)
    print(f"text encoder: vocab={vocab} glove_dim={glove_dim} "
          f"hidden={hidden} (cfg overridden to match)")

    trainer = DamsmTrainer(cfg).init_state(torch.Generator().manual_seed(0))
    load_rnn_encoder_checkpoint(trainer.text_enc, text_sd)
    print(f"text_encoder: all {len(text_sd)} params transferred")
    if img_sd is not None:
        load_cnn_encoder_checkpoint(trainer.img_enc, img_sd)
        print("image_encoder: backbone + projections transferred")
    CheckpointManager(out_dir).save(0, trainer)
    print(f"wrote DamsmTrainer checkpoint (step 0) to {out_dir}\n"
          f"point cfg.TRAIN.NET_E at this directory for Stage-C training")
    return trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", dest="cfg_file", default=None)
    ap.add_argument("--text_pth", required=True,
                    help="lineage text_encoder.pth")
    ap.add_argument("--image_pth", default=None,
                    help="lineage image_encoder.pth (CNN_ENCODER over "
                         "torchvision Inception-v3)")
    ap.add_argument("--out", required=True,
                    help="output checkpoint directory (NET_E target)")
    args = ap.parse_args(argv)

    from objgan_tpu_torch.core.config import Config, cfg_from_file

    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    convert(cfg, args.text_pth, args.image_pth, args.out)


if __name__ == "__main__":
    main()
