"""A DAMSM checkpoint of the port -> lineage ``.pth`` files, the inverse of
``convert_damsm``. Port of ``objgan_tpu/tools/export_damsm.py``.

Writes the newest checkpoint's encoders as the lineage's
``text_encoder.pth`` / ``image_encoder.pth`` state dicts, which the
lineage's PyTorch code (or any AttnGAN/Obj-GAN derivative) loads:

    python -m objgan_tpu_torch.tools.export_damsm --cfg cfg/damsm_coco.yml \
        --ckpt out/coco_damsm/ckpt \
        --text_pth text_encoder.pth [--image_pth image_encoder.pth]

The text encoder exports exactly (torch's two LSTM bias vectors import
summed, so the export writes ``bias_ih = b``, ``bias_hh = 0``: the same in
any torch forward). The image encoder exports only from a checkpoint
trained with ``TEXT.CNN_BACKBONE: inception`` (the lineage's CNN_ENCODER
is torchvision Inception-v3); the lite encoder has no PyTorch counterpart
and is refused with that explanation. G_NET / D_NET cannot be exported:
GroupNorm stands where the lineage has BatchNorm (``core/name_maps.py``).
The export runs on the CPU: it computes nothing.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import torch


def _save_pth(sd: Dict[str, torch.Tensor], path: str) -> None:
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: v.contiguous() for k, v in sd.items()}, path)


def export(cfg, ckpt_dir: str, text_pth: str,
           image_pth: Optional[str] = None):
    """Restore the newest ``DamsmTrainer`` checkpoint under ``ckpt_dir`` and
    write lineage ``.pth`` state dicts. Returns the restored trainer."""
    from objgan_tpu_torch.core.checkpoint import (CheckpointManager,
                                                  latest_step_in)
    from objgan_tpu_torch.core.name_maps import (export_cnn_encoder,
                                                 export_rnn_encoder)
    from objgan_tpu_torch.train.damsm import DamsmTrainer

    if image_pth and cfg.TEXT.CNN_BACKBONE != "inception":
        raise SystemExit(
            "--image_pth requires a checkpoint trained with "
            "TEXT.CNN_BACKBONE: inception — the default InceptionLite "
            "image encoder has no PyTorch counterpart (documented "
            "divergence, models/damsm.py), so there is no lineage "
            "image_encoder.pth layout to export it as")
    if latest_step_in(ckpt_dir) is None:
        raise SystemExit(f"no checkpoint found under {ckpt_dir}")
    trainer = DamsmTrainer(cfg)
    step = CheckpointManager(ckpt_dir).restore_latest(trainer)
    if step is None:
        raise SystemExit(f"the checkpoint under {ckpt_dir} does not match "
                         "the cfg (use the cfg it was trained with)")
    print(f"restored DamsmTrainer (step {step}) from {ckpt_dir}")
    text_sd = export_rnn_encoder(trainer.text_enc)
    _save_pth(text_sd, text_pth)
    print(f"wrote {text_pth} ({len(text_sd)} tensors — lineage "
          f"RNN_ENCODER layout, exact)")
    if image_pth:
        img_sd = export_cnn_encoder(trainer.img_enc)
        _save_pth(img_sd, image_pth)
        print(f"wrote {image_pth} ({len(img_sd)} tensors — lineage "
              f"CNN_ENCODER layout over torchvision Inception-v3)")
    return trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", dest="cfg_file", default=None,
                    help="the cfg the checkpoint was trained with")
    ap.add_argument("--ckpt", required=True,
                    help="DAMSM checkpoint directory (a pretrain_damsm "
                         "output's ckpt/)")
    ap.add_argument("--text_pth", required=True,
                    help="output lineage text_encoder.pth")
    ap.add_argument("--image_pth", default=None,
                    help="output lineage image_encoder.pth (only for "
                         "TEXT.CNN_BACKBONE: inception checkpoints)")
    args = ap.parse_args(argv)

    from objgan_tpu_torch.core.config import Config, cfg_from_file

    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    export(cfg, args.ckpt, args.text_pth, args.image_pth)


if __name__ == "__main__":
    main()
