"""Stage-C entry point of the PyTorch port, mirroring ``gan/main.py``:

    python -m objgan_tpu_torch.gan_main --cfg cfg/coco_objgan.yml \
        --max_steps 4 [--device cpu]

``TRAIN.FLAG`` switches training (one metric line per logged step) and
sampling (PNGs under ``OUTPUT_DIR``). Runs on the CUDA device unless
``--device`` says otherwise.
"""

from __future__ import annotations

import argparse

_LATER = ("Not ported yet (ROADMAP.md, slice 3): checkpoint save and "
          "resume, the pretrained-DAMSM loader (TRAIN.NET_E), the dataset "
          "manifest feed (--manifest, --wire, --grain) and the attention-"
          "grid snapshots. Training and sampling run on synthetic "
          "COCO-shaped batches with fresh weights from RNG_SEED.")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Stage-C GAN: train when TRAIN.FLAG is true, else "
                    "sample.", epilog=_LATER)
    ap.add_argument("--cfg", dest="cfg_file", default=None,
                    help="reference-style yml config (default: Config())")
    ap.add_argument("--max_steps", type=int, default=10 ** 9,
                    help="training: steps to take")
    ap.add_argument("--num_batches", type=int, default=10,
                    help="sampling: batches to generate")
    ap.add_argument("--log_every", type=int, default=50,
                    help="training: steps between metric lines")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import Config, cfg_from_file

    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    if cfg.TRAIN.FLAG:
        cli.train_gan(cfg, max_steps=args.max_steps, device=args.device,
                      log_every=args.log_every)
    else:
        cli.sample_gan(cfg, num_batches=args.num_batches, device=args.device)


if __name__ == "__main__":
    main()
