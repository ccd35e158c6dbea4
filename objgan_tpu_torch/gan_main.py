"""Stage-C entry point of the PyTorch port, mirroring ``gan/main.py``:

    python -m objgan_tpu_torch.gan_main --cfg cfg/coco_objgan.yml \
        [--manifest data_proc2k/manifest.json] --max_steps 4 [--device cpu]

``TRAIN.FLAG`` switches training (metric lines, keep-3 checkpoints, the
metrics CSV and attention grids under ``OUTPUT_DIR/<CONFIG_NAME>_gan``;
resumes from its newest checkpoint) and sampling from ``TRAIN.NET_G`` (PNGs
under ``OUTPUT_DIR``). Both load the DAMSM encoders of ``TRAIN.NET_E``
(``python -m objgan_tpu_torch.pretrain_damsm``). Without ``--manifest``
they run on synthetic COCO-shaped batches. ``--wire`` feeds uint8 wire
batches that the trainer expands on the device, ``--grain`` feeds from
``WORKERS`` worker processes. Runs on the CUDA device unless ``--device``
says otherwise. Training runs data-parallel under torchrun, each rank on
``cuda:LOCAL_RANK`` (``parallel/sharding.py``):

    python -m torch.distributed.run --nproc_per_node=N \
        -m objgan_tpu_torch.gan_main --cfg cfg/coco_objgan.yml ...
"""

from __future__ import annotations

import argparse

_CHECKPOINTS = ("Resumes from, or samples, the newest step under "
                "OUTPUT_DIR/<CONFIG_NAME>_gan/ckpt (TRAIN.NET_G to sample "
                "another run): the port's state.pt or a JAX run's Orbax "
                "step; writes state.pt only.")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Stage-C GAN: train when TRAIN.FLAG is true, else "
                    "sample.", epilog=_CHECKPOINTS)
    ap.add_argument("--cfg", dest="cfg_file", default=None,
                    help="reference-style yml config (default: Config())")
    ap.add_argument("--manifest", default=None,
                    help="dataset manifest JSON (data/pipeline.py); "
                         "synthetic batches without it")
    ap.add_argument("--captions_pickle", default=None,
                    help="reference captions.pickle for vocab parity")
    ap.add_argument("--data_dir", default=None,
                    help="sets DATA_DIR, the directory the manifest's "
                         "image_file paths are relative to")
    ap.add_argument("--wire", action="store_true",
                    help="compact uint8 wire batches + device-side "
                         "pyramid (data/wire.py; ~5x fewer host->device "
                         "bytes, cached host transform)")
    ap.add_argument("--grain", action="store_true",
                    help="the multi-worker host feed: WORKERS worker "
                         "processes (data/grain_feed.py)")
    ap.add_argument("--max_steps", type=int, default=10 ** 9,
                    help="training: steps to reach (default: MAX_EPOCH "
                         "epochs of the manifest)")
    ap.add_argument("--num_batches", type=int, default=10,
                    help="sampling: batches to generate")
    ap.add_argument("--log_every", type=int, default=50,
                    help="training: steps between metric lines")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import Config, cfg_from_file
    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.parallel.sharding import (
        maybe_initialize_distributed, shutdown)

    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    if args.data_dir:
        cfg = cfg.replace(DATA_DIR=args.data_dir)
    if cfg.TRAIN.FLAG:
        # under torchrun: join the group before the feed takes its part
        maybe_initialize_distributed(args.device)
    feed, n_records, vocab = build_feed(cfg, args.manifest,
                                        args.captions_pickle, wire=args.wire,
                                        grain=args.grain)
    if cfg.TRAIN.FLAG:
        cfg, max_steps = cli.apply_epoch_schedule(cfg, n_records,
                                                  args.max_steps)
        cli.train_gan(cfg, feed, max_steps=max_steps, device=args.device,
                      log_every=args.log_every,
                      ixtoword=vocab.ixtoword if vocab else None)
        shutdown()
    else:
        cli.sample_gan(cfg, feed, num_batches=args.num_batches,
                       device=args.device)


if __name__ == "__main__":
    main()
