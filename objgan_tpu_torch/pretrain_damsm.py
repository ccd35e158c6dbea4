"""DAMSM pretraining entry point of the PyTorch port, mirroring
``gan/pretrain_DAMSM.py``:

    python -m objgan_tpu_torch.pretrain_damsm --cfg cfg/damsm_coco.yml \
        --manifest data_proc2k/manifest.json --max_steps N [--device cpu]

Trains the DAMSM text and image encoders on the manifest's records
(synthetic batches without ``--manifest``), writes keep-3 checkpoints, the
metrics CSV and attention-grid snapshots under
``OUTPUT_DIR/<CONFIG_NAME>_damsm``, and resumes from its newest checkpoint
when run again. Stage C loads the encoders through ``TRAIN.NET_E``.
``--wire`` and ``--grain`` choose the feed as ``gan_main``'s do. Runs on
the CUDA device unless ``--device`` says otherwise; data-parallel under
``python -m torch.distributed.run --nproc_per_node=N -m
objgan_tpu_torch.pretrain_damsm ...``, each rank on ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import argparse

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="DAMSM text/image encoder pretraining.")
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
                    help="steps to reach (default: MAX_EPOCH epochs of the "
                         "manifest)")
    ap.add_argument("--log_every", type=int, default=50,
                    help="steps between metric lines")
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
    # under torchrun: join the group before the feed takes its part
    maybe_initialize_distributed(args.device)
    # DAMSM reads images, captions and class ids: no per-object masks
    feed, n_records, vocab = build_feed(
        cfg, args.manifest, args.captions_pickle, with_masks=False,
        wire=args.wire, grain=args.grain)
    cfg, max_steps = cli.apply_epoch_schedule(cfg, n_records, args.max_steps)
    cli.pretrain_damsm(cfg, feed, max_steps=max_steps, device=args.device,
                       log_every=args.log_every,
                       ixtoword=vocab.ixtoword if vocab else None)
    shutdown()


if __name__ == "__main__":
    main()
