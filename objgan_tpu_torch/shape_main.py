"""Stage-B entry point of the PyTorch port, mirroring
``shape_generation/main.py``:

    python -m objgan_tpu_torch.shape_main --cfg cfg/shape_coco.yml \
        [--manifest data_proc2k/manifest.json] --max_steps N [--device cpu]
    python -m objgan_tpu_torch.shape_main --cfg cfg/shape_coco.yml --eval \
        --manifest data_proc2k/manifest.json --num_batches 2

Trains the shape generator and discriminator on the manifest's layouts
and instance masks (no images are read; synthetic batches without
``--manifest``): metric lines, keep-3 checkpoints and the metrics CSV under
``OUTPUT_DIR/<CONFIG_NAME>_shape``, resumed from its newest checkpoint.
With ``--eval``, the held-out mask IoU, pixel accuracy and area ratio of
the newest checkpoint, on classic batches whatever ``--wire`` says.
``--wire`` trains on uint8 wire batches (masks 255-quantised). Runs on
the CUDA device unless ``--device`` says otherwise; training runs
data-parallel under ``python -m torch.distributed.run --nproc_per_node=N
-m objgan_tpu_torch.shape_main ...``, each rank on ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import argparse

_CHECKPOINTS = ("Resumes from, or evaluates, the newest step under OUTPUT_DIR/"
                "<CONFIG_NAME>_shape/ckpt: the port's state.pt or a JAX run's "
                "Orbax step; writes state.pt only.")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Stage B: boxes -> masks.",
                                 epilog=_CHECKPOINTS)
    ap.add_argument("--cfg", dest="cfg_file", default=None)
    ap.add_argument("--manifest", default=None)
    ap.add_argument("--wire", action="store_true",
                    help="compact uint8 wire batches (data/wire.py); "
                         "--eval reads classic batches")
    ap.add_argument("--captions_pickle", default=None)
    ap.add_argument("--data_dir", default=None,
                    help="sets DATA_DIR, the directory the manifest's "
                         "image_file paths are relative to")
    ap.add_argument("--max_steps", type=int, default=10 ** 9)
    ap.add_argument("--eval", action="store_true",
                    help="held-out mask IoU/accuracy instead of training")
    ap.add_argument("--num_batches", type=int, default=10)
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
    if args.eval:
        # the sampling path: B_VALIDATION serves the held-out split
        cfg = cfg.merged({"TRAIN": {"FLAG": False}})
        # no --wire: the mask metrics read batch["shapes"] on the host
        feed, _, _ = build_feed(cfg, args.manifest, args.captions_pickle,
                                with_images=False)
        cli.eval_shape(cfg, feed, num_batches=args.num_batches,
                       device=args.device)
        return
    # under torchrun: join the group before the feed takes its part
    maybe_initialize_distributed(args.device)
    # Stage B reads layouts and instance masks, never photos
    feed, n_records, _ = build_feed(cfg, args.manifest, args.captions_pickle,
                                    with_images=False, wire=args.wire)
    cfg, max_steps = cli.apply_epoch_schedule(cfg, n_records, args.max_steps)
    cli.train_shape(cfg, feed, max_steps=max_steps, device=args.device,
                    log_every=args.log_every)
    shutdown()


if __name__ == "__main__":
    main()
