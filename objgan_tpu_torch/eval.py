"""Stage C's quality evaluation in the PyTorch port, mirroring
``gan/eval.py``: FID, Inception Score, the frozen cross-manifest lite-IS,
R-precision and full-pool retrieval ranks over generated samples, in one
pass.

    python -m objgan_tpu_torch.eval --cfg cfg/eval_coco.yml \
        --manifest data_proc2k/manifest.json --data_dir data_proc2k \
        --num_batches 16 [--real_stats all] [--strict --inception_pth P] \
        [--device cpu]

Restores the Stage-C checkpoint of ``TRAIN.NET_G`` (default
``OUTPUT_DIR/<CONFIG_NAME>_gan/ckpt``) and samples ``--num_batches``
held-out batches with the EMA generator. The default "lite" mode scores
the features of a DAMSM lite encoder with fresh weights (seed 0; the JAX
package draws its own, so the two packages' lite numbers lie in different
feature spaces); ``--strict`` scores Inception-v3 (torchvision weights from
``--inception_pth``; without them only with ``--force``, and the numbers
mean nothing). ``--grain`` reads the held-out batches from ``WORKERS``
worker processes. Runs on the CUDA device unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import argparse
import sys

_CHECKPOINTS = ("Evaluates the newest step of TRAIN.NET_G (default "
                "OUTPUT_DIR/<CONFIG_NAME>_gan/ckpt): the port's state.pt or "
                "a JAX run's Orbax step.")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="FID / IS / R-precision of the Stage-C generator.",
        epilog=_CHECKPOINTS)
    ap.add_argument("--cfg", dest="cfg_file", default=None)
    ap.add_argument("--manifest", default=None)
    ap.add_argument("--captions_pickle", default=None)
    ap.add_argument("--data_dir", default=None,
                    help="sets DATA_DIR, the directory the manifest's "
                         "image_file paths are relative to")
    ap.add_argument("--grain", action="store_true",
                    help="the multi-worker host feed: WORKERS worker "
                         "processes (data/grain_feed.py)")
    ap.add_argument("--num_batches", type=int, default=10)
    ap.add_argument("--strict", action="store_true",
                    help="full Inception-v3 activations (standard FID/IS)")
    ap.add_argument("--real_stats", choices=["paired", "all"],
                    default="paired",
                    help="'all': real-side FID statistics over every unique "
                         "manifest image (one augmentation-free epoch, "
                         "cached next to the manifest); 'paired' (default) "
                         "uses the batches that condition the fakes")
    ap.add_argument("--inception_pth", default=None,
                    help="torchvision inception_v3 .pth state dict "
                         "(required for --strict)")
    ap.add_argument("--force", action="store_true",
                    help="allow --strict without weights (numbers are "
                         "meaningless — random Inception features)")
    ap.add_argument("--frozen_probe", default=None,
                    help="frozen cross-manifest lite-IS artifact "
                         "(python -m objgan_tpu_torch.freeze_probe). "
                         "Default: assets/frozen_lite.npz when present; "
                         "'off' disables. Lite mode only")
    ap.add_argument("--raw_params", action="store_true",
                    help="sample with the raw (last-step) generator instead "
                         "of the EMA one")
    ap.add_argument("--eval_seed", type=int, default=None,
                    help="seed of the eval draws only (held-out batch "
                         "order and latents); the split and the "
                         "initialisation stay at RNG_SEED, and so do the "
                         "real-side statistics with --real_stats all")
    ap.add_argument("--aug_eval", action="store_true",
                    help="protocol bisect only: evaluate on augmented "
                         "(flip + word dropout) held-out batches")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)
    if args.real_stats == "all" and not args.manifest:
        ap.error("--real_stats all needs --manifest (the whole-dataset "
                 "real side is defined by a manifest; without one the "
                 "synthetic feed only supports 'paired')")
    if args.strict and not args.inception_pth and not args.force:
        print("ERROR: --strict without --inception_pth computes FID/IS from "
              "a RANDOMLY INITIALIZED Inception-v3 — the numbers look "
              "publication-formatted but are meaningless. Supply the "
              "torchvision inception_v3 weights via --inception_pth, or "
              "pass --force if you really want random features.",
              file=sys.stderr)
        sys.exit(2)

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import Config, cfg_from_file
    from objgan_tpu_torch.data.feed import build_feed

    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    if args.data_dir:
        cfg = cfg.replace(DATA_DIR=args.data_dir)
    # the held-out split: evaluation never reads the training records
    cfg = cfg.merged({"TRAIN": {"FLAG": False}})
    feed, _, vocab = build_feed(cfg, args.manifest, args.captions_pickle,
                                seed=args.eval_seed, augment=args.aug_eval,
                                grain=args.grain)
    cli.evaluate(cfg, feed, args.num_batches, strict=args.strict,
                 real_stats=args.real_stats, manifest=args.manifest,
                 inception_pth=args.inception_pth,
                 frozen_probe=args.frozen_probe, raw_params=args.raw_params,
                 eval_seed=args.eval_seed, feed_vocab=vocab,
                 device=args.device)


if __name__ == "__main__":
    main()
