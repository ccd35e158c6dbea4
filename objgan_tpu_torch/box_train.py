"""Stage-A training entry point of the PyTorch port, mirroring
``box_generation/train.py``:

    python -m objgan_tpu_torch.box_train --cfg <yml> \
        [--manifest data_proc2k/manifest.json] --max_steps N [--device cpu]

Teacher-forced training of the box generator on the manifest's captions
and layouts (no images, no masks are read; synthetic batches without
``--manifest``; ``--wire`` gives layout-only wire batches, the same
tensors): metric lines, keep-3 checkpoints and the metrics CSV under
``OUTPUT_DIR/<CONFIG_NAME>_box``, resumed from its newest checkpoint. Runs
on the CUDA device unless ``--device`` says otherwise; data-parallel under
``python -m torch.distributed.run --nproc_per_node=N -m
objgan_tpu_torch.box_train ...``, each rank on ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations


def main(argv=None) -> None:
    from objgan_tpu_torch import cli
    from objgan_tpu_torch.box_opts import parse_opts, to_config
    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.parallel.sharding import (
        maybe_initialize_distributed, shutdown)

    args = parse_opts(argv)
    cfg = to_config(args)
    # under torchrun: join the group before the feed takes its part
    maybe_initialize_distributed(args.device)
    # Stage A reads captions and layouts only: no PNG decode, no masks
    feed, n_records, _ = build_feed(cfg, args.manifest, args.captions_pickle,
                                    with_images=False, with_masks=False,
                                    wire=args.wire)
    cfg, max_steps = cli.apply_epoch_schedule(cfg, n_records, args.max_steps)
    cli.train_box(cfg, feed, max_steps=max_steps, device=args.device,
                  log_every=args.log_every)
    shutdown()


if __name__ == "__main__":
    main()
