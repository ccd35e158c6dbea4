"""Host-feed and transfer breakdown of a manifest feed, stage by stage:
the counterpart of ``objgan_tpu/tools/profile_feed.py``.

  1. the record transform (PIL decode, pyramid, rasterize, tokenize), per
     record, in the calling process;
  2. batch assembly (the feed's ms per batch, collate included; with
     ``--grain`` from WORKERS worker processes);
  3. the K-stack: K = ``--k`` (default ``max(1, STEPS_PER_EXECUTION)``)
     batches stacked into pinned host memory (``cli.stack_batches``, what
     the K-step loop's producer thread does), ms and bytes, and that
     stack's pinned host->device copy, synchronised, with GB/s;
  4. host->device of one batch through pinned memory and a non-blocking
     copy (``cli.to_device``), synchronised, with bytes and GB/s;
  5. with ``--train``, one synchronised ``GanTrainer.train_step`` on a
     batch already on the device.

    python -m objgan_tpu_torch.tools.profile_feed --cfg cfg/coco_objgan.yml \
        --manifest data_proc2k/manifest.json [--wire] [--grain] [--k K] \
        [--train]

The image root is ``--data_dir``, by default the manifest's directory.
Runs on the CUDA device unless ``--device`` says otherwise; a time taken
with ``--device cpu`` is a CPU copy, not a device transfer.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import numpy as np

BATCHES = 3  # timed in stage 2, after one that starts the feed


def batch_bytes(batch) -> int:
    """Bytes of a numpy batch ("images" a list of arrays)."""
    return sum(sum(a.nbytes for a in v) if isinstance(v, list) else v.nbytes
               for v in batch.values())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Host-feed breakdown.")
    ap.add_argument("--cfg", dest="cfg_file", default=None)
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--data_dir", default=None,
                    help="image root (default: the manifest's directory)")
    ap.add_argument("--wire", action="store_true",
                    help="profile the uint8 wire feed instead of classic")
    ap.add_argument("--grain", action="store_true",
                    help="batches from the multi-worker host feed "
                         "(WORKERS worker processes)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--k", type=int, default=0,
                    help="steps per execution to stack in stage 3 "
                         "(default: max(1, TRAIN.STEPS_PER_EXECUTION))")
    ap.add_argument("--train", action="store_true",
                    help="also time one Stage-C train step")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import Config, cfg_from_file
    from objgan_tpu_torch.data.grain_feed import PREFETCH, grain_feed
    from objgan_tpu_torch.data.pipeline import CocoFeed, load_records_json
    from objgan_tpu_torch.data.tokenizer import Vocab

    device = torch.device(args.device)
    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    cfg = cfg.replace(DATA_DIR=args.data_dir
                      or os.path.dirname(args.manifest) or ".")
    records = load_records_json(args.manifest)
    vocab = Vocab.build(c for r in records for c in r["captions"])
    feed = CocoFeed(cfg, records, vocab, seed=0, wire=args.wire)
    b = cfg.TRAIN.BATCH_SIZE
    k = args.k or max(1, cfg.TRAIN.STEPS_PER_EXECUTION)
    if args.wire:  # fill the deterministic cache so timings are steady
        if feed._cache is None:
            print("NOTE: wire cache disabled by the byte-budget policy "
                  "(dataset footprint exceeds a quarter of RAM) — the "
                  "timings below are the cache-cold recompute path")
        else:
            for i, r in enumerate(records):
                feed._wire_base(r, i)

    # -- 1. per-record transform --------------------------------------
    rng = np.random.default_rng(0)
    n_rec = min(len(records), 64)
    t0 = time.perf_counter()
    for i in range(n_rec):
        feed._one(records[i % len(records)], rng=rng, rec_id=i)
    t_rec = (time.perf_counter() - t0) / n_rec
    print(f"1. record transform: {t_rec * 1e3:.2f} ms/record "
          f"({1 / t_rec:.0f} rec/s single-core)")

    # -- 2. per-batch assembly ----------------------------------------
    skip = 0
    if args.grain:
        it = grain_feed(cfg, records, vocab, seed=0, wire=args.wire)
        # what the workers prefetched while the first batch was made
        skip = cfg.WORKERS * PREFETCH
        print(f"2. (--grain: {cfg.WORKERS} worker processes, {skip} "
              f"prefetched batches skipped" + ("; their wire caches fill "
              "during their first epoch)" if args.wire else ")"))
    else:
        it = iter(feed)
    next(it)  # workers up, lazy imports done
    for _ in range(skip):
        next(it)
    n = max(BATCHES, k)
    t0 = time.perf_counter()
    batches = list(itertools.islice(it, n))
    t_batch = (time.perf_counter() - t0) / n
    if args.grain:
        it.close()
    print(f"2. batch assembly: {t_batch * 1e3:.1f} ms/batch-{b} "
          f"-> feed ceiling {1 / t_batch:.2f} steps/s")

    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))

    # -- 3. K-stack ----------------------------------------------------
    pin = device.type == "cuda"
    t0 = time.perf_counter()
    stacked = cli.stack_batches(batches[:k], pin=pin)
    t_stack = time.perf_counter() - t0
    k_bytes = k * batch_bytes(batches[0])
    print(f"3. K={k} stack: {t_stack * 1e3:.2f} ms for {k_bytes / 1e6:.2f} "
          f"MB ({'pinned' if pin else 'pageable'} host memory)")
    for rep in range(args.reps):
        sync()
        t0 = time.perf_counter()
        cli.to_device(stacked, device)
        sync()
        t_kput = time.perf_counter() - t0
        print(f"3. K={k} stack host->device ({device}) rep {rep}: "
              f"{t_kput * 1e3:.2f} ms -> {k_bytes / t_kput / 1e9:.2f} GB/s")

    # -- 4. host->device transfer -------------------------------------
    nbytes = batch_bytes(batches[0])
    for rep in range(args.reps):
        sync()
        t0 = time.perf_counter()
        dev = cli.to_device(batches[0], device)
        sync()
        t_put = time.perf_counter() - t0
        print(f"4. host->device ({device}) rep {rep}: {t_put * 1e3:.2f} ms "
              f"for {nbytes / 1e6:.2f} MB -> {nbytes / t_put / 1e9:.2f} GB/s")

    # -- 5. the train step itself -------------------------------------
    if args.train:
        from objgan_tpu_torch.train.common import step_generator
        from objgan_tpu_torch.train.gan import train_noise

        trainer = cli.make_trainer(cfg.merged({"TRAIN": {"FLAG": True}}),
                                   device)
        noise = train_noise(cfg, b, step_generator(cfg.RNG_SEED, 0, device,
                                                   0), device)
        times = []
        for _ in range(2):  # the first call warms up
            sync()
            t0 = time.perf_counter()
            trainer.train_step(dev, noise["z"], noise["ca_eps"])
            sync()
            times.append(time.perf_counter() - t0)
        t_train = times[-1]
        print(f"5. train step: {t_train * 1e3:.1f} ms (first call "
              f"{times[0] * 1e3:.1f} ms)")
        total = t_batch + t_put + t_train
        print(f"=> serial loop estimate: {total * 1e3:.1f} ms/step "
              f"({1 / total:.2f} steps/s); device duty cycle "
              f"{t_train / total * 100:.0f}%")


if __name__ == "__main__":
    main()
