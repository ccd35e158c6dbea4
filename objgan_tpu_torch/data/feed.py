"""The trainers' host feed from a dataset manifest. Port of
``gan/main.py::build_feed``: ``CocoFeed`` in the calling process, or with
``grain`` the worker-process feed of ``data/grain_feed.py``; either gives
classic batches, or with ``wire`` the uint8 wire batches of
``data/wire.py``. Under data parallelism (a process group, see
``parallel/sharding.py``) each rank feeds its strided part of the records,
``records[rank::world]``, at its rows of ``TRAIN.BATCH_SIZE``, with their
global record ids (offset ``rank``, stride ``world``) as class ids. A feed
with masks builds the native polygon fill (``native/``) here, in the
calling process, before any worker starts.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

from objgan_tpu_torch import native
from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.data.pipeline import (CocoFeed, load_records_json,
                                            split_records)
from objgan_tpu_torch.data.tokenizer import Vocab
from objgan_tpu_torch.parallel import sharding


def build_feed(cfg: Config, manifest: Optional[str],
               captions_pickle: Optional[str] = None,
               image_root: Optional[str] = None, with_images: bool = True,
               with_masks: bool = True, seed: Optional[int] = None,
               augment: Optional[bool] = None, wire: bool = False,
               grain: bool = False
               ) -> Tuple[Optional[Iterator], int, Optional[Vocab]]:
    """``(feed or None, number of records, vocab or None)``; no manifest
    gives ``(None, 0, None)`` and the caller feeds synthetic batches.

    The vocabulary is built from the manifest's captions, or read from the
    lineage's ``captions_pickle``. With ``cfg.B_VALIDATION`` training
    (``TRAIN.FLAG``) takes the train portion of ``split_records`` and
    sampling the held-out one; that split always keys on ``RNG_SEED``.
    ``seed`` (default ``RNG_SEED``) orders the batches only: the eval's
    ``--eval_seed``. Only a training feed augments (flip, <unk> word
    dropout) unless ``augment`` says otherwise (the eval's
    ``--aug_eval``). ``image_root``: the directory the records'
    ``image_file`` paths are relative to, by default ``cfg.DATA_DIR`` (the
    entry points' ``--data_dir`` sets it), as in the JAX package.
    ``wire``: uint8 wire batches (``--wire``); ``grain``: the batches come
    from ``cfg.WORKERS`` worker processes (``--grain``). The number of
    records is the global one, so ``cli.apply_epoch_schedule`` gives every
    rank the schedule of one process."""
    if not manifest:
        return None, 0, None
    records = load_records_json(manifest)
    vocab = (Vocab.from_reference_pickle(captions_pickle) if captions_pickle
             else Vocab.build(c for r in records for c in r["captions"]))
    if cfg.B_VALIDATION:
        train_recs, val_recs = split_records(records, seed=cfg.RNG_SEED)
        records = train_recs if cfg.TRAIN.FLAG else val_recs
        print(f"B_VALIDATION split: {len(train_recs)} train / "
              f"{len(val_recs)} held-out; using "
              f"{'train' if cfg.TRAIN.FLAG else 'held-out'}")
    seed = cfg.RNG_SEED if seed is None else seed
    augment = bool(cfg.TRAIN.FLAG) if augment is None else augment
    image_root = image_root or cfg.DATA_DIR
    n_global = len(records)
    rank, world = sharding.rank_and_world()
    if world > 1:
        records = sharding.process_local_records(records)
        _, local_b = sharding.process_local_batch_slice(cfg.TRAIN.BATCH_SIZE)
        cfg = cfg.merged({"TRAIN": {"BATCH_SIZE": local_b}})
    ids = dict(id_offset=rank, id_stride=world)
    if with_masks:
        native.build()  # here, once, before any worker process fills
    if grain:
        from objgan_tpu_torch.data.grain_feed import grain_feed

        return grain_feed(cfg.replace(DATA_DIR=image_root), records, vocab,
                          seed=seed, with_images=with_images,
                          with_masks=with_masks, augment=augment,
                          wire=wire, **ids), n_global, vocab
    feed = CocoFeed(cfg, records, vocab, seed=seed, with_images=with_images,
                    with_masks=with_masks, augment=augment,
                    image_root=image_root, wire=wire, **ids)
    return iter(feed), n_global, vocab
