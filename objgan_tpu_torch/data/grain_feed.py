"""The worker-process host feed: the counterpart of
``objgan_tpu/data/grain_feed.py`` (``--grain``), built on
``torch.utils.data.DataLoader`` instead of Grain, which the port does not
use.

The same per-record transform as :class:`data.pipeline.CocoFeed` runs in
``worker_count`` worker processes (``cfg.WORKERS`` when 0; in the calling
process when both are 0), and batches are assembled there by a numpy
collate, so they stay numpy and equal ``CocoFeed``'s layout. Each item's
randomness depends only on its global output position ``i`` (seed
``seed * 100003 + i``) and its class id only on the record's stable index
(``id_offset + idx * id_stride``), as in the JAX feed, so any number of
workers gives the same batches.

Differences from the JAX feed:
- The shuffle is a per-epoch ``np.random.default_rng(seed).permutation``,
  not Grain's ``MapDataset.shuffle``: the two feeds visit the records in
  different orders (each exactly once per epoch), while the row of a given
  ``(record, item seed, record id)`` is equal to the bit.
- Workers are processes (forked from a fork server, one torch thread
  each), not threads: each holds its own wire cache, which never reaches
  the calling process or the other workers. So the cache is on only when
  ``n_records x wire_record_bytes x max(1, workers)`` fits the budget.
- A worker that dies, or delivers nothing within ``TIMEOUT_S``, fails the
  run; there is no fallback to an in-process feed.
- The fork server stops when the last open worker feed of the process ends
  or is closed, so no process outlives the feeds; the next worker feed
  starts it anew.
"""

from __future__ import annotations

import multiprocessing
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.data.pipeline import (CocoFeed, validate_image_records,
                                            validate_labels, validate_vocab,
                                            wire_cache_allowed)
from objgan_tpu_torch.data.tokenizer import Vocab

TIMEOUT_S = 300  # seconds a worker may take for one batch
PREFETCH = 4     # batches in flight per worker

_open_feeds = 0  # worker feeds of this process whose workers are running


class _RecordTransform:
    """Picklable per-record map: ``(record, item seed, record id)`` ->
    ``CocoFeed._one`` row, with a generator of its own per item."""

    def __init__(self, cfg: Config, vocab: Vocab, with_images: bool,
                 augment: bool = True, image_root=None, wire: bool = False,
                 cacheable: bool = False, with_masks: bool = True):
        self.feed = CocoFeed.__new__(CocoFeed)
        self.feed.cfg = cfg
        self.feed.vocab = vocab
        self.feed.with_images = with_images
        self.feed.with_masks = with_masks
        self.feed.augment = augment
        self.feed.wire = wire
        # keyed by the stable record id, never the output position (which
        # grows forever and names another record each epoch)
        self.feed._cache = {} if (wire and cacheable) else None
        self.feed.image_root = image_root or cfg.DATA_DIR
        self.feed.records = []

    def __call__(self, item):
        record, seed, rec_id = item
        return self.feed._one(record, rng=np.random.default_rng(seed),
                              rec_id=rec_id)


class _Items:
    """Map-style dataset: key ``(i, idx)`` -> the row of record ``idx`` at
    global output position ``i``."""

    def __init__(self, records, transform, seed, id_offset, id_stride):
        self.records = records
        self.transform = transform
        self.seed = seed
        self.id_offset = id_offset
        self.id_stride = id_stride

    def __getitem__(self, key):
        i, idx = key
        return self.transform((self.records[idx], self.seed * 100003 + i,
                               self.id_offset + idx * self.id_stride))


class _EpochBatches:
    """Batches of ``(i, idx)`` keys: a permutation per epoch from
    ``np.random.default_rng(seed)``, batches straddling epochs so they stay
    full; endless, or ``num_epochs`` epochs with the remainder dropped."""

    def __init__(self, n, batch_size, seed, num_epochs):
        self.n, self.batch_size = n, batch_size
        self.seed, self.num_epochs = seed, num_epochs

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        i, epoch, keys = 0, 0, []
        while self.num_epochs is None or epoch < self.num_epochs:
            for idx in rng.permutation(self.n):
                keys.append((i, int(idx)))
                i += 1
                if len(keys) == self.batch_size:
                    yield keys
                    keys = []
            epoch += 1


def _collate(rows):
    batch: Dict = {}
    for k in rows[0]:
        if k == "images":
            batch[k] = [
                np.stack([r[k][j] for r in rows])
                for j in range(len(rows[0][k]))
            ]
        else:
            batch[k] = np.stack([r[k] for r in rows])
    return batch


def _init_worker(_):
    import torch

    torch.set_num_threads(1)


def _stop_fork_server():
    from multiprocessing import forkserver

    forkserver._forkserver._stop()  # closes its pipe and waits for it


def _batches(loader) -> Iterator[Dict[str, np.ndarray]]:
    # one iterator over the endless sampler: its workers, and their caches,
    # live across epochs until the feed ends or is closed
    global _open_feeds
    it = iter(loader)
    _open_feeds += loader.num_workers > 0
    try:
        yield from it
    finally:
        del it  # shuts the workers down and waits for them
        if loader.num_workers:
            _open_feeds -= 1
            if not _open_feeds:
                _stop_fork_server()


def grain_feed(
    cfg: Config,
    records: Sequence[Dict],
    vocab: Vocab,
    seed: int = 0,
    with_images: bool = True,
    num_epochs: Optional[int] = None,
    worker_count: int = 0,
    augment: bool = True,
    wire: bool = False,
    with_masks: bool = True,
    id_offset: int = 0,
    id_stride: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless (or ``num_epochs``-bounded) batch iterator from worker
    processes. ``id_offset``/``id_stride`` map local record indices to
    global ids under a strided partition (records[p::n] -> offset p,
    stride n), as ``CocoFeed``'s do. ``close()`` on the iterator stops
    its workers."""
    from torch.utils.data import DataLoader

    records = list(records)  # a one-shot iterator would be exhausted by
    # validate_labels and leave an empty dataset
    validate_labels(cfg, records)
    validate_vocab(cfg, vocab)  # CocoFeed.__new__ skips __init__'s checks
    if with_images:
        validate_image_records(records)
    workers = worker_count or cfg.WORKERS
    # every worker process fills a cache of its own
    transform = _RecordTransform(
        cfg, vocab, with_images, augment, wire=wire, with_masks=with_masks,
        cacheable=wire_cache_allowed(cfg, len(records) * max(1, workers),
                                     with_images=with_images,
                                     with_masks=with_masks))
    items = _Items(records, transform, seed, id_offset, id_stride)
    sampler = _EpochBatches(len(records), cfg.TRAIN.BATCH_SIZE, seed,
                            num_epochs)
    opts = {}
    if workers:
        # workers fork from a server process that imported this module once
        # (and no CUDA code), never from the caller, which may hold CUDA
        # state or threads; a spawned worker would import torch anew
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload([__name__])
        opts = dict(multiprocessing_context=ctx,
                    worker_init_fn=_init_worker, prefetch_factor=PREFETCH,
                    timeout=TIMEOUT_S)
    loader = DataLoader(items, batch_sampler=sampler, collate_fn=_collate,
                        num_workers=workers, **opts)
    return _batches(loader)
