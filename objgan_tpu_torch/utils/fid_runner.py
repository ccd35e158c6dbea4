"""Feature extractors and the host side of FID / Inception Score. Port of
``objgan_tpu/utils/fid_runner.py``.

Strict mode (``make_inception_extractor``): Inception-v3 pool activations
and the softmax of its logits, the standard definitions once torchvision
weights are loaded (``models/inception_v3.load_torchvision_checkpoint``).
Lite mode (``make_lite_extractor``): the global feature of a DAMSM lite
image encoder, self-consistent relative numbers. Without weights each
extractor draws its own from a generator seeded 0; those differ from the
JAX package's ``PRNGKey(0)`` draw, so lite FID/IS of the two packages lie
in different feature spaces unless weights are carried across.

An extractor takes images (B, S, S, 3) in [-1, 1], numpy or a tensor, and
returns tensors on its device. The rest runs on the host in numpy: the
probe's labels, the real-side streaming pass, the on-disk cache of its
statistics and the final FID/IS.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from objgan_tpu_torch.utils.eval_metrics import (activation_stats,
                                                 fit_class_probe,
                                                 frechet_from_stats,
                                                 inception_score)

_DEGENERATE = ("WARNING: degenerate (near-constant) {side} activations — "
               "the feature extractor is probably untrained (load "
               "converted Inception weights for meaningful FID).")


def to_numpy(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array, floats in fp32."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def _on(images, device) -> torch.Tensor:
    return torch.as_tensor(images).to(device)


def _module(module: torch.nn.Module, params, generator, device):
    from objgan_tpu_torch.core.layers import init_weights

    if params is None:
        init_weights(module, generator or torch.Generator().manual_seed(0))
    else:
        module.load_state_dict(params)
    return module.to(device)


def make_inception_extractor(params=None, generator=None, device="cuda"):
    """(extract, model): images -> (pool activations (B, 2048), softmax of
    the logits (B, 1000)). ``params``: an ``InceptionV3`` state dict; by
    default fresh weights from ``generator`` (seed 0), drawn on the CPU."""
    from objgan_tpu_torch.models.inception_v3 import InceptionV3

    model = _module(InceptionV3(), params, generator, device)

    @torch.no_grad()
    def extract(images):
        out = model(_on(images, device))
        return out["pool"], torch.softmax(out["logits"], dim=-1)

    return extract, model


def make_lite_extractor(cfg, params=None, generator=None, device="cuda"):
    """(extract, encoder): images -> (the global feature (B, D), its
    softmax) of ``models/damsm.py::build_image_encoder(cfg)``. ``params``:
    the encoder's state dict; by default fresh weights from ``generator``
    (seed 0), drawn on the CPU."""
    from objgan_tpu_torch.models.damsm import build_image_encoder

    enc = _module(build_image_encoder(cfg), params, generator, device)

    @torch.no_grad()
    def extract(images):
        _, global_f = enc(_on(images, device))
        # no classifier in lite mode: the feature softmax is returned for a
        # uniform interface; IS reads a fitted probe instead
        return global_f, torch.softmax(global_f, dim=-1)

    return extract, enc


def primary_labels(batch) -> np.ndarray:
    """(B,) int32 image-level labels: the class of each image's
    largest-area valid object, the label the lite-IS probe predicts.
    Images with no valid object get class 0 (background/STOP, which no
    real object uses)."""
    labels = to_numpy(batch["labels"])
    boxes = to_numpy(batch["boxes"]).astype(np.float32)
    valid = to_numpy(batch["obj_valid"]).astype(np.float32)
    area = boxes[..., 2] * boxes[..., 3] * valid
    idx = area.argmax(axis=1)
    lab = labels[np.arange(labels.shape[0]), idx].astype(np.int32)
    return np.where(valid.sum(axis=1) > 0, lab, 0).astype(np.int32)


def real_stats_cache_path(cfg, manifest: str, n_records: int, mode: str,
                          inception_pth: Optional[str] = None,
                          records=None,
                          image_root: Optional[str] = None,
                          kind: str = "real_stats",
                          n_classes: Optional[int] = None) -> str:
    """Disk-cache location, next to the manifest, for a manifest's
    real-side FID statistics (``kind="real_stats"``) or lite-IS probe
    (``"lite_probe"``, keyed by ``n_classes`` too).

    The key changes whenever the feature space or the data can have
    changed: the extractor (``TEXT.CNN_BACKBONE``, image size, embedding
    width, ``mode``), fingerprints (size and mtime) of the manifest, of the
    image files the ``records`` reference under ``image_root`` and of a
    strict weights file. It also holds ``torch``: the port's extractors
    draw other weights than the JAX package's, so the two packages must
    not read each other's statistics for one manifest."""
    def fingerprint(path):
        st = os.stat(path)
        return f"{st.st_size}:{st.st_mtime_ns}"

    parts = [
        "torch", os.path.abspath(manifest), fingerprint(manifest),
        str(n_records), mode, cfg.TEXT.CNN_BACKBONE,
        str(cfg.branch_sizes[-1]), str(cfg.TEXT.EMBEDDING_DIM),
    ]
    if records is not None:
        root = image_root or os.path.dirname(os.path.abspath(manifest))
        n = total = newest = 0
        for r in records:
            f = r.get("image_file")
            if not f:
                continue
            try:
                st = os.stat(os.path.join(root, f))
            except OSError:  # a missing file fails loudly later in the feed
                continue
            n += 1
            total += st.st_size
            newest = max(newest, st.st_mtime_ns)
        parts.append(f"imgs:{n}:{total}:{newest}")
    if inception_pth:
        parts += [os.path.abspath(inception_pth), fingerprint(inception_pth)]
    if n_classes is not None:
        parts.append(f"classes:{n_classes}")
    key = hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]
    return os.path.join(os.path.dirname(os.path.abspath(manifest)),
                        f".fid_{kind}_{key}.npz")


def save_npz_atomic(cache_path: str, **arrays) -> None:
    """Publish a cache file atomically: an interrupted or racing eval never
    leaves a truncated .npz behind."""
    tmp_path = cache_path + f".{os.getpid()}.tmp.npz"  # np.savez would
    # otherwise append .npz and break the rename
    np.savez(tmp_path, **arrays)
    os.replace(tmp_path, cache_path)


def save_stats_atomic(cache_path: str, mu, cov) -> None:
    """``save_npz_atomic`` of an FID statistics pair (``mu``, ``cov``)."""
    save_npz_atomic(cache_path, mu=mu, cov=cov)


def unique_epoch_batches(feed, n_unique: int):
    """Stream exactly ``n_unique`` (finest-scale images, primary labels)
    pairs from a feed, one batch at a time: every unique image once. The
    trailing batch's rows past ``n_unique`` (the next epoch's) are cut.
    Feeds without layouts give label 0 rows (stats-only passes)."""
    seen = 0
    for batch in iter(feed):
        img = to_numpy(batch["images"][-1])
        take = min(img.shape[0], n_unique - seen)
        lab = (primary_labels(batch) if "labels" in batch
               else np.zeros(img.shape[0], np.int32))
        yield img[:take], lab[:take]
        seen += take
        if seen >= n_unique:
            return


def unique_epoch_images(feed, n_unique: int):
    """Image-only view of :func:`unique_epoch_batches`."""
    for img, _ in unique_epoch_batches(feed, n_unique):
        yield img


def real_stats_and_probe(labeled_batches, extractor, n_classes: int,
                         need_stats: bool = True, need_probe: bool = True):
    """One streamed pass over (images, labels) batches giving whichever
    real-side artifacts are needed: the FID statistics (mu, cov) and/or the
    lite-IS class probe. Returns (stats or None, probe or None)."""
    acts, labs = [], []
    for img, lab in labeled_batches:
        acts.append(to_numpy(extractor(img)[0]))
        labs.append(np.asarray(lab))
    ra = np.concatenate(acts)
    if need_probe and not np.any(np.concatenate(labs)):
        # all-zero labels are unique_epoch_batches' placeholder for
        # label-less feeds: a probe fit on them gives a constant IS of 1.0
        raise ValueError(
            "lite-IS probe fitting requires real object labels, but this "
            "feed yielded all-zero labels (image-only feed or degenerate "
            "manifest) — pass need_probe=False for stats-only passes")
    if float(ra.std()) < 1e-6:
        print(_DEGENERATE.format(side="real"), flush=True)
    stats = activation_stats(ra) if need_stats else None
    probe = (fit_class_probe(ra, np.concatenate(labs), n_classes)
             if need_probe else None)
    return stats, probe


def real_activation_stats(real_batches: Iterable, extractor: Callable
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Stream real batches through the extractor into the FID statistics
    (mu, cov)."""
    ra = np.concatenate([to_numpy(extractor(b)[0]) for b in real_batches])
    if float(ra.std()) < 1e-6:
        print(_DEGENERATE.format(side="real"), flush=True)
    return activation_stats(ra)


def compute_fid_is(
    real_batches: Iterable,
    fake_batches: Iterable,
    extractor: Callable,
    real_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    fake_activations: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[float, Tuple[float, float]]:
    """(fid, (is_mean, is_std)). ``real_stats=(mu, cov)`` skips the real
    pass; ``fake_activations=(acts, probs)`` skips the fake pass (an eval
    loop that extracts as it samples keeps no pixels resident)."""
    if real_stats is None:
        real_stats = real_activation_stats(real_batches, extractor)
    if fake_activations is not None:
        fa, fprobs = (np.asarray(fake_activations[0]),
                      np.asarray(fake_activations[1]))
    else:
        outs = [extractor(b) for b in fake_batches]
        fa = np.concatenate([to_numpy(a) for a, _ in outs])
        fprobs = np.concatenate([to_numpy(p) for _, p in outs])
    if float(fa.std()) < 1e-6:
        print(_DEGENERATE.format(side="fake"), flush=True)
    mu_f, cov_f = activation_stats(fa)
    fid = frechet_from_stats(real_stats[0], real_stats[1], mu_f, cov_f)
    return fid, inception_score(fprobs)
