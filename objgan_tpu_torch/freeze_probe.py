"""The frozen cross-manifest lite-IS artifact (``assets/frozen_lite.npz``).
Port of ``objgan_tpu/tools/freeze_probe.py``.

The artifact freezes both halves of one lite-IS metric: a DAMSM lite
image encoder trained once on the reference manifest (the feature space)
and an 81-way linear probe fit on that manifest's real images (the class
head). The eval prints a "frozen lite-IS" line over it whose scale is
comparable across manifests.

The file holds the encoder's parameters in the JAX package's layout under
flax-flattened keys (``enc/params/_ConvBlock_0/Conv_0/kernel``, ...), the
probe under ``probe/``, and ``meta/{embedding_dim, image_size, n_classes,
backbone}``. It is read here with numpy alone and written in the same
layout, so either package reads the other's artifact.

Fit a new one from a DAMSM checkpoint of this package:

    python -m objgan_tpu_torch.freeze_probe --cfg <yml> \
        --manifest data_proc2k/manifest.json [--damsm <ckpt dir>] \
        [--out assets/frozen_lite.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

_META_KEYS = ("embedding_dim", "image_size", "n_classes")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v
    return tree


def save_frozen_artifact(path: str, enc_params: Mapping, probe: dict, *,
                         embedding_dim: int, image_size: int,
                         n_classes: int, backbone: str = "lite") -> None:
    """One .npz: the encoder's JAX-layout param tree (``enc_params``, e.g.
    ``{"params": core.bridge.torch_to_jax(encoder)}``) flattened with "/",
    the probe, and the config fields that rebuild the extractor whatever
    the eval run's config."""
    payload = {f"enc/{k}": v for k, v in _flatten(enc_params).items()}
    for k, v in probe.items():
        payload[f"probe/{k}"] = np.asarray(v)
    payload["meta/embedding_dim"] = np.int64(embedding_dim)
    payload["meta/image_size"] = np.int64(image_size)
    payload["meta/n_classes"] = np.int64(n_classes)
    payload["meta/backbone"] = np.str_(backbone)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def load_frozen_artifact(path: str):
    """(encoder param tree (JAX layout, nested dicts of numpy arrays),
    probe dict, meta dict)."""
    with np.load(path, allow_pickle=False) as z:
        params = _unflatten({k[len("enc/"):]: z[k] for k in z.files
                             if k.startswith("enc/")})
        probe = {k[len("probe/"):]: z[k] for k in z.files
                 if k.startswith("probe/")}
        meta = {k: int(z[f"meta/{k}"]) for k in _META_KEYS}
        meta["backbone"] = str(z["meta/backbone"])
    return params, probe, meta


def make_frozen_extractor(path: str, device="cuda"):
    """(extract, probe, meta) from a frozen artifact. The lite encoder is
    rebuilt at the artifact's widths, not the eval config's, and incoming
    images are resized to its ``image_size`` when they differ: bilinear
    with antialias, as ``jax.image.resize`` by default."""
    from objgan_tpu_torch.core.bridge import load_jax_params
    from objgan_tpu_torch.core.config import Config
    from objgan_tpu_torch.models.damsm import build_image_encoder

    params, probe, meta = load_frozen_artifact(path)
    if meta["backbone"] != "lite":
        raise ValueError(f"frozen artifact backbone {meta['backbone']!r} "
                         "unsupported (expected 'lite')")
    cfg = Config().merged({"TEXT": {"EMBEDDING_DIM": meta["embedding_dim"],
                                    "CNN_BACKBONE": "lite"}})
    enc = build_image_encoder(cfg)
    load_jax_params(enc, params)
    enc = enc.to(device)
    size = meta["image_size"]

    @torch.no_grad()
    def extract(images):
        x = torch.as_tensor(images).to(device).float()
        if x.shape[1] != size or x.shape[2] != size:
            x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                              mode="bilinear", align_corners=False,
                              antialias=True).permute(0, 2, 3, 1)
        return enc(x)[1]

    return extract, probe, meta


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Fit and write the frozen lite-IS artifact from a DAMSM "
                    "checkpoint of this package.")
    ap.add_argument("--cfg", dest="cfg_file", default=None)
    ap.add_argument("--manifest", required=True,
                    help="reference manifest the frozen space is fit on "
                         "(the committed data_proc2k); its images are read "
                         "relative to its directory")
    ap.add_argument("--damsm", default=None,
                    help="DAMSM ckpt dir (default: cfg TRAIN.NET_E or "
                         "OUTPUT_DIR/<name>_damsm/ckpt)")
    ap.add_argument("--out", default="assets/frozen_lite.npz")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    from objgan_tpu_torch.cli import load_damsm_encoders
    from objgan_tpu_torch.core.bridge import torch_to_jax
    from objgan_tpu_torch.core.config import Config, cfg_from_file
    from objgan_tpu_torch.core.precision import true_fp32
    from objgan_tpu_torch.data.pipeline import CocoFeed, load_records_json
    from objgan_tpu_torch.data.tokenizer import Vocab
    from objgan_tpu_torch.utils.eval_metrics import fit_class_probe
    from objgan_tpu_torch.utils.fid_runner import (make_lite_extractor,
                                                   to_numpy,
                                                   unique_epoch_batches)

    true_fp32()
    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    if args.damsm:
        cfg = cfg.merged({"TRAIN": {"NET_E": args.damsm}})
    cfg = cfg.replace(DATA_DIR=os.path.dirname(args.manifest) or ".")
    records = load_records_json(args.manifest)
    vocab = Vocab.build(c for r in records for c in r["captions"])
    feed = CocoFeed(cfg, records, vocab, seed=cfg.RNG_SEED, augment=False,
                    with_masks=False)
    _, img_params = load_damsm_encoders(cfg)
    if img_params is None:
        raise SystemExit(
            "no pretrained DAMSM checkpoint found — a frozen probe over an "
            "untrained encoder would freeze noise; pretrain first (python -m "
            "objgan_tpu_torch.pretrain_damsm) and pass --damsm its ckpt dir")
    extractor, enc = make_lite_extractor(cfg, params=img_params,
                                         device=args.device)
    acts, labs = [], []
    for img, lab in unique_epoch_batches(feed, len(records)):
        acts.append(to_numpy(extractor(img)[0]))
        labs.append(lab)
    probe = fit_class_probe(np.concatenate(acts), np.concatenate(labs),
                            cfg.OBJ.NUM_CLASSES)
    print(f"frozen probe fit on {len(records)} real images: "
          f"train acc {probe['train_acc']:.3f}, "
          f"holdout acc {probe['holdout_acc']:.3f}")
    save_frozen_artifact(
        args.out, {"params": torch_to_jax(enc)}, probe,
        embedding_dim=cfg.TEXT.EMBEDDING_DIM,
        image_size=cfg.branch_sizes[-1],
        n_classes=cfg.OBJ.NUM_CLASSES)
    print(f"wrote {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
