"""Lineage GAN ``.pth`` files -> a Stage-C checkpoint of the port (the
``TRAIN.NET_G`` flow). Port of ``objgan_tpu/tools/convert_gan.py``.

The lineage samples and resumes from ``TRAIN.NET_G`` (``netG_epoch_N.pth``)
and one ``netD*.pth`` per scale. This tool loads those state dicts best
effort through the name maps (``core/name_maps.py``: BatchNorm and the
layout-conditioning divergences are skipped, with a printed report) into a
``GanTrainer`` and writes it as step 0, which the port's samplers and
trainers read:

    python -m objgan_tpu_torch.tools.convert_gan --cfg cfg/coco_objgan.yml \
        --g_pth netG_epoch_600.pth \
        --d_pth netD64.pth --d_pth netD128.pth --d_pth netD256.pth \
        --out ckpts/coco_gan_converted

then set ``TRAIN.NET_G: ckpts/coco_gan_converted`` (``cli.sample_gan``
restores from exactly that directory). The DAMSM encoders come from
``TRAIN.NET_E`` (``tools/convert_damsm``): restoring this checkpoint
replaces whatever encoders a sampler loaded first. Files are loaded with
``weights_only=True`` (``convert_damsm.load_state_dict``). The conversion
runs on the CPU: it computes nothing.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def _report(tag: str, report: dict) -> None:
    print(f"{tag}: loaded {len(report['loaded'])} params; "
          f"skipped {len(report['skipped_bn'])} BatchNorm entries "
          f"(GroupNorm divergence), {len(report['skipped_shape'])} "
          f"shape-mismatched, {len(report['missing_target'])} "
          f"missing-target (stale map entry / shrunken config), "
          f"{len(report['unmapped'])} unmapped")
    for name in report["skipped_shape"]:
        print(f"  shape-mismatch: {name}")
    for name in report["missing_target"]:
        print(f"  missing-target: {name}")


def convert(cfg, g_pth: Optional[str], d_pths: Sequence[str], out_dir: str):
    """Build a ``GanTrainer`` with lineage G / D weights loaded and save it
    as step 0 under ``out_dir``. Returns the trainer (on the CPU)."""
    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.checkpoint import CheckpointManager
    from objgan_tpu_torch.core.name_maps import (d_net_name_map,
                                                 g_net_name_map,
                                                 load_lineage_partial)
    from objgan_tpu_torch.tools.convert_damsm import load_state_dict

    sizes = cfg.branch_sizes
    if d_pths and len(d_pths) != len(sizes):
        raise SystemExit(f"--d_pth must be given once per pyramid scale "
                         f"{sizes} in that order (got {len(d_pths)})")
    # the encoders of TRAIN.NET_E: restoring this checkpoint later (the
    # samplers, the eval) overwrites the encoders the restorer loaded
    # first, so random ones here would replace pretrained ones
    text_enc, img_enc = cli.load_damsm_encoders(cfg)
    if text_enc is None:
        print("WARNING: no pretrained DAMSM checkpoint found "
              "(TRAIN.NET_E) — the converted checkpoint will carry "
              "RANDOM text/image encoders, and restoring it overwrites "
              "any encoders loaded at sampling time. Run "
              "tools/convert_damsm first and set TRAIN.NET_E, then "
              "re-convert.")
    trainer = cli.make_trainer(cfg, "cpu", text_enc, img_enc)
    if g_pth:
        _, rep = load_lineage_partial(trainer.g_net, load_state_dict(g_pth),
                                      g_net_name_map(cfg))
        _report("G_NET", rep)
        trainer.sync_ema()  # sampling reads the EMA copy
    for dnet, pth, size in zip(trainer.d_nets, d_pths, sizes):
        _, rep = load_lineage_partial(dnet, load_state_dict(pth),
                                      d_net_name_map(cfg, size))
        _report(f"D_NET{size}", rep)
    CheckpointManager(out_dir).save(0, trainer)
    print(f"wrote GanTrainer checkpoint (step 0) to {out_dir}\n"
          f"point cfg.TRAIN.NET_G at this directory for sampling, or use "
          f"it as the training ckpt dir to resume")
    return trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", dest="cfg_file", default=None)
    ap.add_argument("--g_pth", default=None, help="lineage netG_epoch_N.pth")
    ap.add_argument("--d_pth", action="append", default=[],
                    help="lineage netD .pth, once per scale (64, 128, 256)")
    ap.add_argument("--out", required=True,
                    help="output checkpoint directory (NET_G target)")
    args = ap.parse_args(argv)
    if not args.g_pth and not args.d_pth:
        ap.error("give at least one of --g_pth / --d_pth")

    from objgan_tpu_torch.core.config import Config, cfg_from_file

    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    convert(cfg, args.g_pth, args.d_pth, args.out)


if __name__ == "__main__":
    main()
