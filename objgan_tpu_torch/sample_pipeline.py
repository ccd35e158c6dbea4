"""Composed caption -> layout -> masks -> image sampling of the PyTorch
port, mirroring ``sample_pipeline.py``:

    python -m objgan_tpu_torch.sample_pipeline --cfg cfg/eval_coco.yml \
        --manifest data_proc2k/manifest.json \
        --caption "two dogs play in a park" --out out_dir [--device cpu]

Each stage is restored from its newest checkpoint
(``ObjGanPipeline.load_states``: ``OUTPUT_DIR/<CONFIG_NAME>_{box,shape,gan}
/ckpt``, the gan stage from ``TRAIN.NET_G`` when set); one PNG per caption
and its layout on stdout. The noise is drawn from ``RNG_SEED``. Runs on the
CUDA device unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Caption -> layout -> masks -> image, every stage from "
                    "its checkpoint.")
    ap.add_argument("--cfg", dest="cfg_file", default=None)
    ap.add_argument("--caption", action="append", default=None)
    ap.add_argument("--captions_file", default=None,
                    help="text file, one caption per line")
    ap.add_argument("--captions_pickle", default=None)
    ap.add_argument("--manifest", default=None,
                    help="training manifest: build the vocab from its "
                         "captions so token ids match the trained "
                         "checkpoints")
    ap.add_argument("--out", default="output/pipeline_samples")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from objgan_tpu_torch.core.config import Config, cfg_from_file
    from objgan_tpu_torch.core.precision import true_fp32
    from objgan_tpu_torch.data.tokenizer import Vocab
    from objgan_tpu_torch.pipeline_e2e import ObjGanPipeline, draw_noise
    from objgan_tpu_torch.utils.visualize import _to_uint8, save_png

    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    captions = list(args.caption or [])
    if args.captions_file:
        with open(args.captions_file, encoding="utf-8") as f:
            captions += [ln.strip() for ln in f if ln.strip()]
    captions = captions or ["a person riding a horse on a beach"]
    if args.captions_pickle:
        vocab = Vocab.from_reference_pickle(args.captions_pickle)
    elif args.manifest:
        with open(args.manifest, encoding="utf-8") as f:
            records = json.load(f)
        vocab = Vocab.build(c for r in records for c in r["captions"])
    else:
        vocab = Vocab.build(captions)
        # a caption-local vocabulary cannot match a trained checkpoint's
        print("WARNING: no --manifest / --captions_pickle given — built a "
              "vocab from the sample captions themselves. If trained "
              "checkpoints are restored below, their token ids will NOT "
              "match this vocab; pass the training manifest (or the "
              "reference captions.pickle) for correct embeddings.")
    if len(vocab) > cfg.TEXT.VOCAB_SIZE:
        raise SystemExit(
            f"vocabulary has {len(vocab)} words but cfg.TEXT.VOCAB_SIZE is "
            f"{cfg.TEXT.VOCAB_SIZE}; raise it (the embedding would index "
            f"past its table)")
    ids, lens = vocab.encode_batch(captions, cfg.TEXT.WORDS_NUM)

    device = torch.device(args.device)
    true_fp32()
    pipe = ObjGanPipeline.load_states(cfg, device=device)
    noise = draw_noise(cfg, len(captions),
                       torch.Generator(device=device).manual_seed(
                           cfg.RNG_SEED), device)
    out = pipe.generate(torch.from_numpy(ids).long().to(device),
                        torch.from_numpy(lens).long().to(device), noise)

    os.makedirs(args.out, exist_ok=True)
    imgs = out["images"][-1].float().cpu().numpy()
    labels = out["labels"].cpu().numpy()
    boxes = out["boxes"].cpu().numpy()
    valid = out["obj_valid"].cpu().numpy()
    for i, cap in enumerate(captions):
        save_png(os.path.join(args.out, f"pipe_{i}.png"), _to_uint8(imgs[i]))
        kept = [(int(lab), [round(float(x), 3) for x in box])
                for lab, box, v in zip(labels[i], boxes[i], valid[i]) if v]
        print(f"{cap!r} -> {len(kept)} objects {kept}")
    print(f"wrote {len(captions)} images to {args.out}")


if __name__ == "__main__":
    main()
