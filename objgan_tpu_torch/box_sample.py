"""Stage-A sampling and evaluation entry point of the PyTorch port,
mirroring ``box_generation/sample.py``:

    python -m objgan_tpu_torch.box_sample --cfg <yml> --caption "two dogs" \
        [--beam_size 3] [--output layout.json] [--device cpu]
    python -m objgan_tpu_torch.box_sample --cfg <yml> --eval \
        --manifest data_proc2k/manifest.json --num_batches 2

Caption -> layout with the newest Stage-A checkpoint of the config
(temperature sampling, or beam search when ``BOX.BEAM_SIZE`` > 1); with
``--eval``, the held-out NLL and the layout statistics of temperature
sampling and beam search side by side (``B_VALIDATION: true`` feeds the
held-out split). Runs on the CUDA device unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import numpy as np


def main(argv=None) -> None:
    from objgan_tpu_torch import cli
    from objgan_tpu_torch.box_opts import parse_opts, to_config
    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.data.tokenizer import Vocab

    args = parse_opts(argv)
    cfg = to_config(args)
    if args.eval:
        # the sampling path: B_VALIDATION serves the held-out split
        cfg = cfg.merged({"TRAIN": {"FLAG": False}})
        feed, _, _ = build_feed(cfg, args.manifest, args.captions_pickle,
                                with_images=False, wire=args.wire)
        cli.eval_box(cfg, feed, num_batches=args.num_batches,
                     device=args.device)
        return
    captions = args.caption or ["a person riding a horse on a beach"]
    vocab = (Vocab.from_reference_pickle(args.captions_pickle)
             if args.captions_pickle else Vocab.build(captions))
    caps, lens = vocab.encode_batch(captions, cfg.TEXT.WORDS_NUM)
    cfg = cfg.merged({"TEXT": {"VOCAB_SIZE": max(len(vocab),
                                                 cfg.TEXT.VOCAB_SIZE)}})
    layout = cli.sample_box(cfg, np.asarray(caps), np.asarray(lens),
                            out_path=args.output, device=args.device)
    for i, cap in enumerate(captions):
        kept = [(int(lab), [round(x, 3) for x in box])
                for lab, box, v in zip(layout["labels"][i],
                                       layout["boxes"][i],
                                       layout["obj_valid"][i]) if v]
        print(f"{cap!r} -> {kept}")


if __name__ == "__main__":
    main()
