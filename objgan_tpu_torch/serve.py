"""Batch-serving CLI of the PyTorch port: stream captions in, get images and
layouts out.

    python -m objgan_tpu_torch.serve --cfg cfg/eval_coco.yml \
        --vocab_from_input --input requests.jsonl --out served/

Same flags and output as ``serve.py`` plus ``--device`` (default ``cuda``)
and ``--output_dir``: one JSON response per request on stdout,
``serve_<id>.png`` per request, the run's stats as JSON on stderr. Each
stage is restored from its newest checkpoint under ``--output_dir``
(default ``OUTPUT_DIR``), ``<CONFIG_NAME>_{box,shape,gan}/ckpt``; a stage
without one runs with untrained weights, and the run says so on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cfg", dest="cfg_file", default=None)
    ap.add_argument("--input", default="-",
                    help="request file, one caption/JSON per line ('-' = "
                         "stdin)")
    ap.add_argument("--out", default="output/served")
    ap.add_argument("--batch", type=int, default=None,
                    help="static serving batch (default TRAIN.BATCH_SIZE)")
    ap.add_argument("--captions_pickle", default=None)
    ap.add_argument("--manifest", default=None,
                    help="training manifest: builds the vocab its "
                         "checkpoints were trained with")
    ap.add_argument("--vocab_from_input", action="store_true",
                    help="SMOKE-TEST ONLY: build the vocab from the request "
                         "captions themselves (reads the whole input up "
                         "front; token ids cannot match any trained "
                         "checkpoint)")
    ap.add_argument("--output_dir", default=None,
                    help="where the stages' checkpoints are (default "
                         "OUTPUT_DIR)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on")
    args = ap.parse_args(argv)

    from objgan_tpu_torch.core.config import Config, cfg_from_file
    from objgan_tpu_torch.data.tokenizer import Vocab
    from objgan_tpu_torch.serving import parse_requests, run_serve

    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    lines = (sys.stdin if args.input == "-"
             else open(args.input, encoding="utf-8"))
    reqs = None
    if args.captions_pickle:
        vocab = Vocab.from_reference_pickle(args.captions_pickle)
    elif args.manifest:
        with open(args.manifest, encoding="utf-8") as f:
            records = json.load(f)
        vocab = Vocab.build(c for r in records for c in r["captions"])
    elif args.vocab_from_input:
        reqs = list(parse_requests(lines))
        vocab = Vocab.build(r["caption"] for r in reqs)
        print("WARNING: --vocab_from_input builds token ids that cannot "
              "match any trained checkpoint; pass --manifest or "
              "--captions_pickle for real serving", file=sys.stderr)
    else:
        raise SystemExit(
            "serve needs the training vocabulary: pass --manifest or "
            "--captions_pickle (or --vocab_from_input for an untrained "
            "smoke test)")
    requests = reqs if reqs is not None else parse_requests(lines)

    def emit(resp):
        print(json.dumps(resp), flush=True)

    try:
        stats = run_serve(cfg, vocab, requests, args.out,
                          batch_size=args.batch, emit=emit,
                          device=args.device, output_dir=args.output_dir)
    finally:
        if lines is not sys.stdin:
            lines.close()
    print(json.dumps({"served": stats}), file=sys.stderr)


if __name__ == "__main__":
    main()
