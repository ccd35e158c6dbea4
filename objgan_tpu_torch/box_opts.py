"""Stage-A command-line flags of the PyTorch port, the counterpart of
``box_generation/opts.py``: the reference's flags mapped onto the config
tree, plus ``--device`` (default ``cuda``), ``--data_dir`` (sets
``DATA_DIR``) and ``--log_every``."""

from __future__ import annotations

import argparse

_CHECKPOINTS = ("Resumes from, or samples, the newest step under OUTPUT_DIR/"
                "<CONFIG_NAME>_box/ckpt: the port's state.pt or a JAX run's "
                "Orbax step; writes state.pt only.")


def parse_opts(argv=None):
    p = argparse.ArgumentParser(description="Stage A: caption -> layout.",
                                epilog=_CHECKPOINTS)
    p.add_argument("--cfg", dest="cfg_file", default=None)
    p.add_argument("--rnn_size", type=int, default=None)
    p.add_argument("--input_encoding_size", type=int, default=None)
    p.add_argument("--att_hid_size", type=int, default=None)
    p.add_argument("--max_seq_length", type=int, default=None)
    p.add_argument("--beam_size", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--grad_clip", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--max_steps", type=int, default=10 ** 9)
    p.add_argument("--manifest", default=None)
    p.add_argument("--wire", action="store_true",
                   help="compact uint8 wire batches (data/wire.py)")
    p.add_argument("--captions_pickle", default=None)
    p.add_argument("--data_dir", default=None,
                   help="sets DATA_DIR, the directory the manifest's "
                        "image_file paths are relative to")
    p.add_argument("--caption", action="append", default=None,
                   help="(box_sample) caption text; repeatable")
    p.add_argument("--output", default=None,
                   help="(box_sample) layout JSON output path")
    p.add_argument("--eval", action="store_true",
                   help="(box_sample) held-out NLL and layout statistics "
                        "instead of free sampling")
    p.add_argument("--num_batches", type=int, default=10,
                   help="(box_sample --eval) held-out batches to evaluate")
    p.add_argument("--log_every", type=int, default=50,
                   help="(box_train) steps between metric lines")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    return p.parse_args(argv)


def to_config(args):
    from objgan_tpu_torch.core.config import Config, cfg_from_file

    cfg = cfg_from_file(args.cfg_file) if args.cfg_file else Config()
    box = {}
    for flag, key in [
        ("rnn_size", "RNN_SIZE"),
        ("input_encoding_size", "INPUT_ENCODING_SIZE"),
        ("att_hid_size", "ATT_HID_SIZE"),
        ("max_seq_length", "MAX_SEQ_LENGTH"),
        ("beam_size", "BEAM_SIZE"),
        ("temperature", "TEMPERATURE"),
        ("learning_rate", "LEARNING_RATE"),
        ("grad_clip", "GRAD_CLIP"),
    ]:
        v = getattr(args, flag)
        if v is not None:
            box[key] = v
    over = {"BOX": box} if box else {}
    if args.batch_size is not None:
        over["TRAIN"] = {"BATCH_SIZE": args.batch_size}
    if args.data_dir:
        over["DATA_DIR"] = args.data_dir
    return cfg.merged(over) if over else cfg
