"""The port's serving front end on the CPU: request parsing, fixed-batch
packing with a padded ragged tail, response order, PNGs, and the
``python -m objgan_tpu_torch.serve`` CLI end to end in a subprocess that
must import neither JAX nor anything of the JAX package."""

import json
import os
import subprocess
import sys

import pytest
import torch
import yaml

from objgan_tpu_torch.data.tokenizer import Vocab
from objgan_tpu_torch.serving import parse_requests, run_serve
from tests.test_torch_data import FORBIDDEN_MODULES
from tests.torch_parity import ttiny as tiny

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAPTIONS = [f"a cat number {w}" for w in ("one", "two", "three", "four",
                                          "five")]


def test_parse_requests_json_bare_and_blank():
    got = list(parse_requests([
        '{"id": "a", "caption": "two dogs"}', "", "a plain caption",
        '{"caption": "no id"}', "{not json",
    ]))
    assert got == [
        {"id": "a", "caption": "two dogs"},
        {"id": 2, "caption": "a plain caption"},
        {"id": 3, "caption": "no id"},
        {"id": 4, "caption": "{not json"},
    ]
    with pytest.raises(ValueError, match="without a 'caption'"):
        list(parse_requests(['{"id": 1}']))


def test_run_serve_ragged_tail_and_order(tmp_path):
    """5 requests at batch 4 -> 2 batches (the tail padded to 4), exactly
    5 responses in request order, one PNG each."""
    cfg = tiny("bfloat16")
    vocab = Vocab.build(CAPTIONS)
    reqs = [{"id": i, "caption": c} for i, c in enumerate(CAPTIONS)]
    got = []
    stats = run_serve(cfg, vocab, reqs, str(tmp_path / "out"), batch_size=4,
                      emit=got.append, device="cpu")
    assert stats["requests"] == 5 and stats["batches"] == 2
    assert len(stats["batch_done_s"]) == 2
    assert [r["id"] for r in got] == list(range(5))
    assert [r["caption"] for r in got] == CAPTIONS
    for r in got:
        assert os.path.exists(r["image"])
        for label, box in r["objects"]:
            assert 1 <= label < cfg.OBJ.NUM_CLASSES and len(box) == 4


def test_run_serve_turns_tf32_off(tmp_path):
    """fp32 means fp32 on the card: the entry point turns cuDNN's TF32 off
    and keeps fp32 matmuls at "highest" before it builds a model."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        run_serve(tiny("float32"), Vocab.build(CAPTIONS[:1]),
                  [{"id": 0, "caption": CAPTIONS[0]}], str(tmp_path),
                  batch_size=1, save_images=False, device="cpu")
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cudnn.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def test_run_serve_rejects_oversized_vocab(tmp_path):
    cfg = tiny("float32")
    vocab = Vocab.build([f"w{i}" for i in range(cfg.TEXT.VOCAB_SIZE)])
    with pytest.raises(ValueError, match="VOCAB_SIZE"):
        run_serve(cfg, vocab, [], str(tmp_path), device="cpu")


def _tiny_yml(path):
    cfg = {
        "TRAIN": {"FLAG": False, "BATCH_SIZE": 2},
        "TREE": {"BASE_SIZE": 16},
        "GAN": {"DF_DIM": 8, "GF_DIM": 8, "Z_DIM": 16, "CONDITION_DIM": 16},
        "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 6, "VOCAB_SIZE": 50,
                 "HIDDEN_DIM": 16, "GLOVE_DIM": 16},
        "OBJ": {"MAX_OBJECTS": 3, "NUM_CLASSES": 7, "ROI_SIZE": 4,
                "LABEL_DIM": 16, "GMM_COMPONENTS": 4, "SHAPE_SIZE": 16},
        "BOX": {"RNN_SIZE": 32, "INPUT_ENCODING_SIZE": 16, "ATT_HID_SIZE": 16,
                "MAX_SEQ_LENGTH": 4},
        "SHAPE": {"GF_DIM": 8, "DF_DIM": 8, "HIDDEN_DIM": 8},
    }
    path.write_text(yaml.safe_dump(cfg))


def test_serve_cli_never_imports_jax(tmp_path):
    yml = tmp_path / "tiny.yml"
    _tiny_yml(yml)
    req = tmp_path / "req.jsonl"
    req.write_text("\n".join(json.dumps({"id": f"r{i}", "caption": c})
                             for i, c in enumerate(CAPTIONS[:3])) + "\n")
    out = tmp_path / "served"
    code = (
        "import runpy, sys\n"
        "sys.argv = ['serve', '--cfg', sys.argv[1], '--input', sys.argv[2],"
        " '--out', sys.argv[3], '--vocab_from_input', '--device', 'cpu']\n"
        "runpy.run_module('objgan_tpu_torch.serve', run_name='__main__')\n"
        + FORBIDDEN_MODULES)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(yml), str(req), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln]
    assert [r["id"] for r in lines] == ["r0", "r1", "r2"]
    assert all(os.path.exists(r["image"]) for r in lines)
    assert "UNTRAINED" in proc.stderr
    stats = json.loads(proc.stderr.strip().splitlines()[-1])["served"]
    assert stats["requests"] == 3 and stats["batches"] == 2
