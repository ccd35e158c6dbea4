"""A benchmark root at a CPU test's size: a procedural manifest of 64 px
records, a tiny Stage-C configuration and one training cell, with the
repo's drivers and metric readers copied beside them."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

TINY = {
    "CONFIG_NAME": "tiny", "DTYPE": "bfloat16",
    "TREE": {"BRANCH_NUM": 3, "BASE_SIZE": 16},
    "TRAIN": {"FLAG": True, "BATCH_SIZE": 4, "DISCRIMINATOR_LR": 0.0002,
              "GENERATOR_LR": 0.0002,
              "SMOOTH": {"GAMMA1": 4.0, "GAMMA2": 5.0, "GAMMA3": 10.0,
                         "LAMBDA": 50.0}},
    "GAN": {"DF_DIM": 8, "GF_DIM": 8, "Z_DIM": 16, "CONDITION_DIM": 16,
            "R_NUM": 2},
    "TEXT": {"EMBEDDING_DIM": 32, "WORDS_NUM": 8, "VOCAB_SIZE": 200,
             "HIDDEN_DIM": 16, "GLOVE_DIM": 16},
    "OBJ": {"MAX_OBJECTS": 3, "NUM_CLASSES": 81, "ROI_SIZE": 4,
            "LABEL_DIM": 16, "SHAPE_SIZE": 16},
}

CELL = "tiny.train_k2"


def make_tiny_root(root: str, n_records: int = 16, k: int = 2) -> str:
    """Write the tiny benchmark under ``root``; returns ``root``."""
    from objgan_tpu_torch.data.procedural import build_manifest

    for sub in ("metrics", "drivers"):
        shutil.copytree(os.path.join(BENCH, sub),
                        os.path.join(root, "h100bench", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(root, "h100bench", "configs"))
    os.makedirs(os.path.join(root, "h100bench", "traffic"))
    build_manifest(os.path.join(root, "data"), n_records, 64, seed=1)
    with open(os.path.join(root, "h100bench", "configs", "tiny.json"),
              "w") as f:
        json.dump({"source": "test", "reduced": [], "config": TINY}, f)
    traffic = {
        "driver": "train_loop", "manifest": "data/manifest.json",
        "wire": True, "grain": False,
        "config": {"TRAIN": {"STEPS_PER_EXECUTION": k,
                             "SNAPSHOT_STEPS": 10 ** 9}},
        "setup_steps": 3 * k if k > 1 else 4, "log_every": 50,
        "trace_span": [1, 1],
        "limits": {"loss1_gap": 0.01, "grad_gap_median": 0.01,
                   "grad_diff_median": 0.01, "grad_gap_matrix": 0.05,
                   "change_gap_median": 0.05, "replay_loss_gap": 0.01,
                   "replay_grad_gap_median": 0.01,
                   "replay_grad_diff_median": 0.01},
    }
    with open(os.path.join(root, "h100bench", "traffic", "tiny_k2.json"),
              "w") as f:
        json.dump(traffic, f)
    bench = {
        "command": ["python3", "h100bench/run.py"], "paths": ["h100bench"],
        "run_seconds": 1,
        "configs": [{"name": "tiny", "source": "test",
                     "file": "h100bench/configs/tiny.json", "reduced": [],
                     "why": "test"}],
        "workloads": [{"name": CELL, "config": "tiny",
                       "traffic": "tiny_k2", "chips": 1, "why": "test"}],
        "end_to_end": [
            {"name": "train_step_ms", "unit": "ms", "better": "lower",
             "bound": 0.05, "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": "train.feed_ms", "unit": "ms", "better": "lower",
             "source": "host_clock", "layer": "host feed",
             "moves": "train_step_ms"}],
    }
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
