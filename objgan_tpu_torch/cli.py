"""Stage-C command-line paths of the port: train and sample. Port of
``objgan_tpu/cli.py::train_gan``, ``sample_gan`` and ``_feed``.

Both run on the synthetic COCO-shaped feed (``data/synthetic.py``) with
fresh weights from ``cfg.RNG_SEED``: checkpoint save and resume, the
pretrained-DAMSM loader, the manifest feed and the attention-grid
snapshots are not ported yet (ROADMAP.md, slice 3).
Everything runs on ``device`` ("cuda" unless the caller says otherwise);
nothing moves to the CPU on its own.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core.precision import true_fp32
from objgan_tpu_torch.data.synthetic import synthetic_batch
from objgan_tpu_torch.train.gan import GanTrainer, train_noise


def make_trainer(cfg: Config, device) -> GanTrainer:
    """A Stage-C trainer with fresh weights from ``cfg.RNG_SEED`` (drawn on
    the CPU, so a seed gives the same weights on every device) on
    ``device``. Warns that no pretrained encoder or checkpoint is loaded."""
    true_fp32()
    trainer = GanTrainer(cfg).init_state(
        torch.Generator().manual_seed(cfg.RNG_SEED))
    print("WARNING: no checkpoint or pretrained DAMSM loader in the PyTorch "
          "port yet — Stage C starts from UNTRAINED random weights and "
          "frozen random encoders", file=sys.stderr)
    return trainer.to(device)


def train_gan(cfg: Config, max_steps: int = 10 ** 9, device="cuda",
              log_every: int = 50) -> GanTrainer:
    """Stage-C adversarial training. Prints one metric line
    ``[step N] name=value ...`` at the first step, every ``log_every``
    steps and at the last step; ``steps_per_sec`` there is over the steps
    since the previous line, synchronised. Returns the trainer."""
    device = torch.device(device)
    trainer = make_trainer(cfg, device)
    gen = torch.Generator(device=device).manual_seed(cfg.RNG_SEED)
    last_logged, t_last = trainer.step, time.monotonic()
    while trainer.step < max_steps:
        batch = synthetic_batch(cfg, gen)
        b = batch["captions"].shape[0]
        noise = train_noise(cfg, b, gen, device)
        metrics = trainer.train_step(batch, noise["z"], noise["ca_eps"])
        step = trainer.step
        if (step - last_logged >= log_every or step == 1
                or step == max_steps):
            vals = {k: float(v) for k, v in metrics.items()}  # synchronises
            now = time.monotonic()
            vals["steps_per_sec"] = (step - last_logged) / max(now - t_last,
                                                               1e-9)
            last_logged, t_last = step, now
            print(f"[step {step}] " + " ".join(
                f"{k}={v:.5g}" for k, v in vals.items()), flush=True)
    return trainer


def sample_gan(cfg: Config, num_batches: int = 10, device="cuda") -> str:
    """Stage-C sampling with the EMA generator: one PNG per image into
    ``OUTPUT_DIR/<CONFIG_NAME>_gan_samples``. Returns that directory."""
    from objgan_tpu_torch.utils.visualize import _to_uint8, save_png

    device = torch.device(device)
    out = os.path.join(cfg.OUTPUT_DIR, f"{cfg.CONFIG_NAME}_gan_samples")
    os.makedirs(out, exist_ok=True)
    trainer = make_trainer(cfg, device)
    gen = torch.Generator(device=device).manual_seed(cfg.RNG_SEED)
    n = 0
    for i in range(num_batches):
        batch = synthetic_batch(cfg, gen)
        noise = train_noise(cfg, batch["captions"].shape[0], gen, device)
        imgs = trainer.sample(batch, noise["z"], noise["ca_eps"])["images"]
        imgs = imgs[-1].cpu().numpy()
        for j in range(imgs.shape[0]):
            save_png(os.path.join(out, f"s{i}_{j}.png"), _to_uint8(imgs[j]))
        n += imgs.shape[0]
    print(f"wrote {n} samples to {out}")
    return out
