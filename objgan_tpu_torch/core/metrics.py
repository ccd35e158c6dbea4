"""Structured metrics logging: one CSV row per logged step, mirrored to
stdout. A copy of ``objgan_tpu/core/metrics.py::MetricsWriter`` without its
optional TensorBoard branch (it imported tensorflow), so that the port
imports nothing of the JAX package; ``tests/test_torch_data.py`` holds the
two writers to identical CSV bytes. Under data parallelism only rank 0
writes and prints (the metrics are already averaged over the ranks).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Mapping

from objgan_tpu_torch.parallel.sharding import is_main


class MetricsWriter:
    def __init__(self, directory: str, name: str = "train",
                 print_every: int = 50):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{name}_metrics.csv")
        self.print_every = print_every
        self._file = None
        self._writer = None
        self._fields = None
        self._t0 = time.monotonic()
        self._last_printed = None

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        if not is_main():
            return
        row = {"step": step, "wall_s": round(time.monotonic() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        if self._writer is None:
            self._fields = list(row)
            if os.path.exists(self.path) and os.path.getsize(self.path):
                # resume-append: the existing file's header is the schema;
                # keys it lacks are dropped from the CSV with one notice
                # rather than misaligning its columns
                with open(self.path, newline="") as f:
                    existing = next(csv.reader(f), None)
                if existing:
                    dropped = [k for k in row if k not in existing]
                    if dropped:
                        print(f"NOTE: resuming {self.path} with its "
                              f"existing CSV schema; new metric keys "
                              f"{dropped} are not recorded in the CSV "
                              "(start a fresh file to include them)",
                              flush=True)
                    self._fields = existing
            self._file = open(self.path, "a", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=self._fields)
            if self._file.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow({k: row.get(k, "") for k in self._fields})
        # the CSV is flushed every row; printing keys off the steps since
        # the last print, not off step divisibility
        self._file.flush()
        last = self._last_printed
        if last is None or step - last >= self.print_every:
            self._last_printed = step
            parts = " ".join(f"{k}={float(v):.4g}" for k, v in metrics.items())
            print(f"[step {step}] {parts}", flush=True)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
            self._writer = None
