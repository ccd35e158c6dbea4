"""One run of one benchmark cell: set-up, a measured window, the check of
what the window produced, and one JSON line of results.

Everything a cell is made of is found by name. ``BENCHMARK.json`` names
the cell's configuration and traffic mix; the configuration is
``h100bench/configs/<config>.json``, the mix ``h100bench/traffic/
<traffic>.json``, which names its driver, ``h100bench/drivers/
<driver>.py``; and every metric, end to end or per layer, is a reader of
its own, ``h100bench/metrics/<metric>.py``, whose ``read(record)`` takes
the run's record and returns a number, or None where the run has nothing
for it to read. A new cell, mix or metric is new files, and no edit.

The driver's ``run(ctx)`` does the work and returns the record: set-up
seconds, the window, its counts and spans, the device's peak memory, and
the checks, each ``(name, value, limit)``, true when value <= limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# what the process that prints a result may never hold (whole top-level
# names): JAX, its libraries and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "objgan_tpu")


class NoDevice(RuntimeError):
    """The run has not the cards its cell asks for."""


@dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic files,
    the run's arguments, and where it may write."""
    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    root: str = ROOT
    require_cuda: bool = True
    faults: Dict = field(default_factory=dict)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def bench_file(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(items: List[Dict], name: str, what: str) -> Dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = ROOT):
    """The ``read`` function of metric ``name``'s own file."""
    return _load(os.path.join(root, "h100bench", "metrics", f"{name}.py"),
                 f"h100bench.metrics.{name}").read


def driver(name: str, root: str = ROOT):
    """The driver module ``name``'s own file."""
    return _load(os.path.join(root, "h100bench", "drivers", f"{name}.py"),
                 f"h100bench.drivers.{name}")


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``. A metric
    without ``workloads`` belongs to every cell that reports what it
    moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]


def require_cards(n: int) -> None:
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        raise NoDevice(f"this cell needs {n} CUDA device(s); found {found}")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def make_context(workload: str, seed: int, seconds: float, trace: bool,
                 t_start: float, root: str = ROOT) -> Context:
    bench = bench_file(root)
    cell = find(bench["workloads"], workload, "workload")
    config = find(bench["configs"], cell["config"], "config")
    return Context(cell=cell,
                   config=load_json(os.path.join(root, config["file"])),
                   traffic=load_json(os.path.join(
                       root, "h100bench", "traffic",
                       f"{cell['traffic']}.json")),
                   seed=seed, seconds=seconds, trace=trace, t_start=t_start,
                   root=root)


def run_cell(ctx: Context) -> Dict:
    """Drive the cell and return its result line (a dict)."""
    if ctx.require_cuda:
        require_cards(ctx.cell["chips"])
    rec = driver(ctx.traffic["driver"], ctx.root).run(ctx)
    bench = bench_file(ctx.root)
    metrics = {}
    for m in cell_metrics(bench, ctx.cell["name"], ctx.trace):
        value = reader(m["name"], ctx.root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = rec["checks"]
    device = dict(rec["device"])
    if ctx.trace and "busy_s" in rec:
        device.update(busy_s=rec["busy_s"], window_s=rec["span_s"])
    line = {"correct": all(v <= lim for _, v, lim in checks),
            "attempted": rec["attempted"], "failed": rec["failed"],
            "metrics": metrics, "device": device}
    if ctx.trace and rec.get("breakdown"):
        line["breakdown"] = rec["breakdown"]
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    return line


def main(argv: Optional[List[str]] = None) -> int:
    t_start = time.monotonic()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    try:
        ctx = make_context(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start)
        line = run_cell(ctx)
    except NoDevice as e:
        print(f"h100bench: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"h100bench: the run loaded {found}; no result",
              file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
