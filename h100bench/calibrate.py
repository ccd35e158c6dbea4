"""The readings that a training cell's limits are set from, on the card:

    python3 h100bench/calibrate.py --workload <cell> --seeds 12 \
        --control 3 --faults 3 [--first_seed N]

For each seed the cell's own set-up runs (no window) and prints the
numbers that can be compared, for the program as the configuration states it (the
lower readings); for the first ``--control`` seeds also for the controls,
the reference computed in float8 and in int8 put in the program's place;
and for the first ``--faults`` seeds for the program with each of
``FAULTS`` planted: half of each batch left out (the mean taken over the
rest), the replays fed the first execution's inputs or its noise,
ROI-align's backward
returning half its gradient. A state left unchanged reads 1 in the change
numbers by construction and needs no run. One JSON line per reading:
``{"seed", "kind", "readings"}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from h100bench import harness  # noqa: E402

# the faults a training cell can have that need a run ("frozen_state" reads
# 1 in the change numbers by construction; "altered_loss" 0.05 in the loss)
FAULTS = ("half_batch", "stale_inputs", "stale_noise", "roi_grad_half")


def readings(cell: str, seed: int, faults=None, control: bool = False,
             require_cuda: bool = True, root: str = harness.ROOT,
             leaves: bool = False):
    """The compared numbers of one seed: the program's (with ``faults``
    planted), and with ``control`` those of the reference in each lower
    precision put in its place ({kind: readings}; else None)."""
    import gc

    import torch

    gc.collect()  # an earlier run's graph, never during this one's capture
    ctx = harness.make_context(cell, seed, 0.0, False, time.monotonic(),
                               root=root)
    ctx.require_cuda = require_cuda
    ctx.faults = dict(faults or {})
    drv = harness.driver(ctx.traffic["driver"], root)
    rec = drv.run(ctx)
    if not (control or leaves):
        return rec["readings"], None
    device = torch.device("cuda" if require_cuda else "cpu")
    flat = drv.ref.flat_config(drv.merged(ctx.config["config"],
                                          ctx.traffic["config"]))
    want, _ = drv.reference_steps(flat, seed, rec["kept"], device)
    if leaves:
        print_leaves(f"{seed} {faults or 'program'}",
                     drv.leaf_table(rec["first"], want))
    if not control:
        return rec["readings"], None
    replay = rec["replay"]
    if replay is not None:
        keep = drv.kept_leaves(want[1])
        want_replay = drv.reference_replay(flat, seed, replay, device)
    controls = {}
    for kind in sorted(drv.ref.ROUNDINGS):
        got, _ = drv.reference_steps(flat, seed, rec["kept"], device,
                                     control=kind)
        controls[kind] = drv.compare(got, want)
        if leaves:
            print_leaves(f"{seed} control {kind}", drv.leaf_table(got, want))
        if replay is not None:
            got = drv.reference_replay(flat, seed, replay, device,
                                       control=kind)
            controls[kind].update(drv.compare_replay(got, want_replay, keep))
    return rec["readings"], controls



def print_leaves(what: str, rows) -> None:
    """The worst dozen leaves, and the ROI's own features' convs, on
    standard error."""
    out = rows[:12] + [r for r in rows[12:] if r[0].startswith(
        ("obj_d.DownBlock_0", "obj_d.DownBlock_1", "obj_d.DownBlock_2"))]
    for name, axes, norm, gap, diff in out:
        print(f"leaf {what}: {name} axes {axes} norm {norm:.4g} "
              f"gap {gap:.4g} diff {diff:.4g}", file=sys.stderr)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first_seed", type=int, default=2 ** 31 + 7)
    ap.add_argument("--leaves", type=int, default=0,
                    help="seeds whose worst leaves are printed")
    args = ap.parse_args()
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        got, ctrl = readings(args.workload, seed, control=i < args.control,
                             leaves=i < args.leaves)
        print(json.dumps({"seed": seed, "kind": "program", "readings": got}),
              flush=True)
        for kind, got in (ctrl or {}).items():
            print(json.dumps({"seed": seed, "kind": f"control_{kind}",
                              "readings": got}), flush=True)
        for fault in FAULTS if i < args.faults else ():
            got, _ = readings(args.workload, seed, {fault: True},
                              leaves=i < args.leaves)
            print(json.dumps({"seed": seed, "kind": fault,
                              "readings": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
