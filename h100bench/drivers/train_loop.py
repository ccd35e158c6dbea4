"""Driver of Stage-C training as ``gan_main --wire`` runs it: the manifest
feed (``data/feed.py::build_feed``) into ``cli._run_loop`` over a
``GanTrainer``, with ``TRAIN.STEPS_PER_EXECUTION`` from the traffic file.

Set-up: one epoch of the feed pulled and dropped, which fills its record
cache; the trainer, built and moved to the card as ``make_trainer`` does
it, loaded with the benchmark's weights (``h100bench/weights.py``, the
reference's too); then ``_run_loop``
over the first ``setup_steps`` batches (at K > 1 the eager execution, the
capture of the CUDA graph and a replay). The first three of those steps are the
ones the reference follows: their losses, the first gradient as Adam holds
it after one step (its first moment over 1 - b1), and each parameter's
change after three. At K > 1 those steps run in the eager execution that
precedes the capture, so the last execution of set-up, the graph replayed
as the window replays it, is checked too: its first step's D and G
losses and gradient, which the graph itself records (``StepRecorder``, on
every replay), and the program's parameters before it.

Window: ``_run_loop`` again, on the same trainer and feed, until the feed,
cut at ``--seconds`` on a whole execution, ends; it closes at a
synchronise after the last execution (the loop's end-of-run checkpoint,
outside the window, is not written). With ``--trace 1`` a few executions
in the window run under the profiler.

Then the peak memory is read, the program's state freed, and the reference
runs the three steps in float32 on the same batches and noise; and, from
the program's parameters before the checked replay, that replay's first
step.
"""

from __future__ import annotations

import gc
import math
import os
import statistics
import time
from typing import Dict, List

import numpy as np

from h100bench import weights as weights_mod
from h100bench.reference import feed as feed_ref
from h100bench.reference import stagec as ref
from h100bench.trace import Profiled

REF_STEPS = 3
B1 = 0.5  # Adam's first-moment decay in every Stage-C optimiser


def merged(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


class TimedFeed:
    """The feed as ``_run_loop`` pulls it: the CPU time that the pulling
    thread spends in the feed for each batch (at K > 1 that thread is the
    prefetch thread, whose wall time also holds its waits for the
    interpreter lock), each batch's boxes, the first ``keep`` batches
    whole; it ends after ``limit`` batches, or at ``stop_at`` (monotonic)
    on a multiple of ``k``."""

    def __init__(self, it, k: int):
        self.it, self.k = it, k
        self.limit = None
        self.stop_at = math.inf
        self.count = 0
        self.keep = 0
        self.kept: List[Dict] = []
        self.feed_s: List[float] = []
        self.boxes: List[np.ndarray] = []

    def __iter__(self):
        return self

    def __next__(self):
        if self.limit is not None and self.count >= self.limit:
            raise StopIteration
        if self.count % self.k == 0 and time.monotonic() >= self.stop_at:
            raise StopIteration
        t0 = time.thread_time()
        batch = next(self.it)
        self.feed_s.append(time.thread_time() - t0)
        if len(self.kept) < self.keep:
            self.kept.append({k: np.array(v) for k, v in batch.items()})
        self.boxes.append(np.array(batch["boxes"]))
        self.count += 1
        return batch

    def reset(self, limit=None, stop_at=math.inf, keep: int = 0) -> None:
        self.limit, self.stop_at, self.keep = limit, stop_at, keep
        self.count = 0
        self.kept, self.feed_s, self.boxes = [], [], []


class WindowEnd:
    """Stands where ``_run_loop`` saves its last checkpoint: it waits for
    the card and notes the time, and writes nothing."""

    def __init__(self, sync):
        self.sync = sync
        self.t = None

    def save(self, step, module) -> bool:
        self.sync()
        self.t = time.monotonic()
        return False


class FirstSteps:
    """Wraps ``trainer.train_step`` for the first ``n`` steps: their
    losses, the first gradient as Adam's first moment holds it after step
    1 (on the host), and the norm of each parameter's change after step
    n."""

    def __init__(self, trainer, n: int):
        import torch

        self.torch = torch
        self.trainer, self.n = trainer, n
        self.names = {p: name for name, p in trainer.named_parameters()}
        self.p0 = {name: p.detach().clone()
                   for name, p in trainer.trained_parameters().items()}
        self.losses: List = []
        self.grads: Dict = {}
        self.change_norms: Dict = {}
        self.own = "train_step" in vars(trainer)  # a planted fault's
        self.inner = trainer.train_step
        trainer.train_step = self

    def __call__(self, batch, z, ca_eps):
        m = self.inner(batch, z, ca_eps)
        if len(self.losses) >= self.n:
            return m
        self.losses.append((m["d_loss"].float().clone(),
                            m["g_loss"].float().clone()))
        t = self.trainer
        if len(self.losses) == 1:
            for opt in t.optimizers():
                for group in opt.param_groups:
                    for p in group["params"]:
                        state = opt.state.get(p)
                        self.grads[self.names[p]] = (
                            state["exp_avg"].float().cpu() / (1 - B1)
                            if state else self.torch.zeros(p.shape))
        if len(self.losses) == self.n:
            for name, p in t.trained_parameters().items():
                self.change_norms[name] = (p.detach() - self.p0[name]).norm()
            self.p0 = None
            if self.own:
                t.train_step = self.inner
            else:
                del t.train_step  # the class's own method again
        return m

    def readings(self):
        return ([(float(d), float(g)) for d, g in self.losses], self.grads,
                {k: float(v) for k, v in self.change_norms.items()})


def host(t):
    """A float32 copy of ``t`` on the host."""
    import torch

    return t.detach().to("cpu", torch.float32, copy=True)


class StepRecorder:
    """Wraps ``trainer.train_step`` where the K-step executions call it,
    so that on a card its records are captured into the graph and every
    replay writes them anew: each step's D and G losses, and Adam's first
    moments after each execution's first step (0 before Adam's first
    update). ``k`` steps an execution."""

    def __init__(self, trainer, k: int):
        import torch

        self.k = k
        self.calls = 0
        self.losses = torch.zeros(k, 2,
                                  device=next(trainer.parameters()).device)
        names = {p: name for name, p in trainer.named_parameters()}
        self.params = [(names[p], p, opt) for opt in trainer.optimizers()
                       for group in opt.param_groups
                       for p in group["params"]]
        self.m = {name: torch.zeros_like(p) for name, p, _ in self.params}
        self.own = "train_step" in vars(trainer)  # a planted fault's
        self.inner = trainer.train_step
        trainer.train_step = self

    def __call__(self, batch, z, ca_eps):
        out = self.inner(batch, z, ca_eps)
        i = self.calls % self.k
        self.calls += 1
        self.losses[i, 0].copy_(out["d_loss"])
        self.losses[i, 1].copy_(out["g_loss"])
        if i == 0:
            for name, p, opt in self.params:
                state = opt.state.get(p)
                if state:
                    self.m[name].copy_(state["exp_avg"])
        return out


class ReplayCheck:
    """Wraps ``trainer.multi_train_step`` for its ``at``-th call (0 is the
    eager execution, 1 the capture, 2 on replays of the graph) and reads
    that execution's first step: the program's trained parameters and
    step before it (on the host), and from ``recorder`` the step's D and
    G losses and its gradient as Adam's first moment holds it after the
    step ((m - b1 m_before) / (1 - b1))."""

    def __init__(self, trainer, at: int, recorder: StepRecorder):
        self.trainer, self.at, self.recorder = trainer, at, recorder
        self.calls = 0
        self.state = None
        self.losses = None
        self.grads: Dict = {}
        self.own = "multi_train_step" in vars(trainer)  # a planted fault's
        self.inner = trainer.multi_train_step
        trainer.multi_train_step = self

    def __call__(self, batches, noises):
        if self.calls != self.at:
            self.calls += 1
            return self.inner(batches, noises)
        import torch

        t, rec = self.trainer, self.recorder
        m = {}
        for name, p, opt in rec.params:
            state = opt.state.get(p)  # none before a first update
            m[name] = host(state["exp_avg"]) if state else torch.zeros(
                p.shape)
        self.state = {"params": {n: host(p) for n, p in
                                 t.trained_parameters().items()},
                      "step": t.step}
        out = self.inner(batches, noises)
        self.losses = tuple(float(x) for x in rec.losses[0])
        self.grads = {n: (host(after) - B1 * m[n]) / (1 - B1)
                      for n, after in rec.m.items()}
        if self.own:
            t.multi_train_step = self.inner
        else:
            del t.multi_train_step  # the class's own method again
        return out


def leaf_gaps(prog: Dict[str, float], want: Dict[str, float],
              keep) -> List[float]:
    """Each kept leaf's gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    the median leaf's."""
    med = statistics.median(want[n] for n in keep)
    return [abs(prog[n] - want[n]) / max(want[n], med) for n in keep]


def kept_leaves(r_grads) -> List[str]:
    """The leaves compared: those whose reference first gradient is at
    least a thousandth of the median leaf's."""
    r_norm = {n: float(g.norm()) for n, g in r_grads.items()}
    med = statistics.median(r_norm.values())
    return [n for n, v in r_norm.items() if v >= 1e-3 * med]


def compare(prog, refr) -> Dict[str, float]:
    """The numbers that can be compared: the worst relative gap of the
    steps' D and G losses (``loss_gap``; the first step's alone,
    ``loss1_gap``); per leaf, the gap between the program's norm and the
    reference's, of the first gradient (``grad_gap``) and of the change
    after the steps (``change_gap``), the worst leaf's and the median
    leaf's (``..._median``), and of the first gradient the worst over the
    leaves of two axes or more (``grad_gap_matrix``: the kernels of convs
    and dense layers, not their biases and GroupNorm scales); and the norm
    of the first gradient's difference (``grad_diff``,
    ``grad_diff_median``). Each leaf's gap is over the larger of its
    reference norm and the median leaf's; leaves whose reference gradient
    is under a thousandth of the median leaf's are left out."""
    p_loss, p_grads, p_change = prog
    r_loss, r_grads, r_change = refr
    r_norm = {n: float(g.norm()) for n, g in r_grads.items()}
    p_norm = {n: float(g.norm()) for n, g in p_grads.items()}
    keep = kept_leaves(r_grads)
    kept_med = statistics.median(r_norm[n] for n in keep)
    loss = [max(abs(p - r) / abs(r) for p, r in zip(ps, rs))
            for ps, rs in zip(p_loss, r_loss)]
    grad = dict(zip(keep, leaf_gaps(p_norm, r_norm, keep)))
    diff = {n: float((p_grads[n] - r_grads[n]).norm())
            / max(r_norm[n], kept_med) for n in keep}
    change = leaf_gaps(p_change, r_change, keep)
    return {"loss_gap": max(loss), "loss1_gap": loss[0],
            "grad_gap": max(grad.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "grad_gap_matrix": max(grad[n] for n in keep
                                   if r_grads[n].dim() >= 2),
            "grad_diff": max(diff.values()),
            "grad_diff_median": statistics.median(diff.values()),
            "change_gap": max(change),
            "change_gap_median": statistics.median(change),
            "leaves_left_out": float(len(r_norm) - len(keep))}


def leaf_table(prog, refr) -> List[tuple]:
    """Per kept leaf: (name, axes, reference norm, gap of norms, norm of
    the difference), the first gradient's, worst difference first."""
    p_grads, r_grads = prog[1], refr[1]
    keep = kept_leaves(r_grads)
    r_norm = {n: float(r_grads[n].norm()) for n in keep}
    med = statistics.median(r_norm.values())
    rows = [(n, r_grads[n].dim(), r_norm[n],
             abs(float(p_grads[n].norm()) - r_norm[n]) / max(r_norm[n], med),
             float((p_grads[n] - r_grads[n]).norm()) / max(r_norm[n], med))
            for n in keep]
    return sorted(rows, key=lambda r: -r[4])


def compare_replay(prog, refr, keep: List[str]) -> Dict[str, float]:
    """The first step of the checked replay against the reference's step
    from the same state: the worst relative gap of its D and G losses
    (``replay_loss_gap``) and, as for the first step, the median leaf's
    gap of gradient norms and norm of the gradient's difference
    (``replay_grad_gap_median``, ``replay_grad_diff_median``)."""
    (p_d, p_g), p_grads = prog
    (r_d, r_g), r_grads = refr
    r_norm = {n: float(r_grads[n].norm()) for n in keep}
    p_norm = {n: float(p_grads[n].norm()) for n in keep}
    med = statistics.median(r_norm.values())
    gap = leaf_gaps(p_norm, r_norm, keep)
    diff = [float((p_grads[n] - r_grads[n]).norm()) / max(r_norm[n], med)
            for n in keep]
    return {"replay_loss_gap": max(abs(p_d - r_d) / abs(r_d),
                                   abs(p_g - r_g) / abs(r_g)),
            "replay_grad_gap_median": statistics.median(gap),
            "replay_grad_diff_median": statistics.median(diff)}


def reference_model(flat: Dict, seed: int, device, control=None):
    """The reference at the weights of ``seed``: (model, its trained
    parameters, the weights drawn)."""
    import torch

    ref.no_tf32()
    num = ref.Numerics(control=control)
    with torch.device("meta"):
        shape = ref.StageC(flat, num)
    w = weights_mod.draw(shape, seed, device)
    with torch.device(device):
        model = ref.StageC(flat, num)
    weights_mod.load_into(model, w)
    return model, model.trained(), w


def reference_steps(flat: Dict, seed: int, batches: List[Dict], device,
                    control=None, count: bool = False):
    """The reference's readings over ``batches`` (wire, numpy) from the
    weights of ``seed``: ([(d_loss, g_loss)], the first gradients (on the
    host), the change norms), and with ``count`` its K1 calls and FLOPs of
    one step."""
    from torch.utils.flop_counter import FlopCounterMode

    model, params, w = reference_model(flat, seed, device, control)
    num = model.num
    adam = ref.Adam(flat)
    losses, extra = [], {}
    for step, wire in enumerate(batches):
        batch = ref.from_wire(flat, wire, device)
        z, eps = ref.step_noise(flat, seed, step, len(wire["class_ids"]),
                                device)
        if count and step == 0:
            num.gn_calls = []
            fc = FlopCounterMode(display=False)
            with fc:
                d, g, grads = model.grads(batch, z, eps)
            extra = {"k1_calls": num.gn_calls,
                     "flops": fc.get_total_flops()}
            num.gn_calls = None
        else:
            d, g, grads = model.grads(batch, z, eps)
        losses.append((d, g))
        if step == 0:
            grads0 = {n: grads[n].detach().float().cpu() for n in params}
        adam.step(params, grads)
    change = {n: float((p.detach() - w[n]).norm()) for n, p in params.items()}
    return (losses, grads0, change), extra


def reference_replay(flat: Dict, seed: int, replay: Dict, device,
                     control=None):
    """The reference's step from the program's state before the checked
    replay (``replay["state"]``) on that replay's first batch (wire,
    numpy) with its step's noise: ((D loss, G loss), {name: gradient on
    the host})."""
    import torch

    model, params, _ = reference_model(flat, seed, device, control)
    state = replay["state"]
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(state["params"][n])
    wire = replay["batch"]
    z, eps = ref.step_noise(flat, seed, state["step"],
                            len(wire["class_ids"]), device)
    d, g, grads = model.grads(ref.from_wire(flat, wire, device), z, eps)
    return (d, g), {n: grads[n].detach().float().cpu() for n in params}


def phase(ctx, what: str) -> None:
    """A line on standard error: seconds since the run started."""
    import sys

    print(f"h100bench: {time.monotonic() - ctx.t_start:.2f} s {what}",
          file=sys.stderr, flush=True)


def run(ctx) -> Dict:
    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import Config
    from objgan_tpu_torch.core.precision import true_fp32
    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.train.gan import GanTrainer

    tr = ctx.traffic
    device = torch.device("cuda" if ctx.require_cuda else "cpu")
    tree = merged(ctx.config["config"], tr["config"])
    tree["RNG_SEED"] = ctx.seed
    flat = ref.flat_config(tree)
    cfg = Config().merged(tree)
    k = max(1, cfg.TRAIN.STEPS_PER_EXECUTION)
    true_fp32()
    manifest = os.path.join(ctx.root, tr["manifest"])
    image_root = os.path.dirname(manifest)
    it, n_records, _ = build_feed(cfg, manifest, image_root=image_root,
                                  wire=tr["wire"], grain=tr["grain"])
    feed = TimedFeed(it, k)
    phase(ctx, "imports and feed built")
    for _ in range(-(-n_records // cfg.TRAIN.BATCH_SIZE)):
        next(feed)  # one epoch: every record's cached wire form
    phase(ctx, "feed cache filled")
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))

    with torch.device("meta"):
        shape = ref.StageC(flat, ref.Numerics())
    w = weights_mod.draw(shape, ctx.seed, device)
    phase(ctx, "weights drawn")
    trainer = GanTrainer(cfg).to(device)  # as make_trainer builds it
    phase(ctx, "trainer built")
    weights_mod.load_into(trainer, w, lambda n: (
        "g_net." + n[len("ema_g."):] if n.startswith("ema_g.") else n))
    del w, shape
    undo = apply_faults(ctx.faults, trainer)
    try:
        executions = tr["setup_steps"] // k
        if k > 1 and (executions < 3 or tr["setup_steps"] % k):
            raise ValueError("set-up must run three or more whole "
                             "executions, the last a replay of the graph")
        # the recorder first: the first steps' wrapper ends before it does
        recorder = StepRecorder(trainer, k) if k > 1 else None
        first = FirstSteps(trainer, REF_STEPS)
        replay = (ReplayCheck(trainer, executions - 1, recorder)
                  if k > 1 else None)
        phase(ctx, "weights loaded, first steps wrapped")

        feed.reset(limit=tr["setup_steps"], keep=tr["setup_steps"])
        cli._run_loop(cfg, trainer, feed, Rows(), WindowEnd(sync), 10 ** 9,
                      device, None, tr["log_every"])
        kept = feed.kept[:REF_STEPS]
        if replay is not None:
            replay = {"state": replay.state, "batch": feed.kept[-k],
                      "prog": (replay.losses, replay.grads)}
        prog = first.readings()
        sync()
        setup_s = time.monotonic() - ctx.t_start
        phase(ctx, "set-up steps run")

        prof = Profiled(device.type == "cuda") if ctx.trace else None
        span = {}
        if prof is not None:
            wrap_span(trainer, k, tr["trace_span"], prof, span)
        rows = Rows()
        end = WindowEnd(sync)
        start_step = trainer.step
        t0 = time.monotonic()
        feed.reset(stop_at=t0 + ctx.seconds)
        cli._run_loop(cfg, trainer, feed, rows, end, 10 ** 9, device, None,
                      tr["log_every"])
        if prof is not None and prof.active:
            prof.stop()
            span["steps"] = trainer.step - span["first_step"]
            span["wall"] = end.t - span["t0"]
    finally:
        undo()
    window_s = end.t - t0
    steps = trainer.step - start_step
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    rec = {"setup_s": setup_s, "window_s": window_s, "steps": steps,
           "step_ms": 1000.0 * window_s / max(steps, 1),
           "feed_ms": 1000.0 * statistics.fmean(feed.feed_s)
           if feed.feed_s else None,
           "attempted": steps, "failed": rows.failed,
           "device": device_info(torch, device, peak)}
    boxes = feed.boxes
    del trainer, first
    gc.collect()  # the trainer's K-step graph and its pool, in a cycle
    if device.type == "cuda":
        torch.cuda.empty_cache()

    phase(ctx, f"window closed: {steps} steps")
    refr, extra = reference_steps(flat, ctx.seed, kept, device,
                                  count=ctx.trace)
    got = compare(prog, refr)
    if replay is not None:
        got.update(compare_replay(
            replay["prog"], reference_replay(flat, ctx.seed, replay, device),
            kept_leaves(refr[1])))
    records = feed_ref.load_records(manifest)
    vocab = feed_ref.build_vocab(records)
    bad = sum(feed_ref.batch_faults(b, records, vocab, image_root,
                                    tree["OBJ"]["SHAPE_SIZE"]) for b in kept)
    rec["checks"] = [("feed_rows_wrong", float(bad), 0.0)] + [
        (name, got[name], lim) for name, lim in tr["limits"].items()]
    rec["readings"] = got
    phase(ctx, "reference and feed check done")
    rec["kept"], rec["replay"], rec["first"] = kept, replay, prog
    if prof is not None and prof.result:
        rec.update(prof.result)
        rec["span_steps"] = span["steps"]
        # the steps outside the profiled span, for the utilisation
        rec["unprofiled_step_ms"] = 1000.0 * (window_s - span["wall"]) / max(
            steps - span["steps"], 1)
        rec["k1_calls"] = extra["k1_calls"]
        rec["model_flops"] = extra["flops"]
        first_step = span["first_step"] - start_step
        rec["span_boxes"] = boxes[first_step:first_step + span["steps"]]
        top = cfg.branch_sizes[-1]
        rec["roi_f_shape"] = (cfg.TRAIN.BATCH_SIZE, top // 8, top // 8,
                              4 * cfg.GAN.DF_DIM)
        rec["roi_size"] = cfg.OBJ.ROI_SIZE
        rec["breakdown"] = {"device_ops": prof.result["device_ops"],
                            "idle_gaps": prof.result["idle_gaps"]}
    return rec


def wrap_span(trainer, k: int, span_cfg, prof: Profiled, span: Dict) -> None:
    """Profile executions ``span_cfg[0]`` to ``span_cfg[0] + span_cfg[1]``
    of the window: the trainer's ``multi_train_step`` (K > 1) or
    ``train_step`` (K = 1), wrapped on the instance."""
    name = "multi_train_step" if k > 1 else "train_step"
    inner = getattr(trainer, name)
    start, n = span_cfg
    calls = [0]

    def call(*args):
        if calls[0] == start:
            span["first_step"] = trainer.step
            span["t0"] = time.monotonic()
            prof.start()
        result = inner(*args)
        calls[0] += 1
        if calls[0] == start + n and prof.active:
            prof.stop()
            span["steps"] = trainer.step - span["first_step"]
            span["wall"] = time.monotonic() - span["t0"]
            delattr(trainer, name)
        return result

    setattr(trainer, name, call)


def _half_grad(x):
    """``x`` as it is (halving is exact), with half the gradient passed
    back through it."""
    return 0.5 * x + (0.5 * x).detach()


def apply_faults(faults: Dict, trainer):
    """Plant a fault in this process's trainer (tests and calibration):
    ``frozen_state`` leaves every parameter as it was; ``half_batch``
    takes each step over the first half of its rows; ``altered_loss``
    returns each step's D loss 5% off where the step produces it;
    ``stale_inputs`` gives every K-step execution after the first the
    first one's batches and noise, as a graph would that read its inputs
    from where the capture left them, ``stale_noise`` only its noise; ``roi_grad_half`` halves the
    gradient that ROI-align's backward (K3 on the card) returns to the
    features. Returns what undoes the faults planted outside the
    trainer."""
    if faults.get("frozen_state"):
        trainer.apply_grads = lambda grads: None
    if faults.get("altered_loss"):
        step = trainer.train_step

        def altered(batch, z, ca_eps):
            m = step(batch, z, ca_eps)
            return dict(m, d_loss=m["d_loss"] * 1.05)
        trainer.train_step = altered
    if faults.get("half_batch"):
        inner = trainer.losses

        def half(batch, z, ca_eps):
            n = z.shape[0] // 2

            def cut(v):
                if isinstance(v, list):
                    return [cut(x) for x in v]
                return v[:n]
            return inner({k: cut(v) for k, v in batch.items()}, z[:n],
                         ca_eps[:n])
        trainer.losses = half
    if faults.get("stale_inputs") or faults.get("stale_noise"):
        execute = trainer.multi_train_step
        first = []

        def stale(batches, noises):
            if not first:
                first.append(_clone((batches, tuple(noises))))
                return execute(batches, noises)
            if faults.get("stale_noise"):
                return execute(batches, first[0][1])
            return execute(*first[0])
        trainer.multi_train_step = stale
    if faults.get("roi_grad_half"):
        from objgan_tpu_torch.models import discriminator

        roi = discriminator.roi_align
        discriminator.roi_align = (
            lambda x, boxes, **kw: roi(_half_grad(x), boxes, **kw))
        return lambda: setattr(discriminator, "roi_align", roi)
    return lambda: None


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if hasattr(tree, "clone") else tree


class Rows:
    """Takes the loop's metrics rows (``MetricsWriter``'s place: kept in
    memory, nothing written or printed); ``failed`` counts the rows whose
    losses are not finite."""

    def __init__(self):
        self.rows: List[Dict] = []
        self.failed = 0

    def write(self, step, metrics) -> None:
        vals = {k: float(v) for k, v in metrics.items()}
        self.rows.append(vals)
        self.failed += not (math.isfinite(vals.get("d_loss", 0.0))
                            and math.isfinite(vals.get("g_loss", 0.0)))

    def close(self) -> None:
        pass


def device_info(torch, device, peak: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
            "count": 1, "memory_peak_bytes": int(peak)}
