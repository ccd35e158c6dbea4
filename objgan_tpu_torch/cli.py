"""Training, sampling and evaluation runners behind the port's entry
points: DAMSM pretraining (``python -m objgan_tpu_torch.pretrain_damsm``),
Stage A (``box_train``, ``box_sample``), Stage B (``shape_main``) and
Stage C, train or sample (``gan_main``), and Stage C's quality evaluation
(``eval``). Port of ``objgan_tpu/cli.py``: ``_out_dir``,
``_already_trained``, ``apply_epoch_schedule``, ``_PrefetchFeed``
(``PrefetchFeed``), ``_run_loop`` (one device; K steps per execution with
``TRAIN.STEPS_PER_EXECUTION``), ``load_damsm_encoders``, ``pretrain_damsm``,
``train_gan``, ``sample_gan``, ``train_box``, ``sample_box``, ``eval_box``,
``train_shape`` and ``eval_shape``; and of ``gan/eval.py``'s body,
``evaluate``.

Each stage writes under ``OUTPUT_DIR/<CONFIG_NAME>_<stage>``: its
checkpoints (``ckpt/<step>``, keep-3), ``<stage>_metrics.csv`` and the
attention-grid snapshots, and resumes from its newest checkpoint (the
port's ``state.pt`` or a JAX run's Orbax step, ``core/checkpoint.py``).
A step's noise comes from a generator seeded from (``RNG_SEED``, step)
(``train/common.py::step_generator``), as do the synthetic batches when no
manifest feed is given, so a resumed run equals an unbroken one on them. A
manifest feed starts its shuffle over on a resume, as the JAX package's
does. A feed that ends stops the loop there, and the stage's last step is
saved.

Everything runs on ``device`` ("cuda" unless the caller says otherwise);
nothing moves to the CPU on its own.

The four trainers run data-parallel under ``torchrun``
(``parallel/sharding.py``): each first joins the process group that
torchrun's environment describes (``cuda`` becomes ``cuda:LOCAL_RANK``;
NCCL on the card, gloo on the CPU), checks that the data axis divides
``TRAIN.BATCH_SIZE``, and feeds its rows of the global batch; a synthetic
batch is drawn from (``RNG_SEED``, step, rank) with class ids from the
start of the rank's rows. The steps equal one process's on the global
batch. Rank 0 writes the checkpoints (the other ranks wait for it), the
metrics and the grids; every rank restores and then takes rank 0's state.
Without such an environment one process runs as before.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import queue
import sys
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from objgan_tpu_torch.core.checkpoint import CheckpointManager, latest_step_in
from objgan_tpu_torch.core.config import Config
from objgan_tpu_torch.core.metrics import MetricsWriter
from objgan_tpu_torch.core.precision import true_fp32
from objgan_tpu_torch.data.synthetic import synthetic_batch
from objgan_tpu_torch.data.wire import WIRE_IMAGE, from_wire
from objgan_tpu_torch.parallel import sharding
from objgan_tpu_torch.train.box import BoxTrainer, box_noise
from objgan_tpu_torch.train.common import (Trainer, index_stack,
                                           step_generator, tensor_leaves)
from objgan_tpu_torch.train.damsm import DamsmTrainer
from objgan_tpu_torch.train.gan import GanTrainer, train_noise
from objgan_tpu_torch.train.shape import ShapeTrainer, shape_noise
from objgan_tpu_torch.utils import profiling

# step_generator streams: a step's noise, a synthetic batch, a snapshot's
_NOISE, _DATA, _SNAPSHOT = 0, 1, 2


def _out_dir(cfg: Config, stage: str) -> str:
    d = os.path.join(cfg.OUTPUT_DIR, f"{cfg.CONFIG_NAME}_{stage}")
    os.makedirs(d, exist_ok=True)
    return d


def _join_group(cfg: Config, device) -> torch.device:
    """A trainer's first act: join torchrun's process group when its
    environment is there, check that the data axis divides the global
    batch, and return this rank's device."""
    sharding.maybe_initialize_distributed(device)
    sharding.local_batch_size(cfg.TRAIN.BATCH_SIZE,
                              sharding.make_mesh(cfg.MESH.MODEL_PARALLELISM))
    return sharding.rank_device(device)


def _restore(manager: CheckpointManager, trainer: Trainer) -> None:
    """Every rank restores the newest checkpoint, then takes rank 0's
    state."""
    restored = manager.restore_latest(trainer)
    sharding.broadcast_module_(trainer)
    if restored is not None:
        print(f"resumed from step {restored}")


def _already_trained(out: str, stage: str, max_steps: int) -> bool:
    """True (and says so) when the stage's newest checkpoint already reaches
    ``max_steps``, found by a directory scan (rank 0's) before any model is
    built."""
    if max_steps >= 10 ** 9:
        return False
    latest = sharding.broadcast_object(
        latest_step_in(os.path.join(out, "ckpt")))
    if latest is not None and latest >= max_steps:
        print(f"{stage}: checkpoint at step {latest} >= max_steps "
              f"{max_steps}; nothing to do")
        return True
    return False


def _start(cfg: Config, stage: str, feed: Optional[Iterator[Dict]],
           max_steps: int, device, make: Callable[[torch.device], Trainer],
           with_images: bool = True) -> Optional[tuple]:
    """The trainer entry points' preamble: join the process group, make the
    stage's output directory, and return None when its checkpoints already
    reach ``max_steps``; else build the trainer (``make(device)``), restore
    its newest checkpoint, feed synthetic batches from the restored step
    when ``feed`` is None, and return (device, output directory, trainer,
    checkpoint manager, feed)."""
    device = _join_group(cfg, device)
    out = _out_dir(cfg, stage)
    if _already_trained(out, stage, max_steps):
        return None
    trainer = make(device)
    manager = CheckpointManager(os.path.join(out, "ckpt"))
    _restore(manager, trainer)
    if feed is None:
        feed = synthetic_feed(cfg, device, trainer.step,
                              with_images=with_images)
    return device, out, trainer, manager, feed


def apply_epoch_schedule(cfg: Config, n_records: int, max_steps: int):
    """The lineage's epoch-denominated knobs in steps once the dataset size
    is known: ``MAX_EPOCH`` epochs when no ``max_steps`` is given, and a
    snapshot every ``SNAPSHOT_INTERVAL`` epochs unless ``SNAPSHOT_STEPS``
    is set. Returns ``(cfg, max_steps)``."""
    if n_records <= 0:
        return cfg, max_steps
    steps_per_epoch = max(1, n_records // cfg.TRAIN.BATCH_SIZE)
    if max_steps >= 10 ** 9:
        max_steps = cfg.TRAIN.MAX_EPOCH * steps_per_epoch
        print(f"training {cfg.TRAIN.MAX_EPOCH} epochs x {steps_per_epoch} "
              f"steps = {max_steps} steps")
    if cfg.TRAIN.SNAPSHOT_STEPS == 0:
        cfg = cfg.merged({"TRAIN": {
            "SNAPSHOT_STEPS": cfg.TRAIN.SNAPSHOT_INTERVAL * steps_per_epoch
        }})
    return cfg, max_steps


def to_device(batch: Dict, device) -> Dict:
    """A feed's batch (numpy arrays, or tensors; "images" a list) on
    ``device``: numpy goes through pinned memory and a non-blocking copy
    to a CUDA device."""
    device = torch.device(device)

    def move(x):
        if isinstance(x, list):
            return [move(v) for v in x]
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return {k: move(v) for k, v in batch.items()}


def synthetic_feed(cfg: Config, device, start: int = 0,
                   with_images: bool = True) -> Iterator[Dict]:
    """Endless synthetic COCO-shaped batches on ``device``; batch i is drawn
    from (RNG_SEED, i), starting at ``start``. Under data parallelism a
    rank draws its rows from (RNG_SEED, i, rank), their class ids counted
    from the start of its rows, as JAX's ``_feed`` does."""
    rank, _ = sharding.rank_and_world()
    first, rows = sharding.process_local_batch_slice(cfg.TRAIN.BATCH_SIZE)
    for i in itertools.count(start):
        yield synthetic_batch(cfg, step_generator(cfg.RNG_SEED, i, device,
                                                  _DATA, rank),
                              batch=rows, with_images=with_images,
                              id_offset=first)


def _finest_scale_only(feed: Iterator[Dict]) -> Iterator[Dict]:
    """DAMSM reads only the finest image scale; the rest is not moved."""
    for b in feed:
        if "images" in b:
            b = dict(b, images=[b["images"][-1]])
        yield b


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def step_noise(cfg: Config, trainer: Trainer, batch: Dict, step: int,
               device) -> tuple:
    """The noise arguments of ``trainer.train_step`` for ``step``, drawn on
    ``device`` from (RNG_SEED, step) (``Trainer.step_noise``): Stage C's z
    and ca_eps, DAMSM's dropout mask, Stage A's scheduled-sampling flips,
    Stage B's z."""
    return trainer.step_noise(batch, step_generator(cfg.RNG_SEED, step,
                                                    device, _NOISE))


def train_step(cfg: Config, trainer: Trainer, batch: Dict, step: int,
               device) -> Dict[str, torch.Tensor]:
    """One step of any trainer on a batch on ``device``, its noise drawn
    from (RNG_SEED, step)."""
    return trainer.train_step(batch, *step_noise(cfg, trainer, batch, step,
                                                 device))


def _host_layout(batch: Dict) -> tuple:
    return tuple((k, tuple(np.shape(v) for v in x) if isinstance(x, list)
                  else tuple(np.shape(x))) for k, x in batch.items())


def stack_batches(batches, pin: bool = False) -> Dict:
    """Batches of one layout stacked on a new leading axis ("images" level
    by level): numpy arrays into one host tensor per key (pinned with
    ``pin``, for a non-blocking copy to a card), tensors where they lie."""
    def stack(xs):
        if isinstance(xs[0], list):
            return [stack([x[i] for x in xs]) for i in range(len(xs[0]))]
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs)
        first = torch.from_numpy(np.ascontiguousarray(xs[0]))
        out = torch.empty((len(xs), *first.shape), dtype=first.dtype,
                          pin_memory=pin)
        for i, x in enumerate(xs):
            out[i].copy_(torch.from_numpy(np.ascontiguousarray(x)))
        return out

    return {k: stack([b[k] for b in batches]) for k in batches[0]}


def stack_noise(noises) -> tuple:
    """K steps' noise arguments (tuples of tensors or None) stacked
    position by position; None stays None."""
    return tuple(None if parts[0] is None else torch.stack(parts)
                 for parts in zip(*noises))


class PrefetchFeed:
    """The K-step loop's feed (``TRAIN.STEPS_PER_EXECUTION`` K > 1): the
    counterpart of JAX's ``_PrefetchFeed``. A producer thread takes the
    batches of ``feed`` for steps ``start``, ``start + 1``, ..., stacks K
    of one layout (``stack_batches``) with the K steps' noise
    (``noise(batch, step)``) and ships them to ``device`` while the
    previous execution runs: on a card through pinned memory and a
    non-blocking copy on a stream of its own, which the consumer's stream
    then waits for. At most ``depth`` items wait.

    Yields ``("exec", (batches, noises))`` per stack, and ``("single",
    batch)`` for each batch that makes none: a bounded feed's partial last
    stack, and batches whose shapes differ from those before them. An
    error of the feed or of the copy reaches the consumer as
    ``RuntimeError("prefetch feed failed")``, raised from it: a producer
    that died silently would leave the loop waiting for good. ``close()``
    ends the thread. ``feed`` stays the caller's, as at K = 1: a worker
    feed's workers, and with the last of them the fork server, stop when
    the caller closes or drops it.

    Spans (``utils/profiling.py``, recorded while the loop's thread runs
    under a profiler): ``feed.wait`` on the consumer's thread, from asking
    for the next item to holding it, the stream's wait for its copy
    included; ``feed.produce`` on the producer's thread, from the first
    pull of a stack's K batches to the stack shipped (stacked, pinned, its
    copy issued, its noise drawn, its ready event recorded), the wait for
    room in the queue left out. The loop starts the recorder's buffer
    anew (``profiling.restart``)."""

    def __init__(self, feed: Iterator[Dict], k: int, start: int,
                 noise: Callable[[Dict, int], tuple], device,
                 depth: int = 2):
        self._feed, self._k, self._start = feed, k, start
        self._noise = noise
        self._device = torch.device(device)
        self._stream = None
        if self._device.type == "cuda":
            # batches the caller made on its stream (the first one, taken
            # for the snapshots) are ready before this stream reads them
            self._stream = torch.cuda.Stream(self._device)
            self._stream.wait_stream(torch.cuda.current_stream(self._device))
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        profiling.restart()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="prefetch-feed")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _ship(self, pending, step: int):
        cuda = self._stream is not None
        if cuda:  # a feed's device tensors, read here
            for t in tensor_leaves(pending):
                if t.is_cuda:
                    t.record_stream(self._stream)
        batches = to_device(stack_batches(pending, pin=cuda), self._device)
        noises = stack_noise([self._noise(b, step + i)
                               for i, b in enumerate(pending)])
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return batches, noises, ready

    def _produce(self):
        try:
            with (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext()):
                self._fill()
        except Exception as e:  # noqa: BLE001 — raised in the consumer
            self._put(("error", e))

    def _fill(self):
        pending, step = [], self._start

        def singles() -> bool:
            nonlocal pending, step
            for b in pending:
                if not self._put(("single", b)):
                    return False
            step += len(pending)
            pending = []
            return True

        it = iter(self._feed)
        while not self._stop.is_set():
            if not pending:
                produce = profiling.side_span("feed.produce", self._k)
            try:
                batch = next(it)
            except StopIteration:
                break
            if pending and _host_layout(batch) != _host_layout(pending[0]):
                if not singles():
                    return
            pending.append(batch)
            if len(pending) == self._k:
                item = ("exec", self._ship(pending, step))
                produce.close()
                if not self._put(item):
                    return
                step += self._k
                pending = []
        if singles():
            self._put(("end", None))

    def _get(self):
        while True:
            try:
                return self._q.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError("prefetch feed failed: its thread "
                                       "ended without a result") from None

    def __iter__(self):
        while True:
            with profiling.span("feed.wait"):
                kind, val = self._get()
                if kind == "exec":
                    batches, noises, ready = val
                    if ready is not None:
                        current = torch.cuda.current_stream(self._device)
                        current.wait_event(ready)
                        for t in tensor_leaves((batches, noises)):
                            t.record_stream(current)
                    val = (batches, noises)
            if kind == "end":
                return
            if kind == "error":
                raise RuntimeError("prefetch feed failed") from val
            yield kind, val

    def close(self, timeout: float = 60.0) -> None:
        """Stop the producer and wait for it, ``timeout`` seconds at
        most."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get_nowait()  # a producer waiting to put goes on
            except queue.Empty:
                self._thread.join(0.1)


def _run_loop(cfg: Config, trainer: Trainer, feed: Iterator[Dict],
              writer: MetricsWriter, manager: CheckpointManager,
              max_steps: int, device, snapshot_hook=None,
              log_every: int = 50):
    """Step loop from the trainer's own (restored) step to ``max_steps``,
    or until ``feed`` ends; a step's noise is drawn from (RNG_SEED, step)
    (``train_step``). With ``TRAIN.STEPS_PER_EXECUTION`` K > 1 it is JAX's
    K-step loop: ``PrefetchFeed`` stacks K batches with their noise, and
    one ``trainer.multi_train_step`` takes them (on a card, one CUDA-graph
    replay); a stack that would pass ``max_steps`` (the ragged tail), a
    bounded feed's partial last stack and batches whose shapes differ from
    the captured ones run as single steps. A K-step execution draws the
    noise of K single steps, so a resume anywhere equals an unbroken run.

    A metric row (CSV, and stdout every ``log_every`` steps) at the first
    step or execution, every ``max(log_every, K)`` steps, at
    ``max_steps`` and when the feed ends first, with ``steps_per_sec``
    over the steps since the previous row, synchronised; an execution's
    row holds its K-axis means. A checkpoint and a snapshot after a step
    or execution that ends past a multiple of ``SNAPSHOT_STEPS`` (500
    when unset): ``step % SNAPSHOT_STEPS < K``, from the first multiple
    on, JAX's rule; and a checkpoint at the end. A step already saved is
    not written again. Rank 0 alone writes rows, checkpoints and
    snapshots. A row is the span ``loop.row`` (its synchronise included;
    ``utils/profiling.py``)."""
    k = max(1, cfg.TRAIN.STEPS_PER_EXECUTION)
    log_every = max(log_every, k)
    step = trainer.step
    last_logged, t_last, logged_any = step, time.monotonic(), False
    snap_every = cfg.TRAIN.SNAPSHOT_STEPS or 500

    def log(metrics):
        nonlocal last_logged, t_last, logged_any
        with profiling.span("loop.row"):
            vals = {k: float(v) for k, v in metrics.items()}  # synchronises
            now = time.monotonic()
            vals["steps_per_sec"] = (step - last_logged) / max(now - t_last,
                                                               1e-9)
            last_logged, t_last, logged_any = step, now, True
            writer.write(step, vals)

    def after(metrics):
        if (step - last_logged >= log_every or not logged_any
                or step == max_steps):
            log(metrics)
        if step >= snap_every and step % snap_every < k:
            manager.save(step, trainer)
            if snapshot_hook is not None and sharding.is_main():
                snapshot_hook(step)

    def single(batch, at):
        return train_step(cfg, trainer, to_device(batch, device), at, device)

    if k == 1:
        for batch in itertools.islice(feed, max(max_steps - step, 0)):
            metrics = single(batch, step)
            step = trainer.step
            after(metrics)
    elif step < max_steps:
        prefetch = PrefetchFeed(feed, k, step, lambda b, at: step_noise(
            cfg, trainer, b, at, device), device)
        try:
            for kind, val in prefetch:
                if (kind == "exec" and max_steps - step >= k
                        and trainer.multi_step().fits(*val)):
                    metrics = trainer.multi_train_step(*val)
                elif kind == "exec":  # the ragged tail, or another layout
                    batches, noises = val
                    for i in range(min(k, max_steps - step)):
                        metrics = trainer.train_step(
                            index_stack(batches, i), *index_stack(noises, i))
                else:
                    metrics = single(val, step)
                step = trainer.step
                after(metrics)
                if step >= max_steps:
                    break
        finally:
            prefetch.close()
    if step != last_logged:  # the feed ended between rows
        log(metrics)
    manager.save(step, trainer)
    writer.close()


def load_damsm_encoders(cfg: Config):
    """Pretrained DAMSM encoder weights for Stage C: the newest checkpoint
    of ``TRAIN.NET_E``, a DAMSM pretraining ``ckpt`` directory (default
    ``OUTPUT_DIR/<CONFIG_NAME>_damsm/ckpt``). Returns the text and image
    encoders' state dicts (CPU), or ``(None, None)`` when there is no such
    checkpoint or it does not match the config."""
    path = cfg.TRAIN.NET_E or os.path.join(
        cfg.OUTPUT_DIR, f"{cfg.CONFIG_NAME}_damsm", "ckpt")
    if latest_step_in(path) is None:
        return None, None
    trainer = DamsmTrainer(cfg)
    step = CheckpointManager(path).restore_latest(trainer)
    if step is None:
        return None, None
    print(f"loaded pretrained DAMSM encoders from {path} (step {step})")
    return trainer.text_enc.state_dict(), trainer.img_enc.state_dict()


def make_trainer(cfg: Config, device, text_enc=None,
                 img_enc=None) -> GanTrainer:
    """A Stage-C trainer with fresh weights from ``cfg.RNG_SEED`` (drawn on
    the CPU, so a seed gives the same weights on every device) on
    ``device``; ``text_enc`` / ``img_enc`` are pretrained encoder state
    dicts (``load_damsm_encoders``)."""
    true_fp32()
    trainer = GanTrainer(cfg).init_state(
        torch.Generator().manual_seed(cfg.RNG_SEED), text_enc, img_enc)
    return trainer.to(device)


def _gan_trainer(cfg: Config, device) -> GanTrainer:
    text_enc, img_enc = load_damsm_encoders(cfg)
    if text_enc is None:
        print("=" * 72 + "\nWARNING: no pretrained DAMSM encoder checkpoint "
              f"found (TRAIN.NET_E={cfg.TRAIN.NET_E!r}, default "
              f"{cfg.OUTPUT_DIR}/{cfg.CONFIG_NAME}_damsm/ckpt).\nStage C "
              "runs against FROZEN UNTRAINED random encoders: the sentence/"
              "word\nconditioning and the DAMSM loss are noise. Run python "
              "-m objgan_tpu_torch.pretrain_damsm\nfirst.\n" + "=" * 72,
              file=sys.stderr, flush=True)
    return make_trainer(cfg, device, text_enc, img_enc)


def train_gan(cfg: Config, feed: Optional[Iterator[Dict]] = None,
              max_steps: int = 10 ** 9, device="cuda", log_every: int = 50,
              ixtoword: Optional[dict] = None) -> Optional[GanTrainer]:
    """Stage-C adversarial training on ``feed`` (a manifest feed's numpy
    batches; synthetic batches when None). Loads the DAMSM encoders
    (``TRAIN.NET_E``), resumes from the stage's own newest checkpoint, and
    every ``SNAPSHOT_STEPS`` renders the EMA generator's word->region
    (``attn_step<N>.png``) and object->word (``objs_step<N>.png``) grids on
    the first batch. ``ixtoword`` renders the words. Returns the trainer,
    or None when the checkpoints already reach ``max_steps``."""
    from objgan_tpu_torch.data.glove import COCO_CLASSES
    from objgan_tpu_torch.utils.visualize import (build_object_images,
                                                  build_super_images,
                                                  save_png)

    run = _start(cfg, "gan", feed, max_steps, device,
                 lambda d: _gan_trainer(cfg, d))
    if run is None:
        return None
    device, out, trainer, manager, feed = run
    first = next(feed)
    feed = itertools.chain([first], feed)
    first_dev = to_device(first, device)
    b = first_dev["captions"].shape[0]

    def snapshot(step):
        noise = train_noise(cfg, b, step_generator(cfg.RNG_SEED, step,
                                                   device, _SNAPSHOT), device)
        o = trainer.sample(first_dev, noise["z"], noise["ca_eps"])
        images = _numpy(o["images"][-1])
        caps, lens = _numpy(first["captions"]), _numpy(first["cap_lens"])
        save_png(os.path.join(out, f"attn_step{step}.png"),
                 build_super_images(images, _numpy(o["grid_attn"][-1]),
                                    captions=caps, cap_lens=lens,
                                    ixtoword=ixtoword))
        save_png(os.path.join(out, f"objs_step{step}.png"),
                 build_object_images(
                     images, _numpy(first["boxes"]), _numpy(first["labels"]),
                     _numpy(first["obj_valid"]), _numpy(o["obj_attn"][-1]),
                     captions=caps, cap_lens=lens, ixtoword=ixtoword,
                     class_names=COCO_CLASSES))

    _run_loop(cfg, trainer, feed, MetricsWriter(out, "gan", log_every),
              manager, max_steps, device, snapshot, log_every)
    return trainer


def sample_gan(cfg: Config, feed: Optional[Iterator[Dict]] = None,
               num_batches: int = 10, device="cuda") -> str:
    """Stage-C sampling with the EMA generator of ``TRAIN.NET_G`` (a
    Stage-C ``ckpt`` directory; default this config's training output):
    one PNG per image into ``OUTPUT_DIR/<CONFIG_NAME>_gan_samples``. Batch
    i's noise is drawn from (RNG_SEED, i). Returns that directory."""
    from objgan_tpu_torch.utils.visualize import _to_uint8, save_png

    device = torch.device(device)
    out = _out_dir(cfg, "gan_samples")
    trainer = _gan_trainer(cfg, device)
    ckpt_dir = cfg.TRAIN.NET_G or os.path.join(_out_dir(cfg, "gan"), "ckpt")
    restored = (CheckpointManager(ckpt_dir).restore_latest(trainer)
                if latest_step_in(ckpt_dir) is not None else None)
    if restored is None:
        print(f"WARNING: no generator checkpoint found under {ckpt_dir} — "
              "sampling with UNTRAINED random weights (noise images); "
              "check TRAIN.NET_G / OUTPUT_DIR")
    if feed is None:
        feed = synthetic_feed(cfg, device)
    n = 0
    for i, batch in enumerate(feed):
        if i >= num_batches:
            break
        batch = to_device(batch, device)
        noise = train_noise(cfg, batch["captions"].shape[0],
                            step_generator(cfg.RNG_SEED, i, device, _NOISE),
                            device)
        imgs = _numpy(trainer.sample(batch, noise["z"],
                                     noise["ca_eps"])["images"][-1])
        for j in range(imgs.shape[0]):
            save_png(os.path.join(out, f"s{i}_{j}.png"), _to_uint8(imgs[j]))
        n += imgs.shape[0]
    print(f"wrote {n} samples to {out}")
    return out


def pretrain_damsm(cfg: Config, feed: Optional[Iterator[Dict]] = None,
                   max_steps: int = 10 ** 9, device="cuda",
                   log_every: int = 50,
                   ixtoword: Optional[dict] = None) -> Optional[DamsmTrainer]:
    """DAMSM encoder pretraining on ``feed`` (synthetic batches when None),
    resumed from the stage's newest checkpoint. Every ``SNAPSHOT_STEPS`` it
    renders the matched pairs' word->region attention over the first batch
    (``attn_step<N>.png``; ``ixtoword`` renders the words). Returns the
    trainer, or None when the checkpoints already reach ``max_steps``."""
    from objgan_tpu_torch.losses.damsm_loss import words_loss
    from objgan_tpu_torch.utils.visualize import build_super_images, save_png

    run = _start(cfg, "damsm", feed, max_steps, device,
                 lambda d: fresh_trainer(cfg, DamsmTrainer(cfg), d))
    if run is None:
        return None
    device, out, trainer, manager, feed = run
    feed = _finest_scale_only(feed)
    first = next(feed)
    feed = itertools.chain([first], feed)
    # a wire batch (--wire) is expanded on the device; the grid's
    # background is its finest scale, taken on the host
    first_dev = from_wire(cfg, to_device(first, device))
    first_img = (np.asarray(first[WIRE_IMAGE], np.float32) / 127.5 - 1.0
                 if WIRE_IMAGE in first else _numpy(first["images"][-1]))
    smooth = cfg.TRAIN.SMOOTH

    @torch.no_grad()
    def snapshot(step):
        caps, lens = first_dev["captions"], first_dev["cap_lens"]
        words, _ = trainer.text_enc(caps, lens)
        regions, _ = trainer.img_enc(first_dev["images"][-1])
        *_, attns = words_loss(regions, words, lens, first_dev["class_ids"],
                               smooth.GAMMA1, smooth.GAMMA2, smooth.GAMMA3)
        idx = torch.arange(attns.shape[0], device=attns.device)
        diag = _numpy(attns[idx, idx])  # (B, T, L): caption i on image i
        b, t, l = diag.shape
        r = int(round(l ** 0.5))
        maps = diag.reshape(b, t, r, r).transpose(0, 2, 3, 1)
        save_png(os.path.join(out, f"attn_step{step}.png"),
                 build_super_images(first_img, maps,
                                    captions=_numpy(caps),
                                    cap_lens=_numpy(lens),
                                    ixtoword=ixtoword))

    _run_loop(cfg, trainer, feed, MetricsWriter(out, "damsm", log_every),
              manager, max_steps, device, snapshot, log_every)
    return trainer


# -- Stage A (boxes) and Stage B (masks) --------------------------------------


def fresh_trainer(cfg: Config, trainer: Trainer, device) -> Trainer:
    """``trainer`` with fresh weights drawn on the CPU from ``RNG_SEED``
    (a seed gives the same weights on every device), on ``device``."""
    true_fp32()
    return trainer.init_state(
        torch.Generator().manual_seed(cfg.RNG_SEED)).to(device)


def _restore_for_sampling(cfg: Config, trainer: Trainer, stage: str,
                          what: str) -> Optional[int]:
    """Restore the stage's newest checkpoint into ``trainer``; warn that
    the weights are untrained when there is none."""
    ckpt_dir = os.path.join(cfg.OUTPUT_DIR, f"{cfg.CONFIG_NAME}_{stage}",
                            "ckpt")
    restored = (CheckpointManager(ckpt_dir).restore_latest(trainer)
                if latest_step_in(ckpt_dir) is not None else None)
    if restored is None:
        print(f"WARNING: no {stage} checkpoint under {ckpt_dir} — {what} "
              "with UNTRAINED random weights")
    else:
        print(f"restored the {stage} checkpoint at step {restored}")
    return restored


def _train_layouts(cfg: Config, stage: str, trainer_cls, feed, max_steps: int,
                   device, log_every: int) -> Optional[Trainer]:
    """Stage A's or B's training: ``_start``, then the loop."""
    run = _start(cfg, stage, feed, max_steps, device,
                 lambda d: fresh_trainer(cfg, trainer_cls(cfg), d),
                 with_images=False)
    if run is None:
        return None
    device, out, trainer, manager, feed = run
    _run_loop(cfg, trainer, feed, MetricsWriter(out, stage, log_every),
              manager, max_steps, device, log_every=log_every)
    return trainer


def train_box(cfg: Config, feed: Optional[Iterator[Dict]] = None,
              max_steps: int = 10 ** 9, device="cuda",
              log_every: int = 50) -> Optional[BoxTrainer]:
    """Stage-A teacher-forced training on ``feed`` (a layouts-only
    manifest feed; synthetic batches when None), resumed from the stage's
    newest checkpoint. With ``BOX.SCHEDULED_SAMPLING_PROB`` > 0 a step's
    flips are drawn from (RNG_SEED, step). Returns the trainer, or None
    when the checkpoints already reach ``max_steps``."""
    return _train_layouts(cfg, "box", BoxTrainer, feed, max_steps, device,
                          log_every)


def sample_box(cfg: Config, captions, cap_lens,
               out_path: Optional[str] = None,
               use_beam: Optional[bool] = None, device="cuda",
               noise: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """Caption ids (B, T) and lengths (B,) -> layouts with the box
    generator of this config's newest Stage-A checkpoint: beam search when
    ``use_beam`` (default: ``BOX.BEAM_SIZE`` > 1; mixture-mean boxes),
    else temperature sampling with ``noise`` (``train/box.py::box_noise``;
    by default drawn from (RNG_SEED, 0)). Returns, and with ``out_path``
    writes as JSON, ``{"labels", "boxes", "obj_valid"}`` as lists."""
    import json

    device = torch.device(device)
    trainer = fresh_trainer(cfg, BoxTrainer(cfg), device)
    _restore_for_sampling(cfg, trainer, "box", "sampling layouts")
    caps = torch.as_tensor(np.array(captions)).long().to(device)
    lens = torch.as_tensor(np.array(cap_lens)).long().to(device)
    if use_beam is None:
        use_beam = cfg.BOX.BEAM_SIZE > 1
    if use_beam:
        out = trainer.beam_sample(caps, lens)
    else:
        if noise is None:
            noise = box_noise(cfg, caps.shape[0], step_generator(
                cfg.RNG_SEED, 0, device, _NOISE), device)
        out = trainer.sample(caps, lens, noise)
    layout = {k: _numpy(out[k]).tolist()
              for k in ("labels", "boxes", "obj_valid")}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(layout, f)
    return layout


def eval_box(cfg: Config, feed: Optional[Iterator[Dict]] = None,
             num_batches: int = 10, device="cuda") -> Dict[str, float]:
    """Stage-A evaluation of this config's newest checkpoint on
    ``num_batches`` batches of ``feed`` (synthetic when None): held-out
    teacher-forced NLL and layout statistics, temperature sampling (batch
    i's noise from (RNG_SEED, i)) and beam search side by side
    (``sample_*`` and ``beam_*``)."""
    from objgan_tpu_torch.utils import box_eval

    device = torch.device(device)
    trainer = fresh_trainer(cfg, BoxTrainer(cfg), device)
    _restore_for_sampling(cfg, trainer, "box", "evaluating")
    if feed is None:
        feed = synthetic_feed(cfg, device, with_images=False)
    batches = [to_device(b, device)
               for b in itertools.islice(feed, num_batches)]
    noises = [box_noise(cfg, b["captions"].shape[0], step_generator(
        cfg.RNG_SEED, i, device, _NOISE), device)
        for i, b in enumerate(batches)]
    metrics = box_eval.heldout_nll(trainer, batches)
    stats = box_eval.layout_stats(trainer, batches, cfg.OBJ.NUM_CLASSES,
                                  noises)
    beam = box_eval.layout_stats(trainer, batches, cfg.OBJ.NUM_CLASSES,
                                 use_beam=True)
    metrics.update({f"sample_{k}": v for k, v in stats.items()})
    metrics.update({f"beam_{k}": v for k, v in beam.items()})
    for k, v in sorted(metrics.items()):
        print(f"{k}: {v:.4f}")
    return metrics


def train_shape(cfg: Config, feed: Optional[Iterator[Dict]] = None,
                max_steps: int = 10 ** 9, device="cuda",
                log_every: int = 50) -> Optional[ShapeTrainer]:
    """Stage-B training on ``feed`` (a manifest feed with masks and no
    images; synthetic batches when None), resumed from the stage's newest
    checkpoint; a step's noise is drawn from (RNG_SEED, step). Returns the
    trainer, or None when the checkpoints already reach ``max_steps``."""
    return _train_layouts(cfg, "shape", ShapeTrainer, feed, max_steps,
                          device, log_every)


def eval_shape(cfg: Config, feed: Optional[Iterator[Dict]] = None,
               num_batches: int = 10, device="cuda") -> Dict[str, float]:
    """Stage-B evaluation of this config's newest checkpoint: held-out mask
    IoU, pixel accuracy and area ratio on ``num_batches`` batches of
    ``feed`` (synthetic when None); batch i's noise from (RNG_SEED, i)."""
    from objgan_tpu_torch.utils import shape_eval

    device = torch.device(device)
    trainer = fresh_trainer(cfg, ShapeTrainer(cfg), device)
    _restore_for_sampling(cfg, trainer, "shape", "evaluating")
    if feed is None:
        feed = synthetic_feed(cfg, device, with_images=False)
    batches = [to_device(b, device)
               for b in itertools.islice(feed, num_batches)]
    zs = [shape_noise(cfg, b["labels"].shape[0], step_generator(
        cfg.RNG_SEED, i, device, _NOISE), device)
        for i, b in enumerate(batches)]
    metrics = shape_eval.heldout_mask_metrics(trainer, batches, zs)
    for k, v in sorted(metrics.items()):
        print(f"{k}: {v:.4f}")
    return metrics


# -- Stage C's quality evaluation (gan/eval.py) -------------------------------

FROZEN_PROBE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "frozen_lite.npz")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A plain tensor state dict from a ``.pth`` (unwrapping a
    ``state_dict`` or ``model`` entry); ``weights_only``, so a file that
    needs arbitrary pickle code is refused."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    return sd


def evaluate(cfg: Config, feed: Optional[Iterator[Dict]] = None,
             num_batches: int = 10, *, strict: bool = False,
             real_stats: str = "paired", manifest: Optional[str] = None,
             inception_pth: Optional[str] = None,
             frozen_probe: Optional[str] = None, raw_params: bool = False,
             eval_seed: Optional[int] = None, feed_vocab=None,
             noise: Optional[Callable[[int, int], Dict]] = None,
             device="cuda") -> Dict[str, float]:
    """FID, IS, the frozen lite-IS, R-precision and full-pool retrieval of
    the Stage-C generator of ``TRAIN.NET_G`` (default this config's
    training output), over ``num_batches`` batches of ``feed`` (a
    held-out manifest feed; synthetic batches when None), printed in
    ``gan/eval.py``'s words and returned.

    Lite mode scores the features of a DAMSM lite encoder with fresh
    weights (seed 0) and fits ``OBJ.NUM_CLASSES``-way probe on the real
    images for IS; ``strict`` scores Inception-v3 pool activations and
    logits (``inception_pth``: torchvision weights; random without). The
    real side comes from the same batches (``real_stats="paired"``) or
    from one augmentation-free pass over every image of ``manifest``
    (``"all"``), cached next to it with the probe. ``frozen_probe``: the
    frozen artifact (default ``assets/frozen_lite.npz``; "off" skips it),
    lite mode only. Batch i's noise is ``noise(i, batch_size)`` ({"z",
    "ca_eps"}), by default drawn from (``eval_seed`` or ``RNG_SEED``,
    1000 + i), which also orders a synthetic feed. ``raw_params`` samples
    with the raw generator instead of the EMA one. Features are extracted
    as the loop samples, so only (B, D) rows stay resident."""
    from objgan_tpu_torch.freeze_probe import make_frozen_extractor
    from objgan_tpu_torch.models.inception_v3 import (
        load_torchvision_checkpoint)
    from objgan_tpu_torch.utils import fid_runner
    from objgan_tpu_torch.utils.eval_metrics import (activation_stats,
                                                     fit_class_probe,
                                                     inception_score,
                                                     probe_probs,
                                                     r_precision,
                                                     retrieval_stats)

    if real_stats not in ("paired", "all"):
        raise ValueError(f"real_stats must be 'paired' or 'all', got "
                         f"{real_stats!r}")
    if real_stats == "all" and not manifest:
        raise ValueError("real_stats='all' needs a manifest: the "
                         "whole-dataset real side is defined by one")
    device = torch.device(device)
    # eval is the non-training path: with B_VALIDATION the manifest split
    # keys off TRAIN.FLAG, so a training cfg would score the TRAIN split
    cfg = cfg.merged({"TRAIN": {"FLAG": False}})
    seed = cfg.RNG_SEED if eval_seed is None else eval_seed
    if eval_seed is not None:
        print(f"eval_seed: {eval_seed} (held-out batch order + latents "
              f"only; the split and the initialisation stay at "
              f"cfg.RNG_SEED={cfg.RNG_SEED}; the real-side statistics stay "
              f"fixed only with --real_stats all — paired mode computes "
              f"them from the reordered batches)")
    text_sd, img_sd = load_damsm_encoders(cfg)
    trainer = make_trainer(cfg, device, text_sd, img_sd)
    ckpt_dir = cfg.TRAIN.NET_G or os.path.join(
        cfg.OUTPUT_DIR, f"{cfg.CONFIG_NAME}_gan", "ckpt")
    restored = (CheckpointManager(ckpt_dir).restore_latest(trainer)
                if latest_step_in(ckpt_dir) is not None else None)
    if restored is not None:
        print(f"evaluating checkpoint at step {restored}")
    # R-precision means something only with trained DAMSM encoders (from
    # the Stage-C checkpoint or from DAMSM pretraining)
    encoders_trained = restored is not None or text_sd is not None

    if strict:
        extractor, inception = fid_runner.make_inception_extractor(
            device=device)
        if inception_pth:
            load_torchvision_checkpoint(
                inception, load_torch_state_dict(inception_pth))
            mode = f"strict-inception (weights: {inception_pth})"
        else:
            mode = "strict-inception (RANDOM WEIGHTS — --force)"
    else:
        extractor, _ = fid_runner.make_lite_extractor(cfg, device=device)
        mode = "lite (framework encoder)"

    # the frozen cross-manifest lite-IS: a second, frozen feature space and
    # class head, so the IS column compares across manifests
    frozen = None
    if not strict and frozen_probe != "off":
        fp_path = frozen_probe or FROZEN_PROBE
        if os.path.exists(fp_path):
            fr_extract, fr_probe, _ = make_frozen_extractor(fp_path, device)
            frozen = {"extract": fr_extract, "probe": fr_probe,
                      "path": fp_path, "feats": []}
        elif frozen_probe:
            print(f"WARNING: --frozen_probe {fp_path} not found — skipping "
                  "frozen lite-IS", file=sys.stderr)

    if feed is None:
        feed = synthetic_feed(cfg.replace(RNG_SEED=seed), device)
    if noise is None:
        def noise(i, b):
            return train_noise(cfg, b, step_generator(seed, 1000 + i, device,
                                                      _NOISE), device)

    host = fid_runner.to_numpy
    paired_reals = real_stats == "paired"
    fake_acts, fake_probs, real_acts, real_labels = [], [], [], []
    sents, globals_, globals_real = [], [], []
    for i, batch in enumerate(itertools.islice(feed, num_batches)):
        if paired_reals:
            real_labels.append(fid_runner.primary_labels(batch))
        batch = from_wire(cfg, to_device(batch, device))
        nz = noise(i, batch["captions"].shape[0])
        fake = trainer.sample(batch, nz["z"], nz["ca_eps"],
                              use_ema=not raw_params)["images"][-1]
        real = batch["images"][-1]
        fa, fp = extractor(fake)
        fake_acts.append(host(fa))
        fake_probs.append(host(fp))
        if frozen is not None:
            frozen["feats"].append(host(frozen["extract"](fake)))
        if paired_reals:
            real_acts.append(host(extractor(real)[0]))
        with torch.no_grad():
            _, sent = trainer.text_enc(batch["captions"], batch["cap_lens"])
            sents.append(host(sent))
            globals_.append(host(trainer.img_enc(fake)[1]))
            globals_real.append(host(trainer.img_enc(real)[1]))
    n_fake = sum(len(a) for a in fake_acts)

    n_real_unique = None
    stats = None
    probe = None  # the lite-IS class head, fit on real images
    if paired_reals:
        stats = activation_stats(np.concatenate(real_acts))
        if not strict:
            probe = fit_class_probe(np.concatenate(real_acts),
                                    np.concatenate(real_labels),
                                    cfg.OBJ.NUM_CLASSES)
    else:
        stats, probe, n_real_unique = _manifest_real_side(
            cfg, manifest, mode, inception_pth, extractor, strict,
            feed_vocab)

    fake_acts_all = np.concatenate(fake_acts)
    if probe is not None:
        # lite mode: p(y|x) from the real-image class probe
        fake_probs_all = probe_probs(probe, fake_acts_all)
        print(f"lite-IS probe: {cfg.OBJ.NUM_CLASSES}-way head on real "
              f"images — train acc {float(probe['train_acc']):.3f}, "
              f"holdout acc {float(probe['holdout_acc']):.3f}")
    else:  # strict mode: Inception's own softmax
        fake_probs_all = np.concatenate(fake_probs)
    fid, (is_m, is_s) = fid_runner.compute_fid_is(
        [], [], extractor, real_stats=stats,
        fake_activations=(fake_acts_all, fake_probs_all))
    sents_all = np.concatenate(sents)
    rp = r_precision(sents_all, np.concatenate(globals_))
    # the same metric on the real images: what any generator can reach
    # under this protocol and encoder
    rp_ceiling = r_precision(sents_all, np.concatenate(globals_real))
    rs_fake = retrieval_stats(sents_all, np.concatenate(globals_))
    rs_real = retrieval_stats(sents_all, np.concatenate(globals_real))

    is_tag = "" if strict else (
        " [lite-probe: class head on lite features — relative, NOT "
        "comparable to published IS]")
    rp_tag = "" if encoders_trained else (
        " [untrained encoders — meaningless until DAMSM is pretrained]")
    if raw_params:
        mode += "; RAW generator params (EMA bypassed)"
    print(f"eval over {n_fake} samples [{mode}]")
    if n_real_unique is not None:
        print(f"real-side FID statistics: full manifest, {n_real_unique} "
              f"unique images (augmentation-free)")
    if n_fake < 2048:
        print(f"NOTE: FID over {n_fake} samples is a relative/debug number "
              f"— the covariance estimate needs thousands of samples "
              f"(standard protocol: 5k-50k) for publication-comparable "
              f"values")
    print(f"FID: {fid:.3f}")
    print(f"IS: {is_m:.3f} +/- {is_s:.3f}{is_tag}")
    result = {"fid": fid, "is_mean": is_m, "is_std": is_s, "n": n_fake,
              "r_precision": rp, "r_precision_real": rp_ceiling,
              **{f"retrieval_{k}": v for k, v in rs_fake.items()},
              **{f"retrieval_real_{k}": v for k, v in rs_real.items()}}
    if frozen is not None:
        fz_m, fz_s = inception_score(probe_probs(
            frozen["probe"], np.concatenate(frozen["feats"])))
        print(f"frozen lite-IS: {fz_m:.3f} +/- {fz_s:.3f} "
              f"[cross-manifest scale — frozen encoder+probe: "
              f"{os.path.relpath(frozen['path'])}]")
        result.update(frozen_is_mean=fz_m, frozen_is_std=fz_s)
    print(f"R-precision: {rp:.3f}{rp_tag}")
    print(f"R-precision (real-image ceiling): {rp_ceiling:.3f}{rp_tag}")
    print(f"Retrieval mean rank (full pool {rs_fake['pool']}): "
          f"{rs_fake['mean_rank']:.2f} | median "
          f"{rs_fake['median_rank']:.0f} | R@5 "
          f"{rs_fake['recall_at_5']:.3f}{rp_tag}")
    print(f"Retrieval mean rank (real-image ceiling): "
          f"{rs_real['mean_rank']:.2f} | median "
          f"{rs_real['median_rank']:.0f} | R@5 "
          f"{rs_real['recall_at_5']:.3f}{rp_tag}")
    return result


def _manifest_real_side(cfg: Config, manifest: str, mode: str,
                        inception_pth: Optional[str], extractor,
                        strict: bool, feed_vocab):
    """(stats, probe or None, number of records) of one augmentation-free
    pass over every image of ``manifest`` (the trailing batch cut at the
    epoch's end), read from or written to the caches next to it: the
    statistics, and in lite mode the probe (keyed by the class count too).
    Only feature rows are kept, never the dataset's pixels."""
    from objgan_tpu_torch.data.pipeline import CocoFeed, load_records_json
    from objgan_tpu_torch.data.tokenizer import Vocab
    from objgan_tpu_torch.utils import fid_runner

    records = load_records_json(manifest)
    key = dict(records=records, image_root=cfg.DATA_DIR)
    cache_path = fid_runner.real_stats_cache_path(
        cfg, manifest, len(records), mode, inception_pth, **key)
    probe_path = fid_runner.real_stats_cache_path(
        cfg, manifest, len(records), mode, inception_pth, kind="lite_probe",
        n_classes=cfg.OBJ.NUM_CLASSES, **key)
    stats = probe = None
    if os.path.exists(cache_path):
        with np.load(cache_path) as z:
            stats = (z["mu"], z["cov"])
        print(f"real-side stats: cached ({cache_path})")
    if not strict and os.path.exists(probe_path):
        with np.load(probe_path) as z:
            probe = dict(z)
        print(f"lite-IS probe: cached ({probe_path})")
    need_probe = not strict and probe is None
    if stats is None or need_probe:
        # masks are never read by the pass: no per-object rasterisation
        vocab = feed_vocab or Vocab.build(c for r in records
                                          for c in r["captions"])
        full = CocoFeed(cfg, records, vocab, seed=cfg.RNG_SEED,
                        augment=False, with_masks=False)
        got_stats, fitted = fid_runner.real_stats_and_probe(
            fid_runner.unique_epoch_batches(full, len(records)), extractor,
            cfg.OBJ.NUM_CLASSES, need_stats=stats is None,
            need_probe=need_probe)
        if got_stats is not None:
            stats = got_stats
            fid_runner.save_npz_atomic(cache_path, mu=stats[0],
                                       cov=stats[1])
        if fitted is not None:
            probe = fitted
            fid_runner.save_npz_atomic(probe_path, **fitted)
    return stats, probe, len(records)
