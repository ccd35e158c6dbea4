#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (objgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths with fresh weights from ``RNG_SEED``: serving at
the full width of ``cfg/eval_coco.yml`` (batch 16, bf16 Stage C, 64 -> 128
-> 256 px), the Stage-C train step at the full width of
``cfg/coco_objgan.yml`` (batch 16, bf16 G and D, DF_DIM 64, 10 objects,
ROI 7), DAMSM pretraining (lite and inception backbones), Stage-A and
Stage-B training (``fm`` and ``vgg`` perceptual modes), serving the three
trained stages from their checkpoints and evaluating the Stage-C one (lite
and strict); and checks every hand-written kernel on them:

1. build        K1 (``csrc/groupnorm.cu``) and K2/K3 (``csrc/roi_align.cu``)
                compiled by nvcc, one process per source, in parallel;
2. serve        ``run_serve`` answers 35 captions (3 batches of 16, the last
                padded): 35 ordered responses with PNGs, finite images in
                [-1, 1], and K1's launch count rises by the number of
                GroupNorm layers per batch;
3. kernels      every K1 call of one served batch replayed through the
                kernel (twice, held bitwise equal), its plain PyTorch twin
                and ``F.group_norm``; per shape the launch plan (regime,
                cluster size), the kernels that one call launches (the
                kernel nodes of a CUDA graph captured around it: exactly
                1) and the achieved GB/s over 1R + 1W and over 2R + 1W
                bytes;
4. stages       synchronised wall time of Stage A, B and C of one batch;
5. small        the tiny fp32 config served on the GPU against the same
                weights and noise on the CPU (the twins);
6. train        ``cli.train_gan`` (what ``python -m
                objgan_tpu_torch.gan_main`` runs) takes TRAIN_STEPS steps
                on synthetic batches, logging each: finite metrics, every
                G, D and object-D parameter moved from the seed's initial
                weights, and per step K1 launched once per GroupNorm call,
                K2 three times (the object D on the real, the detached fake
                and the fake images) and K3 three times (the backward of
                each of those);
7. profile      one more train step under ``torch.profiler``: the device's
                busy share and the kernels that take its time;
8. train_k1     every K1 call of one more train step (the bf16 G and
                discriminators, the fp32 image encoder), checked as in
                phase 3; then (``train_k1b``) every K1 backward call of
                that step, run twice (held bitwise equal) against the
                twin's VJP in fp64, and timed per shape against its bound,
                the twin's VJP and aten's ``native_group_norm_backward``;
9. roi          every K2/K3 call of that step replayed through the
                kernels (twice, held bitwise equal), their twins and,
                where torchvision is installed, ``torchvision.ops.
                roi_align``, with the recorded boxes and with padded boxes
                zeroed (K3 with the cotangent scaled to unit RMS); per call
                the launch plan, the kernels that one call launches (one
                kernel node in a CUDA graph) and, modelled from the plan
                on the host, the bytes its loads would request beside the
                unique bytes the bound counts;
10. damsm       ``cli.pretrain_damsm`` (what ``python -m
                objgan_tpu_torch.pretrain_damsm`` runs) takes DAMSM_STEPS
                steps at the full width of ``cfg/damsm_coco.yml`` (batch
                48, 256 px, lite backbone, fp32) on the manifest feed of
                ``data_proc2k/manifest.json``: finite losses, every text
                and image parameter moved from its seed value, K1 launched
                8 times per step (and per snapshot), checkpoints and
                attention grids written; the checkpoint restored into a
                fresh trainer on the card, bitwise equal, and one more step
                from the live and the restored trainer, bitwise equal; the
                device step on a resident batch (synchronised, and once
                under torch.profiler) and the host feed's ms per batch,
                timed apart;
                then ``cli.train_gan`` on ``cfg/coco_objgan.yml`` with
                ``TRAIN.NET_E`` at that checkpoint, on the manifest feed,
                for 2 steps: its encoders equal the checkpoint's, K2 and K3
                launched 3 times per step;
11. damsm_k1    every K1 call of one more DAMSM step (the fp32 image
                encoder at B = 48), checked as in phase 3;
12. box         ``cli.train_box`` (what ``python -m
                objgan_tpu_torch.box_train`` runs) takes BOX_STEPS steps
                at the width of ``Config()`` (RNN 1024, batch 16, 20 GMM
                components in corr mode) on the manifest's layouts:
                finite losses, every parameter moved, no kernel launched,
                the checkpoint round trip as in phase 10, one step under
                torch.profiler; ``cli.sample_box`` (temperature, and beam
                search at K = 3) and ``cli.eval_box`` on 2 batches;
13. shape       ``cli.train_shape`` (``python -m
                objgan_tpu_torch.shape_main``) takes SHAPE_STEPS steps at
                the width of ``cfg/shape_coco.yml`` (160 objects, 64 px,
                fp32) on the manifest's layouts and masks: finite losses,
                G and D moved, K1 launched 11 times a step, the checkpoint
                round trip, the device step on a resident batch (and once
                under torch.profiler) and the host feed apart;
                ``cli.eval_shape`` on 2 batches;
14. shape_k1    every K1 call of one more Stage-B step (B = 160, fp32),
                checked as in phase 3;
15. compose     the Stage-C (phase 6), Stage-A and Stage-B checkpoints,
                all under one OUTPUT_DIR as ``coco_objgan``, served by
                ``run_serve`` at ``cfg/eval_coco.yml`` with ``output_dir``:
                every stage restored, none untrained, and the first
                batch's layout, masks and images equal to those of
                ``cli.sample_box``, the restored Stage-B sampler and the
                restored Stage-C sampler for the same noise;
16. eval        ``cli.evaluate`` (what ``python -m objgan_tpu_torch.eval``
                runs) at ``cfg/eval_coco.yml`` on phase 6's Stage-C
                checkpoint, EVAL_BATCHES held-out batches of the manifest,
                ``--real_stats all`` and the frozen probe
                (``assets/frozen_lite.npz``): the checkpoint restored,
                ``gan/eval.py``'s lines printed, every metric finite, K1
                launched once per GroupNorm call (the sampling's, 8 per
                lite-encoder application: the extractor and the frozen
                extractor on the fakes, ``img_enc`` on fakes and reals;
                8 per batch of the full-manifest pass); run again, both
                caches read and every metric equal to the bit; per batch,
                synchronised, the host feed, the sampling and the rest
                (extraction) apart, the full-manifest pass, peak memory;
17. eval_k1     every K1 call of one eval batch, checked as in phase 3;
18. strict      a random Inception-v3 written as a torchvision state dict
                and read back through ``inception_pth``: the converter
                against the module; ``cli.evaluate --strict`` on 2 batches,
                finite metrics; Inception's pool activations and
                probabilities at 299 px on 32 images, timed;
19. damsm_inception  ``cli.pretrain_damsm`` with ``TEXT.CNN_BACKBONE:
                inception`` at ``cfg/damsm_coco.yml`` width for 2 steps:
                the backbone bitwise unmoved, the projections and the text
                encoder moved, no Adam state for the backbone, the
                checkpoint round trip;
20. shape_vgg   ``cli.train_shape`` with ``SHAPE.PERCEPTUAL: vgg`` at
                ``cfg/shape_coco.yml`` width for 2 steps: finite losses
                with the perceptual term, VGG unmoved and without Adam
                state, K1 11 times a step; the device step against phase
                13's;
21. small_eval  the tiny fp32 eval on the GPU (K1) against the CPU (twins),
                same checkpoint, batches and noise: every metric.
22. feed        the host feeds of ``--wire`` and ``--grain`` on the
                manifest: the RAM budget the wire cache's policy finds;
                ``cli.pretrain_damsm`` with ``--wire`` at ``damsm_coco``
                width (3 steps, a snapshot drawn on ``image_u8``),
                ``from_wire`` on the card against the CPU, host->device
                bytes and ms wire against classic, the feed's ms per batch
                cold, the cache's fill and warm against classic, the device
                step on a resident wire batch against a classic one;
                ``cli.train_shape`` with ``--wire`` (3 steps) and its warm
                feed against the polygon-mask feed; ``cli.train_gan`` with
                ``--wire --grain`` at ``coco_objgan`` width (2 steps from
                worker processes, K1 launched as often per step as in phase
                6, K2 and K3 3 times) and every K1, K2 and K3 call of one
                more step on a wire batch held against the twins; the
                worker feed's ms per batch at 0 and WORKERS workers,
                classic and wire, at batch 48; ``cli.evaluate`` with
                ``--grain`` on that Stage-C checkpoint, 2 batches.
23. ddp         data parallelism: ``python -m torch.distributed.run
                --nproc_per_node=1 -m objgan_tpu_torch.gan_main`` (NCCL,
                world size 1) for DDP_STEPS steps at ``coco_objgan``
                width: finite metrics, rank 0's checkpoint and CSV, K1-K3
                launched as often per step as in phase 6, its metrics
                against phase 6's first steps; ``parallel.dryrun.run(2,
                cuda, gloo)``: two ranks on this one card against this
                process at world size 1, 2 tiny fp32 steps of Stage C
                (with EMA sampling), DAMSM, Stage A and Stage B (metrics
                within 2e-3, pixels within 5e-3, each rank launching
                what world size 1 launches) and 3 bf16 Stage-C steps at
                ``coco_objgan`` width (finite, the ranks' parameters
                bitwise equal, K1-K3 at phase 6's counts), ms per step at
                world sizes 1 and 2 side by side;
24. multi_step  ``TRAIN.STEPS_PER_EXECUTION`` = 4: each trainer at full
                width (Stage C at ``coco_objgan``, DAMSM at ``damsm_coco``,
                Stage A at ``Config()``, Stage B at ``shape_coco``) takes
                4 steps as one CUDA-graph replay, from the state, batches
                and noise from which 4 eager steps (the same capturable
                Adam) are taken, and from which K = 1's Adam takes them:
                equal to the bit or within the limits of phase orbax;
                ms per step eager and replayed, the device's busy share
                under torch.profiler, the peak memory, and the graph's
                kernel nodes of K1, K2 and K3 (4 x one step's launches,
                named in the graph's DOT print, as many as the wrappers
                counted during the capture); ``gan_main`` on the manifest
                with K = 4 to step 10 (two executions and the ragged
                tail's two steps: the JAX loop's checkpoints, grids and
                rows), resumed to 14; ``gan_main`` as one NCCL rank under
                torchrun with K = 4;
25. native      the feed's C++ polygon fill (``native/rasterize.cc``,
                built by g++) against its numpy plain version, bitwise, on
                every polygon of the manifest, both timed; a Stage-B batch
                (16 x 10 objects, ``shape_coco``) and an eval batch (16,
                ``eval_coco``) fed with each fill: bitwise equal, host ms
                per batch of each;
26. lineage     random lineage ``.pth`` state dicts at full width through
                the port's tools: ``convert_damsm`` of a text_encoder.pth
                and an inception image_encoder.pth (``damsm_coco``) into
                ``cli.train_gan`` at ``coco_objgan`` width with
                ``TRAIN.NET_E`` (2 steps: the encoders equal the converted
                ones, K1 once per GroupNorm call, K2 and K3 3 times a
                step); ``convert_gan`` of a netG and a netD per scale into
                ``cli.sample_gan`` with ``TRAIN.NET_G`` (one batch);
                ``export_damsm`` and ``convert_damsm`` of the export, the
                same encoders bitwise;
27. breakdown   ``utils/breakdown.py`` with ``analyze=True``: Stage-C
                sampling at ``eval_coco`` width on a manifest batch and the
                train step at ``coco_objgan`` width, every key printed;
                each stage once first: finite, K1 once per GroupNorm call
                (and so in exactly the stages that normalise), K2 3 times
                in each train part, K3 in both gradients;
28. orbax       steps the JAX package wrote with Orbax
                (``tests/data/orbax_fixtures.tar.xz``, no JAX here): the
                full-width ``GanTrainState`` at ``cfg/coco_objgan.yml``
                decoded by the port's reader (libzstd's version, ms, MB)
                and every leaf's sha256 held to JAX's; restored onto a
                ``GanTrainer`` on the card through ``CheckpointManager.
                restore_latest`` (step and each optimiser's step = optax's
                count, every tensor equal); ``cli.train_gan`` resumed from
                a copy for ORBAX_STEPS steps ("resumed from step 1000",
                finite, ``state.pt`` beside the Orbax step), its K1/K2/K3
                calls of one more step against their twins; one batch of
                ``cli.sample_gan`` through ``TRAIN.NET_G``; each tiny
                state (DAMSM, Stage A, B, C) restored and stepped on the
                card and on the CPU, against each other and JAX's step
                (``tests/data/orbax_goldens.npz``); ``run_serve`` composed
                from the tiny box, shape and gan steps, 2 requests;
29. hw_check    ``tools/kernel_hw_check.checked()``: K2 + K3 (fp32, bf16)
                and K1 (fp32, bf16, each with and without GLU) through
                their autograd Functions against their plain versions,
                each check launching its kernels once;
30. guard_pages ``tools/guard_pages.checked()``: K1 (resident and
                streaming plans, the ring, the cluster sizes, the scalar
                paths), K1 backward, K2 and K3 with every input ending at
                an unmapped page, each against its twin and launched once,
                in a subprocess; and its control, one float read past a
                guarded tensor, which must die of an illegal address;
31. processes   no process that the smoke started is left: the worker
                feeds' fork server stopped with the last feed, and the
                resource tracker it started stops here (the ranks and
                torchrun's agent of phase 23 included).

Times are device time from CUDA events around a CUDA-graph replay of one
call, median of 20, unless a line says otherwise. K1, K2, K3 and
``F.group_norm`` are also timed with ten calls of a shape in one graph (a
tenth of the replay, so the graph launch's own cost is spread over ten
calls): the JSON keys ``ms_10_per_graph`` and ``library_ms_10_per_graph``.
The bounds count each input read once and each output written once at
3.35 TB/s, or the arithmetic at 67 TFLOP/s fp32, whichever is larger
(H100 SXM data sheet).
Any failure exits non-zero, and so does a host without a CUDA device,
before anything is printed to stdout. The last lines are the kernel
summary JSON, the card's ``name, power.limit`` from nvidia-smi, and
``{"ok": true, "device": {...}}``.
"""

import concurrent.futures
import contextlib
import copy
import csv
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

_SUBJECTS = ["a man", "two dogs", "a woman", "a cat", "three people",
             "a red bus", "a giraffe"]
_SCENES = ["riding a surfboard on a wave", "playing in a green park",
           "sitting at a table with pizza", "standing next to a car",
           "walking down a city street"]
CAPTIONS = [f"{s} {p}" for p in _SCENES for s in _SUBJECTS]  # 35

K1_SOURCE = "objgan_tpu_torch/csrc/groupnorm.cu"
K1_REPLACES = "objgan_tpu/ops/groupnorm.py:88"
# no TPU kernel: JAX differentiates its reference (custom_vjp backward)
K1B_REPLACES = "objgan_tpu/ops/groupnorm.py:332"
ROI_SOURCE = "objgan_tpu_torch/csrc/roi_align.cu"
K2_REPLACES = "objgan_tpu/ops/roi_align.py:107"
K3_REPLACES = "objgan_tpu/ops/roi_align.py:132"
TRAIN_STEPS = 6
ORBAX_STEPS = 2  # Stage-C steps resumed from the JAX run's step
ORBAX_ARCHIVE = "tests/data/orbax_fixtures.tar.xz"
ORBAX_GOLDENS = "tests/data/orbax_goldens.npz"
# a tiny restored step's metrics against JAX's, relative: the CPU parity
# tests' (tests/test_torch_orbax.py)
ORBAX_METRIC_RTOL = {"gan": 1e-4, "damsm": 1e-4, "box": 2e-5, "shape": 2e-5}
DAMSM_STEPS = 6
BOX_STEPS = 5
SHAPE_STEPS = 5
DDP_STEPS = 2
EVAL_BATCHES = 16  # 256 samples
DATA_DIR = "data_proc2k"  # the manifest's image_file paths are under it
MANIFEST = os.path.join(DATA_DIR, "manifest.json")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
FP32_FLOPS_PER_S = 67e12    # H100 SXM, fp32 outside the tensor cores


def bound_ms(nbytes, flops):
    """(least ms, "bytes" or "operations") for the work on the card."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def bf16_ulp(x):
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    import torch

    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _event_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_ms(fn, reps=20, calls=1):
    """(device ms, eager ms) of one call: medians of ``reps`` CUDA-event
    timings. Device time replays ``calls`` calls captured in one CUDA graph
    and divides by ``calls``, so the host's launch overhead is out of it
    (and with calls > 1 the graph launch's own cost is spread too); eager
    time includes the host work the device waits for when it is otherwise
    idle."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    return _event_ms(graph.replay, reps) / calls, _event_ms(fn, reps)


def graph_kernels(fn):
    """(kernel nodes, all nodes) of a CUDA graph captured around one call of
    ``fn`` (``utils/profiling.py::graph_kernel_nodes``)."""
    import torch

    from objgan_tpu_torch.utils.profiling import graph_kernel_nodes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    kernels, nodes, _ = graph_kernel_nodes(graph.raw_cuda_graph())
    graph.reset()
    return kernels, nodes


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    name = torch.cuda.get_device_name(0)
    log("device", f"nvidia-smi: {card} | torch: {name} | devices "
        f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    return card, name


def phase_build():
    from objgan_tpu_torch.ops import _build

    def build(name):
        t0 = time.monotonic()
        path, compiler_log = _build.build(name, force=True)
        return path, compiler_log, time.monotonic() - t0

    names = {"groupnorm": f"K1 {K1_SOURCE}", "roi_align": f"K2/K3 {ROI_SOURCE}"}
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        jobs = {name: pool.submit(build, name) for name in names}
        for name, job in jobs.items():
            path, compiler_log, secs = job.result()
            log("build", f"{names[name]} -> {os.path.relpath(path, ROOT)} in "
                f"{secs:.2f} s")
            for line in compiler_log.splitlines():
                if "registers" in line or "spill" in line:
                    log("build", "ptxas: " + line.strip())
    for name in names:
        _build.load(name)


def phase_serve(cfg, vocab, pipe):
    import torch

    from objgan_tpu_torch.models.common import FusedGroupNorm
    from objgan_tpu_torch.ops import groupnorm
    from objgan_tpu_torch.serving import run_serve

    n_gn = sum(isinstance(m, FusedGroupNorm) for m in pipe.modules())
    outs = []
    generate = pipe.generate

    def recording_generate(*args, **kwargs):
        out = generate(*args, **kwargs)
        outs.append(out)
        return out

    pipe.generate = recording_generate
    reqs = [{"id": i, "caption": c} for i, c in enumerate(CAPTIONS)]
    responses = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            groupnorm.launches = 0
            stats = run_serve(cfg, vocab, reqs, tmp, batch_size=16,
                              emit=responses.append, device="cuda",
                              pipeline=pipe)
            torch.cuda.synchronize()
            launches = groupnorm.launches
            check(len(responses) == len(CAPTIONS),
                  f"{len(responses)} responses for {len(CAPTIONS)} requests")
            check([r["id"] for r in responses] == list(range(len(CAPTIONS))),
                  "responses out of request order")
            check(all(r["image"] and os.path.getsize(r["image"]) > 0
                      for r in responses), "missing PNGs")
    finally:
        del pipe.generate
    n_obj = sum(len(r["objects"]) for r in responses)
    batches = stats["batches"]
    check(batches == 3, f"{batches} batches for 35 requests at batch 16")
    check(launches == batches * n_gn,
          f"K1 launched {launches} times for {batches} batches x {n_gn} "
          f"GroupNorm layers")
    for out in outs:
        for img in out["images"]:
            check(bool(torch.isfinite(img).all()), "non-finite image")
            check(float(img.abs().max()) <= 1.0, "image outside [-1, 1]")
    last = outs[-1]["images"][-1]
    check(tuple(last.shape) == (16, 256, 256, 3),
          f"last-scale images {tuple(last.shape)}")
    done = stats["batch_done_s"]
    steady_ms = 1000.0 * (done[-1] - done[0]) / (len(done) - 1)
    log("serve", f"{stats['requests']} requests in {batches} batches of 16, "
        f"{n_obj} objects laid out; images {tuple(last.shape)} finite in "
        f"[-1, 1]")
    log("serve", f"K1 launches {launches} = {batches} batches x {n_gn} "
        f"GroupNorm layers")
    log("serve", f"first batch done at {done[0]:.3f} s; steady state "
        f"{steady_ms:.1f} ms/batch ({16000.0 / steady_ms:.1f} req/s); "
        f"whole run {stats['req_per_s']} req/s over {stats['wall_s']} s")
    log("serve", "host PNG + JSON emit per batch: " + ", ".join(
        f"{1000 * t:.1f} ms" for t in stats["emit_s"]))
    return launches


def _record_gn(module):
    """(records, hooks): every FusedGroupNorm call under ``module`` appends
    (the layer, a copy of its input) to records until the hooks go."""
    from objgan_tpu_torch.models.common import FusedGroupNorm

    records = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: records.append((mod, args[0].detach().clone())))
        for m in module.modules() if isinstance(m, FusedGroupNorm)]
    return records, hooks


def phase_kernels(cfg, vocab, pipe):
    """Every K1 call of one served batch against the twin, timed."""
    import torch

    from objgan_tpu_torch.pipeline_e2e import draw_noise

    records, hooks = _record_gn(pipe)
    ids, lens = vocab.encode_batch(CAPTIONS[:16], cfg.TEXT.WORDS_NUM)
    noise = draw_noise(cfg, 16, torch.Generator("cuda").manual_seed(1),
                       "cuda")
    try:
        pipe.generate(torch.from_numpy(ids).long().cuda(),
                      torch.from_numpy(lens).long().cuda(), noise)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return _check_k1("kernels", records, "batch")


def _check_k1(phase, records, per):
    """Replays each recorded K1 call through the kernel and its twin and
    fails on any output beyond tolerance; then times each distinct call
    shape (kernel, twin, ``F.group_norm``) against its bound. Returns (max
    error, totals over the calls: the work of one ``per``)."""
    import torch

    from objgan_tpu_torch.ops import groupnorm, twin_rules
    from objgan_tpu_torch.ops.groupnorm import (group_norm_cuda,
                                                group_norm_reference,
                                                plan_for)

    log(phase, f"recorded {len(records)} K1 calls of one {per}; tolerance "
        f"fp32 atol {twin_rules.FP32_ATOL} (against the twin in fp64), bf16 "
        f"atol {twin_rules.K1_BF16_ATOL} rtol {twin_rules.K1_BF16_RTOL}; "
        f"each call run twice and held bitwise equal")
    max_err = 0.0
    shapes = {}
    for mod, x in records:
        b, c = x.shape[0], x.shape[-1]
        x3 = x.reshape(b, -1, c).contiguous()
        args = (mod.weight, mod.bias, mod.num_groups, mod.eps, mod.use_glu)
        got = group_norm_cuda(x3, *args)
        check(bool(torch.equal(got, group_norm_cuda(x3, *args))),
              f"K1 is not bit-reproducible at {tuple(x3.shape)}")
        key = (tuple(x3.shape), str(x3.dtype).replace("torch.", ""),
               mod.num_groups, mod.use_glu)
        want = twin_rules.k1_twin(x3, *args)
        e, ok = twin_rules.k1(got, want, x3.dtype)
        check(ok, f"K1 vs twin {key}: max err {e:.3g}")
        err = (got.float() - group_norm_reference(x3, *args).float()).abs()
        twin_e = float(err.max())
        ulps = (float((err / bf16_ulp(want.float())).max())
                if x3.dtype == torch.bfloat16 else float("nan"))
        max_err = max(max_err, e)
        entry = shapes.setdefault(key, {"count": 0, "err": 0.0, "ulps": 0.0,
                                        "twin_err": 0.0, "x": x3,
                                        "args": args})
        entry["count"] += 1
        entry["err"] = max(entry["err"], e)
        entry["twin_err"] = max(entry["twin_err"], twin_e)
        entry["ulps"] = max(entry["ulps"], ulps)
    import torch.nn.functional as F

    def library(x3, scale, bias, groups, eps, glu):
        # F.group_norm takes (B, C, N): the channels-last tensor's permuted
        # view; with GLU a second call, F.glu over the channel halves
        y = F.group_norm(x3.permute(0, 2, 1), groups, scale.to(x3.dtype),
                         bias.to(x3.dtype), eps)
        return F.glu(y, dim=1) if glu else y

    tot = {"ms": 0.0, "ms_10_per_graph": 0.0, "plain_ms": 0.0, "eager_ms": 0.0,
           "plain_eager_ms": 0.0, "library_ms": 0.0,
           "library_ms_10_per_graph": 0.0, "bound_ms": 0.0, "regimes": {}}
    for key, s in shapes.items():
        x3, args = s["x"], s["args"]
        plan = plan_for(x3, args[-1])
        kernels, nodes = graph_kernels(lambda: group_norm_cuda(x3, *args))
        check(kernels == 1 and nodes == 1,
              f"one K1 call at {tuple(x3.shape)} captured {kernels} kernels "
              f"in {nodes} graph nodes")
        k_ms, k_eager = time_ms(lambda: group_norm_cuda(x3, *args))
        k_ten, _ = time_ms(lambda: group_norm_cuda(x3, *args), calls=10)
        # clusters of the plan the card holds at once (occupancy query)
        held = groupnorm._schedulable[(
            x3.device.index or 0, groupnorm._DTYPE_CODE[x3.dtype], plan.vec,
            args[-1], plan.cluster, plan.smem)]
        p_ms, p_eager = time_ms(lambda: group_norm_reference(x3, *args))
        l_ms, _ = time_ms(lambda: library(x3, *args))
        l_ten, _ = time_ms(lambda: library(x3, *args), calls=10)
        lib_err = float((library(x3, *args).permute(0, 2, 1).float()
                         - group_norm_reference(x3, *args).float()
                         ).abs().max())
        (b, nn_, c), dt, g, glu = key
        nbytes = (x3.numel() * x3.element_size() * (3 if glu else 4) // 2
                  + 2 * 4 * c)  # x read once, y written once, scale, bias
        b_ms, _ = bound_ms(nbytes, 8 * x3.numel())
        n = s["count"]
        for k, v in (("ms", k_ms), ("ms_10_per_graph", k_ten),
                     ("plain_ms", p_ms), ("eager_ms", k_eager),
                     ("plain_eager_ms", p_eager), ("library_ms", l_ms),
                     ("library_ms_10_per_graph", l_ten), ("bound_ms", b_ms)):
            tot[k] += n * v
        tot["regimes"][plan.regime] = tot["regimes"].get(plan.regime, 0) + n
        # achieved rate (ten calls per graph) over 1R + 1W (x read once)
        # and 2R + 1W (x read twice): above 3.35 TB/s over 2R + 1W, the
        # second read hit L2
        x_bytes = x3.numel() * x3.element_size()
        gbps_1r = nbytes / (k_ten * 1e6)
        gbps_2r = (nbytes + x_bytes) / (k_ten * 1e6)
        log(phase, f"(B={b}, N={nn_}, C={c}) {dt} groups {g} "
            f"{'GN+GLU' if glu else 'GN'} x{n}: {plan.regime} cluster "
            f"{plan.cluster} ({held} at once), {plan.res_rows}/{plan.rows} "
            f"rows resident, "
            f"{kernels} kernel per call | max err "
            f"{s['err']:.3g} ({s['ulps']:.2f} bf16 ulp; against the fp32 "
            f"twin {s['twin_err']:.3g}) | device, one call "
            f"per graph: K1 {1000 * k_ms:.1f} us, bound {1000 * b_ms:.1f} "
            f"us, twin {1000 * p_ms:.1f} us, "
            f"{'F.group_norm+F.glu' if glu else 'F.group_norm'} "
            f"{1000 * l_ms:.1f} us (max err {lib_err:.3g}) | ten per graph: "
            f"K1 {1000 * k_ten:.1f} us ({gbps_1r:.0f} GB/s over 1R+1W, "
            f"{gbps_2r:.0f} over 2R+1W), library {1000 * l_ten:.1f} us | "
            f"eager K1 {1000 * k_eager:.1f} us, twin {1000 * p_eager:.1f} us")
    log(phase, f"all {len(records)} calls agree and are bit-reproducible; "
        f"a CUDA graph of one call of each of the {len(shapes)} shapes holds "
        f"one kernel node; regimes " + ", ".join(
            f"{k} {v}" for k, v in sorted(tot["regimes"].items())))
    log(phase, f"per {per}, device, one call per graph: K1 "
        f"{tot['ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms, twin "
        f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms "
        f"(two calls for each GN+GLU); ten per graph: K1 "
        f"{tot['ms_10_per_graph']:.3f} ms, library "
        f"{tot['library_ms_10_per_graph']:.3f} ms; eager: K1 "
        f"{tot['eager_ms']:.3f} ms vs twin {tot['plain_eager_ms']:.3f} ms")
    return max_err, tot


def _check_k1_bwd(phase, calls, per, timed=False):
    """Replays each recorded K1 backward call (``_record_train_step``'s:
    the arguments and the needs flags) through the kernel twice, held
    bitwise equal, and against the twin's VJP in fp64 on the card
    (``twin_rules.k1_grad``). With ``timed``,
    times each distinct call (one and ten per graph, eager), the twin's
    VJP and, without GLU, aten's ``native_group_norm_backward`` on
    channels-first copies (its layout; GLU has no library backward),
    against the bound (x, dy read once, dx, dscale, dbias written once;
    12 operations an element), and all the calls in one graph. Returns
    (max dx error, largest dscale/dbias error over its magnitude, without
    GLU in bf16 and with it, totals over the calls: the work of one
    ``per``, with bf16 dx's largest error in bf16 ulps of the fp64 value
    under "dx_ulps", over the elements where rtol sets the limit)."""
    import torch

    from objgan_tpu_torch.ops import twin_rules as tr
    from objgan_tpu_torch.ops.groupnorm import (
        bwd_plan_for, group_norm_backward_cuda, group_norm_backward_reference)

    log(phase, f"recorded {len(calls)} K1 backward calls of one {per}; "
        f"against the twin's VJP in fp64: dx fp32 atol {tr.FP32_ATOL}, bf16 "
        f"atol {tr.K1_BF16_ATOL} rtol {tr.K1_BF16_RTOL}; dscale, dbias "
        f"{tr.PARAM_RTOL} of their largest magnitude (bf16 GLU: atol "
        f"{tr.K1_BF16_ATOL} of it, rtol {tr.K1_BF16_RTOL}); each call run "
        f"twice and held bitwise equal")
    dx_err, dx_ulps, param_err = 0.0, 0.0, {"plain": 0.0, "bf16_glu": 0.0}
    shapes = {}
    for args, needs in calls:
        x3, scale, bias, groups, eps, glu, gy = args
        bf16_glu = glu and x3.dtype == torch.bfloat16
        key = (tuple(x3.shape), str(x3.dtype).replace("torch.", ""), groups,
               glu, needs)
        got = group_norm_backward_cuda(*args, needs=needs)
        again = group_norm_backward_cuda(*args, needs=needs)
        check(all((g is None) == (not w) for g, w in zip(got, needs)),
              f"K1 backward {key} returned {[g is None for g in got]}")
        check(all(g is None or torch.equal(g, a) for g, a in zip(got, again)),
              f"K1 backward is not bit-reproducible at {key}")
        want = group_norm_backward_reference(
            x3.double(), scale.double(), bias.double(), groups, eps, glu,
            gy.double(), needs)
        errs = {}
        for name, g, w in zip(("dx", "dscale", "dbias"), got, want):
            if g is None:
                continue
            errs[name], ok = tr.k1_grad(name, g, w, x3.dtype, glu)
            check(ok, f"K1 backward vs twin in fp64 {key}: {name} max err "
                  f"{errs[name]:.3g}"
                  f"{'' if name == 'dx' else ' over its magnitude'}")
            if name == "dx" and x3.dtype == torch.bfloat16:
                # in bf16 ulps, over the elements where rtol sets the limit
                big = w.abs() >= tr.K1_BF16_ATOL / tr.K1_BF16_RTOL
                if bool(big.any()):
                    dx_ulps = max(dx_ulps, float(
                        ((g.double() - w).abs()[big]
                         / bf16_ulp(w[big])).max()))
        dx_err = max(dx_err, errs.get("dx", 0.0))
        which = "bf16_glu" if bf16_glu else "plain"
        param_err[which] = max([param_err[which]] + [
            v for k, v in errs.items() if k != "dx"])
        entry = shapes.setdefault(key, {"count": 0, "args": args, "err": {}})
        entry["count"] += 1
        for k, v in errs.items():
            entry["err"][k] = max(entry["err"].get(k, 0.0), v)
    tot = {"ms": 0.0, "ms_10_per_graph": 0.0, "eager_ms": 0.0,
           "plain_ms": 0.0, "plain_eager_ms": 0.0, "library_ms": 0.0,
           "library_calls": 0, "bound_ms": 0.0, "kernels": 0,
           "regimes": {}, "dx_ulps": dx_ulps}
    if not timed:
        log(phase, f"all {len(calls)} calls agree and are bit-reproducible: "
            f"max dx err {dx_err:.3g} ({dx_ulps:.2f} bf16 ulp in bf16), "
            f"dscale/dbias err over magnitude "
            f"{param_err['plain']:.3g} ({param_err['bf16_glu']:.3g} bf16 "
            f"GLU)")
        return dx_err, param_err, tot
    for key, s in shapes.items():
        args, needs = s["args"], key[-1]
        x3, scale, bias, groups, eps, glu, gy = args
        (b, n, c), dt = key[0], key[1]

        def call(args=args, needs=needs):
            return group_norm_backward_cuda(*args, needs=needs)

        plan = bwd_plan_for(x3, gy.contiguous(), glu, needs)
        kernels, nodes = graph_kernels(call)
        check(kernels == nodes == 1 + plan.params, f"one K1 backward call "
              f"{key} captured {kernels} kernels in {nodes} graph nodes")
        k_ms, k_eager = time_ms(call)
        k_ten, _ = time_ms(call, calls=10)
        p_ms, p_eager = time_ms(
            lambda: group_norm_backward_reference(*args, needs))
        lib = "none (GLU)"
        l_ms = 0.0
        if not glu:
            # aten's kernel on (B, C, N) copies, scale and bias in x's dtype
            xc = x3.permute(0, 2, 1).contiguous()
            gc = gy.permute(0, 2, 1).contiguous()
            w = scale.to(x3.dtype)
            _, mean, rstd = torch.ops.aten.native_group_norm(
                xc, w, bias.to(x3.dtype), b, c, n, groups, eps)

            def library(xc=xc, gc=gc, w=w, mean=mean, rstd=rstd):
                return torch.ops.aten.native_group_norm_backward(
                    gc, xc, mean, rstd, w, b, c, n, groups, list(needs))

            l_ms, _ = time_ms(library)
            lib = f"{1000 * l_ms:.1f} us"
            lib_dx = library()[0]
            if lib_dx is not None:
                ref = group_norm_backward_reference(
                    x3.double(), scale.double(), bias.double(), groups, eps,
                    glu, gy.double(), needs)[0]
                lib_err = (lib_dx.permute(0, 2, 1).double() - ref).abs()
                lib += f" (dx max err {float(lib_err.max()):.3g})"
            tot["library_calls"] += s["count"]
        itemsize = x3.element_size()
        nbytes = (x3.numel() * itemsize * (1 + needs[0])
                  + gy.numel() * itemsize + 4 * c * (1 + needs[1] + needs[2]))
        b_ms, _ = bound_ms(nbytes, 12 * x3.numel())
        cnt = s["count"]
        for k, v in (("ms", k_ms), ("ms_10_per_graph", k_ten),
                     ("eager_ms", k_eager), ("plain_ms", p_ms),
                     ("plain_eager_ms", p_eager), ("library_ms", l_ms),
                     ("bound_ms", b_ms)):
            tot[k] += cnt * v
        tot["kernels"] += cnt * kernels
        tot["regimes"][plan.regime] = tot["regimes"].get(plan.regime, 0) + cnt
        log(phase, f"(B={b}, N={n}, C={c}) {dt} "
            f"{'GN+GLU' if glu else 'GN'} needs "
            f"{''.join('x' if w else '-' for w in needs)} x{cnt}: "
            f"{plan.regime} cluster {plan.cluster}, {plan.res_rows}/"
            f"{plan.rows} rows kept, {kernels} kernels | err " + ", ".join(
                f"{k} {v:.3g}" for k, v in s["err"].items())
            + f" (dscale, dbias over their magnitude) | one call per graph: "
            f"{1000 * k_ms:.1f} us, ten per graph {1000 * k_ten:.1f} us, "
            f"bound {1000 * b_ms:.1f} us, twin's VJP {1000 * p_ms:.1f} us, "
            f"native_group_norm_backward {lib} | eager {1000 * k_eager:.1f} "
            f"us, twin {1000 * p_eager:.1f} us")

    def every_call():
        for args, needs in calls:
            group_norm_backward_cuda(*args, needs=needs)

    all_ms, _ = time_ms(every_call, reps=10)
    tot["all_in_one_graph_ms"] = all_ms
    log(phase, f"all {len(calls)} calls agree and are bit-reproducible: max "
        f"dx err {dx_err:.3g} ({dx_ulps:.2f} bf16 ulp in bf16), dscale/dbias "
        f"err over magnitude "
        f"{param_err['plain']:.3g} ({param_err['bf16_glu']:.3g} bf16 GLU); "
        f"{tot['kernels']} kernels; regimes " + ", ".join(
            f"{k} {v}" for k, v in sorted(tot["regimes"].items())))
    log(phase, f"per {per}, device, one call per graph: K1 backward "
        f"{tot['ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
        f"({100 * tot['bound_ms'] / tot['ms']:.1f} %), twin's VJP "
        f"{tot['plain_ms']:.3f} ms; ten per graph {tot['ms_10_per_graph']:.3f}"
        f" ms; all {len(calls)} in one graph {all_ms:.3f} ms; eager "
        f"{tot['eager_ms']:.3f} ms vs twin {tot['plain_eager_ms']:.3f} ms; "
        f"native_group_norm_backward on the {tot['library_calls']} calls "
        f"without GLU {tot['library_ms']:.3f} ms")
    return dx_err, param_err, tot


def phase_stages(cfg, vocab, pipe):
    """Synchronised wall time of each stage of one batch, median of 3."""
    import torch

    from objgan_tpu_torch.pipeline_e2e import draw_noise
    from objgan_tpu_torch.train import box as box_train
    from objgan_tpu_torch.train import gan as gan_train
    from objgan_tpu_torch.train import shape as shape_train

    o = cfg.OBJ.MAX_OBJECTS
    check(cfg.BOX.MAX_SEQ_LENGTH >= o, "stage timing assumes no object pad")
    ids, lens = vocab.encode_batch(CAPTIONS[16:32], cfg.TEXT.WORDS_NUM)
    ids = torch.from_numpy(ids).long().cuda()
    lens = torch.from_numpy(lens).long().cuda()
    gen = torch.Generator("cuda").manual_seed(2)
    times = {"A boxes": [], "B masks": [], "C image": [], "generate": []}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append(1000 * (time.perf_counter() - t0))
        return out

    with torch.inference_mode():
        for _ in range(3):
            noise = draw_noise(cfg, 16, gen, "cuda")
            lay = timed("A boxes", lambda: box_train.sample(
                pipe.box, ids, lens, noise))
            labels, boxes, valid = (lay["labels"][:, :o], lay["boxes"][:, :o],
                                    lay["obj_valid"][:, :o])
            masks = timed("B masks", lambda: shape_train.sample(
                pipe.shape, boxes, labels, valid, noise["shape_z"]))
            batch = {"captions": ids, "cap_lens": lens, "labels": labels,
                     "boxes": boxes, "shapes": masks, "obj_valid": valid}
            timed("C image", lambda: gan_train.sample(
                pipe.gan, batch, noise["z"], noise["ca_eps"]))
            timed("generate", lambda: pipe.generate(ids, lens, noise))
    log("stages", "median of 3 synchronised batches of 16: " + ", ".join(
        f"{k} {statistics.median(v):.1f} ms" for k, v in times.items()))


def phase_small():
    import numpy as np
    import torch

    from objgan_tpu_torch.core.config import tiny_test_config
    from objgan_tpu_torch.ops import groupnorm
    from objgan_tpu_torch.pipeline_e2e import ObjGanPipeline, draw_noise

    cfg = tiny_test_config().merged({"DTYPE": "float32"})
    cpu = ObjGanPipeline.fresh(cfg, 0, "cpu")
    gpu = copy.deepcopy(cpu).cuda()
    r = np.random.default_rng(0)
    caps = torch.from_numpy(r.integers(1, cfg.TEXT.VOCAB_SIZE,
                                       (4, cfg.TEXT.WORDS_NUM)))
    lens = torch.tensor([6, 5, 3, 2])
    noise = draw_noise(cfg, 4, torch.Generator().manual_seed(2), "cpu")
    before = groupnorm.launches
    want = cpu.generate(caps, lens, noise)
    got = gpu.generate(caps.cuda(), lens.cuda(),
                       {k: v.cuda() for k, v in noise.items()})
    torch.cuda.synchronize()
    check(groupnorm.launches > before, "the GPU run launched no K1")
    check(torch.equal(got["labels"].cpu(), want["labels"]),
          "labels differ between GPU and CPU")
    check(torch.equal(got["obj_valid"].cpu(), want["obj_valid"]),
          "obj_valid differs between GPU and CPU")
    box_err = float((got["boxes"].cpu() - want["boxes"]).abs().max())
    img_err = max(float((g.cpu() - w).abs().max())
                  for g, w in zip(got["images"], want["images"]))
    check(box_err <= 1e-4, f"boxes differ by {box_err:.3g}")
    check(img_err <= 1e-3, f"images differ by {img_err:.3g}")
    log("small", f"tiny fp32 config, GPU (K1) vs CPU (twin), same weights "
        f"and noise: labels equal, {int(want['obj_valid'].sum())} objects, "
        f"box err {box_err:.3g} (atol 1e-4), image err {img_err:.3g} "
        f"(atol 1e-3)")


# the kernels whose wrappers count their calls, in ``_counts``' order
COUNTED = ("K1", "K2", "K3", "K1 backward")


def _counts():
    from objgan_tpu_torch.ops import groupnorm, roi_align

    return (groupnorm.launches, roi_align.launches["fwd"],
            roi_align.launches["bwd"], groupnorm.bwd_launches)


def _reset_counts():
    from objgan_tpu_torch.ops import groupnorm, roi_align

    groupnorm.launches = groupnorm.bwd_launches = 0
    roi_align.launches.update(fwd=0, bwd=0)


def _nets(trainer):
    return {"G": trainer.g_net, "objD": trainer.obj_d,
            **{f"D{i}": d for i, d in enumerate(trainer.d_nets)}}


def _metric_lines(text):
    """The "[step N] name=value ... steps_per_sec=v" lines of a run (what
    ``cli._run_loop`` prints), as dicts."""
    return [{k: float(v) for k, v in (kv.split("=") for kv in
                                      ln.split("] ", 1)[1].split())}
            for ln in text.splitlines() if ln.startswith("[step ")]


def phase_train(cfg):
    """The Stage-C train step at full width through ``cli.train_gan``, what
    ``python -m objgan_tpu_torch.gan_main`` runs, logging every step."""
    import collections
    import contextlib
    import io

    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.models.common import FusedGroupNorm
    from objgan_tpu_torch.models.discriminator import ObjectDNet

    # the weights train_gan starts from: make_trainer draws them on the CPU
    # from cfg.RNG_SEED, whatever the device
    t0 = time.monotonic()
    nets = _nets(cli.make_trainer(cfg, "cpu"))
    before = {k: [p.detach().clone() for p in n.parameters()]
              for k, n in nets.items()}
    log("train", f"cfg/coco_objgan.yml: batch {cfg.TRAIN.BATCH_SIZE}, DTYPE "
        f"{cfg.DTYPE}, D_DTYPE {cfg.GAN.D_DTYPE}, pyramid "
        f"{cfg.branch_sizes}, DF_DIM {cfg.GAN.DF_DIM}, GF_DIM "
        f"{cfg.GAN.GF_DIM}, MAX_OBJECTS {cfg.OBJ.MAX_OBJECTS}, ROI_SIZE "
        f"{cfg.OBJ.ROI_SIZE}, REMAT {cfg.GAN.REMAT}, CNN_BACKBONE "
        f"{cfg.TEXT.CNN_BACKBONE}; M params " + ", ".join(
            f"{k} {sum(p.numel() for p in n.parameters()) / 1e6:.2f}"
            for k, n in nets.items()) + f"; initial weights drawn in "
        f"{time.monotonic() - t0:.1f} s")
    del nets
    calls = collections.Counter()

    def count(mod, _):
        calls[type(mod)] += 1

    out = io.StringIO()
    hook = torch.nn.modules.module.register_module_forward_pre_hook(count)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            trainer = cli.train_gan(cfg, max_steps=TRAIN_STEPS,
                                    device="cuda", log_every=1)
        torch.cuda.synchronize()
        k1, k2, k3, k1b = _counts()
        wall_s = time.monotonic() - t0
    finally:
        hook.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    seen = _metric_lines(out.getvalue())
    check(len(seen) == TRAIN_STEPS, f"{len(seen)} metric lines for "
          f"{TRAIN_STEPS} steps")
    times = [1000.0 / m.pop("steps_per_sec") for m in seen]
    gn_calls, objd_calls = calls[FusedGroupNorm], calls[ObjectDNet]
    check(k1 > 0 and k1 == gn_calls and k1 % TRAIN_STEPS == 0,
          f"K1 launched {k1} times for {gn_calls} GroupNorm calls in "
          f"{TRAIN_STEPS} steps")
    check(objd_calls == 3 * TRAIN_STEPS,
          f"{objd_calls} ObjectDNet calls in {TRAIN_STEPS} steps")
    # each ObjectDNet call launches K2 once (twice under REMAT stages, which
    # recomputes it in the backward); its backward launches K3 once
    roi_per_call = 2 if cfg.GAN.REMAT == "stages" else 1
    check(k2 == 3 * roi_per_call * TRAIN_STEPS and k3 == 3 * TRAIN_STEPS,
          f"K2 launched {k2}, K3 {k3} times in {TRAIN_STEPS} steps (expected "
          f"{3 * roi_per_call} and 3 per step)")
    # every GroupNorm of a train step takes a gradient: one K1 backward call
    # per K1 launch
    check(k1b == k1, f"K1 backward called {k1b} times for {k1} K1 launches "
          f"in {TRAIN_STEPS} steps")
    bad = [k for m in seen for k, v in m.items() if not math.isfinite(v)]
    check(not bad, f"non-finite metrics: {sorted(set(bad))}")
    moved = {}
    for k, n in _nets(trainer).items():
        same = sum(bool(torch.equal(a, p.detach().cpu()))
                   for a, p in zip(before[k], n.parameters()))
        check(same == 0, f"{k}: {same} parameter tensors did not change")
        moved[k] = len(before[k])
    median = statistics.median(times[1:])
    log("train", f"cli.train_gan took {TRAIN_STEPS} steps on synthetic "
        f"batches in {wall_s:.1f} s (trainer set-up included); every metric "
        f"finite; every parameter tensor moved from its initial weights ("
        + ", ".join(f"{k} {v}" for k, v in moved.items()) + ")")
    log("train", f"launches in {TRAIN_STEPS} steps: K1 {k1} (= {gn_calls} "
        f"GroupNorm calls, {k1 // TRAIN_STEPS} per step), K2 {k2}, K3 {k3} "
        f"({objd_calls} ObjectDNet calls); K1 backward calls {k1b}")
    log("train", "synchronised ms per step (train_gan's steps_per_sec): "
        + ", ".join(f"{t:.1f}" for t in times) + f"; median after the first "
        f"{median:.1f} ms ({cfg.TRAIN.BATCH_SIZE * 1000.0 / median:.1f} "
        f"img/s); peak memory allocated {peak_gb:.2f} GiB")
    log("train", "last step: " + ", ".join(
        f"{k} {seen[-1][k]:.4g}" for k in ("d_loss", "g_loss", "objd_real",
                                           "objd_fake", "objd_cls", "g_obj",
                                           "damsm", "kl")))
    with open(os.path.join(cfg.OUTPUT_DIR, f"{cfg.CONFIG_NAME}_gan",
                           "gan_metrics.csv")) as f:
        rows = [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)]
    return trainer, {"k1": k1, "k2": k2, "k3": k3, "k1 backward": k1b,
                     "ms": median,
                     "k1_per_step": k1 // TRAIN_STEPS, "rows": rows}


def phase_train_profile(cfg, trainer):
    """One steady train step under torch.profiler: how busy the device is
    and which kernels take its time (the profiler's own overhead is in the
    wall time, so the busy share is a lower bound)."""
    import collections
    import re

    import torch

    from objgan_tpu_torch.data.synthetic import synthetic_batch
    from objgan_tpu_torch.train.gan import train_noise
    from objgan_tpu_torch.utils.profiling import device_profile

    gen = torch.Generator("cuda").manual_seed(9)
    batch = synthetic_batch(cfg, gen)
    noise = train_noise(cfg, cfg.TRAIN.BATCH_SIZE, gen, "cuda")

    def step():
        trainer.train_step(batch, noise["z"], noise["ca_eps"])

    wall_ms, busy_ms, spans = device_profile(step)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    groups = collections.defaultdict(float)
    roi = {"K2": [0.0, 0], "K3": [0.0, 0]}
    for a, b, name in spans:
        ms = (b - a) / 1000.0
        by_name[name][0] += ms
        by_name[name][1] += 1
        group = ("K1 GroupNorm" if re.search(
                     "gn_fused_kernel", name) else
                 "K1 backward" if re.search("gn_bwd", name) else
                 "K2 ROI-align fwd" if re.search("roi_fwd_kernel", name) else
                 "K3 ROI-align bwd" if re.search("roi_bwd_kernel", name) else
                 "conv / matmul" if re.search(
                     "conv|gemm|xmma|cudnn|cutlass|wgrad|dgrad|fprop|sm90",
                     name, re.I) else
                 "other (elementwise, reductions, copies)")
        groups[group] += ms
        if group.startswith(("K2", "K3")):
            roi[group[:2]][0] += ms
            roi[group[:2]][1] += 1
    log("profile", f"one train step under torch.profiler: wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms (share "
        f"{busy_ms / wall_ms:.3f}), {len(spans)} device activities")
    log("profile", "device ms by kernel group: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(groups.items(),
                                          key=lambda kv: -kv[1])))
    log("profile", "ROI-align in the step: " + ", ".join(
        f"{k} {v[0]:.4f} ms over {v[1]} launches" for k, v in roi.items()))
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:10]:
        log("profile", f"  {ms:8.3f} ms x{count:4d}  {name[:90]}")


def _roi_requested(name, boxes, f_shape, out_size, q, itemsize):
    """A model, not a measurement: the bytes that one call's loads would
    request from L2 or device memory (features for K2, g for K3) if they
    follow the launch plan, counted on the host from this call's boxes. K2
    copies each box's footprint once, every channel: modelled as the span
    of pixels its bins weigh along each axis. K3 copies, per block and per
    box that meets it, the box's rows of g that meet the block's band, R
    vectors of the tile's channels each."""
    import torch

    from objgan_tpu_torch.ops import roi_align as ra

    b, h, w, c = f_shape
    a_y, a_x = ra._pool_matrices(boxes, h, w, out_size, q)
    nzy, nzx = a_y != 0, a_x != 0  # (B, O, R, H | W)
    if name == "K2":
        pixels = 1
        for nz in (nzy.any(-2), nzx.any(-2)):  # (B, O, H | W)
            n = nz.shape[-1]
            first = nz.int().argmax(-1)
            last = n - 1 - nz.flip(-1).int().argmax(-1)
            pixels = pixels * torch.where(nz.any(-1), last - first + 1, 0)
        return int(pixels.sum()) * c * itemsize
    plan = ra.bwd_plan(b, h, w, c, boxes.shape[1], out_size, q, itemsize)
    i = torch.arange(out_size, device=boxes.device)[:, None]
    rows = 0
    for y0 in range(0, h, plan.band):
        meet = nzy[..., y0:y0 + plan.band].any(-1, keepdim=True)  # (B,O,R,1)
        first = torch.where(meet, i, out_size).amin((-1, -2))
        last = torch.where(meet, i + 1, 0).amax((-1, -2))
        n_rows = (last - first).clamp(min=0)  # (B, O)
        for x0 in range(0, w, plan.cols):
            hit = nzx[..., x0:x0 + plan.cols].any((-1, -2))
            rows += int((n_rows * hit).sum())
    return rows * out_size * c * itemsize


def _record_train_step(cfg, trainer, batch=None):
    """One full-width train step on ``batch`` (a synthetic one when None)
    with every kernel call's input copied: (K1 records as ``_record_gn``
    makes them, K2 calls, K3 calls, the batch's padded-object mask, K1
    backward calls as ``_check_k1_bwd`` takes them)."""
    import torch

    from objgan_tpu_torch.data.synthetic import synthetic_batch
    from objgan_tpu_torch.ops import groupnorm
    from objgan_tpu_torch.ops import roi_align as ra
    from objgan_tpu_torch.train.gan import train_noise

    fwd, bwd, gn_bwd = [], [], []
    orig = ra.roi_align_cuda, ra.roi_align_backward_cuda
    orig_gn_bwd = groupnorm.group_norm_backward_cuda

    def rec_gn_bwd(*args, needs=(True, True, True)):
        # scale and bias too: Adam updates them in place after the backward
        gn_bwd.append((tuple(a.detach().clone() if torch.is_tensor(a) else a
                             for a in args), tuple(needs)))
        return orig_gn_bwd(*args, needs=needs)

    def rec_fwd(features, boxes, out_size, q):
        fwd.append((features.detach().clone(), boxes.clone(), out_size, q))
        return orig[0](features, boxes, out_size, q)

    def rec_bwd(boxes, g, f_shape, out_size, q):
        bwd.append((boxes.clone(), g.detach().clone(), f_shape, out_size, q))
        return orig[1](boxes, g, f_shape, out_size, q)

    gen = torch.Generator("cuda").manual_seed(7)
    if batch is None:
        batch = synthetic_batch(cfg, gen)
    noise = train_noise(cfg, cfg.TRAIN.BATCH_SIZE, gen, "cuda")
    gn, hooks = _record_gn(trainer)
    ra.roi_align_cuda, ra.roi_align_backward_cuda = rec_fwd, rec_bwd
    groupnorm.group_norm_backward_cuda = rec_gn_bwd
    try:
        trainer.train_step(batch, noise["z"], noise["ca_eps"])
        torch.cuda.synchronize()
    finally:
        ra.roi_align_cuda, ra.roi_align_backward_cuda = orig
        groupnorm.group_norm_backward_cuda = orig_gn_bwd
        for h in hooks:
            h.remove()
    return gn, fwd, bwd, batch["obj_valid"] == 0, gn_bwd


def _unit_rms(g):
    """A train step's K3 cotangent (~1e-4, far below the bf16 atol) scaled
    to unit RMS, so that the tolerance is small against what is
    compared."""
    return (g.float() / g.float().square().mean().sqrt()).to(g.dtype)


def phase_roi(fwd, bwd, pad):
    """Every K2/K3 call of one train step against the twins, timed."""
    import torch

    from objgan_tpu_torch.ops import roi_align as ra
    from objgan_tpu_torch.ops import twin_rules

    check(len(fwd) == 3 and len(bwd) == 3,
          f"one step made {len(fwd)} K2 and {len(bwd)} K3 calls")
    # the serve path and JAX's padding give padded objects all-zero boxes;
    # replay every call with those too
    check(bool(pad.any()), "the replayed batch has no padded objects")

    def zeroed(boxes):
        return boxes.masked_fill(pad[..., None], 0.0)

    try:
        import torchvision.ops as tv_ops
    except ImportError:
        tv_ops = None
    res = {}
    for name, calls in (("K2", fwd), ("K3", bwd)):
        tot = {"ms": 0.0, "ms_10_per_graph": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0,
               "library_ms": None if (tv_ops is None or name == "K3") else
               0.0}
        max_err, bound_by = 0.0, "bytes"
        requested_mb = unique_mb = 0.0  # the model's, for the log line only
        for call in calls:
            if name == "K2":
                f, boxes, r, q = call
                f_shape, dt = tuple(f.shape), f.dtype

                def kernel(bx, f=f, r=r, q=q):
                    return ra.roi_align_cuda(f, bx, r, q)

                def twin(bx, f=f, r=r, q=q):
                    return ra.roi_align_reference(f, bx, r, q)
            else:
                boxes, g, f_shape, r, q = call
                dt = g.dtype
                g = _unit_rms(g)

                def kernel(bx, g=g, f_shape=f_shape, r=r, q=q):
                    return ra.roi_align_backward_cuda(bx, g, f_shape, r, q)

                def twin(bx, g=g, f_shape=f_shape, r=r, q=q):
                    return ra.roi_align_backward_reference(bx, g, f_shape,
                                                           g.dtype, r, q)
            for bx in (boxes, zeroed(boxes)):
                e, ok = twin_rules.roi(kernel(bx), twin(bx), dt)
                max_err = max(max_err, e)
                check(ok, f"{name} vs twin: max err {e:.3g}")
            if name == "K2":
                # a padded (all-zero) box samples the top-left pixel only
                top_left = f[:, 0, 0, :][:, None, None, None, :]
                out = kernel(zeroed(boxes))
                check(bool(torch.equal(
                    out.masked_select(pad[..., None, None, None]),
                    top_left.expand_as(out).masked_select(
                        pad[..., None, None, None]))),
                    "K2: a zero box does not return the top-left pixel")
            check(bool(torch.equal(kernel(boxes), kernel(boxes))),
                  f"{name} is not bit-reproducible")
            kernels, nodes = graph_kernels(lambda: kernel(boxes))
            check(kernels == 1 and nodes == 1, f"one {name} call captured "
                  f"{kernels} kernels in {nodes} graph nodes")
            k_ms, _ = time_ms(lambda: kernel(boxes))
            k_ten, _ = time_ms(lambda: kernel(boxes), calls=10)
            # real batches give padded objects zero boxes, all on pixel (0, 0)
            zb = zeroed(boxes)
            k_zero, _ = time_ms(lambda: kernel(zb), calls=10)
            p_ms, _ = time_ms(lambda: twin(boxes))
            itemsize = torch.tensor([], dtype=dt).element_size()
            touched, terms = ra.roi_work(boxes, f_shape, r, q)
            c = f_shape[-1]
            b, o = boxes.shape[:2]
            out_bytes = b * o * r * r * c * itemsize
            full_bytes = b * f_shape[1] * f_shape[2] * c * itemsize
            nbytes = (touched * c * itemsize + out_bytes if name == "K2"
                      else out_bytes + full_bytes) + boxes.numel() * 4
            b_ms, bound_by = bound_ms(nbytes, 2 * terms * c)
            # what the loads would request by the plan's model, beside the
            # unique input bytes that the bound counts (features touched for
            # K2, all of g for K3)
            requested = _roi_requested(name, boxes, f_shape, r, q, itemsize)
            unique = (touched * c * itemsize if name == "K2" else out_bytes)
            tot["ms"] += k_ms
            tot["ms_10_per_graph"] += k_ten
            requested_mb += requested / 1e6
            unique_mb += unique / 1e6
            tot["plain_ms"] += p_ms
            tot["bound_ms"] += b_ms
            lib = ""
            if tot["library_ms"] is not None:
                _, h, w, _ = f_shape
                x0, y0, bw, bh = boxes.unbind(-1)
                idx = torch.arange(b, device=boxes.device, dtype=torch.float32
                                   )[:, None].expand(b, o)
                rois = torch.stack([idx, x0 * w, y0 * h, (x0 + bw) * w,
                                    (y0 + bh) * h], -1).reshape(-1, 5)
                nchw = f.float().permute(0, 3, 1, 2).contiguous()

                def library():
                    return tv_ops.roi_align(nchw, rois, r, 1.0, q, True)

                l_ms, _ = time_ms(library)
                l_err = float((library().reshape(b, o, c, r, r).permute(
                    0, 1, 3, 4, 2) - ra.roi_align_reference(
                        f.float(), boxes, r, q)).abs().max())
                tot["library_ms"] += l_ms
                lib = (f", torchvision.ops.roi_align (fp32 NCHW input) "
                       f"{1000 * l_ms:.1f} us (max err vs twin {l_err:.3g})")
            if name == "K2":
                plan = ra.fwd_plan(*f_shape, o, r, q, itemsize)
            else:
                plan = ra.bwd_plan(*f_shape, o, r, q, itemsize)
            shape = tuple(f_shape) if name == "K2" else tuple(g.shape)
            log("roi", f"{name} {shape} {str(dt).replace('torch.', '')}: "
                f"device {1000 * k_ms:.1f} us one per graph, "
                f"{1000 * k_ten:.1f} us ten per graph ({1000 * k_zero:.1f} "
                f"with padded boxes zeroed), bound "
                f"{1000 * b_ms:.2f} us ({bound_by}; {nbytes / 1e6:.2f} MB, "
                f"{touched} of {b * f_shape[1] * f_shape[2]} pixels "
                f"touched), twin {1000 * p_ms:.1f} us | {plan} | loads "
                f"request {requested / 1e6:.2f} MB (modelled from the plan) "
                f"of {'features' if name == 'K2' else 'g'} against "
                f"{unique / 1e6:.2f} MB unique" + lib)
        if name == "K2" and tv_ops is None:
            log("roi", "no library call: torchvision is not installed")
        if name == "K3":
            log("roi", "no library call computes K3 alone (torchvision's "
                "backward runs only through autograd)")
        tol = (f"bf16 atol {twin_rules.ROI_BF16_ATOL} rtol "
               f"{twin_rules.ROI_BF16_RTOL}" if dt == torch.bfloat16 else
               f"fp32 atol {twin_rules.FP32_ATOL}")
        log("roi", f"{name}: {len(calls)} calls per step agree with the twin "
            f"(recorded boxes and padded boxes zeroed"
            f"{'; g scaled to unit RMS' if name == 'K3' else ''}), are "
            f"bit-reproducible "
            f"and are one kernel node each in a CUDA graph; max err "
            f"{max_err:.3g} ({tol}); per step: device {tot['ms']:.4f} ms "
            f"one per graph, {tot['ms_10_per_graph']:.4f} ms ten per graph, "
            f"bound {tot['bound_ms']:.4f} ms, twin {tot['plain_ms']:.4f} ms, "
            f"loads request {requested_mb:.2f} MB (modelled from the plan) "
            f"against {unique_mb:.2f} MB unique"
            + ("" if tot["library_ms"] is None
               else f", library {tot['library_ms']:.4f} ms"))
        res[name] = dict(tot, max_abs_err=max_err, bound_by=bound_by)
    return res


def _differing(a, b):
    """Keys of two state dicts whose tensors differ (bitwise)."""
    check(set(a) == set(b), "the two states hold different keys")
    return [k for k in a if not _tensor_equal(a[k], b[k])]


def _tensor_equal(a, b):
    import torch

    return bool(torch.equal(a.cpu(), b.cpu()))


def phase_damsm():
    """DAMSM pretraining at full ``cfg/damsm_coco.yml`` width on the
    manifest feed through ``cli.pretrain_damsm``, its checkpoint round trip
    on the card, the host feed apart from the device step, and Stage C
    from its encoders through ``TRAIN.NET_E``."""
    import collections
    import contextlib
    import io
    import re

    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import cfg_from_file
    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.ops import groupnorm
    from objgan_tpu_torch.train.damsm import DamsmTrainer
    from objgan_tpu_torch.utils.profiling import device_profile

    manifest = os.path.join(ROOT, MANIFEST)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_damsm_")
    cfg = cfg_from_file(os.path.join(ROOT, "cfg", "damsm_coco.yml")).merged(
        {"OUTPUT_DIR": tmp, "DATA_DIR": os.path.join(ROOT, DATA_DIR),
         "TRAIN": {"SNAPSHOT_STEPS": 3}})
    feed, n_records, vocab = build_feed(cfg, manifest, with_masks=False)
    cfg, max_steps = cli.apply_epoch_schedule(cfg, n_records, DAMSM_STEPS)
    seed = DamsmTrainer(cfg).init_state(
        torch.Generator().manual_seed(cfg.RNG_SEED))
    before = {k: v.detach().clone() for k, v in seed.named_parameters()}
    n_gn = sum(type(m).__name__ == "FusedGroupNorm"
               for m in seed.img_enc.modules())
    log("damsm", f"cfg/damsm_coco.yml: batch {cfg.TRAIN.BATCH_SIZE}, "
        f"{cfg.branch_sizes[-1]} px, EMBEDDING_DIM {cfg.TEXT.EMBEDDING_DIM}, "
        f"WORDS_NUM {cfg.TEXT.WORDS_NUM}, backbone {cfg.TEXT.CNN_BACKBONE} "
        f"(base 32), ENCODER_LR {cfg.TRAIN.ENCODER_LR}, RNN_GRAD_CLIP "
        f"{cfg.TRAIN.RNN_GRAD_CLIP}; M params: text "
        f"{sum(p.numel() for p in seed.text_enc.parameters()) / 1e6:.2f}, "
        f"image {sum(p.numel() for p in seed.img_enc.parameters()) / 1e6:.2f};"
        f" {MANIFEST}: {n_records} records, vocabulary {len(vocab)}")
    del seed
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        trainer = cli.pretrain_damsm(cfg, feed, max_steps=max_steps,
                                     device="cuda", log_every=1,
                                     ixtoword=vocab.ixtoword)
    torch.cuda.synchronize()
    k1, k1b = groupnorm.launches, groupnorm.bwd_launches
    wall_s = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    out_dir = os.path.join(tmp, f"{cfg.CONFIG_NAME}_damsm")
    grids = sorted(f for f in os.listdir(out_dir) if f.startswith("attn_"))
    seen = _metric_lines(out.getvalue())
    check(len(seen) == DAMSM_STEPS, f"{len(seen)} metric lines for "
          f"{DAMSM_STEPS} steps")
    bad = [k for m in seen for k, v in m.items() if not math.isfinite(v)]
    check(not bad, f"non-finite metrics: {sorted(set(bad))}")
    check(grids == ["attn_step3.png", "attn_step6.png"],
          f"attention grids {grids}")
    check(n_gn == 8 and k1 == n_gn * (DAMSM_STEPS + len(grids))
          and k1b == n_gn * DAMSM_STEPS,
          f"K1 launched {k1} times, K1 backward {k1b}, for {DAMSM_STEPS} "
          f"steps and {len(grids)} snapshots of {n_gn} GroupNorms")
    moved = {}
    for name, net in (("text", trainer.text_enc), ("image", trainer.img_enc)):
        prefix = "text_enc." if name == "text" else "img_enc."
        same = [k for k, p in net.named_parameters()
                if torch.equal(before[prefix + k], p.detach().cpu())]
        check(not same, f"{name} encoder: {same[:3]} did not change")
        moved[name] = sum(1 for _ in net.parameters())
    ckpt_dir = os.path.join(out_dir, "ckpt")
    steps = sorted(int(n) for n in os.listdir(ckpt_dir) if n.isdigit())
    check(steps == [3, DAMSM_STEPS], f"checkpoints at steps {steps}")
    times = [1000.0 / m.pop("steps_per_sec") for m in seen]
    loop_ms = statistics.median(times[1:])
    log("damsm", f"cli.pretrain_damsm took {DAMSM_STEPS} steps on the "
        f"manifest feed in {wall_s:.1f} s (set-up and 2 snapshots included)"
        f"; every metric finite; every parameter tensor moved (text "
        f"{moved['text']}, image {moved['image']}); checkpoints at steps "
        f"{steps}; grids {', '.join(grids)}")
    log("damsm", f"K1 launches {k1} = {n_gn} GroupNorms x ({DAMSM_STEPS} "
        f"steps + {len(grids)} snapshots), {n_gn} per step; K1 backward "
        f"calls {k1b} (the snapshots take no gradient)")
    log("damsm", "synchronised ms per step of the loop (host feed + "
        "device step; train loop's steps_per_sec): " + ", ".join(
            f"{t:.1f}" for t in times) + f"; median of steps 2-"
        f"{DAMSM_STEPS} {loop_ms:.1f} ms ({cfg.TRAIN.BATCH_SIZE * 1000.0 / loop_ms:.1f} "
        f"img/s); peak memory allocated {peak_gb:.2f} GiB")
    log("damsm", "last step: " + ", ".join(
        f"{k} {seen[-1][k]:.4g}" for k in ("w_loss0", "w_loss1", "s_loss0",
                                           "s_loss1", "damsm_total")))

    # the checkpoint, restored into a fresh trainer on the card; one more
    # step from both, same batch and mask
    batch = cli.to_device(next(cli._finest_scale_only(feed)), "cuda")
    keep = trainer.text_enc.keep_mask(
        batch["captions"], torch.Generator("cuda").manual_seed(123))
    n_tensors = _check_round_trip(
        "damsm", trainer, DamsmTrainer(cfg).init_state(
            torch.Generator().manual_seed(cfg.RNG_SEED + 1)).cuda(),
        ckpt_dir, DAMSM_STEPS, lambda tr: tr.train_step(batch, keep))
    log("damsm", f"checkpoint at step {DAMSM_STEPS} restored into a fresh "
        f"trainer on the card: all {n_tensors} tensors (weights, Adam "
        f"moments, steps) bitwise equal; one more step from the live and the "
        f"restored trainer (same batch and mask, cuDNN deterministic): "
        f"bitwise equal")

    # the device step apart from the host feed
    step_ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, keep)
        torch.cuda.synchronize()
        step_ms.append(1000.0 * (time.perf_counter() - t0))
    feed_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        next(feed)
        feed_ms.append(1000.0 * (time.perf_counter() - t0))
    device_ms = statistics.median(step_ms[1:])
    prof_wall, busy_ms, spans = device_profile(
        lambda: trainer.train_step(batch, keep))
    groups = collections.defaultdict(float)
    for a, b_, name in spans:
        groups["K1 GroupNorm" if "gn_fused_kernel" in name else
               "K1 backward" if "gn_bwd" in name else
               "conv / matmul" if re.search(
                   "conv|gemm|xmma|cudnn|cutlass|wgrad|dgrad|fprop|sm90",
                   name, re.I) else
               "other (elementwise, reductions, copies)"] += (b_ - a) / 1e3
    log("damsm", "device step on a resident batch, synchronised ms: "
        + ", ".join(f"{t:.1f}" for t in step_ms) + f"; median after the "
        f"first {device_ms:.1f} ms ({cfg.TRAIN.BATCH_SIZE * 1000.0 / device_ms:.1f} img/s)")
    log("damsm", f"one device step under torch.profiler: wall "
        f"{prof_wall:.1f} ms, device busy {busy_ms:.1f} ms (share "
        f"{busy_ms / prof_wall:.3f}), {len(spans)} device activities; "
        "device ms by group: " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(groups.items(),
                                              key=lambda kv: -kv[1])))
    log("damsm", f"host feed (CocoFeed, one thread: {cfg.TRAIN.BATCH_SIZE} "
        f"PNG decodes, the {len(cfg.branch_sizes)}-scale box-filter pyramid,"
        f" captions) ms per batch: " + ", ".join(f"{t:.1f}" for t in feed_ms)
        + f"; median {statistics.median(feed_ms):.1f}")

    # Stage C from those encoders
    saved = torch.load(os.path.join(ckpt_dir, str(DAMSM_STEPS), "state.pt"),
                       map_location="cpu", weights_only=True)
    gan_cfg = cfg_from_file(os.path.join(ROOT, "cfg", "coco_objgan.yml")
                            ).merged({"OUTPUT_DIR": tmp,
                                      "DATA_DIR": os.path.join(ROOT,
                                                               DATA_DIR),
                                      "TRAIN": {"NET_E": ckpt_dir}})
    gan_feed, n_records, vocab = build_feed(gan_cfg, manifest)
    gan_cfg, gan_steps = cli.apply_epoch_schedule(gan_cfg, n_records, 2)
    out = io.StringIO()
    torch.cuda.synchronize()
    _reset_counts()
    with contextlib.redirect_stdout(out):
        gan = cli.train_gan(gan_cfg, gan_feed, max_steps=gan_steps,
                            device="cuda", log_every=1,
                            ixtoword=vocab.ixtoword)
    torch.cuda.synchronize()
    k1_gan, k2, k3, _ = _counts()
    text = out.getvalue()
    check(f"loaded pretrained DAMSM encoders from {ckpt_dir} (step "
          f"{DAMSM_STEPS})" in text, "train_gan did not load NET_E")
    gan_sd = gan.state_dict()
    enc_keys = [k for k in saved if k.startswith(("text_enc.", "img_enc."))]
    diff = [k for k in enc_keys if not _tensor_equal(gan_sd[k], saved[k])]
    check(enc_keys and not diff, f"Stage-C encoders differ from the DAMSM "
          f"checkpoint at {diff[:3]}")
    roi_per_call = 2 if gan_cfg.GAN.REMAT == "stages" else 1
    check(k2 == 3 * roi_per_call * gan_steps and k3 == 3 * gan_steps,
          f"K2 launched {k2}, K3 {k3} times in {gan_steps} Stage-C steps")
    gan_seen = _metric_lines(text)
    check(len(gan_seen) == gan_steps and all(
        math.isfinite(v) for m in gan_seen for v in m.values()),
        "Stage-C metrics missing or non-finite")
    log("damsm", f"cli.train_gan on cfg/coco_objgan.yml with TRAIN.NET_E = "
        f"the step-{DAMSM_STEPS} checkpoint, on the manifest feed (masks "
        f"rasterised): {gan_steps} steps, finite metrics (damsm "
        f"{gan_seen[-1]['damsm']:.4g}); its {len(enc_keys)} encoder tensors "
        f"equal the checkpoint's; launches K1 {k1_gan}, K2 {k2}, K3 {k3}")
    del gan, gan_sd, saved
    shutil.rmtree(tmp, ignore_errors=True)
    return trainer, batch, keep, (k1, k1b)


def phase_damsm_k1(trainer, batch, keep):
    """Every K1 call of one more DAMSM step against the twin, timed."""
    import torch

    records, hooks = _record_gn(trainer)
    try:
        trainer.train_step(batch, keep)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    check(len(records) == 8, f"one DAMSM step made {len(records)} K1 calls")
    with torch.no_grad():
        return _check_k1("damsm_k1", records, "DAMSM step")


def _run_stage(phase, run, cfg, feed, steps, module_counts=()):
    """``run(cfg, feed, ...)`` (``cli.train_box`` / ``cli.train_shape``) for
    ``steps`` steps on the card, logging each step, with every kernel count
    set to 0 just before and read just after. Returns (trainer, metric
    rows, kernel counts, forward calls of ``module_counts`` types, wall s,
    peak GiB)."""
    import contextlib
    import io

    import torch

    out = io.StringIO()
    calls, hook = _count_calls(module_counts)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            trainer = run(cfg, feed, max_steps=steps, device="cuda",
                          log_every=1)
        torch.cuda.synchronize()
        counts = _counts()
        wall_s = time.monotonic() - t0
    finally:
        hook.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    seen = _metric_lines(out.getvalue())
    check(len(seen) == steps, f"{len(seen)} metric lines for {steps} steps")
    bad = [k for m in seen for k, v in m.items() if not math.isfinite(v)]
    check(not bad, f"non-finite metrics: {sorted(set(bad))}")
    return trainer, seen, counts, calls, wall_s, peak_gb


def _check_moved(phase, before, trainer, prefixes):
    """Every parameter under ``prefixes`` moved from its initial value."""
    import torch

    now = dict(trainer.named_parameters())
    moved = {}
    for prefix in prefixes:
        names = [k for k in before if k.startswith(prefix)]
        same = [k for k in names
                if torch.equal(before[k], now[k].detach().cpu())]
        check(names and not same, f"{phase}: {same[:3]} did not change")
        moved[prefix.rstrip(".")] = len(names)
    return moved


def _check_round_trip(phase, trainer, fresh, ckpt_dir, steps, step_fn):
    """The newest checkpoint restored into ``fresh`` on the card: every
    tensor bitwise equal; then one more step from each (``step_fn``,
    cuDNN deterministic), bitwise equal."""
    import torch

    from objgan_tpu_torch.core.checkpoint import CheckpointManager

    check(CheckpointManager(ckpt_dir).restore_latest(fresh) == steps,
          f"{phase}: the newest checkpoint did not restore")
    diff = _differing(trainer.state_dict(), fresh.state_dict())
    check(not diff, f"{phase}: restored state differs at {diff[:3]}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        step_fn(trainer)
        step_fn(fresh)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    diff = _differing(trainer.state_dict(), fresh.state_dict())
    check(not diff, f"{phase}: a step from the restored trainer differs at "
          f"{diff[:3]}")
    return len(trainer.state_dict())


def _feed_ms(feed, n=5):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        next(feed)
        times.append(1000.0 * (time.perf_counter() - t0))
    return times


def phase_box(out_dir):
    """Stage A at the width of ``Config()`` (the reference's config #1) on
    the manifest's layouts through ``cli.train_box``, what ``python -m
    objgan_tpu_torch.box_train`` runs; its checkpoint round trip;
    ``cli.sample_box`` (temperature, and beam search at K = 3) and
    ``cli.eval_box``. Its checkpoints go to ``out_dir`` under
    ``coco_objgan`` for phase ``compose``."""
    import contextlib
    import io

    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import Config
    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.train.box import BoxTrainer
    from objgan_tpu_torch.utils.profiling import device_profile

    cfg = Config().merged({"OUTPUT_DIR": out_dir, "CONFIG_NAME": "coco_objgan",
                           "DATA_DIR": os.path.join(ROOT, DATA_DIR)})
    manifest = os.path.join(ROOT, MANIFEST)
    feed, n_records, vocab = build_feed(cfg, manifest, with_images=False,
                                        with_masks=False)
    cfg, steps = cli.apply_epoch_schedule(cfg, n_records, BOX_STEPS)
    seed = BoxTrainer(cfg).init_state(
        torch.Generator().manual_seed(cfg.RNG_SEED))
    before = {k: v.detach().clone() for k, v in seed.named_parameters()}
    b = cfg.BOX
    log("box", f"Config() (config #1): batch {cfg.TRAIN.BATCH_SIZE}, "
        f"RNN_SIZE {b.RNN_SIZE}, ATT_HID_SIZE {b.ATT_HID_SIZE}, "
        f"INPUT_ENCODING_SIZE {b.INPUT_ENCODING_SIZE}, GMM "
        f"{cfg.OBJ.GMM_COMPONENTS} x {cfg.OBJ.GMM_MODE}, MAX_OBJECTS "
        f"{cfg.OBJ.MAX_OBJECTS}, VOCAB_SIZE {cfg.TEXT.VOCAB_SIZE}; "
        f"{sum(p.numel() for p in seed.parameters()) / 1e6:.2f} M params; "
        f"{MANIFEST} layouts: {n_records} records, vocabulary {len(vocab)}")
    del seed
    trainer, seen, counts, _, wall_s, peak_gb = _run_stage(
        "box", cli.train_box, cfg, feed, steps)
    check(counts == (0, 0, 0, 0), f"Stage A launched kernels {counts}")
    moved = _check_moved("box", before, trainer, ("model.encoder.",
                                                  "model.decoder."))
    ckpt_dir = os.path.join(out_dir, "coco_objgan_box", "ckpt")
    batch = cli.to_device(next(feed), "cuda")
    n_tensors = _check_round_trip(
        "box", trainer, BoxTrainer(cfg).init_state(
            torch.Generator().manual_seed(1)).cuda(), ckpt_dir, steps,
        lambda tr: tr.train_step(batch))
    times = [1000.0 / m.pop("steps_per_sec") for m in seen]
    step_ms = statistics.median(times[1:])
    log("box", f"cli.train_box took {steps} steps on the manifest's layouts "
        f"in {wall_s:.1f} s (set-up included); label_loss and box_nll "
        f"finite at every step (last {seen[-1]['label_loss']:.4g}, "
        f"{seen[-1]['box_nll']:.4g}); every parameter tensor moved "
        f"({moved}); no kernel launched (Stage A has no GroupNorm)")
    log("box", "synchronised ms per step (train loop's steps_per_sec): "
        + ", ".join(f"{t:.1f}" for t in times) + f"; median of steps 2-"
        f"{steps} {step_ms:.1f} ms "
        f"({cfg.TRAIN.BATCH_SIZE * 1000.0 / step_ms:.1f} layouts/s); peak "
        f"memory allocated {peak_gb:.2f} GiB; host feed (layouts only) ms "
        f"per batch: " + ", ".join(
            f"{t:.2f}" for t in _feed_ms(feed)))
    log("box", f"checkpoint at step {steps} restored into a fresh trainer on "
        f"the card: all {n_tensors} tensors bitwise equal; one more step from "
        f"the live and the restored trainer: bitwise equal")
    prof_wall, busy_ms, spans = device_profile(
        lambda: trainer.train_step(batch))
    log("box", f"one device step on a resident batch under torch.profiler: "
        f"wall {prof_wall:.1f} ms, device busy {busy_ms:.1f} ms (share "
        f"{busy_ms / prof_wall:.3f}), {len(spans)} device activities")
    del trainer
    # sampling and evaluation from the stage's checkpoint (now at step + 1
    # only in memory; the newest on disk is step ``steps``)
    ids, lens = vocab.encode_batch(CAPTIONS[:16], cfg.TEXT.WORDS_NUM)
    text = io.StringIO()
    layouts = {}
    with contextlib.redirect_stdout(text):
        for mode, bcfg in (("temperature", cfg),
                           ("beam 3", cfg.merged({"BOX": {"BEAM_SIZE": 3}}))):
            t0 = time.perf_counter()
            layouts[mode] = cli.sample_box(bcfg, ids, lens, device="cuda")
            layouts[mode]["ms"] = 1000.0 * (time.perf_counter() - t0)
        eval_feed, _, _ = build_feed(cfg.merged({"TRAIN": {"FLAG": False}}),
                                     manifest, with_images=False)
        metrics = cli.eval_box(cfg, eval_feed, num_batches=2, device="cuda")
    check(text.getvalue().count(f"restored the box checkpoint at step "
                                f"{steps}") == 3,
          "sample_box / eval_box did not restore the checkpoint")
    for mode, lay in layouts.items():
        labels = torch.tensor(lay["labels"])
        boxes = torch.tensor(lay["boxes"])
        valid = torch.tensor(lay["obj_valid"])
        check(labels.shape == (16, cfg.BOX.MAX_SEQ_LENGTH)
              and bool(((labels >= 0) & (labels < cfg.OBJ.NUM_CLASSES)).all())
              and bool(((boxes >= 0) & (boxes <= 1)).all())
              and bool((valid[:, 1:] <= valid[:, :-1]).all()),
              f"sample_box ({mode}) returned a malformed layout")
        log("box", f"cli.sample_box, {mode}: 16 captions -> "
            f"{int(valid.sum())} objects, labels in range, boxes in [0, 1], "
            f"validity a prefix; {lay['ms']:.1f} ms with set-up")
    check(all(math.isfinite(v) for v in metrics.values()),
          "non-finite box evaluation metrics")
    log("box", "cli.eval_box on 2 batches: " + ", ".join(
        f"{k} {v:.4g}" for k, v in sorted(metrics.items())))
    return {"ms": step_ms, "peak_gb": peak_gb}


def phase_shape(out_dir):
    """Stage B at the width of ``cfg/shape_coco.yml`` (config #2) on the
    manifest's layouts and masks through ``cli.train_shape``, what
    ``python -m objgan_tpu_torch.shape_main`` runs: K1 launched 11 times a
    step (G's 5 GroupNorms, D's 2 on the real, the detached fake and the
    fake masks) under autograd; the checkpoint round trip; the host feed
    and the device step apart; ``cli.eval_shape``. Its checkpoints go to
    ``out_dir`` under ``coco_objgan`` for phase ``compose``."""
    import collections
    import contextlib
    import io
    import re

    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import cfg_from_file
    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.models.common import FusedGroupNorm
    from objgan_tpu_torch.train.shape import ShapeTrainer, shape_noise
    from objgan_tpu_torch.train.common import step_generator
    from objgan_tpu_torch.utils.profiling import device_profile

    cfg = cfg_from_file(os.path.join(ROOT, "cfg", "shape_coco.yml")).merged(
        {"OUTPUT_DIR": out_dir, "CONFIG_NAME": "coco_objgan",
         "DATA_DIR": os.path.join(ROOT, DATA_DIR)})
    manifest = os.path.join(ROOT, MANIFEST)
    feed, n_records, _ = build_feed(cfg, manifest, with_images=False)
    cfg, steps = cli.apply_epoch_schedule(cfg, n_records, SHAPE_STEPS)
    seed = ShapeTrainer(cfg).init_state(
        torch.Generator().manual_seed(cfg.RNG_SEED))
    before = {k: v.detach().clone() for k, v in seed.named_parameters()}
    s = cfg.SHAPE
    log("shape", f"cfg/shape_coco.yml (config #2): batch "
        f"{cfg.TRAIN.BATCH_SIZE} x {cfg.OBJ.MAX_OBJECTS} objects, "
        f"{cfg.OBJ.SHAPE_SIZE} px masks, GF_DIM {s.GF_DIM}, DF_DIM "
        f"{s.DF_DIM}, HIDDEN_DIM {s.HIDDEN_DIM}, PERCEPTUAL {s.PERCEPTUAL}, "
        f"fp32; M params: G "
        f"{sum(p.numel() for p in seed.g.parameters()) / 1e6:.2f}, D "
        f"{sum(p.numel() for p in seed.d.parameters()) / 1e6:.2f}; "
        f"{MANIFEST} layouts and masks: {n_records} records")
    del seed
    trainer, seen, counts, calls, wall_s, peak_gb = _run_stage(
        "shape", cli.train_shape, cfg, feed, steps, (FusedGroupNorm,))
    k1, k1b = counts[0], counts[3]
    check(k1 == 11 * steps and k1 == calls[FusedGroupNorm] == k1b,
          f"K1 launched {k1} times, K1 backward {k1b}, for "
          f"{calls[FusedGroupNorm]} GroupNorm calls in {steps} steps "
          f"(expected 11 per step)")
    check(counts[1:3] == (0, 0), f"Stage B launched K2/K3 {counts[1:3]}")
    moved = _check_moved("shape", before, trainer, ("g.", "d."))
    ckpt_dir = os.path.join(out_dir, "coco_objgan_shape", "ckpt")
    batch = cli.to_device(next(feed), "cuda")
    z = shape_noise(cfg, cfg.TRAIN.BATCH_SIZE, step_generator(
        cfg.RNG_SEED, 999, "cuda"), "cuda")
    n_tensors = _check_round_trip(
        "shape", trainer, ShapeTrainer(cfg).init_state(
            torch.Generator().manual_seed(1)).cuda(), ckpt_dir, steps,
        lambda tr: tr.train_step(batch, z))
    times = [1000.0 / m.pop("steps_per_sec") for m in seen]
    loop_ms = statistics.median(times[1:])
    log("shape", f"cli.train_shape took {steps} steps on the manifest feed "
        f"in {wall_s:.1f} s (set-up included); shape_d and shape_g finite at "
        f"every step (last {seen[-1]['shape_d']:.4g}, "
        f"{seen[-1]['shape_g']:.4g}); every parameter tensor moved "
        f"({moved})")
    log("shape", f"launches in {steps} steps: K1 {k1} (= "
        f"{calls[FusedGroupNorm]} GroupNorm calls, {k1 // steps} per step), "
        f"K1 backward calls {k1b}")
    log("shape", "synchronised ms per step of the loop (host feed + device "
        "step; steps_per_sec): " + ", ".join(f"{t:.1f}" for t in times)
        + f"; median of steps 2-{steps} {loop_ms:.1f} ms; peak memory "
        f"allocated {peak_gb:.2f} GiB")
    log("shape", f"checkpoint at step {steps} restored into a fresh trainer "
        f"on the card: all {n_tensors} tensors (weights, Adam moments, "
        f"label table, step) bitwise equal; one more step from the live and "
        f"the restored trainer (same batch and noise, cuDNN deterministic): "
        f"bitwise equal")
    # the device step on a resident batch, and the host feed, apart
    step_ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, z)
        torch.cuda.synchronize()
        step_ms.append(1000.0 * (time.perf_counter() - t0))
    feed_ms = _feed_ms(feed)
    device_ms = statistics.median(step_ms[1:])
    prof_wall, busy_ms, spans = device_profile(
        lambda: trainer.train_step(batch, z))
    groups = collections.defaultdict(float)
    for a, b_, name in spans:
        groups["K1 GroupNorm" if "gn_fused_kernel" in name else
               "K1 backward" if "gn_bwd" in name else
               "conv / matmul" if re.search(
                   "conv|gemm|xmma|cudnn|cutlass|wgrad|dgrad|fprop|sm90",
                   name, re.I) else
               "other (elementwise, reductions, copies)"] += (b_ - a) / 1e3
    log("shape", "device step on a resident batch, synchronised ms: "
        + ", ".join(f"{t:.1f}" for t in step_ms) + f"; median after the "
        f"first {device_ms:.1f} ms")
    log("shape", f"one device step under torch.profiler: wall "
        f"{prof_wall:.1f} ms, device busy {busy_ms:.1f} ms (share "
        f"{busy_ms / prof_wall:.3f}), {len(spans)} device activities; "
        "device ms by group: " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(groups.items(),
                                              key=lambda kv: -kv[1])))
    log("shape", f"host feed (CocoFeed, one thread: {cfg.TRAIN.BATCH_SIZE} "
        f"records' layouts, {cfg.TRAIN.BATCH_SIZE * cfg.OBJ.MAX_OBJECTS} "
        f"polygon masks rasterised at {cfg.OBJ.SHAPE_SIZE} px, captions) ms "
        f"per batch: " + ", ".join(f"{t:.1f}" for t in feed_ms)
        + f"; median {statistics.median(feed_ms):.1f}")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        eval_feed, _, _ = build_feed(cfg.merged({"TRAIN": {"FLAG": False}}),
                                     manifest, with_images=False)
        metrics = cli.eval_shape(cfg, eval_feed, num_batches=2,
                                 device="cuda")
    check(f"restored the shape checkpoint at step {steps}" in text.getvalue(),
          "eval_shape did not restore the checkpoint")
    check(all(math.isfinite(v) for v in metrics.values())
          and metrics["n_objects"] > 0, "bad shape evaluation metrics")
    log("shape", "cli.eval_shape on 2 batches: " + ", ".join(
        f"{k} {v:.4g}" for k, v in sorted(metrics.items())))
    return trainer, batch, z, {"k1": k1, "k1b": k1b, "ms": loop_ms,
                               "device_ms": device_ms,
                               "peak_gb": peak_gb}


def phase_shape_k1(trainer, batch, z):
    """Every K1 call of one more Stage-B step against the twin, timed."""
    import torch

    records, hooks = _record_gn(trainer)
    try:
        trainer.train_step(batch, z)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    check(len(records) == 11, f"one Stage-B step made {len(records)} K1 "
          f"calls")
    with torch.no_grad():
        return _check_k1("shape_k1", records, "Stage-B step")


def phase_compose(out_dir, vocab):
    """The stages trained in phases ``train`` (Stage C), ``box`` and
    ``shape``, all under ``out_dir`` as ``coco_objgan``, served by
    ``run_serve`` at ``cfg/eval_coco.yml`` with ``output_dir``: every stage
    restored, none untrained; the first batch's layout, masks and image
    equal ``cli.sample_box``'s, the restored Stage-B sampler's and the
    restored Stage-C sampler's (``sample_gan``'s) for the same noise."""
    import contextlib
    import io

    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.checkpoint import CheckpointManager
    from objgan_tpu_torch.core.config import cfg_from_file
    from objgan_tpu_torch.models.common import FusedGroupNorm
    from objgan_tpu_torch.ops import groupnorm
    from objgan_tpu_torch.pipeline_e2e import ObjGanPipeline
    from objgan_tpu_torch.serving import run_serve
    from objgan_tpu_torch.train.shape import ShapeTrainer

    cfg = cfg_from_file(os.path.join(ROOT, "cfg", "eval_coco.yml")).merged(
        {"OUTPUT_DIR": out_dir})
    recorded = []
    generate = ObjGanPipeline.generate

    def recording(self, captions, cap_lens, noise):
        out = generate(self, captions, cap_lens, noise)
        recorded.append((self, captions, cap_lens, noise, out))
        return out

    reqs = [{"id": i, "caption": c} for i, c in enumerate(CAPTIONS)]
    responses = []
    out, err = io.StringIO(), io.StringIO()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ObjGanPipeline.generate = recording
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            torch.cuda.synchronize()
            _reset_counts()
            stats = run_serve(cfg, vocab, reqs, tmp, batch_size=16,
                              emit=responses.append, device="cuda",
                              output_dir=out_dir)
            torch.cuda.synchronize()
            launches = groupnorm.launches
            check(all(r["image"] and os.path.getsize(r["image"]) > 0
                      for r in responses), "missing PNGs")
    finally:
        ObjGanPipeline.generate = generate
    text = out.getvalue()
    for name in ("box", "shape", "gan"):
        check(f"restored the {name} stage from" in text,
              f"run_serve did not restore the {name} stage")
    check("UNTRAINED" not in err.getvalue(),
          "run_serve warned of an untrained stage: " + err.getvalue()[-500:])
    check(len(responses) == len(CAPTIONS) and stats["batches"] == 3,
          f"{len(responses)} responses in {stats['batches']} batches")
    pipe, ids, lens, noise, served = recorded[0]
    n_gn = sum(isinstance(m, FusedGroupNorm) for m in pipe.modules())
    check(launches == 3 * n_gn, f"K1 launched {launches} times for 3 "
          f"batches x {n_gn} GroupNorm layers")
    for img in served["images"]:
        check(bool(torch.isfinite(img).all()), "non-finite served image")
    # the same batch through each stage's own sampler, from its checkpoint
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        layout = cli.sample_box(cfg, ids.cpu().numpy(), lens.cpu().numpy(),
                                use_beam=False, device="cuda",
                                noise={k: noise[k] for k in (
                                    "label_gumbel", "comp_gumbel",
                                    "box_normal")})
        shape = ShapeTrainer(cfg).cuda()
        CheckpointManager(os.path.join(out_dir, "coco_objgan_shape",
                                       "ckpt")).restore_latest(shape)
        gan = cli._gan_trainer(cfg, "cuda")
        CheckpointManager(os.path.join(out_dir, "coco_objgan_gan",
                                       "ckpt")).restore_latest(gan)
    torch.backends.cudnn.deterministic = True
    try:
        masks = shape.sample(served["boxes"], served["labels"],
                             served["obj_valid"], noise["shape_z"])
        batch = {"captions": ids, "cap_lens": lens,
                 "labels": served["labels"], "boxes": served["boxes"],
                 "shapes": served["masks"],
                 "obj_valid": served["obj_valid"]}
        images = gan.sample(batch, noise["z"], noise["ca_eps"])["images"]
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # the served layout keeps the first OBJ.MAX_OBJECTS decode steps
    layout = {k: [row[:cfg.OBJ.MAX_OBJECTS] for row in v]
              for k, v in layout.items()}
    errs = {
        "labels": int(layout["labels"] != served["labels"].tolist()),
        "obj_valid": int(layout["obj_valid"] != served["obj_valid"].tolist()),
        "boxes": float((torch.tensor(layout["boxes"], device="cuda")
                        - served["boxes"]).abs().max()),
        "masks": float((masks - served["masks"]).abs().max()),
        "images": max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(images, served["images"])),
    }
    check(all(v == 0 for v in errs.values()),
          f"the served batch differs from the stages' own samplers: {errs}")
    del shape, gan
    n_obj = int(served["obj_valid"].sum())
    log("compose", f"run_serve at cfg/eval_coco.yml with output_dir: the box "
        f"(step {BOX_STEPS}), shape (step {SHAPE_STEPS}) and gan (step "
        f"{TRAIN_STEPS}) checkpoints restored, no untrained warning; "
        f"{stats['requests']} requests in {stats['batches']} batches, "
        f"K1 launches {launches} = 3 batches x {n_gn} GroupNorm layers")
    log("compose", f"first batch ({n_obj} objects): layout equal to "
        f"cli.sample_box's, masks to the restored ShapeTrainer.sample's, "
        f"images to the restored GanTrainer.sample's (sample_gan) for the "
        f"same noise, to the bit (cuDNN deterministic)")


def _count_calls(types_):
    """(Counter, hook): forward calls of modules of ``types_`` counted by a
    global pre-hook until the hook goes."""
    import collections

    import torch

    calls = collections.Counter()

    def count(mod, _):
        if isinstance(mod, types_):
            calls[type(mod)] += 1

    return calls, torch.nn.modules.module.register_module_forward_pre_hook(
        count)


def _eval_cfg(out_dir):
    from objgan_tpu_torch.core.config import cfg_from_file

    return cfg_from_file(os.path.join(ROOT, "cfg", "eval_coco.yml")).merged(
        {"OUTPUT_DIR": out_dir, "DATA_DIR": os.path.join(ROOT, DATA_DIR)})


def _eval_run(cfg, manifest, num_batches, timing=None, **kw):
    """``cli.evaluate`` on a fresh held-out manifest feed, stdout captured;
    with ``timing`` (a dict of lists) it records, synchronised, each
    batch's host feed ms, sampling ms and loop ms (feed pull to feed
    pull), and the full-manifest pass's seconds. Returns (metrics, text)."""
    import contextlib
    import io

    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.train.gan import GanTrainer
    from objgan_tpu_torch.utils import fid_runner

    feed, _, vocab = build_feed(cfg, manifest, augment=False)
    sample, real_pass = GanTrainer.sample, fid_runner.real_stats_and_probe
    if timing is not None:
        def timed_feed(feed):
            start = None
            while True:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if start is not None:
                    timing["loop"].append(1000.0 * (t0 - start))
                start = t0
                batch = next(feed)
                timing["feed"].append(1000.0 * (time.perf_counter() - t0))
                yield batch

        def timed_sample(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sample(self, *a, **k)
            torch.cuda.synchronize()
            timing["sample"].append(1000.0 * (time.perf_counter() - t0))
            return out

        def timed_pass(*a, **k):
            t0 = time.perf_counter()
            out = real_pass(*a, **k)
            timing["pass_s"].append(time.perf_counter() - t0)
            return out

        feed = timed_feed(feed)
        GanTrainer.sample = timed_sample
        fid_runner.real_stats_and_probe = timed_pass
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            metrics = cli.evaluate(cfg, feed, num_batches, manifest=manifest,
                                   feed_vocab=vocab, device="cuda", **kw)
        torch.cuda.synchronize()
    finally:
        GanTrainer.sample = sample
        fid_runner.real_stats_and_probe = real_pass
    return metrics, out.getvalue()


def phase_eval(out_dir):
    """``cli.evaluate`` (what ``python -m objgan_tpu_torch.eval`` runs) at
    ``cfg/eval_coco.yml`` on the Stage-C checkpoint of phase ``train``
    under ``out_dir``, EVAL_BATCHES held-out batches of the manifest,
    ``--real_stats all`` and the frozen probe; then again, reading both
    caches. Returns (the work directory, K1 launches of the first run)."""
    import collections

    import torch

    from objgan_tpu_torch.models.common import FusedGroupNorm
    from objgan_tpu_torch.models.generator import GNet

    cfg = _eval_cfg(out_dir)
    # the manifest is copied, so that the caches written next to it land
    # in a temporary directory; its images stay under DATA_DIR
    work = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    manifest = os.path.join(work, "manifest.json")
    shutil.copy(os.path.join(ROOT, MANIFEST), manifest)
    frozen = os.path.join(ROOT, "assets", "frozen_lite.npz")
    n_g = sum(isinstance(m, FusedGroupNorm) for m in GNet(cfg).modules())
    timing = collections.defaultdict(list)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        calls, hook = _count_calls((FusedGroupNorm,))
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.monotonic()
            first, text = _eval_run(cfg, manifest, EVAL_BATCHES, timing,
                                    real_stats="all", frozen_probe=frozen)
            wall_s = time.monotonic() - t0
            k1 = _counts()[0]
        finally:
            hook.remove()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        _reset_counts()
        t0 = time.monotonic()
        second, text2 = _eval_run(cfg, manifest, EVAL_BATCHES,
                                  real_stats="all", frozen_probe=frozen)
        wall2_s = time.monotonic() - t0
        k1_cached = _counts()[0]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check(f"evaluating checkpoint at step {TRAIN_STEPS}" in text,
          "evaluate did not restore the Stage-C checkpoint")
    for line in ("eval over", "real-side FID statistics: full manifest",
                 "NOTE: FID over", "FID:", "IS:", "frozen lite-IS:",
                 "R-precision:", "R-precision (real-image ceiling):",
                 "Retrieval mean rank (full pool",
                 "Retrieval mean rank (real-image ceiling)"):
        check(line in text, f"evaluate printed no {line!r} line")
    check("cached" not in text, "the first run read a cache")
    check("real-side stats: cached" in text2 and "lite-IS probe: cached"
          in text2, "the second run did not read both caches")
    bad = [k for k, v in first.items() if not math.isfinite(v)]
    check(not bad, f"non-finite metrics: {bad}")
    diff = [k for k in first if first[k] != second[k]]
    check(not diff, f"the cached run differs at {diff}")
    n_batches = math.ceil(2000 / cfg.TRAIN.BATCH_SIZE)
    # per batch: sampling, then the lite extractor and the frozen extractor
    # on the fakes and img_enc on the fakes and the reals (8 GroupNorms
    # each); the full-manifest pass: the lite extractor once per batch
    per_batch = n_g + 4 * 8
    check(k1 == calls[FusedGroupNorm] == EVAL_BATCHES * per_batch
          + n_batches * 8, f"K1 launched {k1} times for "
          f"{calls[FusedGroupNorm]} GroupNorm calls (expected "
          f"{EVAL_BATCHES} x {per_batch} + {n_batches} x 8)")
    check(k1_cached == EVAL_BATCHES * per_batch,
          f"the cached run launched K1 {k1_cached} times")
    feed, samp, loop = timing["feed"], timing["sample"], timing["loop"]
    extract = [l - f - s for l, f, s in zip(loop, feed, samp)]
    log("eval", f"cfg/eval_coco.yml (batch {cfg.TRAIN.BATCH_SIZE}, DTYPE "
        f"{cfg.DTYPE}, pyramid {cfg.branch_sizes}, GF_DIM {cfg.GAN.GF_DIM}, "
        f"lite encoder EMBEDDING_DIM {cfg.TEXT.EMBEDDING_DIM}) on "
        f"{MANIFEST}, {EVAL_BATCHES} batches ({first['n']} samples), "
        f"--real_stats all, frozen probe assets/frozen_lite.npz: the "
        f"step-{TRAIN_STEPS} Stage-C checkpoint restored; every metric "
        f"finite; FID {first['fid']:.6f}, IS {first['is_mean']:.4f}, frozen "
        f"lite-IS {first['frozen_is_mean']:.4f}, R-precision "
        f"{first['r_precision']:.4f} (real {first['r_precision_real']:.4f}),"
        f" mean rank {first['retrieval_mean_rank']:.2f} (real "
        f"{first['retrieval_real_mean_rank']:.2f})")
    log("eval", f"K1 launches {k1} = {EVAL_BATCHES} batches x ({n_g} "
        f"sampling + 4 lite applications x 8) + {n_batches} full-manifest "
        f"batches x 8; the cached run {k1_cached}")
    log("eval", f"second run: both caches read, every metric equal to the "
        f"bit (cuDNN deterministic); wall {wall_s:.1f} s first, {wall2_s:.1f}"
        f" s cached (set-up included)")
    log("eval", f"synchronised ms per batch (batches 2-{len(loop)}): "
        f"loop {_spread(loop[1:])}; host feed {_spread(feed[1:])}; Stage-C "
        f"sampling {_spread(samp[1:])}; extraction and host copies (loop - "
        f"feed - sampling) {_spread(extract[1:])}")
    log("eval", f"full-manifest pass (2000 images, {n_batches} batches, "
        f"feed and lite extractor, probe fit): {timing['pass_s'][0]:.2f} s;"
        f" peak memory allocated {peak_gb:.2f} GiB")
    return work, k1, {
        "loop_ms": statistics.median(loop[1:]),
        "feed_ms": statistics.median(feed[1:]),
        "sample_ms": statistics.median(samp[1:]),
        "extract_ms": statistics.median(extract[1:]),
        "pass_s": timing["pass_s"][0], "peak_gb": peak_gb}


def _spread(xs):
    return (f"median {statistics.median(xs):.1f} (min {min(xs):.1f}, max "
            f"{max(xs):.1f})")


def phase_eval_k1(out_dir, work):
    """Every K1 call of one eval batch (the caches of phase ``eval`` read,
    so no full-manifest pass) against the twin, timed."""
    import torch

    from objgan_tpu_torch.models.common import FusedGroupNorm

    records = []
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda mod, args: records.append((mod, args[0].detach().clone()))
        if isinstance(mod, FusedGroupNorm) else None)
    try:
        _eval_run(_eval_cfg(out_dir), os.path.join(work, "manifest.json"), 1,
                  real_stats="all", frozen_probe=os.path.join(
                      ROOT, "assets", "frozen_lite.npz"))
    finally:
        hook.remove()
    with torch.no_grad():
        return _check_k1("eval_k1", records, "eval batch")


def phase_strict(out_dir):
    """``cli.evaluate`` in strict mode on 2 batches with a random
    Inception-v3 written as a torchvision state dict and read back through
    ``inception_pth`` (what ``--strict --inception_pth`` runs; with random
    weights ``--force``'s numbers): the converter against the module, and
    Inception's pool activations and probabilities at 299 px on a batch of
    16 fakes and 16 reals, timed."""
    import torch

    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.models.inception_v3 import (
        load_torchvision_checkpoint, torchvision_state_dict)
    from objgan_tpu_torch.utils import fid_runner

    cfg = _eval_cfg(out_dir)
    _, model = fid_runner.make_inception_extractor(
        generator=torch.Generator().manual_seed(7), device="cpu")
    sd = torchvision_state_dict(model)
    # what torchvision's file holds besides: the auxiliary head and the
    # BatchNorm step counters, which the converter skips
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    sd["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(0)
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "inception_v3.pth")
        torch.save(sd, pth)
        extract, loaded = fid_runner.make_inception_extractor(device="cuda")
        load_torchvision_checkpoint(loaded, torch.load(pth,
                                                       weights_only=True))
        diff = [k for k, p in model.named_parameters()
                if not torch.equal(p, dict(loaded.named_parameters())[k]
                                   .cpu())]
        check(not diff, f"the converted weights differ at {diff[:3]}")
        metrics, text = _eval_run(cfg, os.path.join(ROOT, MANIFEST), 2,
                                  strict=True, inception_pth=pth)
    check(f"strict-inception (weights: {pth})" in text,
          "evaluate did not run strict mode with the weights file")
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    check(not bad, f"non-finite strict metrics: {bad}")
    feed, _, _ = build_feed(cfg, os.path.join(ROOT, MANIFEST), augment=False)
    images = torch.cat([torch.from_numpy(next(feed)["images"][-1])
                        for _ in range(2)]).cuda()
    pool, probs = extract(images)
    torch.cuda.synchronize()
    check(tuple(pool.shape) == (32, 2048) and tuple(probs.shape)
          == (32, 1000), f"strict features {tuple(pool.shape)}, "
          f"{tuple(probs.shape)}")
    check(bool(torch.isfinite(pool).all() and torch.isfinite(probs).all()),
          "non-finite Inception features")
    sums = float((probs.sum(-1) - 1).abs().max())
    check(sums < 1e-4, f"probabilities sum to 1 within {sums:.3g}")
    ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extract(images)
        torch.cuda.synchronize()
        ms.append(1000.0 * (time.perf_counter() - t0))
    n_params = sum(1 for _ in model.parameters())
    log("strict", f"a random Inception-v3 written as a torchvision state "
        f"dict ({len(sd)} entries, AuxLogits and a step counter among "
        f"them) and read back by the converter: {n_params} parameters "
        f"equal; cli.evaluate --strict on 2 batches ({metrics['n']} "
        f"samples): FID {metrics['fid']:.4f}, IS "
        f"{metrics['is_mean']:.4f}, every metric finite")
    log("strict", f"Inception-v3 at 299 px (bilinear from 256, no "
        f"antialias), true fp32, on two batches of 16 real images (the "
        f"work of 16 fakes and 16 reals): pool (32, 2048) and "
        f"probabilities finite, rows sum to 1 within {sums:.2g}; "
        f"synchronised ms per 32 images " + ", ".join(
            f"{t:.1f}" for t in ms) + f"; median after the first "
        f"{statistics.median(ms[1:]):.1f} ms")
    return statistics.median(ms[1:])


def phase_damsm_inception():
    """DAMSM pretraining with ``TEXT.CNN_BACKBONE: inception`` at
    ``cfg/damsm_coco.yml`` width through ``cli.pretrain_damsm`` for 2 steps
    on the manifest feed: the backbone bitwise unmoved, the projections and
    the text encoder moved, no Adam state for the backbone in the
    checkpoint, the round trip bitwise."""
    import contextlib
    import io

    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import cfg_from_file
    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.train.damsm import DamsmTrainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_damsm_inc_")
    cfg = cfg_from_file(os.path.join(ROOT, "cfg", "damsm_coco.yml")).merged(
        {"OUTPUT_DIR": tmp, "DATA_DIR": os.path.join(ROOT, DATA_DIR),
         "TEXT": {"CNN_BACKBONE": "inception"}})
    feed, n_records, _ = build_feed(cfg, os.path.join(ROOT, MANIFEST),
                                    with_masks=False)
    cfg, steps = cli.apply_epoch_schedule(cfg, n_records, 2)
    seed = DamsmTrainer(cfg).init_state(
        torch.Generator().manual_seed(cfg.RNG_SEED))
    before = {k: v.detach().clone() for k, v in seed.named_parameters()}
    n_backbone = sum(k.startswith("img_enc.backbone.") for k in before)
    del seed
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        trainer = cli.pretrain_damsm(cfg, feed, max_steps=steps,
                                     device="cuda", log_every=1)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check(_counts() == (0, 0, 0, 0), f"launches {_counts()}: Inception has no "
          "GroupNorm")
    seen = _metric_lines(out.getvalue())
    check(len(seen) == steps and all(math.isfinite(v) for m in seen
                                     for v in m.values()),
          "DAMSM metrics missing or non-finite")
    now = dict(trainer.named_parameters())
    moved_backbone = [k for k in before if k.startswith("img_enc.backbone.")
                      and not torch.equal(before[k], now[k].detach().cpu())]
    check(not moved_backbone, f"the backbone moved at {moved_backbone[:3]}")
    moved = _check_moved("damsm_inception", {
        k: v for k, v in before.items()
        if not k.startswith("img_enc.backbone.")}, trainer,
        ("text_enc.", "img_enc.emb_features.", "img_enc.emb_cnn_code."))
    ckpt_dir = os.path.join(tmp, f"{cfg.CONFIG_NAME}_damsm", "ckpt")
    saved = torch.load(os.path.join(ckpt_dir, str(steps), "state.pt"),
                       map_location="cpu", weights_only=True)
    adam_backbone = [k for k in saved
                     if k.startswith("optim.img_enc.backbone.")]
    check(not adam_backbone, f"Adam state for the backbone: "
          f"{adam_backbone[:3]}")
    n_adam = sum(k.startswith("optim.img_enc.") for k in saved)
    batch = cli.to_device(next(cli._finest_scale_only(feed)), "cuda")
    keep = trainer.text_enc.keep_mask(
        batch["captions"], torch.Generator("cuda").manual_seed(123))
    n_tensors = _check_round_trip(
        "damsm_inception", trainer, DamsmTrainer(cfg).init_state(
            torch.Generator().manual_seed(cfg.RNG_SEED + 1)).cuda(),
        ckpt_dir, steps, lambda tr: tr.train_step(batch, keep))
    step_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, keep)
        torch.cuda.synchronize()
        step_ms.append(1000.0 * (time.perf_counter() - t0))
    times = [1000.0 / m.pop("steps_per_sec") for m in seen]
    log("damsm_inception", f"cfg/damsm_coco.yml with TEXT.CNN_BACKBONE "
        f"inception (batch {cfg.TRAIN.BATCH_SIZE}, 256 px resized to 299): "
        f"cli.pretrain_damsm took {steps} steps on the manifest feed in "
        f"{wall_s:.1f} s; finite losses (last damsm_total "
        f"{seen[-1]['damsm_total']:.4g}); all {n_backbone} backbone tensors "
        f"bitwise unmoved, the text encoder and projections moved ({moved}); "
        f"no K1 launch; the checkpoint holds Adam state for the projections "
        f"only ({n_adam} entries, none for the backbone)")
    log("damsm_inception", f"checkpoint restored into a fresh trainer: all "
        f"{n_tensors} tensors bitwise equal, one more step from each bitwise "
        f"equal; ms per step of the loop " + ", ".join(
            f"{t:.1f}" for t in times) + "; device step on a resident batch "
        + ", ".join(f"{t:.1f}" for t in step_ms) + f"; peak memory "
        f"allocated {peak_gb:.2f} GiB")
    shutil.rmtree(tmp, ignore_errors=True)


def phase_shape_vgg(shape_ms):
    """Stage B with ``SHAPE.PERCEPTUAL: vgg`` at ``cfg/shape_coco.yml``
    width through ``cli.train_shape`` for 2 steps on the manifest: finite
    losses with the perceptual term, VGG unmoved, K1 11 times a step; the
    device step against phase ``shape``'s."""
    import contextlib
    import io

    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import cfg_from_file
    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.models.common import FusedGroupNorm
    from objgan_tpu_torch.train.common import step_generator
    from objgan_tpu_torch.train.shape import ShapeTrainer, shape_noise

    tmp = tempfile.mkdtemp(prefix="chip_smoke_vgg_")
    cfg = cfg_from_file(os.path.join(ROOT, "cfg", "shape_coco.yml")).merged(
        {"OUTPUT_DIR": tmp, "DATA_DIR": os.path.join(ROOT, DATA_DIR),
         "SHAPE": {"PERCEPTUAL": "vgg"}})
    feed, n_records, _ = build_feed(cfg, os.path.join(ROOT, MANIFEST),
                                    with_images=False)
    cfg, steps = cli.apply_epoch_schedule(cfg, n_records, 2)
    with contextlib.redirect_stdout(io.StringIO()):
        seed = ShapeTrainer(cfg).init_state(
            torch.Generator().manual_seed(cfg.RNG_SEED))
    before = {k: v.detach().clone() for k, v in seed.named_parameters()}
    del seed
    trainer, seen, counts, calls, wall_s, peak_gb = _run_stage(
        "shape_vgg", cli.train_shape, cfg, feed, steps, (FusedGroupNorm,))
    check(counts[0] == 11 * steps == calls[FusedGroupNorm],
          f"K1 launched {counts[0]} times for {calls[FusedGroupNorm]} "
          f"GroupNorm calls in {steps} steps (expected 11 per step)")
    check(all("shape_perceptual" in m for m in seen),
          "no perceptual term in the metrics")
    now = dict(trainer.named_parameters())
    moved_vgg = [k for k in before if k.startswith("vgg.")
                 and not torch.equal(before[k], now[k].detach().cpu())]
    check(not moved_vgg, f"VGG moved at {moved_vgg[:3]}")
    moved = _check_moved("shape_vgg", before, trainer, ("g.", "d."))
    saved = os.path.join(tmp, f"{cfg.CONFIG_NAME}_shape", "ckpt", str(steps),
                         "state.pt")
    adam_vgg = [k for k in torch.load(saved, map_location="cpu",
                                      weights_only=True)
                if k.startswith("optim.vgg.")]
    check(not adam_vgg, f"Adam state for VGG: {adam_vgg[:3]}")
    batch = cli.to_device(next(feed), "cuda")
    z = shape_noise(cfg, cfg.TRAIN.BATCH_SIZE, step_generator(
        cfg.RNG_SEED, 999, "cuda"), "cuda")
    step_ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, z)
        torch.cuda.synchronize()
        step_ms.append(1000.0 * (time.perf_counter() - t0))
    device_ms = statistics.median(step_ms[1:])
    n_vgg = sum(p.numel() for p in trainer.vgg.parameters()) / 1e6
    log("shape_vgg", f"cfg/shape_coco.yml with SHAPE.PERCEPTUAL vgg (VGG-16 "
        f"to relu4_3, random weights, {n_vgg:.2f} M parameters): "
        f"cli.train_shape took {steps} steps in {wall_s:.1f} s; "
        f"finite losses (last shape_g {seen[-1]['shape_g']:.4g}, "
        f"shape_perceptual {seen[-1]['shape_perceptual']:.4g}); G and D "
        f"moved ({moved}), VGG bitwise unmoved and without Adam state; K1 "
        f"{counts[0]} launches, 11 per "
        f"step")
    log("shape_vgg", "device step on a resident batch, synchronised ms: "
        + ", ".join(f"{t:.1f}" for t in step_ms) + f"; median after the "
        f"first {device_ms:.1f} ms against phase shape's {shape_ms:.1f} ms "
        f"(fm mode); peak memory allocated {peak_gb:.2f} GiB")
    shutil.rmtree(tmp, ignore_errors=True)
    return device_ms


def phase_small_eval():
    """The tiny fp32 eval on the GPU (K1 in every lite encoder) against
    the CPU (twins), same checkpoint, batches and noise: every metric."""
    import contextlib
    import io

    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.checkpoint import CheckpointManager
    from objgan_tpu_torch.core.config import tiny_test_config
    from objgan_tpu_torch.data.synthetic import synthetic_batch
    from objgan_tpu_torch.train.gan import train_noise

    cfg = tiny_test_config().merged({"DTYPE": "float32",
                                     "TRAIN": {"BATCH_SIZE": 4}})
    gen = torch.Generator().manual_seed(3)
    batches = [synthetic_batch(cfg, gen) for _ in range(2)]
    noises = [train_noise(cfg, 4, gen, "cpu") for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cfg.merged({"OUTPUT_DIR": tmp})
        CheckpointManager(os.path.join(tmp, "objgan_gan", "ckpt")).save(
            1, cli.make_trainer(cfg, "cpu"))
        results = {}
        for device in ("cpu", "cuda"):
            before = _counts()[0]
            with contextlib.redirect_stdout(io.StringIO()):
                results[device] = cli.evaluate(
                    cfg, iter(batches), 2, device=device,
                    noise=lambda i, b, device=device: {
                        k: v.to(device) for k, v in noises[i].items()})
            torch.cuda.synchronize()
            results[device + "_k1"] = _counts()[0] - before
    want, got = results["cpu"], results["cuda"]
    errs = {k: abs(got[k] - v) / max(abs(v), 1e-6) for k, v in want.items()}
    worst = max(errs, key=errs.get)
    check(results["cpu_k1"] == 0 and results["cuda_k1"] > 0,
          f"K1 launches: CPU {results['cpu_k1']}, GPU {results['cuda_k1']}")
    check(errs[worst] <= 1e-3, f"tiny eval GPU vs CPU: {worst} differs by "
          f"{errs[worst]:.3g} relative")
    log("small_eval", f"tiny fp32 eval (2 batches of 4), GPU "
        f"({results['cuda_k1']} K1 launches) vs CPU (twins), same "
        f"checkpoint, batches and noise: "
        f"{len(want)} metrics within {errs[worst]:.3g} relative (worst "
        f"{worst}; limit 1e-3); FID {got['fid']:.6f} vs {want['fid']:.6f}")


def _put_ms(batch, n=5):
    """Synchronised ms of ``cli.to_device`` (pinned memory, non-blocking
    copy) of a numpy batch to the card: the median of ``n``."""
    import torch

    from objgan_tpu_torch import cli

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.to_device(batch, "cuda")
        torch.cuda.synchronize()
        times.append(1000.0 * (time.perf_counter() - t0))
    return statistics.median(times)


def _hold_against_twins(phase, gn, fwd, bwd, gn_bwd):
    """Every recorded K1, K2, K3 and K1 backward call against its twin by
    ``ops/twin_rules.py`` (K3's cotangent scaled to unit RMS as in phase
    ``roi``). Returns the max error per kernel (K1 backward's: dx's)."""
    from objgan_tpu_torch.ops import roi_align as ra
    from objgan_tpu_torch.ops import twin_rules
    from objgan_tpu_torch.ops.groupnorm import group_norm_cuda

    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0}

    def hold(name, close):
        e, ok = close
        check(ok, f"{phase}: {name} vs twin, max err {e:.3g}")
        errs[name] = max(errs[name], e)

    for mod, x in gn:
        x3 = x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()
        args = (mod.weight.detach(), mod.bias.detach(), mod.num_groups,
                mod.eps, mod.use_glu)
        hold("K1", twin_rules.k1(group_norm_cuda(x3, *args),
                                 twin_rules.k1_twin(x3, *args), x3.dtype))
    for f, boxes, r, q in fwd:
        hold("K2", twin_rules.roi(ra.roi_align_cuda(f, boxes, r, q),
                                  ra.roi_align_reference(f, boxes, r, q),
                                  f.dtype))
    for boxes, g, f_shape, r, q in bwd:
        g = _unit_rms(g)
        hold("K3", twin_rules.roi(
            ra.roi_align_backward_cuda(boxes, g, f_shape, r, q),
            ra.roi_align_backward_reference(boxes, g, f_shape, g.dtype, r, q),
            g.dtype))
    errs["K1 backward"] = _check_k1_bwd(phase, gn_bwd, "train step")[0]
    return errs


def _feed_run_ms(feed, n, skip):
    """(first batch ms, ms per batch of ``n`` more after ``skip`` untimed
    ones: the batches its workers prefetched while the first was made)."""
    t0 = time.perf_counter()
    next(feed)
    first = 1000.0 * (time.perf_counter() - t0)
    for _ in range(skip):
        next(feed)
    t0 = time.perf_counter()
    for _ in range(n):
        next(feed)
    return first, 1000.0 * (time.perf_counter() - t0) / n


def phase_feed(k1_per_step):
    """The host feeds of ``--wire`` and ``--grain``: DAMSM and Stage B on
    wire batches through their CLI runners, the cache's cold and warm feed
    against the classic one, host->device bytes, the device step on a
    resident wire batch against a classic one; Stage C through
    ``cli.train_gan`` with ``--wire --grain`` and its kernel calls held
    against the twins; the worker feed's ms per batch; ``cli.evaluate``
    with ``--grain``; the RAM budget the cache policy finds. Returns the
    Stage-C run's launches and max errors per kernel."""
    import contextlib
    import io

    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import cfg_from_file
    from objgan_tpu_torch.data import pipeline as pl
    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.data.grain_feed import PREFETCH, grain_feed
    from objgan_tpu_torch.data.tokenizer import Vocab
    from objgan_tpu_torch.data.wire import WIRE_IMAGE, from_wire
    from objgan_tpu_torch.models.common import FusedGroupNorm
    from objgan_tpu_torch.ops import groupnorm
    from objgan_tpu_torch.tools.profile_feed import batch_bytes

    manifest = os.path.join(ROOT, MANIFEST)
    data_dir = os.path.join(ROOT, DATA_DIR)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_feed_")
    records = pl.load_records_json(manifest)

    # -- the cache budget on this host -----------------------------------
    try:
        sysconf = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):
        sysconf = -1
    limit = pl._cgroup_mem_limit()
    ram = pl._physical_ram_bytes()
    damsm_cfg = cfg_from_file(os.path.join(ROOT, "cfg", "damsm_coco.yml")
                              ).merged({"OUTPUT_DIR": tmp,
                                        "DATA_DIR": data_dir,
                                        "TRAIN": {"SNAPSHOT_STEPS": 2}})
    per = pl.wire_record_bytes(damsm_cfg, with_masks=False)
    log("feed", f"cache budget: sysconf RAM {sysconf / 2 ** 30:.1f} GiB, "
        f"cgroup limit {limit} B, _physical_ram_bytes {ram / 2 ** 30:.1f} GiB, budget a quarter "
        f"{ram / 4 / 2 ** 30:.1f} GiB; DAMSM wire record {per} B x "
        f"{len(records)} records = {per * len(records) / 1e6:.1f} MB: cached "
        f"{pl.wire_cache_allowed(damsm_cfg, len(records), with_masks=False)}"
        f"; with {damsm_cfg.WORKERS} workers' copies "
        f"{per * len(records) * damsm_cfg.WORKERS / 1e6:.1f} MB: cached "
        f"{pl.wire_cache_allowed(damsm_cfg, len(records) * damsm_cfg.WORKERS, with_masks=False)}")

    # -- DAMSM with --wire through cli.pretrain_damsm --------------------
    cfg = damsm_cfg
    feed, n_records, vocab = build_feed(cfg, manifest, with_masks=False,
                                        wire=True)
    steps = 3
    out = io.StringIO()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        trainer = cli.pretrain_damsm(cfg, feed, max_steps=steps,
                                     device="cuda", log_every=1,
                                     ixtoword=vocab.ixtoword)
    torch.cuda.synchronize()
    k1 = groupnorm.launches
    wall_s = time.monotonic() - t0
    seen = _metric_lines(out.getvalue())
    check(len(seen) == steps and all(math.isfinite(v) for m in seen
                                     for v in m.values()),
          "DAMSM --wire: metrics missing or non-finite")
    grids = sorted(f for f in os.listdir(os.path.join(
        tmp, f"{cfg.CONFIG_NAME}_damsm")) if f.startswith("attn_"))
    check(grids == ["attn_step2.png"], f"DAMSM --wire grids {grids}")
    check(k1 == 8 * (steps + len(grids)), f"DAMSM --wire: K1 launched {k1} "
          f"times for {steps} steps and {len(grids)} snapshot")
    loop = [1000.0 / m["steps_per_sec"] for m in seen]
    log("feed", f"DAMSM --wire (cfg/damsm_coco.yml, batch "
        f"{cfg.TRAIN.BATCH_SIZE}, {MANIFEST}): cli.pretrain_damsm took "
        f"{steps} steps in {wall_s:.1f} s, finite metrics, the snapshot grid "
        f"{grids[0]} drawn on image_u8; K1 launches {k1} = 8 x ({steps} "
        f"steps + 1 snapshot); loop ms per step " + ", ".join(
            f"{t:.1f}" for t in loop))

    # from_wire on the card against the CPU
    wire = next(feed)
    classic_feed = cli._finest_scale_only(build_feed(
        cfg, manifest, with_masks=False)[0])
    classic = next(classic_feed)
    wire_dev = cli.to_device(wire, "cuda")
    got = from_wire(cfg, wire_dev)["images"]
    want = from_wire(cfg, cli.to_device(wire, "cpu"))["images"]
    # the card divides by 127.5 through its reciprocal: the finest scale
    # may differ by an ulp of x / 127.5 in [0, 2] (2^-23), rounded twice
    finest = float((got[-1].cpu() - want[-1]).abs().max())
    check(finest <= 2.0 ** -22, f"from_wire: the finest scale differs by "
          f"{finest:.3g} between card and CPU")
    coarse = max(float((g.cpu() - w).abs().max())
                 for g, w in zip(got[:-1], want[:-1]))
    check(coarse <= 1e-6, f"from_wire: a coarse scale differs by {coarse:.3g}")
    wire_b, classic_b = batch_bytes(wire), batch_bytes(classic)
    wire_img = wire[WIRE_IMAGE].nbytes
    classic_img = classic["images"][-1].nbytes
    log("feed", f"from_wire of a DAMSM wire batch on the card vs the CPU: "
        f"finest scale {tuple(got[-1].shape)} within {finest:.3g} (atol "
        f"2^-22: the card multiplies by 1/127.5), "
        f"{int((got[-1].cpu() != want[-1]).sum())} of {want[-1].numel()} "
        f"values differ; coarse scales "
        + ", ".join(str(tuple(g.shape[1:3])) for g in got[:-1])
        + f" within {coarse:.3g} (atol 1e-6: means in another order)")
    log("feed", f"host->device per DAMSM batch: wire {wire_b / 1e6:.2f} MB "
        f"(image_u8 {wire_img / 1e6:.2f} MB) in {_put_ms(wire):.2f} ms; "
        f"classic (finest scale only) {classic_b / 1e6:.2f} MB (fp32 images "
        f"{classic_img / 1e6:.2f} MB) in {_put_ms(classic):.2f} ms; "
        f"synchronised, median of 5")

    # the feed cold, the cache's fill, the feed warm, the classic feed
    cold = pl.CocoFeed(cfg, records, vocab, seed=5, wire=True,
                       with_masks=False, augment=True)
    check(cold._cache is not None, "the DAMSM wire cache is off")
    cold_ms = _feed_ms(iter(cold), 5)
    t0 = time.perf_counter()
    for i, rec in enumerate(records):
        cold._wire_base(rec, i)
    fill_s = time.perf_counter() - t0
    cache_mb = sum(a.nbytes for base in cold._cache.values()
                   for k, a in base.items() if k != "enc") / 1e6
    warm_ms = _feed_ms(iter(cold), 5)
    classic_ms = _feed_ms(classic_feed, 5)
    log("feed", f"DAMSM host feed ms per batch of {cfg.TRAIN.BATCH_SIZE}, "
        f"one thread: wire cold (first epoch: {cfg.TRAIN.BATCH_SIZE} PNG "
        f"decodes, no resize) " + ", ".join(f"{t:.1f}" for t in cold_ms)
        + f" (median {statistics.median(cold_ms):.1f}); the cache's fill "
        f"over {len(records)} records {fill_s:.2f} s, {cache_mb:.1f} MB of "
        f"arrays; wire warm " + ", ".join(f"{t:.1f}" for t in warm_ms)
        + f" (median {statistics.median(warm_ms):.1f}); classic "
        + ", ".join(f"{t:.1f}" for t in classic_ms)
        + f" (median {statistics.median(classic_ms):.1f})")

    # the device step on a resident batch, wire against classic, in turns
    classic_dev = cli.to_device(classic, "cuda")
    keep = trainer.text_enc.keep_mask(
        wire_dev["captions"], torch.Generator("cuda").manual_seed(123))
    times = {"classic": [], "wire": []}
    for name in ("classic", "wire", "wire", "classic") * 3:
        batch = wire_dev if name == "wire" else classic_dev
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch, keep)
        torch.cuda.synchronize()
        times[name].append(1000.0 * (time.perf_counter() - t0))
    expand_ms = _event_ms(lambda: from_wire(cfg, wire_dev), 20)
    log("feed", "DAMSM device step on a resident batch, synchronised ms, "
        "in turns: classic " + ", ".join(f"{t:.1f}" for t in times["classic"])
        + f" (median {statistics.median(times['classic'][1:]):.1f}); wire "
        + ", ".join(f"{t:.1f}" for t in times["wire"])
        + f" (median {statistics.median(times['wire'][1:]):.1f}); from_wire "
        f"alone (the 64/128 px means DAMSM drops included) "
        f"{expand_ms:.3f} ms (CUDA events, eager, median of 20)")
    del trainer, wire_dev, classic_dev, keep, got, want
    torch.cuda.empty_cache()

    # -- Stage B with --wire through cli.train_shape ---------------------
    cfg = cfg_from_file(os.path.join(ROOT, "cfg", "shape_coco.yml")).merged(
        {"OUTPUT_DIR": tmp, "DATA_DIR": data_dir})
    feed, n_records, vocab = build_feed(cfg, manifest, with_images=False,
                                        wire=True)
    cfg, steps = cli.apply_epoch_schedule(cfg, n_records, 3)
    trainer, seen, counts, _, wall_s, _ = _run_stage(
        "feed", cli.train_shape, cfg, feed, steps, (FusedGroupNorm,))
    check(counts[0] == 11 * steps, f"Stage B --wire: K1 launched "
          f"{counts[0]} times in {steps} steps")
    loop = [1000.0 / m["steps_per_sec"] for m in seen]
    subset = records[:20 * cfg.TRAIN.BATCH_SIZE]
    warm = pl.CocoFeed(cfg, subset, vocab, seed=5, wire=True,
                       with_images=False)
    t0 = time.perf_counter()
    for i, rec in enumerate(subset):
        warm._wire_base(rec, i)
    fill_s = time.perf_counter() - t0
    warm_ms = _feed_ms(iter(warm), 5)
    classic_ms = _feed_ms(iter(pl.CocoFeed(cfg, subset, vocab, seed=5,
                                           with_images=False)), 5)
    log("feed", f"Stage B --wire (cfg/shape_coco.yml, {cfg.TRAIN.BATCH_SIZE}"
        f" x {cfg.OBJ.MAX_OBJECTS} objects): cli.train_shape took {steps} "
        f"steps in {wall_s:.1f} s, finite metrics, K1 {counts[0]} launches; "
        f"loop ms per step " + ", ".join(f"{t:.1f}" for t in loop)
        + f"; host feed ms per batch, one thread, on the first "
        f"{len(subset)} records: wire warm (cache filled in {fill_s:.2f} s) "
        + ", ".join(f"{t:.1f}" for t in warm_ms) + f" (median "
        f"{statistics.median(warm_ms):.1f}); classic polygon-mask feed "
        + ", ".join(f"{t:.1f}" for t in classic_ms) + f" (median "
        f"{statistics.median(classic_ms):.1f})")
    del trainer
    torch.cuda.empty_cache()

    # -- Stage C with --wire --grain through cli.train_gan ----------------
    cfg = cfg_from_file(os.path.join(ROOT, "cfg", "coco_objgan.yml")).merged(
        {"OUTPUT_DIR": tmp, "DATA_DIR": data_dir,
         "TRAIN": {"SNAPSHOT_STEPS": 1000}})
    feed, n_records, vocab = build_feed(cfg, manifest, wire=True, grain=True)
    out = io.StringIO()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        trainer = cli.train_gan(cfg, feed, max_steps=2, device="cuda",
                                log_every=1, ixtoword=vocab.ixtoword)
    torch.cuda.synchronize()
    k1, k2, k3, k1b = _counts()
    wall_s = time.monotonic() - t0
    seen = _metric_lines(out.getvalue())
    check(len(seen) == 2 and all(math.isfinite(v) for m in seen
                                 for v in m.values()),
          "Stage C --wire --grain: metrics missing or non-finite")
    check(k1 == k1b == 2 * k1_per_step, f"Stage C --wire --grain: K1 "
          f"launched {k1}, K1 backward {k1b} times in 2 steps; phase train "
          f"{k1_per_step} per step")
    check(k2 == 6 and k3 == 6, f"Stage C --wire --grain: K2 {k2}, K3 {k3} "
          f"launches in 2 steps")
    batch = next(feed)
    check(WIRE_IMAGE in batch and "shapes_u8" in batch,
          "the --wire --grain feed gave no wire batch")
    gn, fwd, bwd, _, gn_bwd = _record_train_step(
        cfg, trainer, cli.to_device(batch, "cuda"))
    feed.close()
    check(len(gn) == len(gn_bwd) == k1_per_step and len(fwd) == 3
          and len(bwd) == 3, f"one wire step made {len(gn)} K1, {len(fwd)} "
          f"K2, {len(bwd)} K3, {len(gn_bwd)} K1 backward calls")
    errs = _hold_against_twins("feed", gn, fwd, bwd, gn_bwd)
    loop = [1000.0 / m["steps_per_sec"] for m in seen]
    log("feed", f"Stage C --wire --grain (cfg/coco_objgan.yml, batch "
        f"{cfg.TRAIN.BATCH_SIZE}, {cfg.WORKERS} worker processes): "
        f"cli.train_gan took 2 steps in {wall_s:.1f} s (set-up and the "
        f"workers' start included), finite metrics; launches K1 {k1} "
        f"({k1_per_step} per step, as phase train), K2 {k2}, K3 {k3}, K1 "
        f"backward {k1b}; loop "
        f"ms per step " + ", ".join(f"{t:.1f}" for t in loop))
    log("feed", f"one more step on a wire batch from the workers: its "
        f"{len(gn)} K1, {len(fwd)} K2, {len(bwd)} K3 and {len(gn_bwd)} K1 "
        f"backward calls agree with the twins: max err K1 {errs['K1']:.3g}, "
        f"K2 {errs['K2']:.3g}, K3 {errs['K3']:.3g}, K1 backward dx "
        f"{errs['K1 backward']:.3g} (tolerances of phases kernels, roi and "
        f"train_k1b)")
    del trainer, gn, fwd, bwd, gn_bwd, batch
    torch.cuda.empty_cache()

    # -- the worker feed at DAMSM's batch ---------------------------------
    cfg = damsm_cfg
    vocab = Vocab.build(c for r in records for c in r["captions"])
    rows = []
    for wire in (False, True):
        for workers in (0, cfg.WORKERS):
            feed = grain_feed(cfg.replace(WORKERS=workers), records, vocab,
                              seed=9, with_masks=False, wire=wire)
            first, per_batch = _feed_run_ms(feed, 8, workers * PREFETCH)
            feed.close()
            rows.append(f"{'wire' if wire else 'classic'}, {workers} "
                        f"workers: {per_batch:.1f} ms per batch (the first "
                        f"{first:.0f} ms)")
    log("feed", f"worker feed (data/grain_feed.py) at DAMSM's batch "
        f"{cfg.TRAIN.BATCH_SIZE}, cold (first epoch), 8 batches after the "
        f"first and the {PREFETCH} per worker prefetched meanwhile: " + "; ".join(rows))

    # -- cli.evaluate with --grain ----------------------------------------
    cfg = _eval_cfg(tmp)
    feed, _, vocab = build_feed(cfg, manifest, augment=False, grain=True)
    out = io.StringIO()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        metrics = cli.evaluate(cfg, feed, 2, frozen_probe="off",
                               feed_vocab=vocab, device="cuda")
    torch.cuda.synchronize()
    eval_k1 = groupnorm.launches
    feed.close()
    text = out.getvalue()
    check("evaluating checkpoint at step 2" in text,
          "eval --grain did not restore the --wire --grain checkpoint")
    check(all(math.isfinite(float(v)) for v in metrics.values()),
          "eval --grain: a metric is not finite")
    log("feed", f"cli.evaluate with --grain (cfg/eval_coco.yml, "
        f"{cfg.WORKERS} workers) on that step-2 checkpoint, 2 batches in "
        f"{time.monotonic() - t0:.1f} s: FID {metrics['fid']:.3f}, "
        f"R-precision {metrics['r_precision']:.3f}, every metric finite; "
        f"K1 launches {eval_k1}")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": {"K1": k1, "K2": k2, "K3": k3, "K1 backward": k1b},
            "errs": errs}


def _ddp_entry(argv):
    """``chip_smoke.py --entry MODULE COUNTS ARGS...``, what phase ddp has
    torchrun start in each rank: MODULE's entry point with ARGS, as ``python
    -m MODULE ARGS`` runs it, then the rank's kernel launches written to
    COUNTS.<rank> as JSON."""
    import runpy

    module, counts, *args = argv
    sys.path.insert(0, ROOT)
    sys.argv = [module, *args]
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    with open(f"{counts}.{os.environ['RANK']}", "w") as f:
        json.dump(dict(zip(COUNTED, _counts())), f)
    return 0


def phase_ddp(train):
    """Data parallelism: (a) ``gan_main`` under torchrun, one rank on NCCL,
    at ``cfg/coco_objgan.yml`` width, against phase train's first steps;
    (b, c) ``parallel.dryrun.run(2, cuda, gloo)``: two ranks on this card
    against this process at world size 1, Stage C (tiny fp32, with EMA
    sampling), DAMSM, Stage A and Stage B (tiny fp32), and bf16 Stage-C
    steps at ``coco_objgan`` width."""
    import yaml

    from objgan_tpu_torch.parallel import dryrun

    per_step = {k: train[k.lower()] // TRAIN_STEPS for k in COUNTED}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    with open(os.path.join(ROOT, "cfg", "coco_objgan.yml")) as f:
        raw = yaml.safe_load(f)
    raw["OUTPUT_DIR"] = os.path.join(tmp, "out")
    yml = os.path.join(tmp, "coco_objgan.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(raw, f)
    counts = os.path.join(tmp, "counts")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", os.path.abspath(__file__), "--entry",
         "objgan_tpu_torch.gan_main", counts, "--cfg", yml, "--max_steps",
         str(DDP_STEPS), "--log_every", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall_a = time.monotonic() - t0
    check(proc.returncode == 0, f"torchrun gan_main failed (rc "
          f"{proc.returncode}):\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    stage = os.path.join(tmp, "out", f"{raw['CONFIG_NAME']}_gan")
    check(os.listdir(os.path.join(stage, "ckpt")) == [str(DDP_STEPS)],
          f"torchrun gan_main: checkpoints {os.listdir(stage)}")
    with open(os.path.join(stage, "gan_metrics.csv")) as f:
        rows = [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)]
    check([r["step"] for r in rows] == list(range(1, DDP_STEPS + 1)),
          f"torchrun gan_main wrote rows for steps {[r['step'] for r in rows]}")
    skip = ("step", "wall_s", "steps_per_sec")
    bad = [k for r in rows for k, v in r.items() if not math.isfinite(v)]
    check(not bad, f"torchrun gan_main: non-finite metrics {bad}")
    # per step: step 1 runs on the same weights, so it shows what the
    # group changes; step 2 adds the first update's nondeterminism
    per = [(max(abs(r[k] - w[k]) for k in r if k not in skip),
            max(abs(r[k] - w[k]) / max(abs(w[k]), 1e-6) for k in r
                if k not in skip))
           for r, w in zip(rows, train["rows"])]
    a_err = max(e for e, _ in per)
    with open(f"{counts}.0") as f:
        a_launch = json.load(f)
    want = {k: v * DDP_STEPS for k, v in per_step.items()}
    check(a_launch == want, f"torchrun gan_main launched {a_launch}, phase "
          f"train's counts for {DDP_STEPS} steps are {want}")
    diffs = ", ".join(f"step {i + 1} max |d| {e:.3g} (rel {r:.3g})"
                      for i, (e, r) in enumerate(per))
    log("ddp", f"(a) python -m torch.distributed.run --nproc_per_node=1 -m "
        f"objgan_tpu_torch.gan_main --cfg coco_objgan --max_steps "
        f"{DDP_STEPS}: NCCL, world size 1, {wall_a:.1f} s with start-up; "
        f"rank 0 wrote the step-{DDP_STEPS} checkpoint and the metrics CSV; "
        f"every metric finite; launches {a_launch} (phase train's per step "
        f"{per_step}); against phase train's first {DDP_STEPS} steps (no "
        f"group, same seed and batches): {diffs}; ms per step " + ", ".join(
            f"{1000.0 / r['steps_per_sec']:.1f}" for r in rows))
    shutil.rmtree(tmp, ignore_errors=True)

    t0 = time.monotonic()
    res = dryrun.run(2, "cuda", "gloo", bf16=os.path.join(
        ROOT, "cfg", "coco_objgan.yml"))
    wall_b = time.monotonic() - t0
    log("ddp", f"(b, c) parallel.dryrun.run(2, cuda, gloo) in {wall_b:.1f} "
        f"s: " + dryrun.summary(2, res))
    errs = dict.fromkeys(COUNTED, a_err)
    launches = {k: v for k, v in a_launch.items()}
    for name, r in res["stages"].items():
        ran = [k for k in COUNTED if r["launches_1"][k]]
        for rank, got in enumerate(r["launches"]):
            check(got == r["launches_1"], f"{name}: rank {rank} launched "
                  f"{got}, world size 1 {r['launches_1']}")
            for k in ran:
                launches[k] += got[k]
        out = max(r["abs"], r.get("pixel_err", 0.0))
        for k in ran:
            errs[k] = max(errs[k], out)
        log("ddp", f"{name}: launches per rank {r['launches'][0]} (world "
            f"size 1: {r['launches_1']}), metrics max |d| {r['abs']:.3g}, "
            f"rel {r['rel']:.3g} ({r['worst']}), state max |d| "
            f"{r['state_err']:.3g}" + (f", sampled pixels max |d| "
                                       f"{r['pixel_err']:.3g}"
                                       if "pixel_err" in r else ""))
    check(all(res["stages"]["gan"]["launches_1"][k] for k in per_step),
          "the tiny Stage-C steps launched no K1, K2 or K3")
    for k in ("damsm", "shape"):
        check(res["stages"][k]["launches_1"]["K1"] > 0,
              f"the tiny {k} steps launched no K1")
    bf = res["bf16"]
    want = {k: v * dryrun.BF16_STEPS for k, v in per_step.items()}
    for rank, got in enumerate(bf["ranks"]):
        check(got["launches"] == want, f"bf16: rank {rank} launched "
              f"{got['launches']}, phase train's counts {want}")
        for k in launches:
            launches[k] += got["launches"][k]
    ms1 = statistics.median(bf["one"]["ms"][1:])
    ms2 = statistics.median(bf["ranks"][0]["ms"][1:])
    log("ddp", f"bf16 coco_objgan, global batch {bf['one']['batch']}: "
        f"{dryrun.BF16_STEPS} steps finite, parameters bitwise equal on both "
        f"ranks, launches per rank {bf['ranks'][0]['launches']}; "
        f"synchronised ms per step after the first: world size 1 "
        f"{ms1:.1f} (batch {bf['one']['batch']}), world size 2 {ms2:.1f} "
        f"(batch {bf['one']['batch'] // 2} per rank; both ranks on this one "
        f"card over gloo through the host, so this is no measure of NCCL "
        f"across cards)")
    return {"launches": launches, "errs": errs, "ms_1": ms1, "ms_2": ms2,
            "a": a_launch}


MULTI_K = 4  # TRAIN.STEPS_PER_EXECUTION in phase multi_step
MULTI_STAGES = (("gan", "coco_objgan.yml"), ("damsm", "damsm_coco.yml"),
                ("box", None), ("shape", "shape_coco.yml"))


def _sync_ms(fn, reps):
    """Median synchronised wall ms of ``reps`` calls of ``fn``."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _graph_against_eager(stage, cfg):
    """One trainer's K = MULTI_K steps as a CUDA-graph replay against eager
    steps (``train/card_check.py::graph_against_eager``) in PyTorch's
    default mode, then timed and profiled both ways; the graph's kernel
    nodes by kernel. Where two eager runs agree to the bit, the replay
    must equal them to the bit."""
    import torch

    from objgan_tpu_torch.ops.twin_rules import KERNEL_NAMES
    from objgan_tpu_torch.train import card_check
    from objgan_tpu_torch.train.common import index_stack
    from objgan_tpu_torch.utils.profiling import (device_profile,
                                                  graph_kernel_nodes)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = card_check.graph_against_eager(stage, cfg, MULTI_K)
    e, spread, k1e = r["eager_err"], r["spread"], r["k1_err"]
    check(e["bitwise"] or not spread["bitwise"], f"{stage}: two eager runs "
          f"agree to the bit and the replay differs from them (max |d| "
          f"{e['max_abs']:.3g})")
    check(math.isfinite(r["metric_err"]) and math.isfinite(e["max_abs"]),
          f"{stage}: non-finite replay")
    graph, eager = r["graph"], r["eager"]
    batches, noises = r["inputs"]
    del r["eager2"], r["k1"]

    def replay():
        graph.multi_train_step(batches, noises)

    def eager_steps():
        for i in range(MULTI_K):
            eager.train_step(index_stack(batches, i),
                             *index_stack(noises, i))

    _reset_counts()
    eager_ms = _sync_ms(eager_steps, 1) / MULTI_K
    per_step = {k: v // MULTI_K for k, v in zip(COUNTED, _counts())}
    eager_ms = min(eager_ms, _sync_ms(eager_steps, 2) / MULTI_K)
    _reset_counts()
    graph_ms = _sync_ms(replay, 3) / MULTI_K
    check(_counts() == (0, 0, 0, 0), f"{stage}: a replay counted launches")
    g_wall, g_busy, _ = device_profile(replay)
    e_wall, e_busy, _ = device_profile(eager_steps)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    kernels, nodes, found = graph_kernel_nodes(
        graph.multi_step().graph().raw_cuda_graph(),
        list(KERNEL_NAMES.values()))
    in_graph = {k: found[name] for k, name in KERNEL_NAMES.items()}
    want = {k: MULTI_K * v for k, v in per_step.items()}
    check(in_graph == want == r["captured"], f"{stage}: the graph holds "
          f"{in_graph} kernel nodes and its capture counted {r['captured']}; "
          f"{MULTI_K} eager steps launch {want}")

    def err(d):
        return ("equal to the bit" if d["bitwise"] else
                f"max |d| {d['max_abs']:.3g}, rel {d['rel']:.3g}")

    log("multi_step", f"{stage}, default mode: {MULTI_K} steps as one "
        f"replay against {MULTI_K} eager steps (capturable Adam) "
        f"{err(e)}; two eager runs {err(spread)}; against K = 1's Adam "
        f"{err(k1e)}; metric means rel {r['metric_err']:.3g}; ms per step "
        f"eager {eager_ms:.2f}, replay {graph_ms:.2f} (synchronised, inputs "
        f"copied in); device busy share under torch.profiler eager "
        f"{e_busy / e_wall:.3f} ({e_busy:.1f} of {e_wall:.1f} ms for "
        f"{MULTI_K} steps), replay {g_busy / g_wall:.3f} ({g_busy:.1f} of "
        f"{g_wall:.1f} ms); peak memory allocated {peak_gb:.2f} GiB; graph "
        f"{nodes} nodes, {kernels} kernels, of them K1 {in_graph['K1']}, "
        f"K2 {in_graph['K2']}, K3 {in_graph['K3']}, K1 backward "
        f"{in_graph['K1 backward']}")
    return {"eager_ms": eager_ms, "graph_ms": graph_ms,
            "busy": (e_busy / e_wall, g_busy / g_wall), "peak_gb": peak_gb,
            "nodes": in_graph, "kernels": kernels, "all_nodes": nodes,
            "default": card_check.agreement(r)}


def _deterministic_agreement(cfgs):
    """Each trainer's replay against eager steps at its full-width config
    in a process under ``torch.use_deterministic_algorithms``
    (``card_check.deterministic_agreement``): the eager steps are
    reproducible there, and the replay must equal them to the bit."""
    from objgan_tpu_torch.train import card_check

    t0 = time.monotonic()
    try:
        res = card_check.deterministic_agreement(cfgs, MULTI_K)
    except RuntimeError as e:
        check(False, str(e))
    for stage, r in res.items():
        e, spread, k1e = r["eager_err"], r["spread"], r["k1_err"]
        check(spread["bitwise"], f"{stage}: eager steps not reproducible "
              f"under deterministic algorithms")
        check(e["bitwise"] and r["metric_err"] == 0.0, f"{stage}: under "
              f"deterministic algorithms the replay differs from the eager "
              f"steps: max |d| {e['max_abs']:.3g}, rel {e['rel']:.3g}, "
              f"metrics {r['metric_err']:.3g}")
        log("multi_step", f"{stage}, deterministic algorithms: {MULTI_K} "
            f"steps as one replay equal to {MULTI_K} eager steps to the bit "
            f"(state and metric means; two eager runs equal too); against "
            f"K = 1's Adam (the bias corrections on the host, another "
            f"rounding) max |d| {k1e['max_abs']:.3g}, rel {k1e['rel']:.3g}")
    log("multi_step", f"deterministic agreement in a subprocess: "
        f"{time.monotonic() - t0:.1f} s with start-up")
    return res


def _gan_main_k(yml, max_steps):
    """``gan_main --cfg yml`` on the manifest to ``max_steps``, in this
    process: (its stdout, the kernels' launches)."""
    import io

    from objgan_tpu_torch import gan_main

    out = io.StringIO()
    _reset_counts()
    with contextlib.redirect_stdout(out):
        gan_main.main(["--cfg", yml, "--manifest",
                       os.path.join(ROOT, MANIFEST), "--data_dir",
                       os.path.join(ROOT, DATA_DIR), "--max_steps",
                       str(max_steps), "--log_every", "1"])
    return out.getvalue(), dict(zip(COUNTED, _counts()))


def phase_multi_step(per_step):
    """``TRAIN.STEPS_PER_EXECUTION``: (a) each trainer at full width, K =
    MULTI_K steps as one CUDA-graph replay against as many eager steps
    from the same state, batches and noise: to the bit under deterministic
    algorithms (a subprocess), and in the default mode beside two eager
    runs' own spread; timed, profiled, the graph's kernel nodes counted;
    (b) ``gan_main`` on the manifest with K =
    MULTI_K to step 10 (two executions, the ragged tail's two steps), the
    JAX loop's checkpoints and rows, then resumed to 14; (c) ``gan_main``
    as one NCCL rank under torchrun with K = MULTI_K."""
    import torch
    import yaml

    from objgan_tpu_torch.core.config import Config, cfg_from_file

    cfgs = {stage: (cfg_from_file(os.path.join(ROOT, "cfg", name)) if name
                    else Config()) for stage, name in MULTI_STAGES}
    agree = _deterministic_agreement(cfgs)
    res = {}
    for stage, cfg in cfgs.items():
        res[stage] = _graph_against_eager(stage, cfg)
        torch.cuda.empty_cache()
    want = {k: MULTI_K * v for k, v in per_step.items()}
    check(res["gan"]["nodes"] == want, f"the Stage-C graph holds "
          f"{res['gan']['nodes']} kernel nodes, {MULTI_K} x phase train's "
          f"per step is {want}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    with open(os.path.join(ROOT, "cfg", "coco_objgan.yml")) as f:
        raw = yaml.safe_load(f)
    raw["OUTPUT_DIR"] = os.path.join(tmp, "out")
    raw["TRAIN"].update(STEPS_PER_EXECUTION=MULTI_K, SNAPSHOT_STEPS=3)
    yml = os.path.join(tmp, "coco_objgan_k.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(raw, f)
    stage_dir = os.path.join(tmp, "out", f"{raw['CONFIG_NAME']}_gan")
    t0 = time.monotonic()
    text, launched = _gan_main_k(yml, 10)
    wall = time.monotonic() - t0
    ckpts = sorted(int(d) for d in os.listdir(os.path.join(stage_dir,
                                                           "ckpt")))
    # the JAX loop's saves at SNAPSHOT_STEPS 3, K 4: the executions ending
    # at 4 and 8 pass 3 and 6, the ragged tail's end 10 passes 9
    check(ckpts == [4, 8, 10], f"gan_main K={MULTI_K}: checkpoints {ckpts}")
    pngs = sorted(f for f in os.listdir(stage_dir) if f.startswith("attn"))
    check(pngs == ["attn_step10.png", "attn_step4.png", "attn_step8.png"],
          f"gan_main K={MULTI_K}: grids {pngs}")
    with open(os.path.join(stage_dir, "gan_metrics.csv")) as f:
        rows = [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)]
    check([r["step"] for r in rows] == [4, 8, 10], f"gan_main K={MULTI_K}: "
          f"rows at {[r['step'] for r in rows]}")
    bad = [k for r in rows for k, v in r.items() if not math.isfinite(v)]
    check(not bad, f"gan_main K={MULTI_K}: non-finite metrics {bad}")
    # launches counted: the eager first execution, the capture (recorded
    # once, replayed), the tail's two steps; K2 and K3 only in the steps
    counted = 2 * MULTI_K + 2
    check(launched["K2"] == 3 * counted and launched["K3"] == 3 * counted
          and launched["K1"] >= per_step["K1"] * counted
          and launched["K1 backward"] == per_step["K1 backward"] * counted,
          f"gan_main K={MULTI_K}: launches {launched}")
    t0 = time.monotonic()
    text2, _ = _gan_main_k(yml, 14)
    wall2 = time.monotonic() - t0
    check("resumed from step 10" in text2, "gan_main K: no resume")
    ckpts2 = sorted(int(d) for d in os.listdir(os.path.join(stage_dir,
                                                            "ckpt")))
    check(ckpts2 == [8, 10, 14], f"gan_main K resumed: checkpoints {ckpts2}")
    log("multi_step", f"(b) gan_main --cfg coco_objgan (STEPS_PER_EXECUTION "
        f"{MULTI_K}, SNAPSHOT_STEPS 3) --manifest {MANIFEST} --max_steps 10 "
        f"in {wall:.1f} s with set-up: checkpoints {ckpts}, grids {pngs}, "
        f"CSV rows at steps {[int(r['step']) for r in rows]} (K-meaned at 4 "
        f"and 8), every metric finite, launches counted {launched}; resumed "
        f"to 14 in {wall2:.1f} s: checkpoints {ckpts2}")

    counts = os.path.join(tmp, "counts")
    t0 = time.monotonic()
    raw["OUTPUT_DIR"] = os.path.join(tmp, "ddp")
    raw["TRAIN"]["SNAPSHOT_STEPS"] = 1000  # no grid: only the steps count
    with open(yml, "w") as f:
        yaml.safe_dump(raw, f)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", os.path.abspath(__file__), "--entry",
         "objgan_tpu_torch.gan_main", counts, "--cfg", yml, "--max_steps",
         str(2 * MULTI_K), "--log_every", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall3 = time.monotonic() - t0
    check(proc.returncode == 0, f"torchrun gan_main K={MULTI_K} failed (rc "
          f"{proc.returncode}):\n{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    ddp_dir = os.path.join(tmp, "ddp", f"{raw['CONFIG_NAME']}_gan")
    with open(os.path.join(ddp_dir, "gan_metrics.csv")) as f:
        ddp_rows = [int(float(r["step"])) for r in csv.DictReader(f)]
    check(ddp_rows == [MULTI_K, 2 * MULTI_K], f"torchrun gan_main K: rows "
          f"{ddp_rows}")
    with open(f"{counts}.0") as f:
        ddp_launched = json.load(f)
    want = {k: 2 * MULTI_K * v for k, v in per_step.items()}
    check(ddp_launched == want, f"torchrun gan_main K: launches "
          f"{ddp_launched}, want {want} (the eager execution and the "
          f"capture)")
    log("multi_step", f"(c) torchrun --nproc_per_node=1 gan_main "
        f"(STEPS_PER_EXECUTION {MULTI_K}, NCCL, the gradients' and "
        f"metrics' all-reduces inside the graph) --max_steps {2 * MULTI_K} "
        f"in {wall3:.1f} s with start-up: rows {ddp_rows}, launches "
        f"counted {ddp_launched}")
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"stages": res, "agreement": agree, "launches": launched,
            "ddp": ddp_launched}


@contextlib.contextmanager
def _numpy_fill():
    """The feed's polygon fill swapped for its numpy plain version."""
    from objgan_tpu_torch import native
    from objgan_tpu_torch.data import pipeline as pl

    saved = native.rasterize_polygon
    native.rasterize_polygon = pl._numpy_polygon_fill
    try:
        yield
    finally:
        native.rasterize_polygon = saved


def phase_native():
    """The native polygon fill (``native/rasterize.cc``, g++) against its
    numpy plain version, bitwise, on every polygon of the manifest; then a
    Stage-B batch and an eval batch fed with each fill."""
    import numpy as np

    from objgan_tpu_torch import native
    from objgan_tpu_torch.core.config import cfg_from_file
    from objgan_tpu_torch.data import pipeline as pl
    from objgan_tpu_torch.data.feed import build_feed

    t0 = time.monotonic()
    path = native.build()
    log("native", f"{os.path.relpath(path, ROOT)} (g++ "
        f"{' '.join(native.GXX_FLAGS)}) ready in "
        f"{time.monotonic() - t0:.2f} s")
    shape_cfg = cfg_from_file(os.path.join(ROOT, "cfg", "shape_coco.yml")
                              ).merged({"DATA_DIR": os.path.join(ROOT,
                                                                 DATA_DIR)})
    size = shape_cfg.OBJ.SHAPE_SIZE
    records = pl.load_records_json(os.path.join(ROOT, MANIFEST))
    pairs = [(np.asarray(p, np.float64), np.asarray(b, np.float32))
             for r in records for p, b in zip(r.get("polygons") or [],
                                              r["boxes"])]
    check(len(pairs) > 1000, f"the manifest holds {len(pairs)} polygons")
    fills = {}
    for name, ctx in (("native", contextlib.nullcontext), ("numpy",
                                                           _numpy_fill)):
        with ctx():
            t0 = time.perf_counter()
            fills[name] = [pl.polygon_to_box_mask(p, b, size)
                           for p, b in pairs]
            fills[name + "_ms"] = 1000.0 * (time.perf_counter() - t0)
    bad = sum(not np.array_equal(a, b)
              for a, b in zip(fills["native"], fills["numpy"]))
    check(bad == 0, f"native and numpy fills differ on {bad} of "
          f"{len(pairs)} polygons")
    log("native", f"{len(pairs)} manifest polygons at {size} px: native == "
        f"numpy bitwise on every one; {fills['native_ms']:.1f} ms native, "
        f"{fills['numpy_ms']:.1f} ms numpy (polygon_to_box_mask)")

    eval_cfg = _eval_cfg(tempfile.gettempdir()).merged(
        {"TRAIN": {"FLAG": False}})
    out = {}
    for stage, cfg, kw in (
            (f"Stage-B batch ({shape_cfg.TRAIN.BATCH_SIZE} x "
             f"{shape_cfg.OBJ.MAX_OBJECTS} objects, shape_coco)", shape_cfg,
             {"with_images": False}),
            (f"eval batch ({eval_cfg.TRAIN.BATCH_SIZE}, eval_coco)",
             eval_cfg, {"augment": False})):
        times, batches = {}, {}
        for name, ctx in (("native", contextlib.nullcontext),
                          ("numpy", _numpy_fill)):
            with ctx():
                feed, _, _ = build_feed(cfg, os.path.join(ROOT, MANIFEST),
                                        **kw)
                batches[name] = next(feed)  # the first: the feed's set-up
                times[name] = _feed_ms(feed, n=3)
        for key in batches["native"]:
            a, b = batches["native"][key], batches["numpy"][key]
            same = (all(np.array_equal(x, y) for x, y in zip(a, b))
                    if isinstance(a, list) else np.array_equal(a, b))
            check(same, f"{stage}: {key} differs between the fills")
        check(batches["native"]["shapes"].any(), f"{stage}: empty masks")
        out[stage] = {k: statistics.median(v) for k, v in times.items()}
        log("native", f"{stage}: bitwise equal with either fill; host ms "
            f"per batch native " + ", ".join(f"{t:.1f}" for t in
                                            times["native"])
            + " (median " f"{out[stage]['native']:.1f}), numpy "
            + ", ".join(f"{t:.1f}" for t in times["numpy"])
            + f" (median {out[stage]['numpy']:.1f})")
    return out


def _lineage_tensors(module, name_map, gen, skip=()):
    """Random lineage-format tensors (torch layouts) for every entry of
    ``name_map`` whose target ``module`` has: the LSTM's weights (4H, D), a
    1x1 conv where the lineage has one onto a Dense weight."""
    import torch

    state = module.state_dict()
    sd = {}
    for tname, pname in name_map.items():
        if pname not in state or tname in skip:
            continue
        shape = tuple(state[pname].shape)
        if "weight_ih" in tname or "weight_hh" in tname:
            shape = shape[::-1]
        elif "conv_context" in tname:
            shape = shape + (1, 1)
        sd[tname] = torch.randn(shape, generator=gen) * 0.02
    return sd


def phase_lineage():
    """Lineage ``.pth`` files at full width through the port's tools:
    ``convert_damsm`` (text + inception image encoder at ``damsm_coco``)
    into ``cli.train_gan`` at ``coco_objgan`` via ``TRAIN.NET_E``;
    ``convert_gan`` (netG + a netD per scale) into ``cli.sample_gan`` via
    ``TRAIN.NET_G``; ``export_damsm`` and a re-import, bitwise."""
    import io

    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.checkpoint import STATE_FILE
    from objgan_tpu_torch.core.config import cfg_from_file
    from objgan_tpu_torch.core.layers import init_weights
    from objgan_tpu_torch.core.name_maps import (d_net_name_map,
                                                 export_rnn_encoder,
                                                 g_net_name_map)
    from objgan_tpu_torch.models.common import FusedGroupNorm
    from objgan_tpu_torch.models.inception_v3 import (InceptionEncoder,
                                                      torchvision_state_dict)
    from objgan_tpu_torch.tools import convert_damsm, convert_gan, export_damsm
    from objgan_tpu_torch.train.gan import GanTrainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_lineage_")
    damsm_cfg = cfg_from_file(os.path.join(ROOT, "cfg", "damsm_coco.yml"))
    t = damsm_cfg.TEXT
    gen = torch.Generator().manual_seed(11)
    # text_encoder.pth: the lineage's nn.Embedding + bidirectional nn.LSTM
    with torch.random.fork_rng():
        torch.manual_seed(11)
        emb = torch.nn.Embedding(t.VOCAB_SIZE, t.GLOVE_DIM)
        lstm = torch.nn.LSTM(t.GLOVE_DIM, t.HIDDEN_DIM, batch_first=True,
                             bidirectional=True)
    text_sd = {"encoder." + k: v.detach().clone()
               for k, v in emb.state_dict().items()}
    text_sd.update({"rnn." + k: v.detach().clone()
                    for k, v in lstm.state_dict().items()})
    # image_encoder.pth: torchvision Inception-v3's feature modules and the
    # lineage's two projections, BatchNorm step counters included
    src = InceptionEncoder(t.EMBEDDING_DIM)
    init_weights(src, gen)
    img_sd = {k: v for k, v in torchvision_state_dict(src).items()
              if not k.startswith("fc.")}
    img_sd.update({k[:-len("running_mean")] + "num_batches_tracked":
                   torch.tensor(0) for k in list(img_sd)
                   if k.endswith("running_mean")})
    img_sd.update({
        "emb_features.weight": torch.randn(t.EMBEDDING_DIM, 768, 1, 1,
                                           generator=gen) * 0.02,
        "emb_cnn_code.weight": torch.randn(t.EMBEDDING_DIM, 2048,
                                           generator=gen) * 0.02,
        "emb_cnn_code.bias": torch.randn(t.EMBEDDING_DIM, generator=gen)})
    text_pth = os.path.join(tmp, "text_encoder.pth")
    img_pth = os.path.join(tmp, "image_encoder.pth")
    torch.save(text_sd, text_pth)
    torch.save(img_sd, img_pth)
    net_e = os.path.join(tmp, "net_e")
    t0 = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()):
        convert_damsm.main(["--cfg", os.path.join(ROOT, "cfg",
                                                  "damsm_coco.yml"),
                            "--text_pth", text_pth, "--image_pth", img_pth,
                            "--out", net_e])
    convert_s = time.monotonic() - t0
    saved = torch.load(os.path.join(net_e, "0", STATE_FILE),
                       map_location="cpu", weights_only=True)

    # Stage C from the converted encoders, at coco_objgan width
    gan_cfg = cfg_from_file(os.path.join(ROOT, "cfg", "coco_objgan.yml")
                            ).merged({"OUTPUT_DIR": os.path.join(tmp, "out"),
                                      "TRAIN": {"NET_E": net_e},
                                      "TEXT": {"CNN_BACKBONE": "inception"}})
    steps = 2
    calls, hook = _count_calls((FusedGroupNorm,))
    out = io.StringIO()
    try:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            gan = cli.train_gan(gan_cfg, max_steps=steps, device="cuda",
                                log_every=1)
        torch.cuda.synchronize()
        k1, k2, k3, k1b = _counts()
        train_s = time.monotonic() - t0
    finally:
        hook.remove()
    text = out.getvalue()
    check(f"loaded pretrained DAMSM encoders from {net_e} (step 0)" in text,
          "train_gan did not load the converted NET_E")
    seen = _metric_lines(text)
    check(len(seen) == steps and all(math.isfinite(v) for m in seen
                                     for v in m.values()),
          "lineage Stage-C metrics missing or non-finite")
    gan_sd = gan.state_dict()
    enc_keys = [k for k in saved if k.startswith(("text_enc.", "img_enc."))]
    diff = [k for k in enc_keys if not _tensor_equal(gan_sd[k], saved[k])]
    check(enc_keys and not diff, f"Stage-C encoders differ from the "
          f"converted ones at {diff[:3]}")
    check(torch.equal(gan.text_enc.embedding.weight.cpu(),
                      text_sd["encoder.weight"]),
          "the text encoder's embedding is not the lineage's")
    gn_calls = calls[FusedGroupNorm]
    check(k1 > 0 and k1 == gn_calls == k1b and k2 == 3 * steps
          and k3 == 3 * steps, f"lineage Stage C launched K1 {k1} "
          f"({gn_calls} GroupNorm calls), K2 {k2}, K3 {k3}, K1 backward "
          f"{k1b} in {steps} steps")
    log("lineage", f"convert_damsm: random lineage text_encoder.pth (vocab "
        f"{t.VOCAB_SIZE}, GloVe {t.GLOVE_DIM}, hidden {t.HIDDEN_DIM}) and "
        f"inception image_encoder.pth ({len(img_sd)} tensors) -> NET_E in "
        f"{convert_s:.1f} s; cli.train_gan at coco_objgan width, inception "
        f"image encoder, {steps} steps in {train_s:.1f} s: finite metrics, "
        f"its {len(enc_keys)} encoder tensors equal the converted ones; "
        f"launches per step K1 {k1 // steps}, K2 {k2 // steps}, K3 "
        f"{k3 // steps}, K1 backward {k1b // steps}; ms per step "
        + ", ".join(
            f"{1000.0 / m['steps_per_sec']:.1f}" for m in seen))
    launches = {"K1": k1, "K2": k2, "K3": k3, "K1 backward": k1b}
    del gan, gan_sd

    # netG_epoch_N.pth + a netD per scale, at coco_objgan width
    template = GanTrainer(gan_cfg)
    g_map = g_net_name_map(gan_cfg)
    g_sd = _lineage_tensors(template.g_net, g_map, gen)
    k = tuple(template.g_net.init_stage.up0.conv.weight.shape)
    # the lineage's first up-block takes no layout features: fewer inputs
    g_sd["h_net1.upsample1.1.weight"] = torch.zeros(
        k[0], k[1] - 8 * gan_cfg.GAN.GF_DIM, *k[2:])
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        g_sd[f"h_net1.upsample1.2.{leaf}"] = torch.ones(k[0])
    d_pths = []
    for dnet, size in zip(template.d_nets, gan_cfg.branch_sizes):
        d_sd = _lineage_tensors(dnet, d_net_name_map(gan_cfg, size), gen)
        d_pths.append(os.path.join(tmp, f"netD{size}.pth"))
        torch.save(d_sd, d_pths[-1])
    g_pth = os.path.join(tmp, "netG_epoch_600.pth")
    torch.save(g_sd, g_pth)
    del template
    net_g = os.path.join(tmp, "net_g")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        convert_gan.main(["--g_pth", g_pth, *sum((["--d_pth", p]
                                                   for p in d_pths), []),
                          "--out", net_g, "--cfg", _yml(tmp, gan_cfg)])
    report = [ln for ln in out.getvalue().splitlines()
              if ln.startswith(("G_NET", "D_NET", "  "))]
    check(len([ln for ln in report if "loaded" in ln]) == 4,
          f"convert_gan reported {report}")
    conv = torch.load(os.path.join(net_g, "0", STATE_FILE),
                      map_location="cpu", weights_only=True)
    for key in ("g_net.", "ema_g."):
        check(torch.equal(conv[key + "ca_net.fc.weight"],
                          g_sd["ca_net.fc.weight"]),
              f"the converted {key} does not hold the lineage's CA-net")
    check(_tensor_equal(conv["text_enc.embedding.weight"],
                        text_sd["encoder.weight"]),
          "convert_gan did not seed the encoders from NET_E")
    sample_cfg = gan_cfg.merged({"TRAIN": {"NET_G": net_g, "FLAG": False}})
    _reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        samples = cli.sample_gan(sample_cfg, num_batches=1, device="cuda")
    torch.cuda.synchronize()
    k1_s = _counts()[0]
    check("UNTRAINED" not in out.getvalue(), "sample_gan found no NET_G")
    pngs = sorted(os.listdir(samples))
    check(len(pngs) == gan_cfg.TRAIN.BATCH_SIZE and k1_s > 0,
          f"sample_gan wrote {len(pngs)} PNGs, launched K1 {k1_s} times")
    launches["K1"] += k1_s
    log("lineage", "convert_gan: random lineage netG + netD64/128/256 at "
        "coco_objgan width -> NET_G (" + "; ".join(
            ln.split(" (")[0] for ln in report if "loaded" in ln)
        + f"); cli.sample_gan from it: {len(pngs)} PNGs, K1 {k1_s}")

    # export_damsm, then convert_damsm of the export: the same checkpoint
    inc_cfg = damsm_cfg.merged({"TEXT": {"CNN_BACKBONE": "inception"}})
    exp_text = os.path.join(tmp, "export", "text_encoder.pth")
    exp_img = os.path.join(tmp, "export", "image_encoder.pth")
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = export_damsm.export(inc_cfg, net_e, exp_text, exp_img)
        convert_damsm.convert(damsm_cfg, exp_text, exp_img,
                              os.path.join(tmp, "net_e2"))
    again = torch.load(os.path.join(tmp, "net_e2", "0", STATE_FILE),
                       map_location="cpu", weights_only=True)
    diff = [k for k in enc_keys if not torch.equal(again[k], saved[k])]
    check(not diff, f"export -> import differs at {diff[:3]}")
    exported = torch.load(exp_text, weights_only=True)
    check(all(torch.equal(exported[k], v) for k, v in
              export_rnn_encoder(trainer.text_enc).items()),
          "the exported text_encoder.pth differs from the encoder")
    log("lineage", f"export_damsm -> text_encoder.pth ({len(exported)} "
        f"tensors) + image_encoder.pth, convert_damsm of them: all "
        f"{len(enc_keys)} encoder tensors bitwise equal to the first "
        f"conversion")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches, "k1_per_step": k1 // steps}


def _yml(directory, cfg):
    """``cfg`` as a yml file in ``directory``, for an entry point's --cfg."""
    import dataclasses

    import yaml

    path = tempfile.mkstemp(suffix=".yml", dir=directory)[1]
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f)
    return path


def _finite(tree):
    """Every tensor in ``tree`` (nested lists, tuples, dicts) finite."""
    import torch
    from torch.utils._pytree import tree_flatten

    return all(bool(torch.isfinite(t.float()).all())
               for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor))


def phase_breakdown():
    """``utils/breakdown.py`` on the card with ``analyze=True``: Stage-C
    sampling at ``eval_coco`` width (batch 16, bf16, 64 -> 256 px) on a
    manifest batch, the train step at ``coco_objgan`` width on a synthetic
    one; every stage's output finite, K1 launched once per GroupNorm call
    of each stage."""
    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core.config import cfg_from_file
    from objgan_tpu_torch.data.feed import build_feed
    from objgan_tpu_torch.data.synthetic import synthetic_batch
    from objgan_tpu_torch.models.common import FusedGroupNorm
    from objgan_tpu_torch.train.gan import train_noise
    from objgan_tpu_torch.utils import breakdown

    results, launches = {}, dict.fromkeys(COUNTED, 0)
    eval_cfg = _eval_cfg(tempfile.gettempdir()).merged(
        {"TRAIN": {"FLAG": False}})
    train_cfg = cfg_from_file(os.path.join(ROOT, "cfg", "coco_objgan.yml"))
    for what, cfg in (("sampling", eval_cfg), ("train", train_cfg)):
        trainer = cli.make_trainer(cfg, "cuda")
        gen = torch.Generator("cuda").manual_seed(13)
        if what == "sampling":
            feed, _, _ = build_feed(cfg, os.path.join(ROOT, MANIFEST),
                                    augment=False)
            batch = cli.to_device(next(feed), "cuda")
        else:
            batch = synthetic_batch(cfg, gen)
        noise = train_noise(cfg, cfg.TRAIN.BATCH_SIZE, gen, "cuda")
        args = (trainer, batch, noise["z"], noise["ca_eps"])
        stages = (breakdown.sampling_stages(cfg, *args) if what == "sampling"
                  else breakdown.train_stages(*args))
        per_stage = {}
        for name, fn in stages.items():
            calls, hook = _count_calls((FusedGroupNorm,))
            try:
                _reset_counts()
                res = fn()
                torch.cuda.synchronize()
                counts = dict(zip(COUNTED, _counts()))
            finally:
                hook.remove()
            check(_finite(res), f"breakdown {what}: {name} is not finite")
            check(counts["K1"] == calls[FusedGroupNorm],
                  f"breakdown {what}: {name} launched K1 {counts['K1']} "
                  f"times for {calls[FusedGroupNorm]} GroupNorm calls")
            per_stage[name] = counts
            for k, v in counts.items():
                launches[k] += v
        normalising = [n for n, c in per_stage.items() if c["K1"]]
        if what == "sampling":
            want = [n for n in stages if n.startswith(
                ("layout_encoder", "init_stage", "attn_stage"))]
        else:
            want = list(stages)
            check(all(c["K2"] == 3 for c in per_stage.values())
                  and per_stage["g_grad"]["K3"] > 0
                  and per_stage["d_grad"]["K3"] > 0,
                  f"breakdown train: ROI-align launches {per_stage}")
        check(normalising == want, f"breakdown {what}: K1 in {normalising}, "
              f"expected in {want}")
        log("breakdown", f"{what}: each stage once, finite, launches "
            + "; ".join(f"{n} " + "/".join(str(c[k]) for k in c)
                        for n, c in per_stage.items())
            + " (K1/K2/K3/K1 backward)")
        t0 = time.monotonic()
        if what == "sampling":
            out = breakdown.sampling_breakdown(cfg, *args, n_loop=8,
                                               analyze=True)
        else:
            out = breakdown.train_breakdown(cfg, *args, n_loop=4,
                                            analyze=True)
        results[what] = out
        log("breakdown", f"{what}_breakdown (analyze, {time.monotonic() - t0:.1f} s): "
            + ", ".join(f"{k} {v:.6g}" for k, v in out.items()))
        del trainer, batch, args, stages
        torch.cuda.empty_cache()
    return {"launches": launches, **results}


def _flat_tree(tree, path=()):
    """{Orbax name (keys joined by "."): leaf} of a ``read_orbax`` tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = enumerate(tree)
    else:
        return {} if tree is None else {".".join(path): tree}
    out = {}
    for k, v in items:
        out.update(_flat_tree(v, path + (str(k),)))
    return out


def _leaf_digest(leaf):
    """(little-endian dtype string, shape, sha256) of a leaf."""
    import hashlib

    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):  # bf16
        return ("bfloat16", list(leaf.shape), hashlib.sha256(
            leaf.view(torch.int16).numpy().tobytes()).hexdigest())
    a = np.asarray(leaf)  # ascontiguousarray would make a scalar 1-d
    le = a.astype(a.dtype.newbyteorder("<"))
    return le.dtype.str, list(a.shape), hashlib.sha256(
        le.tobytes()).hexdigest()


def _orbax_tiny(tiny_root, device):
    """Each tiny JAX state (DAMSM, Stage A, B, C) restored on ``device``
    and on the CPU: a ``grads`` call on each, held together as phases
    ``small_*`` hold them; then one train step on each, both held to JAX's
    step. Returns the launches on ``device``."""
    import contextlib
    import io

    import numpy as np
    import torch

    from objgan_tpu_torch.train import card_check

    goldens = dict(np.load(os.path.join(ROOT, ORBAX_GOLDENS)))
    launches = dict.fromkeys(COUNTED, 0)
    for stage in ("gan", "damsm", "box", "shape"):
        before = _counts()
        with contextlib.redirect_stdout(io.StringIO()):
            r = card_check.restored_grads_on_card(stage, tiny_root, goldens,
                                                  device)
            card, m_card, step = card_check.restored_step(stage, tiny_root,
                                                          goldens, device)
            if device == "cuda":
                torch.cuda.synchronize()
            rose = [a - b for a, b in zip(_counts(), before)]
            cpu, m_cpu, _ = card_check.restored_step(stage, tiny_root,
                                                     goldens, "cpu")
        check(r["metric_err"] <= card_check.METRIC_RTOL
              and r["grad_err"] <= card_check.GRAD_RTOL,
              f"tiny {stage} restored, card vs CPU: metrics "
              f"{r['metric_err']:.3g}, gradient of {r['worst']} "
              f"{r['grad_err']:.3g}")
        jax_errs = [card_check.golden_errors(stage, t, m, goldens)
                    for t, m in ((card, m_card), (cpu, m_cpu))]
        rtol = ORBAX_METRIC_RTOL[stage]
        for where, e in zip(("card", "CPU"), jax_errs):
            check(e["step_ok"] and e["metric_err"] <= rtol
                  and e["state_score"] <= 1.0,
                  f"tiny {stage} on the {where} against JAX's step: {e}")
        need = {"gan": (1, 1, 1, 1), "damsm": (1, 0, 0, 1),
                "shape": (1, 0, 0, 1), "box": (0, 0, 0, 0)}[stage]
        check(device != "cuda" or all((n > 0) == bool(k)
                                      for n, k in zip(rose, need)),
              f"tiny {stage} on the card launched K1/K2/K3/K1 backward "
              f"{rose}")
        for k, n in zip(COUNTED, rose):
            launches[k] += n
        log("orbax", f"tiny {stage} (JAX step {step}, fp32) restored on the "
            f"card and on the CPU: grads, {r['metrics']} metrics within "
            f"{r['metric_err']:.3g} relative (rtol "
            f"{card_check.METRIC_RTOL}), {r['grads']} gradients within "
            f"{r['grad_err']:.3g} relative norm (worst {r['worst']}; limit "
            f"{card_check.GRAD_RTOL}); one train step on each (card "
            f"launches K1/K2/K3/K1 backward {rose} for both calls) against "
            f"JAX's: "
            f"metrics {jax_errs[0]['metric_err']:.3g} (card), "
            f"{jax_errs[1]['metric_err']:.3g} (CPU) relative (limit {rtol}), "
            f"state scores {jax_errs[0]['state_score']:.3g}, "
            f"{jax_errs[1]['state_score']:.3g} (limit 1: each tensor within "
            f"{card_check.STATE_ATOL} absolute or "
            f"{card_check.STATE_RTOL[stage]} relative in norm)")
    return launches


def _orbax_serve(tiny_root, vocab, out_dir, device):
    """``run_serve`` composed from the tiny Orbax box, shape and gan steps:
    2 requests answered. Returns K1's launches."""
    import contextlib
    import io

    import torch

    from objgan_tpu_torch.core.config import tiny_test_config
    from objgan_tpu_torch.serving import run_serve

    tcfg = tiny_test_config().merged({"DTYPE": "float32"})
    responses = []
    out, err = io.StringIO(), io.StringIO()
    _reset_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        stats = run_serve(tcfg, vocab, [{"id": i, "caption": c} for i, c in
                                        enumerate(CAPTIONS[:2])],
                          out_dir, batch_size=2, emit=responses.append,
                          device=device, output_dir=tiny_root)
    if device == "cuda":
        torch.cuda.synchronize()
    k1 = _counts()[0]
    text = out.getvalue()
    check(all(f"restored the {n} stage from" in text
              for n in ("box", "shape", "gan"))
          and "UNTRAINED" not in err.getvalue(),
          f"the composed serve did not restore every stage:\n{text[-800:]}\n"
          f"{err.getvalue()[-800:]}")
    check(len(responses) == 2 and all(
        r["image"] and os.path.getsize(r["image"]) > 0 for r in responses)
        and (k1 > 0 or device != "cuda"),
        f"{len(responses)} responses, K1 {k1}")
    log("orbax", f"run_serve from the tiny Orbax box, shape and gan steps "
        f"(ObjGanPipeline.load_states): 2 requests answered with PNGs in "
        f"{stats['batches']} batch, K1 {k1}")
    return k1


def phase_orbax(vocab):
    """Steps the JAX package wrote (``tests/data/orbax_fixtures.tar.xz``,
    from ``tests/make_orbax_fixtures.py``: no JAX here) through the port's
    own reader: the full-width ``GanTrainState`` decoded and every leaf's
    sha256 held to JAX's; restored into a ``GanTrainer`` on the card
    (``CheckpointManager.restore_latest``); ``cli.train_gan`` resumed from
    it for ORBAX_STEPS steps on a copy, its K1/K2/K3 calls of one more step
    held against their twins; one batch sampled through ``TRAIN.NET_G``;
    each tiny state (DAMSM, Stage A, B, C) restored and stepped on the card
    and on the CPU, both against each other and against JAX's step
    (``tests/data/orbax_goldens.npz``); the composed serve from the tiny
    box, shape and gan steps."""
    import contextlib
    import io
    import tarfile

    import numpy as np
    import torch

    from objgan_tpu_torch import cli
    from objgan_tpu_torch.core import bridge, zstd
    from objgan_tpu_torch.core import checkpoint as ckpt
    from objgan_tpu_torch.core.config import cfg_from_file
    from objgan_tpu_torch.models.common import FusedGroupNorm
    from objgan_tpu_torch.train.gan import GanTrainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_orbax_")
    with tarfile.open(os.path.join(ROOT, ORBAX_ARCHIVE)) as tar:
        tar.extractall(tmp, filter="data")
    root = os.path.join(tmp, "orbax")
    full_ckpt = os.path.join(root, "full", "coco_objgan_gan", "ckpt")
    with open(os.path.join(root, "full_leaves.json")) as f:
        want = json.load(f)
    step = want["step"]

    # the full-width state: decode, hashes, restore onto the card
    decoder = zstd.version()
    t0 = time.perf_counter()
    tree = ckpt.read_orbax(os.path.join(full_ckpt, str(step)))
    read_ms = 1000.0 * (time.perf_counter() - t0)
    flat = _flat_tree(tree)
    mb = sum(np.asarray(v).nbytes if not isinstance(v, torch.Tensor)
             else v.numel() * 2 for v in flat.values()) / 1e6
    check(sorted(flat) == sorted(want["leaves"]),
          f"{len(flat)} leaves read, JAX's tree has {len(want['leaves'])}")
    bad = [k for k, v in want["leaves"].items()
           if list(_leaf_digest(flat[k])) != [v["dtype"], v["shape"],
                                              v["sha256"]]]
    check(not bad, f"{len(bad)} leaves differ from JAX's: {bad[:3]}")
    log("orbax", f"full-width GanTrainState (cfg/coco_objgan.yml, JAX step "
        f"{step}): read_orbax with {decoder}, {len(flat)} leaves, "
        f"{mb:.1f} MB decoded in {read_ms:.0f} ms; every leaf's dtype, "
        f"shape and sha256 equal JAX's")
    cfg = cfg_from_file(os.path.join(ROOT, "cfg", "coco_objgan.yml"))
    trainer = GanTrainer(cfg).to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ckpt.CheckpointManager(full_ckpt).restore_latest(trainer)
    torch.cuda.synchronize()
    restore_ms = 1000.0 * (time.perf_counter() - t0)
    check(restored == step and trainer.step == step,
          f"restore_latest gave {restored}, trainer step {trainer.step}")
    counts = {float(opt.state[p]["step"]) for opt in trainer.optimizers()
              for g in opt.param_groups for p in g["params"]}
    check(counts == {float(want["count"])} and len(trainer.optimizers()) == 5,
          f"optimiser steps {counts} for optax count {want['count']}")
    sd = trainer.state_dict()
    wanted = bridge.jax_state_dict(trainer, tree)
    diff = [k for k, v in wanted.items()
            if not torch.equal(sd[k].cpu().to(v.dtype), v)]
    check(not diff, f"restored tensors differ from the tree at {diff[:3]}")
    log("orbax", f"CheckpointManager.restore_latest onto a GanTrainer on the "
        f"card in {restore_ms:.0f} ms (decode included): step {restored}, "
        f"{len(trainer.optimizers())} Adam optimisers (G, 3 DNets, object D) "
        f"at step {want['count']}; all {len(wanted)} state tensors equal the "
        f"tree's")
    del trainer, sd, wanted, tree, flat
    torch.cuda.empty_cache()

    # resume cli.train_gan from a copy of the JAX run's OUTPUT_DIR
    out_dir = os.path.join(tmp, "run")
    shutil.copytree(os.path.join(root, "full"), out_dir)
    run_ckpt = os.path.join(out_dir, "coco_objgan_gan", "ckpt")
    train_cfg = cfg.merged({"OUTPUT_DIR": out_dir})
    calls, hook = _count_calls((FusedGroupNorm,))
    out = io.StringIO()
    try:
        torch.cuda.synchronize()
        _reset_counts()
        with contextlib.redirect_stdout(out):
            trainer = cli.train_gan(train_cfg, max_steps=step + ORBAX_STEPS,
                                    device="cuda", log_every=1)
        torch.cuda.synchronize()
        k1, k2, k3, k1b = _counts()
    finally:
        hook.remove()
    text = out.getvalue()
    check(f"resumed from step {step}" in text,
          "train_gan did not resume from the Orbax step")
    seen = _metric_lines(text)
    check(len(seen) == ORBAX_STEPS and all(
        math.isfinite(v) for m in seen for v in m.values()),
        "resumed Stage-C metrics missing or non-finite")
    kinds = ckpt.steps_in(run_ckpt)
    check(kinds == {step: ckpt.ORBAX, step + ORBAX_STEPS: ckpt.PORT},
          f"steps after the resumed run: {kinds}")
    gn_calls = calls[FusedGroupNorm]
    check(k1 > 0 and k1 == gn_calls == k1b and k2 == 3 * ORBAX_STEPS
          and k3 == 3 * ORBAX_STEPS,
          f"resumed run launched K1 {k1} ({gn_calls} GroupNorm calls), K2 "
          f"{k2}, K3 {k3}, K1 backward {k1b} in {ORBAX_STEPS} steps")
    log("orbax", f"cli.train_gan with OUTPUT_DIR on a copy of the JAX run: "
        f"\"resumed from step {step}\", {ORBAX_STEPS} steps, finite metrics "
        f"(g_loss " + ", ".join(f"{m['g_loss']:.4g}" for m in seen)
        + ", d_loss " + ", ".join(f"{m['d_loss']:.4g}" for m in seen)
        + f"), ms per step " + ", ".join(
            f"{1000.0 / m['steps_per_sec']:.1f}" for m in seen)
        + f"; step {step + ORBAX_STEPS} written as state.pt beside the Orbax "
        f"step {step}, which keep-N left alone; launches per step K1 "
        f"{k1 // ORBAX_STEPS}, K2 {k2 // ORBAX_STEPS}, K3 {k3 // ORBAX_STEPS}"
        f", K1 backward {k1b // ORBAX_STEPS}")
    gn, fwd, bwd, _, gn_bwd = _record_train_step(train_cfg, trainer)
    errs = _hold_against_twins("orbax", gn, fwd, bwd, gn_bwd)
    log("orbax", f"one more step of the resumed trainer: its {len(gn)} K1, "
        f"{len(fwd)} K2, {len(bwd)} K3 and {len(gn_bwd)} K1 backward calls "
        f"against their twins, max err " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()))
    del trainer, gn, fwd, bwd, gn_bwd
    torch.cuda.empty_cache()
    launches = {"K1": k1, "K2": k2, "K3": k3, "K1 backward": k1b}

    # sample from the JAX step through TRAIN.NET_G
    sample_cfg = cfg.merged({"OUTPUT_DIR": os.path.join(tmp, "sample"),
                             "TRAIN": {"NET_G": full_ckpt, "FLAG": False}})
    out, err = io.StringIO(), io.StringIO()
    _reset_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        samples = cli.sample_gan(sample_cfg, num_batches=1, device="cuda")
    torch.cuda.synchronize()
    k1_s = _counts()[0]
    pngs = os.listdir(samples)
    check("no generator checkpoint" not in out.getvalue() and k1_s > 0
          and len(pngs) == cfg.TRAIN.BATCH_SIZE,
          f"sample_gan from NET_G: {len(pngs)} PNGs, K1 {k1_s}:\n"
          f"{out.getvalue()[-500:]}")
    launches["K1"] += k1_s
    log("orbax", f"cli.sample_gan with TRAIN.NET_G at the JAX run's ckpt: "
        f"{len(pngs)} PNGs, K1 {k1_s}")

    for k, r in _orbax_tiny(os.path.join(root, "tiny"), "cuda").items():
        launches[k] += r
    launches["K1"] += _orbax_serve(os.path.join(root, "tiny"), vocab,
                                   os.path.join(tmp, "served"), "cuda")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches, "errs": errs, "decoder": decoder,
            "read_ms": read_ms, "mb": mb, "restore_ms": restore_ms}


def phase_hw_check():
    """``kernel_hw_check.checked()``: each check passes and launches its
    kernels once."""
    from objgan_tpu_torch.tools import kernel_hw_check

    t0 = time.monotonic()
    try:
        r = kernel_hw_check.checked([])
    except RuntimeError as e:
        check(False, str(e))
    log("hw_check", f"{r['passed']} checks PASS in "
        f"{time.monotonic() - t0:.2f} s; launches {r['launches']}")
    return r


def phase_guard_pages():
    """``guard_pages.checked()``: every kernel on guarded inputs against its
    twin, launched once per check, and the control, which must fault."""
    from objgan_tpu_torch.tools import guard_pages

    try:
        r = guard_pages.checked()
    except RuntimeError as e:
        check(False, str(e))
    log("guard_pages", f"{len(r['checks'])} checks PASS in "
        f"{r['seconds']:.1f} s (K1 plans {r['regimes']}; launches "
        f"{r['launches']}); control: a plain read one float past a guarded "
        f"tensor faults ({r['control_seconds']:.1f} s)")
    return r


def _child_processes():
    """(pid, command line) of every running process whose parent is this
    one, from /proc."""
    kids = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue  # it ended meanwhile
        if ppid == os.getpid():
            kids.append((int(pid), cmd.strip()[:200]))
    return kids


def phase_processes():
    from multiprocessing import resource_tracker

    resource_tracker._resource_tracker._stop()  # closes its pipe, waits
    left = _child_processes()
    check(not left, f"processes still running at the end: {left}")
    log("processes", "no process started by the smoke is still running (the "
        "fork server stopped with the last worker feed, the resource "
        "tracker here)")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from objgan_tpu_torch.core.config import cfg_from_file
    from objgan_tpu_torch.core.precision import true_fp32
    from objgan_tpu_torch.data.tokenizer import Vocab
    from objgan_tpu_torch.pipeline_e2e import ObjGanPipeline

    true_fp32()
    card, kind = phase_device()
    phase_build()
    cfg = cfg_from_file(os.path.join(ROOT, "cfg", "eval_coco.yml"))
    t0 = time.monotonic()
    pipe = ObjGanPipeline.fresh(cfg, cfg.RNG_SEED, "cuda")
    log("serve", f"cfg/eval_coco.yml: batch {cfg.TRAIN.BATCH_SIZE}, DTYPE "
        f"{cfg.DTYPE}, pyramid {cfg.branch_sizes}, GF_DIM {cfg.GAN.GF_DIM}, "
        f"RNN_SIZE {cfg.BOX.RNN_SIZE}; "
        f"{sum(p.numel() for p in pipe.parameters()) / 1e6:.1f} M params "
        f"initialised in {time.monotonic() - t0:.1f} s")
    vocab = Vocab.build(CAPTIONS)
    launches = phase_serve(cfg, vocab, pipe)
    with torch.no_grad():
        k1_err, k1 = phase_kernels(cfg, vocab, pipe)
    phase_stages(cfg, vocab, pipe)
    phase_small()
    del pipe
    torch.cuda.empty_cache()
    # the stages' checkpoints, read back by phase compose
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_out_")
    train_cfg = cfg_from_file(os.path.join(ROOT, "cfg", "coco_objgan.yml")
                              ).merged({"OUTPUT_DIR": out_dir})
    trainer, train = phase_train(train_cfg)
    phase_train_profile(train_cfg, trainer)
    gn_calls, fwd, bwd, pad, gn_bwd = _record_train_step(train_cfg, trainer)
    del trainer
    check(len(gn_calls) == len(gn_bwd) == train["k1_per_step"],
          f"one step made {len(gn_calls)} K1 and {len(gn_bwd)} K1 backward "
          f"calls, train_gan {train['k1_per_step']} per step")
    with torch.no_grad():
        k1_train_err, k1_train = _check_k1("train_k1", gn_calls, "train step")
    del gn_calls
    k1b_err, k1b_param_err, k1b = _check_k1_bwd("train_k1b", gn_bwd,
                                                 "train step", timed=True)
    del gn_bwd
    roi = phase_roi(fwd, bwd, pad)
    del fwd, bwd
    torch.cuda.empty_cache()
    damsm_trainer, batch, keep, (damsm_k1_launches,
                                 damsm_k1b_launches) = phase_damsm()
    k1_damsm_err, k1_damsm = phase_damsm_k1(damsm_trainer, batch, keep)
    del damsm_trainer, batch, keep
    torch.cuda.empty_cache()
    phase_box(out_dir)
    shape_trainer, batch, z, shape = phase_shape(out_dir)
    k1_shape_err, k1_shape = phase_shape_k1(shape_trainer, batch, z)
    del shape_trainer, batch, z
    torch.cuda.empty_cache()
    phase_compose(out_dir, vocab)
    work, eval_launches, _ = phase_eval(out_dir)
    k1_eval_err, k1_eval = phase_eval_k1(out_dir, work)
    phase_strict(out_dir)
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_damsm_inception()
    phase_shape_vgg(shape["device_ms"])
    phase_small_eval()
    feed = phase_feed(train["k1_per_step"])
    ddp = phase_ddp(train)
    multi = phase_multi_step({k: train[k.lower()] // TRAIN_STEPS
                              for k in COUNTED})
    phase_native()
    lineage = phase_lineage()
    torch.cuda.empty_cache()
    orbax = phase_orbax(vocab)
    torch.cuda.empty_cache()
    bd = phase_breakdown()
    hw = phase_hw_check()
    guard = phase_guard_pages()
    phase_processes()
    new_paths = {"lineage": lineage, "breakdown": bd, "hw_check": hw,
                 "guard_pages": guard}
    kernels = [{
        "name": "groupnorm_glu", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": max(k1_err, k1_train_err, k1_damsm_err,
                           k1_shape_err, k1_eval_err, feed["errs"]["K1"],
                           orbax["errs"]["K1"]),
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "bytes", "library_ms": k1["library_ms"],
        "regimes": k1["regimes"], "ms_10_per_graph": k1["ms_10_per_graph"],
        "library_ms_10_per_graph": k1["library_ms_10_per_graph"],
        # K1 runs on five paths: the keys above are per served batch (the
        # error the largest of the paths'), "train" per Stage-C train step,
        # "damsm" per DAMSM step, "shape" per Stage-B step, "eval" per eval
        # batch (launches: the whole eval run); "feed" is the Stage-C run
        # on --wire --grain batches (2 steps); the library time takes two
        # calls (F.group_norm, F.glu) for a GN+GLU
        "feed": {"launches": feed["launches"]["K1"],
                 "max_abs_err": feed["errs"]["K1"]},
        "ddp": {"launches": ddp["launches"]["K1"],
                "max_abs_err": ddp["errs"]["K1"]},
        "orbax": {"launches": orbax["launches"]["K1"],
                  "max_abs_err": orbax["errs"]["K1"]},
        # launches: counted by the wrappers in phase multi_step's gan_main
        # run (the eager execution, the capture, the tail); graph_nodes: K1
        # nodes in each trainer's graph of MULTI_K steps
        "multi_step": {"launches": multi["launches"]["K1"],
                       "graph_nodes": {s: r["nodes"]["K1"] for s, r in
                                       multi["stages"].items()}},
        **{path: {"launches": r["launches"]["K1"]}
           for path, r in new_paths.items()},
        **{path: {"launches": launched, "max_abs_err": err, "ms": r["ms"],
                  "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                  "library_ms": r["library_ms"], "regimes": r["regimes"],
                  "ms_10_per_graph": r["ms_10_per_graph"],
                  "library_ms_10_per_graph": r["library_ms_10_per_graph"]}
           for path, launched, err, r in (
               ("train", train["k1"], k1_train_err, k1_train),
               ("damsm", damsm_k1_launches, k1_damsm_err, k1_damsm),
               ("shape", shape["k1"], k1_shape_err, k1_shape),
               ("eval", eval_launches, k1_eval_err, k1_eval))},
    }]
    kernels.append({
        "name": "groupnorm_bwd", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1B_REPLACES,
        # per Stage-C train step (the 90 calls of one step replayed): dx's
        # largest error, dscale's and dbias's over their magnitude; ms one
        # call per graph; plain_ms the twin's VJP (fp32); library_ms aten's
        # native_group_norm_backward on the library_calls calls without
        # GLU (GLU has no library backward)
        "launches": train["k1 backward"], "max_abs_err": max(
            k1b_err, feed["errs"]["K1 backward"],
            orbax["errs"]["K1 backward"]),
        "param_err": k1b_param_err, "dx_ulps": k1b["dx_ulps"],
        "ms": k1b["ms"],
        "plain_ms": k1b["plain_ms"], "bound_ms": k1b["bound_ms"],
        "bound_by": "bytes", "library_ms": k1b["library_ms"],
        "library_calls": k1b["library_calls"], "kernels": k1b["kernels"],
        "regimes": k1b["regimes"], "ms_10_per_graph": k1b["ms_10_per_graph"],
        "all_in_one_graph_ms": k1b["all_in_one_graph_ms"],
        "damsm": {"launches": damsm_k1b_launches},
        "shape": {"launches": shape["k1b"]},
        "feed": {"launches": feed["launches"]["K1 backward"],
                 "max_abs_err": feed["errs"]["K1 backward"]},
        "ddp": {"launches": ddp["launches"]["K1 backward"]},
        "orbax": {"launches": orbax["launches"]["K1 backward"],
                  "max_abs_err": orbax["errs"]["K1 backward"]},
        "multi_step": {"launches": multi["launches"]["K1 backward"],
                       "graph_nodes": {s: r["nodes"]["K1 backward"] for s, r
                                       in multi["stages"].items()}},
        **{path: {"launches": r["launches"].get("K1 backward", 0)}
           for path, r in new_paths.items()},
    })
    for name, replaces, key in (("roi_align_fwd", K2_REPLACES, "K2"),
                                ("roi_align_bwd", K3_REPLACES, "K3")):
        r = roi[key]
        kernels.append({
            "name": name, "route": "cuda", "source": ROI_SOURCE,
            "replaces": replaces,
            "launches": train["k2" if key == "K2" else "k3"],
            "max_abs_err": max(r["max_abs_err"], feed["errs"][key],
                               orbax["errs"][key]),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "ms_10_per_graph": r["ms_10_per_graph"],
            "feed": {"launches": feed["launches"][key],
                     "max_abs_err": feed["errs"][key]},
            "ddp": {"launches": ddp["launches"][key],
                    "max_abs_err": ddp["errs"][key]},
            "orbax": {"launches": orbax["launches"][key],
                      "max_abs_err": orbax["errs"][key]},
            "multi_step": {"launches": multi["launches"][key],
                           "graph_nodes": multi["stages"]["gan"]["nodes"][
                               key]},
            **{path: {"launches": r["launches"][key]}
               for path, r in new_paths.items()},
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--entry"]:
        sys.exit(_ddp_entry(sys.argv[2:]))
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
