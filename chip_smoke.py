#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (objgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths with fresh weights from ``RNG_SEED``:
serving at the full width of ``cfg/eval_coco.yml`` (batch 16, bf16 Stage C,
64 -> 128 -> 256 px) and the Stage-C train step at the full width of
``cfg/coco_objgan.yml`` (batch 16, bf16 G and D, DF_DIM 64, 10 objects,
ROI 7), and checks every hand-written kernel on them:

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
                phase 3;
9. roi          every K2/K3 call of that step replayed through the
                kernels (twice, held bitwise equal), their twins and,
                where torchvision is installed, ``torchvision.ops.
                roi_align``, with the recorded boxes and with padded boxes
                zeroed (K3 with the cotangent scaled to unit RMS); per call
                the launch plan, the kernels that one call launches (one
                kernel node in a CUDA graph) and, modelled from the plan
                on the host, the bytes its loads would request beside the
                unique bytes the bound counts;
10. small_train one tiny fp32 train step on the GPU (K1 Function, K2, K3)
                against the same weights, batch and noise on the CPU
                (twins): metrics and every parameter's gradient.

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
import copy
import json
import math
import os
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
ROI_SOURCE = "objgan_tpu_torch/csrc/roi_align.cu"
K2_REPLACES = "objgan_tpu/ops/roi_align.py:107"
K3_REPLACES = "objgan_tpu/ops/roi_align.py:132"
FP32_ATOL = 1e-4
BF16_ATOL, BF16_RTOL = 3e-2, 2e-2
# K2/K3 in bf16: fp32 sums in another order, one rounding to bf16 (a step
# of at most 2^-8 relative) on both sides
ROI_BF16_ATOL, ROI_BF16_RTOL = 1e-2, 1e-2
TRAIN_STEPS = 6
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
    ``fn``, counted with libcuda's cuGraphGetNodes and cuGraphNodeGetType."""
    import ctypes

    import torch

    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw, count = graph.raw_cuda_graph(), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0,
          "cuGraphGetNodes failed")
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        kinds.append(kind.value)
    graph.reset()
    return kinds.count(0), len(kinds)  # 0: CU_GRAPH_NODE_TYPE_KERNEL


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

    from objgan_tpu_torch.ops import groupnorm
    from objgan_tpu_torch.ops.groupnorm import (group_norm_cuda,
                                                group_norm_reference,
                                                plan_for)

    log(phase, f"recorded {len(records)} K1 calls of one {per}; tolerance "
        f"fp32 atol {FP32_ATOL}, bf16 atol {BF16_ATOL} rtol {BF16_RTOL}; "
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
        got = got.float()
        want = group_norm_reference(x3, *args).float()
        err = (got - want).abs()
        e = float(err.max())
        max_err = max(max_err, e)
        key = (tuple(x3.shape), str(x3.dtype).replace("torch.", ""),
               mod.num_groups, mod.use_glu)
        if x3.dtype == torch.float32:
            check(e <= FP32_ATOL, f"K1 vs twin {key}: max err {e:.3g}")
            ulps = float("nan")
        else:
            bad = err > BF16_ATOL + BF16_RTOL * want.abs()
            check(not bool(bad.any()), f"K1 vs twin {key}: "
                  f"{int(bad.sum())} elements beyond tolerance")
            ulps = float((err / bf16_ulp(want)).max())
        entry = shapes.setdefault(key, {"count": 0, "err": 0.0, "ulps": 0.0,
                                        "x": x3, "args": args})
        entry["count"] += 1
        entry["err"] = max(entry["err"], e)
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
            f"{s['err']:.3g} ({s['ulps']:.2f} bf16 ulp) | device, one call "
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


def _counts():
    from objgan_tpu_torch.ops import groupnorm, roi_align

    return (groupnorm.launches, roi_align.launches["fwd"],
            roi_align.launches["bwd"])


def _reset_counts():
    from objgan_tpu_torch.ops import groupnorm, roi_align

    groupnorm.launches = 0
    roi_align.launches.update(fwd=0, bwd=0)


def _nets(trainer):
    return {"G": trainer.g_net, "objD": trainer.obj_d,
            **{f"D{i}": d for i, d in enumerate(trainer.d_nets)}}


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
        k1, k2, k3 = _counts()
        wall_s = time.monotonic() - t0
    finally:
        hook.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    # train_gan's metric lines: "[step N] name=value ... steps_per_sec=v"
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("[step ")]
    check(len(lines) == TRAIN_STEPS, f"{len(lines)} metric lines for "
          f"{TRAIN_STEPS} steps")
    seen = [{k: float(v) for k, v in (kv.split("=") for kv in
                                      ln.split("] ", 1)[1].split())}
            for ln in lines]
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
        f"({objd_calls} ObjectDNet calls)")
    log("train", "synchronised ms per step (train_gan's steps_per_sec): "
        + ", ".join(f"{t:.1f}" for t in times) + f"; median after the first "
        f"{median:.1f} ms ({cfg.TRAIN.BATCH_SIZE * 1000.0 / median:.1f} "
        f"img/s); peak memory allocated {peak_gb:.2f} GiB")
    log("train", "last step: " + ", ".join(
        f"{k} {seen[-1][k]:.4g}" for k in ("d_loss", "g_loss", "objd_real",
                                           "objd_fake", "objd_cls", "g_obj",
                                           "damsm", "kl")))
    return trainer, {"k1": k1, "k2": k2, "k3": k3, "ms": median,
                     "k1_per_step": k1 // TRAIN_STEPS}


def _device_profile(fn):
    """(wall ms, device-busy ms, [(start us, end us, kernel name)]) of one
    call of ``fn`` under torch.profiler; busy is the union of the device
    intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1000.0 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and "#" not in e.name)
    check(bool(spans), "the profiler saw no device activity")
    busy_us, end = 0.0, float("-inf")
    for a, b, _ in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    return wall_ms, busy_us / 1000.0, spans


def phase_train_profile(cfg, trainer):
    """One steady train step under torch.profiler: how busy the device is
    and which kernels take its time (the profiler's own overhead is in the
    wall time, so the busy share is a lower bound). Then every GroupNorm
    backward of one step (the twin's VJP, which has no kernel yet) is
    replayed alone under the profiler."""
    import collections
    import re

    import torch

    from objgan_tpu_torch.data.synthetic import synthetic_batch
    from objgan_tpu_torch.ops import groupnorm
    from objgan_tpu_torch.train.gan import train_noise

    gen = torch.Generator("cuda").manual_seed(9)
    batch = synthetic_batch(cfg, gen)
    noise = train_noise(cfg, cfg.TRAIN.BATCH_SIZE, gen, "cuda")

    def step():
        trainer.train_step(batch, noise["z"], noise["ca_eps"])

    wall_ms, busy_ms, spans = _device_profile(step)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    groups = collections.defaultdict(float)
    roi = {"K2": [0.0, 0], "K3": [0.0, 0]}
    for a, b, name in spans:
        ms = (b - a) / 1000.0
        by_name[name][0] += ms
        by_name[name][1] += 1
        group = ("K1 GroupNorm" if re.search(
                     "gn_fused_kernel", name) else
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

    gn_bwd = groupnorm.group_norm_backward_reference
    calls = []

    def recording(*args, **kwargs):
        calls.append((args, kwargs))
        return gn_bwd(*args, **kwargs)

    groupnorm.group_norm_backward_reference = recording
    try:
        step()
        torch.cuda.synchronize()
    finally:
        groupnorm.group_norm_backward_reference = gn_bwd

    def replay():
        for args, kwargs in calls:
            gn_bwd(*args, **kwargs)

    replay()  # warm-up
    r_wall, r_busy, r_spans = _device_profile(replay)
    log("profile", f"GroupNorm backward (the twin's VJP, statistics "
        f"recomputed) of one step replayed alone: {len(calls)} calls, "
        f"{len(r_spans)} device activities, device busy {r_busy:.1f} ms "
        f"({r_busy / busy_ms:.2f} of the step's), wall {r_wall:.1f} ms "
        f"under the profiler")


def _roi_work(boxes, f_shape, out_size, q):
    """(touched feature pixels, multiply-add terms) of one ROI-align call:
    the pixels some sample weighs, and sum over (b, o) of
    nnz(A_y) * nnz(A_x), each term one multiply-add per channel."""
    from objgan_tpu_torch.ops.roi_align import _pool_matrices

    _, h, w, _ = f_shape
    a_y, a_x = _pool_matrices(boxes, h, w, out_size, q)
    rows, cols = (a_y != 0).any(-2), (a_x != 0).any(-2)  # (B, O, H|W)
    touched = (rows[..., :, None] & cols[..., None, :]).any(1).sum()
    terms = ((a_y != 0).sum((-1, -2)) * (a_x != 0).sum((-1, -2))).sum()
    return int(touched), int(terms)


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


def _record_train_step(cfg, trainer):
    """One full-width train step with every kernel call's input copied:
    (K1 records as ``_record_gn`` makes them, K2 calls, K3 calls, the
    batch's padded-object mask)."""
    import torch

    from objgan_tpu_torch.data.synthetic import synthetic_batch
    from objgan_tpu_torch.ops import roi_align as ra
    from objgan_tpu_torch.train.gan import train_noise

    fwd, bwd = [], []
    orig = ra.roi_align_cuda, ra.roi_align_backward_cuda

    def rec_fwd(features, boxes, out_size, q):
        fwd.append((features.detach().clone(), boxes.clone(), out_size, q))
        return orig[0](features, boxes, out_size, q)

    def rec_bwd(boxes, g, f_shape, out_size, q):
        bwd.append((boxes.clone(), g.detach().clone(), f_shape, out_size, q))
        return orig[1](boxes, g, f_shape, out_size, q)

    gen = torch.Generator("cuda").manual_seed(7)
    batch = synthetic_batch(cfg, gen)
    noise = train_noise(cfg, cfg.TRAIN.BATCH_SIZE, gen, "cuda")
    gn, hooks = _record_gn(trainer)
    ra.roi_align_cuda, ra.roi_align_backward_cuda = rec_fwd, rec_bwd
    try:
        trainer.train_step(batch, noise["z"], noise["ca_eps"])
        torch.cuda.synchronize()
    finally:
        ra.roi_align_cuda, ra.roi_align_backward_cuda = orig
        for h in hooks:
            h.remove()
    return gn, fwd, bwd, batch["obj_valid"] == 0


def phase_roi(fwd, bwd, pad):
    """Every K2/K3 call of one train step against the twins, timed."""
    import torch

    from objgan_tpu_torch.ops import roi_align as ra

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
                # the step's cotangent is ~1e-4, far below the bf16 atol:
                # replay it scaled to unit RMS so the tolerance is small
                # against what is compared
                g = (g.float() / g.float().square().mean().sqrt()).to(dt)

                def kernel(bx, g=g, f_shape=f_shape, r=r, q=q):
                    return ra.roi_align_backward_cuda(bx, g, f_shape, r, q)

                def twin(bx, g=g, f_shape=f_shape, r=r, q=q):
                    return ra.roi_align_backward_reference(bx, g, f_shape,
                                                           g.dtype, r, q)
            for bx in (boxes, zeroed(boxes)):
                got, want = kernel(bx).float(), twin(bx).float()
                err = (got - want).abs()
                max_err = max(max_err, float(err.max()))
                if dt == torch.float32:
                    check(float(err.max()) <= FP32_ATOL,
                          f"{name} vs twin: max err {float(err.max()):.3g}")
                else:
                    over = err > ROI_BF16_ATOL + ROI_BF16_RTOL * want.abs()
                    check(not bool(over.any()), f"{name} vs twin: "
                          f"{int(over.sum())} elements beyond tolerance")
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
            touched, terms = _roi_work(boxes, f_shape, r, q)
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
        tol = (f"bf16 atol {ROI_BF16_ATOL} rtol {ROI_BF16_RTOL}"
               if dt == torch.bfloat16 else f"fp32 atol {FP32_ATOL}")
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


def phase_small_train():
    """A tiny fp32 train step, GPU (kernels) against CPU (twins)."""
    import torch

    from objgan_tpu_torch.core.config import tiny_test_config
    from objgan_tpu_torch.data.synthetic import synthetic_batch
    from objgan_tpu_torch.train.gan import GanTrainer, train_noise

    cfg = tiny_test_config().merged({"DTYPE": "float32"})
    cpu = GanTrainer(cfg).init_state(torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    batch = synthetic_batch(cfg, torch.Generator().manual_seed(1))
    noise = train_noise(cfg, cfg.TRAIN.BATCH_SIZE,
                        torch.Generator().manual_seed(2), "cpu")
    want_g, want_m = cpu.grads(batch, noise["z"], noise["ca_eps"])
    before = _counts()
    cuda = {k: ([x.cuda() for x in v] if isinstance(v, list) else v.cuda())
            for k, v in batch.items()}
    got_g, got_m = gpu.grads(cuda, noise["z"].cuda(), noise["ca_eps"].cuda())
    torch.cuda.synchronize()
    rose = [a - b for a, b in zip(_counts(), before)]
    check(all(n > 0 for n in rose), f"K1/K2/K3 launches on the GPU: {rose}")
    m_err = max(abs(float(got_m[k]) - float(v)) / max(abs(float(v)), 1e-6)
                for k, v in want_m.items())
    check(m_err <= 1e-4, f"metrics differ by {m_err:.3g} relative")
    g_err, worst = 0.0, ""
    for k, w in want_g.items():
        e = float((got_g[k].cpu() - w).norm() / w.norm().clamp(min=1e-12))
        if e > g_err:
            g_err, worst = e, k
    check(g_err <= 1e-3, f"gradient of {worst} differs by {g_err:.3g}")
    log("small_train", f"tiny fp32 train step, GPU (K1 {rose[0]}, K2 "
        f"{rose[1]}, K3 {rose[2]} launches) vs CPU (twins), same weights, "
        f"batch and noise: {len(want_m)} metrics within {m_err:.3g} "
        f"relative (rtol 1e-4); {len(want_g)} parameter gradients within "
        f"{g_err:.3g} relative norm (worst {worst}; limit 1e-3)")


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
    train_cfg = cfg_from_file(os.path.join(ROOT, "cfg", "coco_objgan.yml"))
    trainer, train = phase_train(train_cfg)
    phase_train_profile(train_cfg, trainer)
    gn_calls, fwd, bwd, pad = _record_train_step(train_cfg, trainer)
    del trainer
    check(len(gn_calls) == train["k1_per_step"],
          f"one step made {len(gn_calls)} K1 calls, train_gan "
          f"{train['k1_per_step']} per step")
    with torch.no_grad():
        k1_train_err, k1_train = _check_k1("train_k1", gn_calls, "train step")
    del gn_calls
    roi = phase_roi(fwd, bwd, pad)
    del fwd, bwd
    torch.cuda.empty_cache()
    phase_small_train()
    kernels = [{
        "name": "groupnorm_glu", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": max(k1_err, k1_train_err), "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "bytes", "library_ms": k1["library_ms"],
        "regimes": k1["regimes"], "ms_10_per_graph": k1["ms_10_per_graph"],
        "library_ms_10_per_graph": k1["library_ms_10_per_graph"],
        # K1 runs on both paths: the keys above are per served batch (the
        # error the larger of both paths'), "train" per train step; the
        # library time takes two calls (F.group_norm, F.glu) for a GN+GLU
        "train": {"launches": train["k1"], "max_abs_err": k1_train_err,
                  "ms": k1_train["ms"], "plain_ms": k1_train["plain_ms"],
                  "bound_ms": k1_train["bound_ms"],
                  "library_ms": k1_train["library_ms"],
                  "regimes": k1_train["regimes"],
                  "ms_10_per_graph": k1_train["ms_10_per_graph"],
                  "library_ms_10_per_graph":
                      k1_train["library_ms_10_per_graph"]},
    }]
    for name, replaces, key in (("roi_align_fwd", K2_REPLACES, "K2"),
                                ("roi_align_bwd", K3_REPLACES, "K3")):
        r = roi[key]
        kernels.append({
            "name": name, "route": "cuda", "source": ROI_SOURCE,
            "replaces": replaces,
            "launches": train["k2" if key == "K2" else "k3"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "ms_10_per_graph": r["ms_10_per_graph"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
