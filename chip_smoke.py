#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (objgan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path at the full width of ``cfg/eval_coco.yml``
(batch 16, bf16 Stage C, 64 -> 128 -> 256 px) with fresh weights from
``RNG_SEED``, and checks every hand-written kernel on its path:

1. device   the card as ``nvidia-smi`` and torch name it;
2. build    K1 (``objgan_tpu_torch/csrc/groupnorm.cu``) compiled by nvcc;
3. serve    ``run_serve`` answers 35 captions (3 batches of 16, the last
            padded): 35 ordered responses with PNGs, finite images in
            [-1, 1], and K1's launch count rises by the number of GroupNorm
            layers per batch;
4. kernels  every K1 call of one batch recorded and replayed through the
            kernel and its plain PyTorch twin: agreement within the printed
            tolerance, and both timed with CUDA events (median of 20), as
            device time (CUDA-graph replay) and eager time;
5. stages   synchronised wall time of Stage A, B and C of one batch;
6. small    a tiny fp32 config end to end on the GPU against the same
            weights and noise on the CPU (the twin path).

Any failure exits non-zero. So does a host without a CUDA device, before
anything is printed to stdout. The last lines are the kernel summary JSON,
the card's ``name, power.limit`` from nvidia-smi, and
``{"ok": true, "device": {...}}``.
"""

import copy
import json
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
FP32_ATOL = 1e-4
BF16_ATOL, BF16_RTOL = 3e-2, 2e-2


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


def time_ms(fn, reps=20):
    """(device ms, eager ms): medians of ``reps`` CUDA-event timings of one
    call. Device time replays the call captured in a CUDA graph, so the
    host's launch overhead is out of it; eager time includes the host work
    the device waits for when it is otherwise idle."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    return _event_ms(graph.replay, reps), _event_ms(fn, reps)


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

    t0 = time.monotonic()
    path, compiler_log = _build.build("groupnorm", force=True)
    secs = time.monotonic() - t0
    log("build", f"K1 {K1_SOURCE} -> {os.path.relpath(path, ROOT)} in "
        f"{secs:.2f} s")
    for line in compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", "ptxas: " + line.strip())
    _build.load("groupnorm")


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


def phase_kernels(cfg, vocab, pipe):
    import torch

    from objgan_tpu_torch.models.common import FusedGroupNorm
    from objgan_tpu_torch.ops.groupnorm import (group_norm_cuda,
                                                group_norm_reference)
    from objgan_tpu_torch.pipeline_e2e import draw_noise

    torch.set_grad_enabled(False)
    records = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: records.append((mod, args[0].detach().clone())))
        for m in pipe.modules() if isinstance(m, FusedGroupNorm)]
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
    log("kernels", f"recorded {len(records)} K1 calls of one batch; "
        f"tolerance fp32 atol {FP32_ATOL}, bf16 atol {BF16_ATOL} rtol "
        f"{BF16_RTOL}")
    max_err = 0.0
    shapes = {}
    for mod, x in records:
        b, c = x.shape[0], x.shape[-1]
        x3 = x.reshape(b, -1, c).contiguous()
        args = (mod.weight, mod.bias, mod.num_groups, mod.eps, mod.use_glu)
        got = group_norm_cuda(x3, *args).float()
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
    ms = plain_ms = eager_ms = plain_eager_ms = 0.0
    for key, s in shapes.items():
        x3, args = s["x"], s["args"]
        k_ms, k_eager = time_ms(lambda: group_norm_cuda(x3, *args))
        p_ms, p_eager = time_ms(lambda: group_norm_reference(x3, *args))
        ms += s["count"] * k_ms
        plain_ms += s["count"] * p_ms
        eager_ms += s["count"] * k_eager
        plain_eager_ms += s["count"] * p_eager
        (b, nn_, c), dt, g, glu = key
        gbps = (2 * x3.numel() * x3.element_size()
                + x3.numel() * x3.element_size() // (2 if glu else 1)
                ) / (k_ms * 1e6)
        log("kernels", f"(B={b}, N={nn_}, C={c}) {dt} groups {g} "
            f"{'GN+GLU' if glu else 'GN'} x{s['count']}: max err "
            f"{s['err']:.3g} ({s['ulps']:.2f} bf16 ulp) | device K1 "
            f"{1000 * k_ms:.1f} us ({gbps:.0f} GB/s), twin "
            f"{1000 * p_ms:.1f} us | eager K1 {1000 * k_eager:.1f} us, "
            f"twin {1000 * p_eager:.1f} us")
    log("kernels", f"all {len(records)} calls agree; per batch, device: K1 "
        f"{ms:.3f} ms vs twin {plain_ms:.3f} ms; eager: K1 {eager_ms:.3f} "
        f"ms vs twin {plain_eager_ms:.3f} ms")
    return max_err, ms, plain_ms


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

    from objgan_tpu.core.config import tiny_test_config
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from objgan_tpu.core.config import cfg_from_file
    from objgan_tpu_torch.core.precision import true_fp32
    from objgan_tpu_torch.data.tokenizer import Vocab
    from objgan_tpu_torch.pipeline_e2e import ObjGanPipeline

    true_fp32()
    card, name = phase_device()
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
    max_err, ms, plain_ms = phase_kernels(cfg, vocab, pipe)
    phase_stages(cfg, vocab, pipe)
    phase_small()
    print(json.dumps({"kernels": [{
        "name": "groupnorm_glu",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
