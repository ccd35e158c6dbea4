"""The port's kernels with every input ending at an unmapped page, so that a
read past the end of an input faults instead of passing.

    python -m objgan_tpu_torch.tools.guard_pages            # the checks
    python -m objgan_tpu_torch.tools.guard_pages --control  # must fault

``checked()`` runs both, each in a process of its own, and holds them to
what they must show; ``chip_smoke.py`` and the card test call it.

Compute Sanitizer does not run on the card's host ("Device not
supported"), and the caching allocator packs tensors, so a kernel that
reads a little past its input reads mapped memory and passes its tests.
Here each input is copied into memory of its own, placed through the CUDA
driver's virtual memory API (``libcuda.so.1`` through ctypes): a range is
reserved (``cuMemAddressReserve``) one allocation granule (2 MiB on an
H100) larger than the input rounded up to granules, only the leading
granules are backed and mapped (``cuMemCreate``, ``cuMemMap``,
``cuMemSetAccess``), and the input's last byte is the last mapped byte.
The granule after it is reserved and unmapped, so any access there is an
illegal address. (An input's start is then aligned as its byte count is:
where that is not 16 bytes, the wrappers take their scalar plans, as they
would for any such tensor.)

Each check runs one wrapper on guarded inputs and holds the result against
its plain PyTorch twin by the rules of ``ops/twin_rules.py``: K1
(``group_norm_cuda``) at the streaming and resident plans on both sides
of ``ops/groupnorm.py::_plan``'s threshold, the ring, the cluster sizes
and the scalar path, and K1 backward (``group_norm_backward_cuda``, its
cotangent guarded too) at the same shapes against the twin's VJP in fp64;
K2 and K3 (``roi_align_cuda``, ``roi_align_backward_cuda``) at the train
step's shape, the scalar path and other sampling ratios, and on
``twin_rules.adversarial_boxes``. One line per check (its name printed
before the launch, so a fault names it), then the launches and "guard
pages: N checks PASS". An illegal address poisons the process's CUDA
context: run this in a process of its own, as ``checked`` does.
``--control`` reads one element past the end of a guarded tensor with a
plain PyTorch op, which must fault (exit code nonzero): the check's own
witness that the guard works.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from typing import List

import torch

from objgan_tpu_torch.ops import twin_rules

# CUDA driver enums (cuda.h)
_ALLOC_PINNED, _LOC_DEVICE, _GRANULARITY_MIN, _PROT_RW = 1, 1, 0, 3


class _Location(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]


class _AllocFlags(ctypes.Structure):
    _fields_ = [("compressionType", ctypes.c_ubyte),
                ("gpuDirectRDMACapable", ctypes.c_ubyte),
                ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _AllocProp(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("requestedHandleTypes", ctypes.c_int),
                ("location", _Location), ("win32HandleMetaData",
                                          ctypes.c_void_p),
                ("allocFlags", _AllocFlags)]


class _AccessDesc(ctypes.Structure):
    _fields_ = [("location", _Location), ("flags", ctypes.c_int)]


_P = ctypes.POINTER
_ULL, _SIZE = ctypes.c_ulonglong, ctypes.c_size_t
# (argument types) of the driver calls used here; each returns a CUresult
_SIGNATURES = {
    "cuMemGetAllocationGranularity": (_P(_SIZE), _P(_AllocProp),
                                      ctypes.c_int),
    "cuMemAddressReserve": (_P(_ULL), _SIZE, _SIZE, _ULL, _ULL),
    "cuMemCreate": (_P(_ULL), _SIZE, _P(_AllocProp), _ULL),
    "cuMemMap": (_ULL, _SIZE, _SIZE, _ULL, _ULL),
    "cuMemSetAccess": (_ULL, _SIZE, _P(_AccessDesc), _SIZE),
    "cuMemUnmap": (_ULL, _SIZE),
    "cuMemRelease": (_ULL,),
    "cuMemAddressFree": (_ULL, _SIZE),
    "cuGetErrorString": (ctypes.c_int, _P(ctypes.c_char_p)),
}


class _Interface:
    """A raw device range as ``__cuda_array_interface__`` (uint8), for
    ``torch.as_tensor``."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 3, "strides": None, "stream": None}


class GuardedArena:
    """Guarded copies of tensors on one card; ``close()`` (after a
    synchronize, with the copies no longer used) unmaps and frees them."""

    def __init__(self, device=None):
        self.device = torch.device(device or "cuda")
        torch.zeros(1, device=self.device)  # a current primary context
        self.cu = ctypes.CDLL("libcuda.so.1")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.cu, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        self.prop = _AllocProp()
        self.prop.type = _ALLOC_PINNED
        self.prop.location = _Location(_LOC_DEVICE,
                                       self.device.index or 0)
        gran = ctypes.c_size_t()
        self._call("cuMemGetAllocationGranularity", ctypes.byref(gran),
                   ctypes.byref(self.prop), _GRANULARITY_MIN)
        self.granule = gran.value
        self._ranges = []

    def _call(self, name: str, *args) -> None:
        err = getattr(self.cu, name)(*args)
        if err:
            msg = ctypes.c_char_p()
            self.cu.cuGetErrorString(err, ctypes.byref(msg))
            raise RuntimeError(f"{name} failed: {err} "
                               f"({(msg.value or b'?').decode()})")

    def raw(self, nbytes: int) -> int:
        """The address of ``nbytes`` whose last byte is followed by an
        unmapped granule."""
        mapped = -(-max(nbytes, 1) // self.granule) * self.granule
        base, handle = _ULL(), _ULL()
        self._call("cuMemAddressReserve", ctypes.byref(base),
                   mapped + self.granule, 0, 0, 0)
        self._call("cuMemCreate", ctypes.byref(handle), mapped,
                   ctypes.byref(self.prop), 0)
        self._call("cuMemMap", base, mapped, 0, handle, 0)
        access = _AccessDesc(self.prop.location, _PROT_RW)
        self._call("cuMemSetAccess", base, mapped, ctypes.byref(access), 1)
        self._ranges.append((base.value, mapped, handle.value))
        return base.value + mapped - nbytes

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``t`` on the card whose last byte is the last
        mapped byte."""
        t = t.contiguous()
        nbytes = t.numel() * t.element_size()
        raw = torch.as_tensor(_Interface(self.raw(nbytes), nbytes),
                              device=self.device)
        out = raw.view(t.dtype).view(t.shape)
        out.copy_(t)
        return out

    def close(self) -> None:
        for base, mapped, handle in self._ranges:
            self._call("cuMemUnmap", base, mapped)
            self._call("cuMemRelease", handle)
            self._call("cuMemAddressFree", base, mapped + self.granule)
        self._ranges = []


# (B, N, C, dtype, use_glu): tests/test_torch_cuda.py's PLAN_SHAPES (the
# resident/streaming threshold for the bf16 vector, fp32 vector and fp32
# scalar paths, each cluster size, the ring) and two of its SHAPES (the
# DAMSM step's largest call; the bf16 scalar path)
K1_SHAPES = [
    (2, 9924, 64, torch.bfloat16, True),
    (2, 9925, 64, torch.bfloat16, True),
    (2, 3408, 96, torch.float32, False),
    (2, 3409, 96, torch.float32, False),
    (1, 57216, 6, torch.float32, False),
    (1, 57217, 6, torch.float32, False),
    (2, 64, 256, torch.bfloat16, False),
    (2, 128, 256, torch.bfloat16, False),
    (2, 512, 256, torch.bfloat16, False),
    (2, 1024, 256, torch.bfloat16, False),
    (2, 2048, 256, torch.bfloat16, False),
    (160, 4096, 64, torch.float32, False),
    (2, 65536, 64, torch.bfloat16, True),
    (48, 16384, 32, torch.float32, False),
    (2, 100, 12, torch.bfloat16, True),
    (3, 37, 6, torch.float32, False),
]
# (B, H, W, C, O, R, dtype, q): tests/test_torch_cuda.py's ROI_SHAPES
ROI_SHAPES = [
    (16, 32, 32, 256, 10, 7, torch.bfloat16, 2),
    (16, 32, 32, 256, 10, 7, torch.float32, 2),
    (2, 8, 8, 32, 3, 4, torch.float32, 2),
    (3, 9, 7, 5, 4, 3, torch.float32, 2),
    (2, 8, 8, 12, 3, 4, torch.bfloat16, 2),
    (3, 9, 7, 5, 4, 3, torch.float32, 3),
    (2, 16, 16, 64, 5, 7, torch.bfloat16, 1),
]

# (C, dtype) of the features K2 and K3 take on twin_rules.adversarial_boxes
ADVERSARIAL = [(256, torch.bfloat16), (64, torch.float32),
               (12, torch.bfloat16)]
# each check launches its kernel once
LAUNCHES = {"K1": len(K1_SHAPES), "K2": len(ROI_SHAPES) + len(ADVERSARIAL),
            "K3": len(ROI_SHAPES) + len(ADVERSARIAL),
            "K1 backward": len(K1_SHAPES)}
_TIMEOUT_S = 600


def _grads_close(got, want, dtype, use_glu):
    """(largest error, all within) of (dx, dscale, dbias) by
    ``twin_rules.k1_grad``."""
    closes = [twin_rules.k1_grad(name, g, w, dtype, use_glu)
              for name, g, w in zip(("dx", "dscale", "dbias"), got, want)]
    return max(e for e, _ in closes), all(ok for _, ok in closes)


def _roi_inputs(b, h, w, c, o, dtype, gen, dev):
    f = torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
    xy = torch.rand(b, o, 2, generator=gen, device=dev) * 0.7
    wh = torch.rand(b, o, 2, generator=gen, device=dev) * 0.2 + 0.1
    boxes = torch.cat([xy, wh], -1)
    boxes[:, -1] = 0.0  # a padded (all-zero) box in every image
    boxes[0, 0] = torch.tensor([0.0, 0.0, 1.0, 1.0])  # the full frame
    return f, boxes


def run_checks(device="cuda", out=print) -> List[dict]:
    """Every check once; returns one record per check (name, plan, error,
    ok). Raises on a kernel fault (an illegal address)."""
    from objgan_tpu_torch.ops import groupnorm as gnm
    from objgan_tpu_torch.ops import roi_align as ra

    dev = torch.device(device)
    arena = GuardedArena(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    records = []

    def report(name, plan, close):
        err, ok = close
        records.append({"name": name, "plan": plan, "err": err, "ok": ok})
        out(f"{'PASS' if ok else 'FAIL'} {name}: {plan}, max err {err:.3g}",
            flush=True)

    try:
        for b, n, c, dtype, glu in K1_SHAPES:
            x = (torch.randn(b, n, c, generator=gen, device=dev) * 1.5
                 + 0.3).to(dtype)
            scale = torch.rand(c, generator=gen, device=dev) + 0.5
            bias = torch.randn(c, generator=gen, device=dev) * 0.2
            gx, gs, gb = (arena.copy(v) for v in (x, scale, bias))
            groups = 32 if c % 32 == 0 else 2 if c % 2 == 0 else 1
            plan = gnm.plan_for(gx, glu)
            name = f"K1 ({b}, {n}, {c}) {str(dtype)[6:]} glu={glu}"
            out(f"run  {name}", flush=True)
            got = gnm.group_norm_cuda(gx, gs, gb, groups, 1e-6, glu)
            torch.cuda.synchronize(dev)
            want = twin_rules.k1_twin(x, scale, bias, groups, 1e-6, glu)
            report(name, f"{plan.regime} cluster {plan.cluster} vec "
                   f"{plan.vec}", twin_rules.k1(got, want, dtype))
            gy = torch.randn(got.shape, generator=gen, device=dev).to(dtype)
            ggy = arena.copy(gy)
            bplan = gnm.bwd_plan_for(gx, ggy, glu, (True, True, True))
            out(f"run  {name} backward", flush=True)
            grads = gnm.group_norm_backward_cuda(gx, gs, gb, groups, 1e-6,
                                                 glu, ggy)
            torch.cuda.synchronize(dev)
            wants = gnm.group_norm_backward_reference(
                x.double(), scale.double(), bias.double(), groups, 1e-6, glu,
                gy.double())
            report(f"{name} backward", f"{bplan.regime} cluster "
                   f"{bplan.cluster} vec {bplan.vec}",
                   _grads_close(grads, wants, dtype, glu))
        cases = [(_roi_inputs(b, h, w, c, o, dtype, gen, dev), r, dtype, q)
                 for b, h, w, c, o, r, dtype, q in ROI_SHAPES]
        adversarial = twin_rules.adversarial_boxes(dev)
        for c, dtype in ADVERSARIAL:
            f = torch.randn(len(adversarial), 32, 32, c, generator=gen,
                            device=dev).to(dtype)
            cases.append(((f, adversarial), 7, dtype, 2))
        for (f, boxes), r, dtype, q in cases:
            gf, gboxes = arena.copy(f), arena.copy(boxes)
            shape = f"{tuple(f.shape)} O {boxes.shape[1]} R {r} q {q} " \
                    f"{str(dtype)[6:]}"
            out(f"run  K2 {shape}", flush=True)
            got = ra.roi_align_cuda(gf, gboxes, r, q)
            torch.cuda.synchronize(dev)
            want = ra.roi_align_reference(f, boxes, r, q)
            report(f"K2 {shape}", "forward",
                   twin_rules.roi(got, want, dtype))
            g = torch.randn(got.shape, generator=gen, device=dev).to(dtype)
            gg = arena.copy(g)
            out(f"run  K3 {shape}", flush=True)
            dfg = ra.roi_align_backward_cuda(gboxes, gg, f.shape, r, q)
            torch.cuda.synchronize(dev)
            dfw = ra.roi_align_backward_reference(boxes, g, f.shape, dtype,
                                                  r, q)
            report(f"K3 {shape}", "backward",
                   twin_rules.roi(dfg, dfw, dtype))
    finally:
        torch.cuda.synchronize(dev)
        arena.close()
    return records


def control(device="cuda") -> None:
    """Reads one element past the end of a guarded tensor: must fault."""
    arena = GuardedArena(device)
    t = arena.copy(torch.ones(1000, device=device))
    past = torch.as_tensor(_Interface(t.data_ptr(), t.numel() * 4 + 4),
                           device=t.device).view(torch.float32)
    print(f"control: summing {past.numel()} floats of a guarded "
          f"{t.numel()}-float tensor", flush=True)
    print(f"control: sum {float(past.sum())} (no fault: the guard failed)",
          flush=True)


def checked() -> dict:
    """The checks, then the control, each in a process of its own. Raises
    RuntimeError unless every check passed, K1 ran both its plans, each
    check launched its kernel once (``LAUNCHES``) and the control died of
    an illegal address. Returns {"checks": PASS lines, "regimes": K1's
    plans, "launches", "seconds", "control_seconds"}."""
    import os
    import re
    import subprocess
    import time

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cmd = [sys.executable, "-m", "objgan_tpu_torch.tools.guard_pages"]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=_TIMEOUT_S)
    secs = time.monotonic() - t0
    lines = proc.stdout.splitlines()
    tail = f"\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
    if proc.returncode != 0 or not lines or not lines[-1].endswith("PASS"):
        ran = [ln for ln in lines if ln.startswith("run ")]
        raise RuntimeError(f"guard_pages exited {proc.returncode} (last "
                           f"launched: {ran[-1:]}):{tail}")
    checks = [ln for ln in lines if ln.startswith("PASS")]
    regimes = sorted({ln.split(": ", 1)[1].split(" cluster")[0]
                      for ln in checks if ln.startswith("PASS K1")})
    found = re.search(r"launches: K1 (\d+), K2 (\d+), K3 (\d+), K1 "
                      r"backward (\d+)", proc.stdout)
    launches = found and dict(zip(LAUNCHES, map(int, found.groups())))
    if regimes != ["resident", "streaming"] or launches != LAUNCHES:
        raise RuntimeError(f"guard_pages ran K1's plans {regimes} and "
                           f"launched {launches}, not {LAUNCHES}:{tail}")
    t0 = time.monotonic()
    control = subprocess.run(cmd + ["--control"], cwd=root,
                             capture_output=True, text=True,
                             timeout=_TIMEOUT_S)
    if control.returncode == 0 or "illegal memory access" not in \
            control.stderr:
        raise RuntimeError(f"the control read past a guarded tensor "
                           f"without a fault (exit {control.returncode}):\n"
                           f"{control.stdout[-500:]}\n"
                           f"{control.stderr[-1000:]}")
    return {"checks": checks, "regimes": regimes, "launches": launches,
            "seconds": secs, "control_seconds": time.monotonic() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The kernels with every input ending at an unmapped "
                    "page.")
    ap.add_argument("--control", action="store_true",
                    help="read past a guarded tensor's end (must fault)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("guard_pages: no CUDA device", file=sys.stderr)
        return 2
    if args.control:
        control()
        return 0
    from objgan_tpu_torch.ops import groupnorm, roi_align

    records = run_checks()
    bad = [r["name"] for r in records if not r["ok"]]
    print(f"launches: K1 {groupnorm.launches}, K2 "
          f"{roi_align.launches['fwd']}, K3 {roi_align.launches['bwd']}, "
          f"K1 backward {groupnorm.bwd_launches}")
    print(f"guard pages: {len(records)} checks "
          f"{'PASS' if not bad else 'FAIL ' + ', '.join(bad)}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
