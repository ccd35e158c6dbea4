"""Streaming batch inference over the composed pipeline (the backend of
``python -m objgan_tpu_torch.serve``). Port of ``objgan_tpu/serving.py``.

* Requests are packed into a fixed batch of ``batch_size``; the ragged tail
  is padded by repeating the last caption, and padded rows are dropped on
  output, so every batch has the same shapes.
* One-deep software pipeline: CUDA launches are asynchronous, so batch
  k+1's tokenization and launches are queued before batch k's results are
  fetched and its PNGs and JSON written; the device works on batch k+1
  while the host writes batch k.
* One ``torch.Generator`` seeded with ``cfg.RNG_SEED`` draws every batch's
  noise in order: results are reproducible for a fixed request order.

Request format (one per line): a JSON object ``{"id": ..., "caption":
"..."}`` or a bare caption (id = line number). Each response is
``{"id", "caption", "objects": [[label, [x, y, w, h]], ...], "image"}``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import torch


def parse_requests(lines: Iterable[str]) -> Iterator[Dict]:
    """Lazily parse a line stream into request dicts. JSON lines must carry
    a ``caption``; anything that does not parse as a JSON object is a bare
    caption. Blank lines are skipped."""
    for n, ln in enumerate(lines):
        ln = ln.strip()
        if not ln:
            continue
        req: Optional[Dict] = None
        if ln.startswith("{"):
            try:
                obj = json.loads(ln)
            except json.JSONDecodeError:
                obj = None
            if isinstance(obj, dict):
                if "caption" not in obj:
                    raise ValueError(
                        f"request line {n} is a JSON object without a "
                        f"'caption' key: {ln[:80]!r}")
                req = {"id": obj.get("id", n), "caption": str(obj["caption"])}
        if req is None:
            req = {"id": n, "caption": ln}
        yield req


def _batched(it: Iterator[Dict], n: int) -> Iterator[List[Dict]]:
    group: List[Dict] = []
    for item in it:
        group.append(item)
        if len(group) == n:
            yield group
            group = []
    if group:
        yield group


def run_serve(
    cfg,
    vocab,
    requests: Iterable[Dict],
    out_dir: str,
    batch_size: Optional[int] = None,
    emit: Optional[Callable[[Dict], None]] = None,
    save_images: bool = True,
    device="cuda",
    pipeline=None,
    output_dir: Optional[str] = None,
) -> Dict:
    """Drive the composed pipeline over a request stream; returns stats.

    ``emit`` receives one response dict per request, in request order.
    ``pipeline`` is an ``ObjGanPipeline`` on ``device``; without one, each
    stage is restored from its newest checkpoint under ``output_dir`` (by
    default ``cfg.OUTPUT_DIR``) by ``ObjGanPipeline.load_states``, and a
    stage without one runs with fresh weights from ``cfg.RNG_SEED``,
    loudly warned. In the stats, ``batch_done_s`` holds per batch the
    seconds from the start until its results were on the host, and
    ``emit_s`` the seconds the host then spent writing its PNGs and
    responses."""
    from objgan_tpu_torch.utils.visualize import _to_uint8, save_png
    from objgan_tpu_torch.core.precision import true_fp32
    from objgan_tpu_torch.pipeline_e2e import ObjGanPipeline, draw_noise

    b = int(batch_size or cfg.TRAIN.BATCH_SIZE)
    if b < 1:
        raise ValueError(f"batch_size must be >= 1, got {b}")
    if len(vocab) > cfg.TEXT.VOCAB_SIZE:
        raise ValueError(
            f"vocabulary has {len(vocab)} words but cfg.TEXT.VOCAB_SIZE is "
            f"{cfg.TEXT.VOCAB_SIZE} (the embedding would index past its "
            f"table)")
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    true_fp32()
    pipe = (pipeline if pipeline is not None
            else ObjGanPipeline.load_states(cfg, output_dir, device))
    gen = torch.Generator(device=device).manual_seed(cfg.RNG_SEED)

    def encode(group: List[Dict]):
        caps = [r["caption"] for r in group]
        # pad the ragged tail by repeating the last caption: every batch
        # keeps the shape (b, T); padded rows are not emitted below
        caps = caps + [caps[-1]] * (b - len(caps))
        ids, lens = vocab.encode_batch(caps, cfg.TEXT.WORDS_NUM)
        ids, lens = torch.from_numpy(ids).long(), torch.from_numpy(lens).long()
        if device.type == "cuda":
            # from pinned memory the copy is queued on the stream; from
            # pageable memory it would wait for the device to drain first
            ids, lens = ids.pin_memory(), lens.pin_memory()
        return (ids.to(device, non_blocking=True),
                lens.to(device, non_blocking=True))

    def flush(group: List[Dict], out) -> None:
        # the copies to the host wait for the batch; everything after is
        # host work that overlaps the next batch's device execution
        n = len(group)
        imgs = out["images"][-1][:n].cpu().numpy()
        labels = out["labels"][:n].cpu().numpy()
        boxes = out["boxes"][:n].cpu().numpy()
        valid = out["obj_valid"][:n].cpu().numpy()
        t_done = time.monotonic()
        done.append(t_done - t0)
        for i, req in enumerate(group):
            path = None
            if save_images:
                path = os.path.join(out_dir, f"serve_{req['id']}.png")
                save_png(path, _to_uint8(imgs[i]))
            resp = {
                "id": req["id"],
                "caption": req["caption"],
                "objects": [
                    [int(lab), [round(float(x), 4) for x in bx]]
                    for lab, bx, v in zip(labels[i], boxes[i], valid[i])
                    if v
                ],
                "image": path,
            }
            if emit is not None:
                emit(resp)
        emit_s.append(time.monotonic() - t_done)

    n_req = n_batch = 0
    done: List[float] = []
    emit_s: List[float] = []
    t0 = time.monotonic()
    pending = None  # (group, device outputs)
    for group in _batched(iter(requests), b):
        ids, lens = encode(group)
        out = pipe.generate(ids, lens, draw_noise(cfg, b, gen, device))
        n_batch += 1
        n_req += len(group)
        if pending is not None:
            flush(*pending)
        pending = (group, out)
    if pending is not None:
        flush(*pending)
    wall = time.monotonic() - t0
    return {
        "requests": n_req,
        "batches": n_batch,
        "batch_size": b,
        "device": str(device),
        "wall_s": round(wall, 4),
        "batch_done_s": [round(t, 4) for t in done],
        "emit_s": [round(t, 4) for t in emit_s],
        "req_per_s": round(n_req / max(wall, 1e-9), 3),
    }

