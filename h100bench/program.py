"""The program's own record of its newest traced stretch, read in the
process that ran the cell: the spans and counters of
``objgan_tpu_torch/utils/profiling.py::recorded``. A program without that
recorder gives None, and so does every reader of it."""

from __future__ import annotations

from typing import Dict, List, Optional


def recorded() -> Optional[Dict]:
    try:
        from objgan_tpu_torch.utils.profiling import recorded as read
    except ImportError:
        return None
    return read()


def spans(name: str) -> List[Dict]:
    """The recorded spans named ``name`` (none without a recorder)."""
    rec = recorded()
    return [s for s in rec["spans"] if s["name"] == name] if rec else []


def mean_ms(found: List[Dict]) -> float:
    return sum(s["end_ns"] - s["start_ns"] for s in found) / len(found) / 1e6
