"""What the per-layer readers of the program's own spans and counters
read: the finished roots of `bm2f_tpu_torch.utils.tracing.records()` in
this process (a run is one process). A program without that module, or with
no root of the name, gives nothing to read: the readers then return None.

The traced run's roots: a train cell's steps of its marked stretch and of
its profiled one ("train.step"), a served cell's requests of its profiled
stretch ("serve.request").
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def roots(name: str) -> List[Dict]:
    """The finished roots named `name`, oldest first; none without the
    tracing module."""
    try:
        from bm2f_tpu_torch.utils import tracing
    except ImportError:
        return []
    return [r for r in tracing.records() if r["name"] == name]


def span_ms(root: Dict, span: str, clock: str) -> float:
    """The summed length of the root's spans named `span`, on `clock`
    ("device" or "host")."""
    return sum(s[f"{clock}_ms"] for s in root["spans"] if s["name"] == span)


def mean_span_ms(root_name: str, span: str, clock: str) -> Optional[float]:
    """The mean over the roots of `root_name` of each one's `span_ms`; None
    without a root that holds the span."""
    found = [r for r in roots(root_name) if any(s["name"] == span for s in r["spans"])]
    return statistics.fmean(span_ms(r, span, clock) for r in found) if found else None
