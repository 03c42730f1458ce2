"""A profiled stretch of a traced run, read from torch.profiler's trace.

`profiled(fn)` runs `fn` under the profiler (CPU and CUDA activity) and
returns a `Trace`: the device events (kernels, copies, memsets), the host
ranges, and which host range launched each device event (through the
trace's correlation of a launch on the host with its device event, and the
launch's time and thread inside the range, so the work is attributed to
the call whatever kernels implement it).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
# the longest idle gaps named by the host op under them (the rest count in busy_s only)
NAMED_GAPS = 200


@dataclass
class Trace:
    window_s: float
    device: List[dict]  # device events: name, ts, dur (us), launch (ts, tid) or None
    host: List[dict]  # host ranges: name, ts, dur, tid
    main_tid: object

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def device_seconds_in(self, names: Sequence[str]) -> float:
        """Device time of every event launched inside a host range of one of
        `names` (on the launching thread)."""
        ranges = defaultdict(list)
        for h in self.host:
            if h["name"] in names:
                ranges[h["tid"]].append((h["ts"], h["ts"] + h["dur"]))
        total = 0.0
        for e in self.device:
            if e["launch"] is None:
                continue
            ts, tid = e["launch"]
            if any(a <= ts <= b for a, b in ranges.get(tid, ())):
                total += e["dur"]
        return total * 1e-6

    def breakdown(self, top: int = 10) -> Dict[str, List[list]]:
        ops = defaultdict(float)
        for e in self.device:
            ops[e["name"][:120]] += e["dur"] * 1e-6
        gaps = defaultdict(float)
        busy = self.busy_intervals()
        main = [h for h in self.host if h["tid"] == self.main_tid]
        ts = np.array([h["ts"] for h in main])
        dur = np.array([h["dur"] for h in main])
        between = sorted(((b - a, a, b) for (_, a), (b, _) in zip(busy, busy[1:])),
                         reverse=True)[:NAMED_GAPS]
        for length, a, b in between:
            mid = 0.5 * (a + b)
            inside = np.nonzero((ts <= mid) & (ts + dur >= mid))[0]
            name = (main[inside[np.argmin(dur[inside])]]["name"][:120] if inside.size
                    else "(no host op)")
            gaps[name] += length * 1e-6
        order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": order(ops), "idle_gaps": order(gaps)}


def _read(path: str, window_s: float) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches = {}
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (float(e["ts"]), e.get("tid"))
        elif cat in DEVICE_CATS:
            device.append({"name": e.get("name", ""), "ts": float(e["ts"]),
                           "dur": float(e.get("dur", 0)), "corr": args.get("correlation")})
        elif cat in HOST_CATS:
            host.append({"name": e.get("name", ""), "ts": float(e["ts"]),
                         "dur": float(e.get("dur", 0)), "tid": e.get("tid")})
    for d in device:
        d["launch"] = launches.get(d.pop("corr"))
    marks = [h for h in host if h["name"] == STRETCH]
    main_tid = marks[0]["tid"] if marks else None
    return Trace(window_s, device, host, main_tid)


STRETCH = "port_bench.stretch"


def profiled(fn: Callable[[], None], device, tmpdir: str = None) -> Trace:
    """Runs fn() under the profiler, from an idle device to a synchronise
    (on a CPU device, for rehearsals, with host activity only)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(STRETCH):
            fn()
            sync()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return _read(path, window_s)
    finally:
        os.unlink(path)
