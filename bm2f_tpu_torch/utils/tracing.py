"""Spans and counters inside the port, on the profiler's clock.

    with tracing.span("serve.request", device):
        with tracing.span("serve.prepare"):
            ...
        tracing.count("serve.to_host_bytes", nbytes)
    roots = tracing.records()

A span that opens with no span open in its thread is a root: one id for
every span of a request or a train step. Each span records its name, its
parent, its root's id, its host start and end (`time.perf_counter_ns`)
and, when its root is on a CUDA device, a start and an end
`torch.cuda.Event` (from a pool), which give its length on the device's
clock; on the CPU the device clock is the host clock. The events are
resolved only when the records are read, after one synchronise. While on, a
span also opens `torch.profiler.record_function(name)`, so that a profiler
trace shows it as a `user_annotation`, on the clock of the device events it
launches.

`count(name, n)` adds `n` (a Python int or a 0-d tensor) to a counter of
the open root. A tensor is kept as it is and summed when the records are
read: a counter adds no synchronise and no kernel.

Tracing is on while a `torch.profiler` profile records, and inside a
`collect()` block (thread by thread). Off, `span` returns one shared null
context after one check, and `count` returns without touching its
argument: about half a microsecond a span on the host.

The store keeps the last `MAX_ROOTS` finished roots; `records()` reads them
and does not clear them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

MAX_ROOTS = 256

_profiling = torch.autograd._profiler_enabled


class _Null:
    """The span of tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()


class _Local(threading.local):
    def __init__(self):
        self.depth = 0  # open collect() blocks
        self.stack: List["_Span"] = []  # open spans, the root first
        self.listeners: List[Callable[[str], None]] = []


_local = _Local()


def enabled() -> bool:
    """Whether spans and counters record in this thread now."""
    return _local.depth > 0 or _profiling()


def span(name: str, device=None):
    """A context manager timing `name` (see the module's docstring).
    `device` sets a root's clock (a CUDA device: its events; otherwise the
    host's); left None, a root is on the card when CUDA is initialised. A
    span inside a root takes its root's clock."""
    if _local.depth or _profiling():
        return _Span(name, device)
    return NULL


def count(name: str, n) -> None:
    """Adds `n` (an int or a 0-d tensor) to the open root's counter `name`;
    nothing without an open root or with tracing off."""
    if _local.depth or _profiling():
        stack = _local.stack
        if stack:
            stack[0].root.counters[name].append(n)


@contextlib.contextmanager
def collect(on_end: Optional[Callable[[str], None]] = None) -> Iterator[None]:
    """Tracing on in this thread for the block, whether a profiler records
    or not. `on_end(name)`, when given, is called after each span that ends
    in the block."""
    loc = _local
    loc.depth += 1
    if on_end is not None:
        loc.listeners.append(on_end)
    try:
        yield
    finally:
        loc.depth -= 1
        if on_end is not None:
            loc.listeners.pop()


class _Events:
    """Timing events for reuse, one pool per CUDA device."""

    def __init__(self):
        self.free: Dict[int, List[torch.cuda.Event]] = collections.defaultdict(list)

    def take(self, dev: int) -> torch.cuda.Event:
        free = self.free[dev]
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def give(self, dev: int, events) -> None:
        self.free[dev].extend(events)


_EVENTS = _Events()
_IDS = itertools.count()


class _Rec:
    __slots__ = ("name", "parent", "t0", "t1", "ev0", "ev1", "device_ms")

    def __init__(self, name: str, parent: Optional[int]):
        self.name, self.parent = name, parent
        self.ev0 = self.ev1 = self.device_ms = None


class _Root:
    __slots__ = ("id", "dev", "spans", "counters", "pending")

    def __init__(self, device):
        self.id = next(_IDS)
        if device is None:
            cuda = torch.cuda.is_initialized()
        else:
            cuda = torch.device(device).type == "cuda"
        # the CUDA device whose events time the spans, or None for the host clock
        self.dev = torch.cuda.current_device() if cuda else None
        self.spans: List[_Rec] = []
        self.counters: Dict[str, list] = collections.defaultdict(list)
        self.pending = True

    def release(self) -> None:
        """Gives the events back to the pool."""
        if self.dev is not None:
            _EVENTS.give(self.dev, [e for r in self.spans for e in (r.ev0, r.ev1)
                                    if e is not None])
        for r in self.spans:
            r.ev0 = r.ev1 = None

    def resolve(self) -> None:
        """Device lengths and counter sums; the device is synchronised."""
        for r in self.spans:
            r.device_ms = (r.ev0.elapsed_time(r.ev1) if self.dev is not None
                           else (r.t1 - r.t0) * 1e-6)
        for name, parts in self.counters.items():
            parts[:] = [sum(p.item() if isinstance(p, torch.Tensor) else p for p in parts)]
        self.release()
        self.pending = False

    def as_dict(self) -> Dict:
        return {
            "id": self.id, "name": self.spans[0].name,
            "clock": "host" if self.dev is None else "cuda",
            "spans": [{"name": r.name, "parent": r.parent, "root": self.id,
                       "start_ns": r.t0, "end_ns": r.t1, "host_ms": (r.t1 - r.t0) * 1e-6,
                       "device_ms": r.device_ms} for r in self.spans],
            "counters": {k: v[0] for k, v in self.counters.items()},
        }


class _Store:
    def __init__(self):
        self.lock = threading.Lock()
        self.roots: collections.deque = collections.deque()

    def finish(self, root: _Root) -> None:
        with self.lock:
            self.roots.append(root)
            while len(self.roots) > MAX_ROOTS:
                self.roots.popleft().release()


_STORE = _Store()


class _Span:
    __slots__ = ("name", "device", "root", "rec", "at", "rf")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        stack = _local.stack
        if stack:
            self.root, parent = stack[-1].root, stack[-1].at
        else:
            self.root, parent = _Root(self.device), None
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        rec = self.rec = _Rec(self.name, parent)
        self.at = len(self.root.spans)
        self.root.spans.append(rec)
        stack.append(self)
        if self.root.dev is not None:
            rec.ev0 = _EVENTS.take(self.root.dev)
            rec.ev0.record()
        rec.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1 = time.perf_counter_ns()
        if self.root.dev is not None:
            rec.ev1 = _EVENTS.take(self.root.dev)
            rec.ev1.record()
        self.rf.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if not stack:
            _STORE.finish(self.root)
        for fn in _local.listeners:
            fn(self.name)
        return False


def records() -> List[Dict]:
    """The finished roots in the store, oldest first, each a dict: id, name
    (its first span's), clock ("cuda" or "host"), spans (name, parent: the
    index of the parent span in the list or None, root, start_ns, end_ns,
    host_ms, device_ms) and counters. Synchronises, once, each CUDA device
    that holds a root not yet read."""
    with _STORE.lock:
        roots = list(_STORE.roots)
        todo = [r for r in roots if r.pending]
        for dev in {r.dev for r in todo if r.dev is not None}:
            torch.cuda.synchronize(dev)
        for r in todo:
            r.resolve()
        return [r.as_dict() for r in roots]
