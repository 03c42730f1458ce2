"""The device of the tools that run a model: the card unless the caller
asks for the CPU. Without a card, asking for it raises; nothing falls back
to the CPU. On the CPU every kernel takes its plain version, and the first
line a tool prints says so."""

from __future__ import annotations

import time

import torch


def tool_device(tool: str, device: str = "cuda") -> torch.device:
    """`device` ("cuda" or "cpu") as a torch device, after printing it as
    the tool's first line. Raises RuntimeError for "cuda" without a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{tool}: no CUDA device (--device cpu runs the plain "
                               "versions of the kernels)")
        print(f"{tool}: device cuda ({torch.cuda.get_device_name(dev)}), the kernels",
              flush=True)
    elif dev.type == "cpu":
        print(f"{tool}: device cpu, the plain versions of the kernels; times are "
              "host-clock times of the CPU, not of the card", flush=True)
    else:
        raise ValueError(f"{tool}: device must be cuda or cpu, got {device!r}")
    return dev


def timed_ms(fn, iters: int, warmup: int = 3, dev="cuda") -> float:
    """Mean time of `fn` in ms over `iters` back-to-back calls after
    `warmup` calls: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if torch.device(dev).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
