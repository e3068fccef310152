"""Time a call on the card: device time from the profiler, wall time from
CUDA events. Used by ``chip_smoke.py`` and ``bench/kernel_ab.py``."""

from __future__ import annotations

import numpy as np
import torch

TIMED_RUNS = 30


def median_ms(fn, runs=TIMED_RUNS):
    """Median of ``runs`` CUDA-event timings around one call of ``fn``
    (after warm-up); includes the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, runs=TIMED_RUNS):
    """Device time of one call of ``fn``: the sum of the durations of every
    kernel it launches, from torch.profiler (CUPTI), averaged over ``runs``
    calls after warm-up. None where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total_us = sum(self_device_us(e) for e in prof.key_averages())
    return total_us / runs / 1e3 if total_us > 0 else None


def self_device_us(event):
    """Self device time (µs) of one ``key_averages()`` entry, under the name
    this torch version gives it."""
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)
