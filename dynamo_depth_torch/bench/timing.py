"""Time a call on the card: device time from the profiler, wall time from
CUDA events. Used by ``chip_smoke.py`` and ``bench/kernel_ab.py``."""

from __future__ import annotations

import numpy as np
import torch

TIMED_RUNS = 30
PROFILE_TRIES = 3


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


# Written before each call of a cold timing: more than the H100's 50 MB L2.
L2_FLUSH_BYTES = 64 * 2**20
# The overwrite is an in-place bitwise not of int32s: a kernel whose name no
# timed call shares, so the sum can leave it out by name.
_FLUSH_KERNEL = "bitwise_not"


def device_ms(fn, runs=TIMED_RUNS, cold=False):
    """Device time of one call of ``fn``: the sum of the durations of every
    kernel it launches, from torch.profiler (CUPTI), averaged over ``runs``
    calls after warm-up. None where the profiler saw no device activity in
    any of ``PROFILE_TRIES`` profiled runs.

    ``cold``: before each call, overwrite a scratch buffer larger than the L2
    cache, so that the call finds its inputs in device memory, as a kernel
    inside a training step finds what an earlier op wrote long before. The
    overwrite's own kernel is left out of the sum by its name."""
    from torch.profiler import ProfilerActivity, profile

    flush = None
    if cold:
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda").bitwise_not_
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # The profiler on the card's machine now and then returns a profiled run
    # without its kernels, or with a few launches of the run before: each
    # kernel counts as its mean duration times its launches per call, and an
    # empty run is profiled again.
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        total_us = sum(
            self_device_us(e) / e.count * round(e.count / runs)
            for e in prof.key_averages()
            if self_device_us(e) > 0 and _FLUSH_KERNEL not in e.key
        )
        if total_us > 0:
            return total_us / 1e3
    return None


def self_device_us(event):
    """Self device time (µs) of one ``key_averages()`` entry, under the name
    this torch version gives it."""
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)
