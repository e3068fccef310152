"""The 90th percentile of the periods of all steps in the window (CUDA
events after each step), linear between the two nearest ranks."""

import math


def percentile(values: list, q: float) -> float:
    s = sorted(values)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def read(record):
    periods = record["window"]["periods_ms"]
    return percentile(periods, 90) if periods else None
