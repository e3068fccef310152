"""The program's four CUDA kernels (K1/K2 warp forward and backward, with
their bfloat16-image instances, K3/K4 photometric forward and backward)
against their roofline: over every launch in the profiled steps, the sum of
its least time (``roofline.least_seconds`` at the cell's image shape, each
launch one full-resolution image) over the sum of their traced times.
Launches are matched by kernel name; nothing is read where none ran."""

from benchmark.roofline import least_seconds, peaks
from benchmark.trace import BF16_INSTANCES, PORT_KERNELS, classify


def read(record):
    card = peaks(record["device"]["name"])
    if not card:
        return None
    least = traced = 0.0
    for e in record["device_events"]:
        kind = classify(e["name"], e["cat"])
        if kind in PORT_KERNELS + BF16_INSTANCES:
            least += least_seconds(kind, tuple(record["image_shape"]), card)
            traced += e["dur"] / 1e6
    return 100.0 * least / traced if traced > 0 else None
