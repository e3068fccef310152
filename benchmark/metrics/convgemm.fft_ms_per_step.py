"""Device time per profiled step of cuDNN's FFT and Winograd convolution
kernels: those whose names hold ``fft``, ``cf32`` (the complex-float32 GEMMs
of the FFT path) or ``winograd``. 0 where the profiled steps ran none."""

FRAGMENTS = ("fft", "cf32", "winograd")


def read(record):
    events = record["device_events"]
    if not events:
        return None
    us = sum(e["dur"] for e in events if e["cat"] == "kernel" and any(f in e["name"].lower() for f in FRAGMENTS))
    return us / 1e3 / record["profiled_steps"]
