"""Device time per profiled step of the kernels the classifier calls
convolution or GEMM (cuDNN, cuBLAS, CUTLASS)."""

from benchmark.trace import classify


def read(record):
    events = record["device_events"]
    if not events:
        return None
    us = sum(e["dur"] for e in events if classify(e["name"], e["cat"]) == "convolution/GEMM")
    return us / 1e3 / record["profiled_steps"]
