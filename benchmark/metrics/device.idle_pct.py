"""The share of a step in which the card runs nothing: one minus the
device's busy time per profiled step (the union of its kernels, memcpys and
memsets in the trace) over the mean step of the unprofiled window. The
profiler slows the host's dispatch, so the profiled steps' own span would
overstate the idle share wherever the host sets the pace."""

from benchmark.trace import busy_and_window


def read(record):
    busy, _ = busy_and_window(record)
    window = record["window"]
    if busy <= 0 or not window["steps"]:
        return None
    return 100.0 * (1.0 - busy / record["profiled_steps"] / (window["seconds"] / window["steps"]))
