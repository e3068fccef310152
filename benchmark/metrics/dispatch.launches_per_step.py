"""Device kernels, memcpys and memsets per profiled step, counted from the
trace."""


def read(record):
    events = record["device_events"]
    return len(events) / record["profiled_steps"] if events else None
