"""From a ``torch.profiler`` Chrome trace of the profiled steps to the
record that the per-layer readers (``metrics/*.py``) and the breakdown read.

The kernel classifier and the attribution of a device event to the
``aten::`` operator that launched it are copies of the program's
``bench/profile_top_ops.py``.
"""

from __future__ import annotations

from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PORT_KERNELS = ("warp_fwd", "warp_bwd", "photometric_fwd", "photometric_bwd")
BF16_INSTANCES = ("warp_fwd_bf16", "warp_bwd_bf16")
# Category -> name fragments, first match wins (lower case).
CATEGORIES = (
    ("convolution/GEMM", ("conv", "gemm", "gemv", "cutlass", "xmma", "cudnn", "fft", "winograd", "dgrad", "wgrad")),
    ("reduction/norm", ("reduce", "norm", "welford", "softmax", "cub::", "argmin", "argmax")),
    ("elementwise", ("elementwise", "unrolled", "vectorized", "pointwise", "index", "gather", "scatter", "upsample",
                     "grid_sampler", "pad", "cat")),
)
BREAKDOWN_ENTRIES = 10


def classify(name: str, cat: str = "kernel") -> str:
    """A device event's category, or the port kernel's name."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "memcpy/memset"
    for k in PORT_KERNELS:
        if f"{k}_kernel" in name:
            return k + "_bf16" if k + "_bf16" in BF16_INSTANCES and "bfloat16" in name else k
    n = name.lower()
    for category, fragments in CATEGORIES:
        if any(f in n for f in fragments):
            return category
    return "other"


def launching_ops(events) -> dict:
    """{correlation id: name of the innermost ``aten::`` operator around the
    runtime call with that id} (None where the call lies in no ``aten::``
    operator)."""
    by_thread = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "cpu_op" or (cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})):
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    out = {}
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e.get("dur", 0), e.get("cat") != "cpu_op"))
        stack = []
        for e in evs:
            while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) <= e["ts"]:
                stack.pop()
            if e.get("cat") == "cpu_op":
                stack.append(e)
                continue
            aten = [op["name"] for op in stack if op["name"].startswith("aten::")]
            out[e["args"]["correlation"]] = aten[-1] if aten else None
    return out


def device_events(trace: dict) -> list:
    """[{"name", "cat", "ts", "dur", "op"}] of every kernel, memcpy and
    memset, in µs, sorted by start; ``op`` is the launching ``aten::``
    operator, or the runtime call where there is none."""
    events = trace.get("traceEvents", [])
    ops = launching_ops(events)
    runtime = {e["args"]["correlation"]: e["name"] for e in events
               if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            out.append({"name": e.get("name", ""), "cat": e["cat"], "ts": float(e["ts"]), "dur": float(e.get("dur", 0)),
                        "op": ops.get(corr) or runtime.get(corr) or "?"})
    out.sort(key=lambda e: e["ts"])
    return out


def busy_intervals(events: list) -> list:
    """The union of the events' [start, end) intervals, merged, in µs."""
    merged = []
    for e in events:
        a, b = e["ts"], e["ts"] + e["dur"]
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_gaps(events: list) -> list:
    """[(µs, operator that launched the event ending the gap)] of every gap
    between busy intervals, longest first."""
    gaps = []
    ends = busy_intervals(events)
    starts = {}
    for e in events:
        starts.setdefault(e["ts"], e["op"])
    for (_, end), (nxt, _) in zip(ends, ends[1:]):
        gaps.append((nxt - end, starts.get(nxt, "?")))
    gaps.sort(key=lambda g: -g[0])
    return gaps


def make_record(*, window, setup_s: float, shape: tuple, device: dict, trace: dict = None, steps: int = 0,
                flops_per_step=None) -> dict:
    """What the metric readers take: the timed window, the set-up time, the
    cell's image shape ``(B, C, H, W)`` and the card; in a traced run also
    the profiled steps' device events and the FLOPs of one step."""
    return {
        "setup_s": setup_s,
        "image_shape": list(shape),
        "device": device,
        "window": {"steps": window.steps, "seconds": window.seconds, "periods_ms": window.periods_ms,
                   "host_spans_ms": window.host_spans_ms},
        "profiled_steps": steps,
        "device_events": device_events(trace) if trace is not None else [],
        "flops_per_step": flops_per_step,
    }


def breakdown(record: dict) -> dict:
    """The device operations that took most time per profiled step, and the
    longest idle gaps, named by the operator the device then waited for;
    seconds."""
    steps = record["profiled_steps"]
    per_name = defaultdict(float)
    for e in record["device_events"]:
        per_name[e["name"][:160]] += e["dur"] / 1e6 / steps
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    gaps = idle_gaps(record["device_events"])[:BREAKDOWN_ENTRIES]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[f"before {op}"[:160], us / 1e6] for us, op in gaps]}


def busy_and_window(record: dict) -> tuple:
    """(seconds in which a device event ran, seconds from the first device
    event to the end of the last) over the profiled steps."""
    merged = busy_intervals(record["device_events"])
    if not merged:
        return 0.0, 0.0
    return sum(b - a for a, b in merged) / 1e6, (merged[-1][1] - merged[0][0]) / 1e6
