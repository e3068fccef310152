"""What each of the program's spans did in a ``torch.profiler`` Chrome trace
of its training steps, and in a recording of the same spans.

The program marks the boundaries of ``Trainer.train_step`` with spans named
``dynamo.*`` (``dynamo_depth_torch/utils/spans.py``): under the profiler
each is a ``user_annotation`` on the thread that ran it, on the timeline of
the runtime calls and kernels; under ``spans.recording()`` each is a
``Span`` on ``time.perf_counter_ns``, which the profiler does not slow.

From the trace, each device event (kernel, memcpy, memset) is attributed by
the runtime call that issued it (``args.correlation``):

- ``span``: the innermost ``dynamo.*`` span open on the thread that issued
  the call; a thread without spans (autograd's device thread) takes the
  span open on the thread that has them at that time, ``dynamo.backward``;
- ``layer``: the same, except that a call inside an
  ``autograd::engine::evaluate_function: ...Backward`` operator is given the
  span of the forward operator with the same ``Sequence number``, the op
  whose gradient it computes; where no forward op matches, ``span``.

The blocking runtime calls (``BLOCKING``, and the synchronous
``cudaMemcpy*``) are counted by ``span``, and each idle gap of the card goes
to the ``span`` of the launch that ends it. Nothing here imports the
program: a recording comes in as a list of tuples.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from typing import NamedTuple

from benchmark.trace import BF16_INSTANCES, DEVICE_CATS, PORT_KERNELS, busy_intervals, classify, launching_ops

PREFIX = "dynamo."
ROOT = "dynamo.train_step"
# The spans that hold view synthesis and the losses (the ground plane nests in the losses).
SYNTHESIS_LOSSES = ("dynamo.view_synthesis", "dynamo.losses", "dynamo.ground_plane")
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
EVALUATE = "autograd::engine::evaluate_function: "
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
GAPS_LISTED = 10


class Blocking(NamedTuple):
    """A runtime call during which the host waited for the card."""
    name: str
    ts: float  # µs, the trace's clock
    dur: float
    span: str  # innermost ``dynamo.*`` span, None outside every one


def is_blocking(name: str) -> bool:
    return name in BLOCKING or (name.startswith("cudaMemcpy") and "Async" not in name)


class Nest:
    """Properly nested intervals of one thread; ``at(t)`` is the innermost
    one that holds ``t``."""

    def __init__(self, events: list):
        self.events = sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0)))
        self.starts = [e["ts"] for e in self.events]
        self.ends = [e["ts"] + e.get("dur", 0) for e in self.events]
        self.parent = []
        stack = []
        for i, e in enumerate(self.events):
            while stack and self.ends[stack[-1]] < e["ts"]:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: float):
        i = bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        return self.events[i] if i >= 0 else None


def program_view(trace: dict) -> dict:
    """Per profiled step (a ``dynamo.train_step`` span of the trace): for
    each span name, the device ms and launches of what it issued (``layer``
    attribution), the blocking calls and the card's idle ms before its
    launches (``span`` attribution); the device ms no span holds; the
    blocking calls; the port kernels' launches by ``layer``; and the
    longest idle gaps, each with the ``aten::`` op (as
    ``trace.device_events`` names it) and the span of the launch that ends
    it, and the span the step's thread was in when the card fell idle.
    None where the trace holds no step."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    threads = defaultdict(list)
    evaluate = defaultdict(list)
    forward = {}  # sequence number -> the last forward op holding it, on a thread with spans
    for e in events:
        key = (e.get("pid"), e.get("tid"))
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX):
            threads[key].append(e)
        elif e.get("cat") == "cpu_op" and e.get("name", "").startswith(EVALUATE):
            evaluate[key].append(e)
    roots = [e for evs in threads.values() for e in evs if e["name"] == ROOT]
    if not roots:
        return None
    steps = len(roots)
    main = max(threads, key=lambda k: sum(e["name"] == ROOT for e in threads[k]))
    nests = {k: Nest(v) for k, v in threads.items()}
    evaluate = {k: Nest(v) for k, v in evaluate.items()}

    def span_at(key, t):
        s = nests.get(key, nests[main]).at(t)
        return s["name"] if s else None

    for e in events:
        seq = e.get("args", {}).get("Sequence number")
        if e.get("cat") == "cpu_op" and seq is not None and not e["name"].startswith(EVALUATE) \
                and (e["pid"], e["tid"]) in nests:
            if seq not in forward or forward[seq]["ts"] <= e["ts"]:
                forward[seq] = e

    calls = {}  # correlation -> (span, layer, the runtime call's name)
    blocking = []
    for e in events:
        if e.get("cat") not in RUNTIME_CATS:
            continue
        key, t = (e.get("pid"), e.get("tid")), e["ts"]
        span = span_at(key, t)
        if is_blocking(e.get("name", "")):
            blocking.append(Blocking(e["name"], t, e.get("dur", 0.0), span))
        corr = e.get("args", {}).get("correlation")
        if corr is None:
            continue
        layer = span
        node = evaluate[key].at(t) if key in evaluate else None
        if node is not None:
            fwd = forward.get(node.get("args", {}).get("Sequence number"))
            if fwd is not None:
                layer = span_at((fwd["pid"], fwd["tid"]), fwd["ts"]) or span
        calls[corr] = (span, layer, e.get("name", "?"))

    ops = launching_ops(trace.get("traceEvents", []))
    device = []
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            span, layer, call = calls.get(corr, (None, None, "?"))
            device.append({"name": e.get("name", ""), "cat": e["cat"], "ts": float(e["ts"]),
                           "dur": float(e.get("dur", 0)), "op": ops.get(corr) or call, "span": span, "layer": layer})
    device.sort(key=lambda d: d["ts"])

    rows = defaultdict(lambda: {"device_ms": 0.0, "launches": 0.0, "syncs": 0.0, "idle_ms": 0.0})
    unattributed_us = 0.0
    kernels = defaultdict(float)
    for d in device:
        if d["layer"] is None:
            unattributed_us += d["dur"]
            continue
        rows[d["layer"]]["device_ms"] += d["dur"] / 1e3 / steps
        rows[d["layer"]]["launches"] += 1 / steps
        if classify(d["name"], d["cat"]) in PORT_KERNELS + BF16_INSTANCES:
            kernels[d["layer"]] += 1 / steps
    for b in blocking:
        if b.span is not None:
            rows[b.span]["syncs"] += 1 / steps
    gaps = []
    merged = busy_intervals(device)
    first = {}
    for d in device:
        first.setdefault(d["ts"], d)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        d = first[nxt]
        gaps.append((nxt - end, d["op"], d["span"], span_at(main, end)))
        if d["span"] is not None:
            rows[d["span"]]["idle_ms"] += (nxt - end) / 1e3 / steps
    gaps.sort(key=lambda g: -g[0])
    busy_us = sum(b - a for a, b in merged)
    return {
        "steps": steps,
        "spans": {k: dict(v) for k, v in sorted(rows.items())},
        "device_ms": sum(d["dur"] for d in device) / 1e3 / steps,
        "busy_ms": busy_us / 1e3 / steps,
        "unattributed_ms": unattributed_us / 1e3 / steps,
        "syncs": sum(b.span is not None for b in blocking) / steps,
        "blocking": blocking,
        "port_kernels": dict(kernels),
        "gaps": [[us / 1e3, op, span, host] for us, op, span, host in gaps[:GAPS_LISTED]],
    }


def recorded_view(spans: list) -> dict:
    """{span name: {"host_ms", "self_ms"}} per step, means over the steps
    of a recording (``(name, parent, step, start_ns, end_ns)`` tuples):
    a span's host time from entry to exit, summed over its entries in a
    step, and its self time, less what its child spans cover. A step is a
    root span."""
    n = sum(s[1] < 0 for s in spans)
    if not n:
        return {}
    host = defaultdict(float)
    child = defaultdict(float)
    for name, parent, _, start, end in spans:
        host[name] += (end - start) / 1e6
        if parent >= 0:
            child[parent] += (end - start) / 1e6
    own = defaultdict(float)
    for i, (name, _, _, start, end) in enumerate(spans):
        own[name] += (end - start) / 1e6 - child[i]
    return {k: {"host_ms": host[k] / n, "self_ms": own[k] / n} for k in sorted(host)}


def synthesis_losses_device_ms(view: dict) -> float:
    """Device ms per step of view synthesis and the losses, forward and the
    backward mapped to them."""
    return sum(view["spans"].get(k, {}).get("device_ms", 0.0) for k in SYNTHESIS_LOSSES)


def host_ms(recorded: dict, names) -> float:
    """The recorded host ms per step of the spans ``names`` (none nested in
    another), or None where the recording has none of them."""
    found = [recorded[k]["host_ms"] for k in names if k in recorded]
    return sum(found) if found else None
