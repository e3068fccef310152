"""Summarise a ``torch.profiler`` Chrome trace: the top device kernels.

    python -m dynamo_depth_torch.bench.profile_top_ops logs/<name>/traces/<phase>[/trace.json] [N] [--by-op|--copies]

The port's counterpart of the JAX package's ``scripts/profile_top_ops.py``,
for the trace the port's ``--profile`` writes (``Trainer.run_phase``:
``logs/<name>/traces/<phase>/trace.json``). It prints the top-N device
kernels by total time with their count and mean, then a rollup by category:
convolution/GEMM, elementwise, reduction/norm, each of the four port
kernels by name, memcpy/memset, and the rest.

``--by-op`` rolls device time up by the ``aten::`` operator that launched
each kernel instead: a kernel's ``correlation`` id names the runtime call
that launched it (``cudaLaunchKernel`` and the like), and the innermost
``aten::`` operator around that call on its host thread is the one that
launched it (the port's own kernels are launched from Python through
ctypes, outside any ``aten::`` operator: they roll up by their own name).
This takes the place of the JAX script's ``--by-module``: the port's trace
carries no module scopes.

``--copies`` lists the memcpy and memset events by name, with their count,
time and bytes. XLA's layout copies, which the JAX script's ``--copies``
hunts, do not exist here: eager PyTorch re-lays out data only where an
operator asks for it, and then as a kernel of that operator.

A trace of a CPU-only run holds no device event: the script says so and
prints an empty table.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os.path as osp
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PORT_KERNELS = ("warp_fwd", "warp_bwd", "photometric_fwd", "photometric_bwd")
# Category -> name fragments, first match wins (lower case).
CATEGORIES = (
    ("convolution/GEMM", ("conv", "gemm", "gemv", "cutlass", "xmma", "cudnn", "fft", "winograd", "dgrad", "wgrad")),
    ("reduction/norm", ("reduce", "norm", "welford", "softmax", "cub::", "argmin", "argmax")),
    ("elementwise", ("elementwise", "unrolled", "vectorized", "pointwise", "index", "gather", "scatter", "upsample",
                     "grid_sampler", "pad", "cat")),
)


def load_trace(path: str) -> dict:
    """The Chrome trace at ``path``, or ``<path>/trace.json``."""
    if osp.isdir(path):
        path = osp.join(path, "trace.json")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def classify(name: str, cat: str = "kernel") -> str:
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "memcpy/memset"
    for k in PORT_KERNELS:
        if f"{k}_kernel" in name:
            return k
    n = name.lower()
    for category, fragments in CATEGORIES:
        if any(f in n for f in fragments):
            return category
    return "other"


def device_events(events):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


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
        # Enclosing first: by start, then the longer span, then operators
        # before the runtime calls they contain.
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


def summarize(trace: dict) -> dict:
    """{"kernels": {name: [ms, count]}, "categories": {category: [ms,
    count]}, "by_op": {op: [ms, count]}, "copies": {name: [ms, count,
    bytes]}, "total_ms": device ms} of a trace's device events."""
    events = trace.get("traceEvents", [])
    dev = device_events(events)
    ops = launching_ops(events)
    kernels, categories = defaultdict(lambda: [0.0, 0]), defaultdict(lambda: [0.0, 0])
    by_op, copies = defaultdict(lambda: [0.0, 0]), defaultdict(lambda: [0.0, 0, 0])
    for e in dev:
        ms, name, cat, args = e.get("dur", 0) / 1e3, e.get("name", ""), e["cat"], e.get("args", {})
        category = classify(name, cat)
        for table, key in ((kernels, name), (categories, category)):
            table[key][0] += ms
            table[key][1] += 1
        op = ops.get(args.get("correlation"))
        key = op or (category if category in PORT_KERNELS else f"<no aten op> {name[:60]}")
        by_op[key][0] += ms
        by_op[key][1] += 1
        if cat != "kernel":
            copies[name][0] += ms
            copies[name][1] += 1
            copies[name][2] += int(args.get("bytes", 0))
    return {"kernels": dict(kernels), "categories": dict(categories), "by_op": dict(by_op), "copies": dict(copies),
            "total_ms": sum(ms for ms, _ in kernels.values())}


def _table(rows, total, topn, label):
    print(f"{'ms':>10} {'%':>6} {'n':>6} {'mean us':>9}  {label}")
    for name, (ms, n, *_) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:topn]:
        print(f"{ms:10.3f} {100 * ms / max(total, 1e-12):6.2f} {n:6d} {1e3 * ms / n:9.2f}  {name[:110]}")


def report(summary: dict, topn: int = 25, by_op: bool = False, copies: bool = False) -> None:
    total = summary["total_ms"]
    if not summary["kernels"]:
        print("no device events in the trace (a CPU-only run): nothing to rank")
        _table({}, 0.0, topn, "kernel")
        return
    if copies:
        rows = summary["copies"]
        print(f"memcpy/memset: {sum(r[0] for r in rows.values()):.3f} ms of {total:.3f} ms device time")
        print(f"{'ms':>10} {'n':>6} {'MiB':>10}  event")
        for name, (ms, n, nbytes) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:topn]:
            print(f"{ms:10.3f} {n:6d} {nbytes / 2**20:10.2f}  {name}")
        return
    rows = summary["by_op"] if by_op else summary["kernels"]
    print(f"total device time: {total:.3f} ms in {sum(n for _, n in summary['kernels'].values())} events, "
          f"{len(rows)} distinct {'launching operators' if by_op else 'kernels'}")
    _table(rows, total, topn, "launching operator" if by_op else "kernel")
    if not by_op:
        print("\ncategory rollup:")
        _table(summary["categories"], total, len(summary["categories"]), "category")


def build_parser():
    ap = argparse.ArgumentParser(description="top device kernels of a torch.profiler Chrome trace")
    ap.add_argument("trace", help="trace.json, or the folder that holds it (logs/<name>/traces/<phase>)")
    ap.add_argument("topn", nargs="?", type=int, default=25)
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--by-op", action="store_true", help="roll device time up by the launching aten:: operator")
    group.add_argument("--copies", action="store_true", help="list the memcpy and memset events")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    summary = summarize(load_trace(args.trace))
    report(summary, args.topn, by_op=args.by_op, copies=args.copies)
    return summary


if __name__ == "__main__":
    main()
