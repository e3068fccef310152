"""The benchmark's one command:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the program's ``Trainer`` for the cell, loads weights drawn
from the seed, and runs its first steps on a ring of synthetic batches kept
on the card: the first three are snapshotted for the output check, and all
of them warm up the cell's shapes. The window then runs ``train_step`` back
to back for ``--seconds`` on the host clock, with a CUDA event after each
step, and ends in one synchronize. ``--trace 1`` then profiles a few more
steps. Once the window has closed and the program is freed, the frozen
reference runs the first three steps again from the same inputs
(``check.py``). The last line of standard output is the result as one JSON
object; the numbers the check compared are the last lines of standard error.
"""

T_START = __import__("time").perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

from benchmark import spec  # noqa: E402

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "dynamo_depth_tpu")
# The profiler on the card's machine now and then returns a run without its
# kernels: such a run is profiled again.
PROFILE_TRIES = 3
# Build and kernel caches, at fixed paths inside the checkout.
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": "build/benchmark/torch_extensions",
    "TRITON_CACHE_DIR": "build/benchmark/triton",
    "CUDA_CACHE_PATH": "build/benchmark/cuda_cache",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the timed window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def forbidden_loaded() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda", patch=None) -> tuple:
    """One run of ``cell``; -> (the result object, the compared numbers).
    ``patch(trainer)``, where given, is applied to the program's step before
    its first step (the harness's own tests break it so)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark import check, inputs, program
    from benchmark import trace as tr
    from benchmark.reference.model import DynamoModel

    dev = torch.device(device)
    options, traffic = cell.options, cell.traffic
    with torch.device("meta"):
        layout = DynamoModel(depth_model=options["depth_model"], encoder_num_layers=options["encoder_num_layers"],
                             scales=tuple(options["scales"]), frame_ids=tuple(options["frame_ids"])).state_dict()
    weights = inputs.draw_weights(layout, seed, dev)
    batches = inputs.make_batches(options, traffic["ring"], seed, dev)
    gen = inputs.generator(seed, "step", dev)

    trainer = program.build(cell, seed, dev, weights)
    if patch is not None:
        patch(trainer)
    warmup = traffic["warmup_steps"]
    snap = program.first_steps(trainer, batches, gen, warmup)
    setup_s = time.perf_counter() - T_START

    window = program.timed_window(trainer, batches, gen, warmup, seconds)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    chrome = None
    if trace:
        first = warmup + window.steps
        for _ in range(PROFILE_TRIES):
            chrome = program.profiled_steps(trainer, batches, gen, first, traffic["profiled_steps"])
            if dev.type != "cuda" or tr.device_events(chrome):
                break
            first += traffic["profiled_steps"] + 1
    del trainer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    flops = FlopCounterMode(display=False) if trace else None
    ref = check.reference_steps(cell, weights, batches, snap.gen_states, dev, flop_counter=flops)
    numbers = check.compare(snap, ref, weights)
    correct, compared = check.verdict(numbers, cell.limits)
    correct = correct and window.failed == 0

    card = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(peak)}
    limit = power_limit() if dev.type == "cuda" else "cpu"
    B = options["batch_size"]
    print(f"window: {window.steps} steps of batch {B} in {window.seconds:.6f} s; set-up {setup_s:.3f} s; "
          f"peak {peak} bytes; card {limit}", file=sys.stderr)
    record = tr.make_record(window=window, setup_s=setup_s, shape=(B, 3, options["height"], options["width"]),
                            device={"name": card["kind"], "power_limit": limit}, trace=chrome,
                            steps=traffic["profiled_steps"] if trace else 0,
                            flops_per_step=flops.get_total_flops() if trace else None)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.metric_reader(m["name"])(record)
        if value is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        card["busy_s"], card["window_s"] = tr.busy_and_window(record)
        print(f"flops per step {record['flops_per_step']}; profiled steps {record['profiled_steps']}; "
              f"device events {len(record['device_events'])}", file=sys.stderr)
    result = {"correct": bool(correct), "attempted": window.steps, "failed": window.failed, "metrics": metrics,
              "device": card}
    if trace:
        result["breakdown"] = tr.breakdown(record)
    for name in check.NUMBERS:
        if name not in compared:
            print(f"not compared: {name} {numbers[name]!r}", file=sys.stderr)
    result["check"] = compared
    return result, compared


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.load_cell(args.workload, bench)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(spec.ROOT / rel)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); this machine has {found}: no result",
              file=sys.stderr)
        return 2
    result, compared = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_loaded()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}: no result", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
