"""What each span of the program's training step costs, in one cell:

    python3 -m benchmark.span_table --workload <cell> --seed <n> [--spanned 20] [--save-trace <file.json.gz>]

Set-up as ``benchmark.run`` has it: weights and a ring of batches from the
seed, the cell's warm-up steps. Then ``--spanned`` steps with the program's
span recorder on (``dynamo_depth_torch/utils/spans.py``), in blocks of five
that alternate with blocks of as many steps with it off, each call timed on
the host clock: the recorded host times and the recorder's cost. Then the
cell's profiled steps under ``torch.profiler`` (``program.profiled_steps``),
read by ``spans.program_view``. Standard error gets one line per span, per
step: host ms (recorder), device ms and launches (trace, forward and the
backward mapped to it), blocking calls, and the card's idle ms before its
launches; standard output gets the result as one JSON object, last. Needs a
CUDA card; no output check runs.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import statistics
import sys
import time

from benchmark import spec
from benchmark.run import CACHE_DIRS, forbidden_loaded

BLOCK = 5


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--spanned", type=int, default=20, help="steps with the recorder on, as many with it off")
    ap.add_argument("--save-trace", default=None, help="write the profiled steps' Chrome trace here, gzipped")
    return ap


def _timed(trainer, batches, gen, first: int, count: int) -> list:
    """Host ms of each of ``count`` ``train_step`` calls, back to back."""
    out = []
    for k in range(count):
        a = time.perf_counter()
        trainer.train_step(batches[(first + k) % len(batches)], gen, first + k)
        out.append(1e3 * (time.perf_counter() - a))
    return out


def measure(cell: spec.Cell, seed: int, spanned: int, device: str = "cuda") -> tuple:
    """-> (the result object, the profiled steps' Chrome trace)."""
    import torch

    from benchmark import inputs, program
    from benchmark import spans as sp
    from benchmark import trace as tr
    from benchmark.reference.model import DynamoModel
    from benchmark.run import PROFILE_TRIES
    from dynamo_depth_torch.utils import spans as program_spans

    dev = torch.device(device)
    options, traffic = cell.options, cell.traffic
    with torch.device("meta"):
        layout = DynamoModel(depth_model=options["depth_model"], encoder_num_layers=options["encoder_num_layers"],
                             scales=tuple(options["scales"]), frame_ids=tuple(options["frame_ids"])).state_dict()
    weights = inputs.draw_weights(layout, seed, dev)
    batches = inputs.make_batches(options, traffic["ring"], seed, dev)
    gen = inputs.generator(seed, "step", dev)
    trainer = program.build(cell, seed, dev, weights)
    step = traffic["warmup_steps"]
    program.first_steps(trainer, batches, gen, step)

    on, off, recorded = [], [], []
    for block in range(0, spanned, BLOCK):
        n = min(BLOCK, spanned - block)
        for recording in ((False, True) if block // BLOCK % 2 == 0 else (True, False)):
            if recording:
                with program_spans.recording() as rec:
                    on += _timed(trainer, batches, gen, step, n)
                base = len(recorded)
                recorded += [s._replace(parent=s.parent + base if s.parent >= 0 else -1) for s in rec]
            else:
                off += _timed(trainer, batches, gen, step, n)
            step += n

    chrome = None
    for _ in range(PROFILE_TRIES):
        chrome = program.profiled_steps(trainer, batches, gen, step, traffic["profiled_steps"])
        if dev.type != "cuda" or tr.device_events(chrome):
            break
        step += traffic["profiled_steps"] + 1

    host = sp.recorded_view(recorded)
    view = sp.program_view(chrome)
    blocking = {}
    for b in view["blocking"] if view else ():
        blocking.setdefault(str(b.span), {}).setdefault(b.name, 0)
        blocking[str(b.span)][b.name] += 1
    result = {
        "workload": cell.name, "seed": seed,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "host_ms_per_step": {"recorder_on": statistics.fmean(on), "recorder_off": statistics.fmean(off),
                             "on": on, "off": off},
        "recorded": host,
        "trace": None if view is None else dict({k: v for k, v in view.items() if k != "blocking"},
                                                 blocking=blocking),
        "metrics": None if view is None else {
            "dispatch.syncs_per_step": view["syncs"],
            "synthesis_losses.device_ms_per_step": sp.synthesis_losses_device_ms(view),
            "synthesis_losses.host_ms_per_step": sp.host_ms(host, ("dynamo.view_synthesis", "dynamo.losses")),
            "optimizer.host_ms_per_step": sp.host_ms(host, ("dynamo.optimizer",)),
        },
    }
    return result, chrome


def lines(result: dict) -> list:
    """One line per span: host ms and self ms (recorder), device ms,
    launches, blocking calls and idle ms before its launches (trace)."""
    view = result["trace"] or {"spans": {}}
    names = sorted(set(result["recorded"]) | set(view["spans"]))
    out = []
    for name in names:
        h = result["recorded"].get(name, {})
        t = view["spans"].get(name, {})
        out.append(f"span {name} host_ms {h.get('host_ms')!r} self_ms {h.get('self_ms')!r} "
                   f"device_ms {t.get('device_ms', 0.0)!r} launches {t.get('launches', 0.0)!r} "
                   f"syncs {t.get('syncs', 0.0)!r} idle_ms {t.get('idle_ms', 0.0)!r}")
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cell = spec.load_cell(args.workload)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(spec.ROOT / rel)
    import torch

    if not torch.cuda.is_available():
        print("span_table: needs a CUDA card; this machine has none: no result", file=sys.stderr)
        return 2
    result, chrome = measure(cell, args.seed, args.spanned)
    loaded = forbidden_loaded()
    if loaded:
        print(f"span_table: the run loaded {', '.join(loaded)}: no result", file=sys.stderr)
        return 3
    if args.save_trace:
        with gzip.open(args.save_trace, "wt") as f:
            json.dump(chrome, f)
    for line in lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
