"""The readings that a cell's check limits are set from, on the card:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 ... [--controls N] [--out FILE]

For each seed, in one process, every number of ``check.py`` for:

- sound runs, each against the reference: the program's first three steps;
  the program with ``cudnn.benchmark`` on, so that cuDNN picks its
  convolution algorithms by timing them and rounds otherwise; the reference
  again on the same inputs (the card's backward sums in another order each
  run); and the reference with every pixel of the first batch's frame-0
  ``color_aug`` image moved up by one ulp. Each stands for a sound change
  that alters float32 rounding, and the largest of them is the lower
  reading;
- for the first ``--controls`` seeds, the control and the faults, each put
  in the program's place: the reference with TF32 on (the nearest precision
  below the configuration's float32 with TF32 off), the reference on half
  of each batch, and the program's own bfloat16 network path.

One JSON line per seed and variant on standard output (and in ``--out``).
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from benchmark import check, inputs, program, spec
from benchmark.reference.model import DynamoModel

NUDGED = ("color_aug", 0, 0)


@contextlib.contextmanager
def cudnn_benchmark():
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


def nudged(batches: list) -> list:
    """The batches with every pixel of the first one's frame-0 ``color_aug``
    image one ulp higher."""
    out = [dict(b) for b in batches]
    image = out[0][NUDGED]
    out[0][NUDGED] = torch.nextafter(image, torch.full_like(image, 2.0))
    return out


def readings(cell, seeds, controls, device="cuda"):
    dev = torch.device(device)
    options, traffic = cell.options, cell.traffic
    with torch.device("meta"):
        layout = DynamoModel(depth_model=options["depth_model"], encoder_num_layers=options["encoder_num_layers"],
                             scales=tuple(options["scales"]), frame_ids=tuple(options["frame_ids"])).state_dict()
    trainers = {}

    def program_steps(variant, weights, batches, seed):
        opts = dict(options, compute_dtype="bfloat16") if variant == "program_bf16" else options
        if variant not in trainers:
            trainers[variant] = program.build(cell, seed, dev, weights, opts)
        trainer = trainers[variant]
        trainer.setup_phase(traffic["phase"], opts["epoch_size"])
        trainer.model.load_state_dict(weights)
        return program.first_steps(trainer, batches, inputs.generator(seed, "step", dev), program.CHECKED_STEPS)

    def line(seed, variant, snap, ref, weights, **extra):
        return {"seed": seed, "variant": variant, **check.compare(snap, ref, weights),
                "losses": [d["loss"] for d in snap.losses], **extra}

    for k, seed in enumerate(seeds):
        weights = inputs.draw_weights(layout, seed, dev)
        batches = inputs.make_batches(options, program.CHECKED_STEPS, seed, dev)
        t = time.perf_counter()
        prog = program_steps("program", weights, batches, seed)
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        ref = check.reference_steps(cell, weights, batches, prog.gen_states, dev)
        t_ref = time.perf_counter() - t
        yield line(seed, "program", prog, ref, weights, ref_losses=[d["loss"] for d in ref.losses],
                   program_s=t_prog, reference_s=t_ref)
        with cudnn_benchmark():
            other = program_steps("program", weights, batches, seed)
        yield line(seed, "program_cudnn_benchmark", other, ref, weights)
        other = check.reference_steps(cell, weights, batches, prog.gen_states, dev)
        yield line(seed, "reference_again", other, ref, weights)
        other = check.reference_steps(cell, weights, nudged(batches), prog.gen_states, dev)
        yield line(seed, "reference_nudged", other, ref, weights)
        if k >= controls:
            continue
        variants = {
            "control_tf32": lambda: check.reference_steps(cell, weights, batches, prog.gen_states, dev, use_tf32=True),
            "fault_half_batch": lambda: check.reference_steps(cell, weights, batches, prog.gen_states, dev,
                                                              rows=options["batch_size"] // 2),
            "program_bf16": lambda: program_steps("program_bf16", weights, batches, seed),
        }
        for name, make in variants.items():
            yield line(seed, name, make(), ref, weights)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3, help="seeds that also read the control and the faults")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    for line in readings(cell, args.seeds, args.controls):
        text = json.dumps({"workload": args.workload, **line})
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
