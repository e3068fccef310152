"""Decide ``correct``: hold what the program's first steps left against the
plain reference's, run from the same weights, batches and generator states.

The numbers (each a relative gap, 0 where the two agree); a leaf's gap is
the gap between the program's norm of it and the reference's, over the
larger of the reference's norm of that leaf and of the median leaf:

- ``loss0_gap``: the first step's total loss, ``|program - reference| /
  |reference|``;
- ``terms0_gap``: the first step's loss terms (every other entry of the
  losses dict: each term summed over the scales, each scale's weighted sum,
  each coefficient), by the worst term, ``|program - reference|`` over the
  larger of the reference's ``|term|`` and of the median term's; a term
  the program does not return reads as not finite;
- ``grad_gap``: the first gradient (the program's as Adam took it), by the
  worst leaf; ``grad_median``, the same by the median leaf;
- ``change_median``: the parameters' change over the three steps, by the
  median leaf. A leaf whose reference gradient lies under a thousandth of
  the median leaf's moves under Adam by round-off alone and is left out; one
  the reference leaves unmoved must stay unmoved (else the gap is 1);
- ``stats0_gap``: the BatchNorm running statistics' change in the first
  step, by the worst buffer;
- ``loss_gap``, the worst of the three steps' total losses; ``terms_gap``,
  the worst term of the three steps; ``change_gap``, the change by the worst
  leaf; ``stats_gap``, the statistics after three steps by the worst buffer.

A number is compared where ``workloads/<cell>.json`` gives it a limit; the
others are printed beside them (PERF.md gives why: a sound change of float32
rounding moves them as far as the control does). Every gap is read only
after the window has closed.
"""

from __future__ import annotations

import contextlib
import math

import torch

from benchmark.program import CHECKED_STEPS, Snapshot, as_floats, running_stats
from benchmark.reference.step import ReferenceStep

NUMBERS = ("loss0_gap", "terms0_gap", "grad_gap", "grad_median", "change_median", "stats0_gap", "loss_gap", "terms_gap",
           "change_gap", "stats_gap")
# A leaf whose reference gradient norm is below this share of the median
# leaf's is left out of the change numbers.
NOUGHT_GRADIENT = 1e-3
_STATS = ("running_mean", "running_var")
NOT_FINITE = 1e300


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 in cuBLAS and cuDNN on or off, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reference_steps(cell, weights: dict, batches: list, gen_states: list, device, *, use_tf32=False,
                    rows=None, flop_counter=None) -> Snapshot:
    """The reference's first ``CHECKED_STEPS`` steps, in float32 with TF32
    off (on under ``use_tf32``: the control). ``rows`` keeps only the first
    rows of every batch (a fault: half of the batch left out).
    ``flop_counter``, a ``FlopCounterMode``, counts the first step."""
    options = dict(cell.options)
    if rows is not None:
        batches = [{k: v[:rows] for k, v in b.items()} for b in batches]
        options["batch_size"] = rows
    ref = ReferenceStep(options, cell.traffic["phase"], options["epoch_size"], cell.config["drop_path_rate"], device)
    ref.model.load_state_dict(weights)
    gen = torch.Generator(device=device)
    snap = Snapshot()
    with tf32(use_tf32):
        for i in range(CHECKED_STEPS):
            gen.set_state(gen_states[i])
            counting = flop_counter if (i == 0 and flop_counter is not None) else contextlib.nullcontext()
            with counting:
                losses = ref.step(batches[i % len(batches)], gen, i)
            snap.losses.append(as_floats(losses))
            if i == 0:
                names = {id(p): n for n, p in ref.model.named_parameters()}
                snap.grads = {names[id(p)]: None if p.grad is None else p.grad.detach().clone()
                              for p in ref.model.parameters()}
                snap.stats0 = running_stats(ref.model)
    snap.after = {k: v.detach().clone() for k, v in ref.model.state_dict().items()}
    del ref
    return snap


def _norm(t) -> float:
    return 0.0 if t is None else float(torch.linalg.vector_norm(t.double()))


def _leaf_gaps(program: dict, reference: dict) -> list:
    """Per leaf, |program norm - reference norm| / max(reference norm,
    median reference norm)."""
    if not reference:
        return [0.0]
    med = _median(list(reference.values()))
    return [abs(program.get(k, 0.0) - r) / max(r, med, 1e-30) for k, r in reference.items()]


def _median(values: list) -> float:
    return sorted(values)[len(values) // 2]


def _term_gaps(program: dict, reference: dict) -> list:
    """Per loss term but the total, |program - reference| / max(|reference|,
    median |reference|); inf where the program lacks the term or reads a
    number that is not finite."""
    ref = {k: v for k, v in reference.items() if k != "loss"}
    if not ref:
        return [0.0]
    med = _median([abs(v) for v in ref.values()])
    return [abs(program[k] - r) / max(abs(r), med, 1e-30) if math.isfinite(program.get(k, math.inf)) else math.inf
            for k, r in ref.items()]


def compare(program: Snapshot, reference: Snapshot, weights: dict) -> dict:
    """The numbers of the module's docstring, program against reference."""
    loss_gaps = [abs(p["loss"] - r["loss"]) / max(abs(r["loss"]), 1e-30) if math.isfinite(p["loss"]) else math.inf
                 for p, r in zip(program.losses, reference.losses)]
    term_gaps = [max(_term_gaps(p, r)) for p, r in zip(program.losses, reference.losses)]
    ref_grads = {k: _norm(g) for k, g in reference.grads.items() if g is not None}
    grad = _leaf_gaps({k: _norm(program.grads.get(k)) for k in ref_grads}, ref_grads)
    med_grad = _median(list(ref_grads.values())) if ref_grads else 0.0

    def change(snap, key):
        return _norm(snap.after[key].double() - weights[key].double())

    moved, unmoved_gap = {}, 0.0
    for key, g in reference.grads.items():
        if g is None:
            # The reference leaves this leaf as it is: so must the program.
            unmoved_gap = max(unmoved_gap, 1.0 if change(program, key) > 0 else 0.0)
        elif ref_grads[key] >= NOUGHT_GRADIENT * med_grad:
            moved[key] = change(reference, key)
    changes = _leaf_gaps({k: change(program, k) for k in moved}, moved)
    ref_stats = {k: change(reference, k) for k in reference.after if k.endswith(_STATS)}
    stats = _leaf_gaps({k: change(program, k) for k in ref_stats}, ref_stats)
    ref_stats0 = {k: _norm(v.double() - weights[k].double()) for k, v in reference.stats0.items()}
    stats0 = _leaf_gaps({k: _norm(program.stats0[k].double() - weights[k].double()) for k in ref_stats0}, ref_stats0)
    out = {"loss0_gap": loss_gaps[0], "terms0_gap": term_gaps[0], "grad_gap": max(grad), "grad_median": _median(grad),
           "change_median": max(unmoved_gap, _median(changes)), "stats0_gap": max(stats0), "loss_gap": max(loss_gaps),
           "terms_gap": max(term_gaps), "change_gap": max(unmoved_gap, max(changes)), "stats_gap": max(stats)}
    # A gap that is not finite reads as the largest number JSON carries.
    return {k: (v if math.isfinite(v) else NOT_FINITE) for k, v in out.items()}


def verdict(numbers: dict, limits: dict):
    """-> (correct, {name: {"value", "limit"}} of the numbers compared). A
    number that is not finite fails."""
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS if limits.get(k) is not None}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    return correct, compared
