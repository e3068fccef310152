"""The port's ``Trainer.train_step`` at Monodepth2's ResNet-50 configuration
against the benchmark's frozen plain-PyTorch reference
(``benchmark/reference/step.py``), on the CPU.

The cell ``monodepthv2-r50-kitti-b12`` cut to 64x128 and batch 2, in the
phases ``fine_tune`` (all seven networks) and ``disp_init`` (depth and pose,
the automask): weights drawn from the seed by ``benchmark.inputs``, three
steps through ``benchmark.program.first_steps``, and the numbers that
``benchmark/check.py`` compares on the card. A reference that leaves out
half of each batch has to fail.
"""

import dataclasses

import pytest
import torch

from benchmark import check, inputs, program, spec
from benchmark.reference.model import DynamoModel
from torch_test_threads import two_torch_threads  # noqa: F401

CELL = "monodepthv2-r50-kitti-b12"
SEED = 2**31 + 23
# Both sides run the same float32 equations on the CPU, in another order
# of operations here and there (the fused loss terms, Adam's foreach
# update). Readings at SEED (fine_tune / disp_init) and the half-batch
# reference's (fine_tune / disp_init):
# - grad_median, the first gradient of the median leaf: 7.6e-9 / 7.1e-9,
#   round-off of a float32 sum; half batch 0.12 / 0.39;
# - change_median, the parameters' change over three steps: 1.2e-4 /
#   3.2e-5, as Adam's first updates are lr * sign(g) and its later ones
#   divide by square roots of small moments, which magnify round-off;
#   half batch 0.023 / 0.030;
# - stats0_gap, BatchNorm's running statistics after the first step: 0,
#   bit-equal (the same batch moments in the same order); half batch 0.26 /
#   0.23.
# Each limit lies an order of magnitude above its reading and below the
# fault's.
LIMITS = {"grad_median": 1e-6, "change_median": 2e-3, "stats0_gap": 1e-6}


def _cell(phase: str) -> spec.Cell:
    cell = spec.load_cell(CELL)
    config = dict(cell.config, options=dict(cell.config["options"], height=64, width=128))
    return dataclasses.replace(cell, config=config, traffic=dict(cell.traffic, batch_size=2, phase=phase))


@pytest.fixture(scope="module", params=["fine_tune", "disp_init"])
def stepped(request):
    """(cell, weights, batches, the program's snapshot of its first three
    steps) of one phase."""
    cell, dev = _cell(request.param), torch.device("cpu")
    options = cell.options
    assert options["encoder_num_layers"] == 50
    with torch.device("meta"):
        layout = DynamoModel(depth_model=options["depth_model"], encoder_num_layers=options["encoder_num_layers"],
                             scales=tuple(options["scales"]), frame_ids=tuple(options["frame_ids"])).state_dict()
    weights = inputs.draw_weights(layout, SEED, dev)
    batches = inputs.make_batches(options, program.CHECKED_STEPS, SEED, dev)
    trainer = program.build(cell, SEED, dev, weights)
    snap = program.first_steps(trainer, batches, inputs.generator(SEED, "step", dev), program.CHECKED_STEPS)
    return cell, weights, batches, snap


def _numbers(stepped, rows=None) -> dict:
    cell, weights, batches, snap = stepped
    ref = check.reference_steps(cell, weights, batches, snap.gen_states, torch.device("cpu"), rows=rows)
    numbers = check.compare(snap, ref, weights)
    return {k: numbers[k] for k in LIMITS}


def test_resnet50_step_matches_the_reference(stepped):
    cell, _, _, snap = stepped
    assert snap.grads and any(g is not None for g in snap.grads.values())
    if cell.traffic["phase"] == "disp_init":  # the motion nets take no step there
        assert all(g is None for k, g in snap.grads.items() if k.startswith(("motion_enc", "motion_dec", "motion_mask")))
    numbers = _numbers(stepped)
    assert all(numbers[k] <= v for k, v in LIMITS.items()), numbers


def test_resnet50_half_batch_reference_fails(stepped):
    numbers = _numbers(stepped, rows=1)
    assert any(numbers[k] > v for k, v in LIMITS.items()), numbers
