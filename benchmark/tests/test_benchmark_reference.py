"""The frozen reference takes one ``fine_tune`` step as the program's plain
CPU path does, at 64x96 and batch 2, for both configurations: this ties the
copy to the program that tier-1 holds against the JAX package. The only
test that holds the reference beside the program."""

import pytest
import torch

from benchmark import inputs, program
from benchmark.reference.model import DynamoModel
from benchmark.reference.step import ReferenceStep
from benchmark.tests.conftest import tiny_cell


@pytest.mark.parametrize("name", ["litemono-kitti-b3", "monodepthv2-kitti-b3"])
def test_reference_step_is_the_programs_plain_step(name):
    cell = tiny_cell(name)
    options, seed, dev = cell.options, 2**31 + 5, torch.device("cpu")
    with torch.device("meta"):
        layout = DynamoModel(depth_model=options["depth_model"], scales=tuple(options["scales"])).state_dict()
    weights = inputs.draw_weights(layout, seed, dev)
    batch = inputs.make_batches(options, 1, seed, dev)[0]
    trainer = program.build(cell, seed, dev, weights)
    ref = ReferenceStep(options, "fine_tune", options["epoch_size"], cell.config["drop_path_rate"], dev)
    ref.model.load_state_dict(weights)

    prog_losses = trainer.train_step(batch, inputs.generator(seed, "step", dev), 0)
    ref_losses = ref.step(batch, inputs.generator(seed, "step", dev), 0)

    assert prog_losses.keys() == ref_losses.keys()
    for key, v in ref_losses.items():
        torch.testing.assert_close(prog_losses[key], v, rtol=1e-6, atol=1e-9, msg=key)
    grads = program.first_gradient(trainer)
    for key, p in ref.model.named_parameters():
        if p.grad is None:
            assert grads[key] is None, key
        else:
            torch.testing.assert_close(grads[key], p.grad, rtol=1e-5, atol=1e-6 * float(p.grad.abs().max()), msg=key)
    after = trainer.model.state_dict()
    assert after.keys() == ref.model.state_dict().keys()
    for key, v in ref.model.state_dict().items():
        # Adam's first update is lr * sign(g) where g is well above its
        # round-off: 1e-9 of a 5e-5 step is the two formulas' rounding.
        torch.testing.assert_close(after[key], v, rtol=1e-6, atol=1e-9, msg=key)
