"""The port's ``bench/grad_compare.py`` against the JAX package's
``scripts/grad_compare.py``, on the CPU at 32x64, batch 2, ``motion_init``.

Both scripts take one step from the same weights (the port's seed-0 model,
carried into the JAX ``Trainer`` by the JAX package's converter in place of
its own initialisation) on the same synthetic batch. Drop-path is off on
both sides, and the RANSAC hypotheses the JAX step draws from the script's
key are handed to the port, as ``test_torch_train_step.py`` does. The port's
JSON has the JAX script's keys and goes through the JAX script's ``--diff``.
"""

import argparse
import io
import json
from contextlib import redirect_stdout

import jax
import pytest
import torch

import scripts.grad_compare as jgc
from dynamo_depth_torch.bench import grad_compare as tgc
from dynamo_depth_torch.models.layers import DropPath
from dynamo_depth_torch.ops import ground_plane as t_ground_plane
from dynamo_depth_torch.training import losses as t_losses
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.models import layers as j_layers
from dynamo_depth_tpu.training.trainer import Trainer as JTrainer
from test_torch_train_step import _jax_draws
from test_torch_train_vis import _carried_variables
from torch_test_threads import two_torch_threads  # noqa: F401

SIZE = ["--height", "32", "--width", "64", "--batch_size", "2"]
# motion_init: the JAX script's step compiles in ~35 s here, fine_tune's in ~90.
PHASE = "motion_init"


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    out = tmp_path_factory.mktemp("grad_compare")
    port_args = tgc.build_parser().parse_args(["--device", "cpu", "--phase", PHASE, "--out", str(out / "port.json"), *SIZE])
    jax_args = argparse.Namespace(platform="cpu", phase=PHASE, depth_model="litemono", height=32, width=64,
                                  batch_size=2, compute_dtype="float32", step_in_phase=50, data_path=None,
                                  out=str(out / "jax.json"))
    jcfg = JConfig(dataset="kitti", height=32, width=64, batch_size=2)
    carried = {}

    def setup(trainer):
        for m in trainer.model.modules():
            if isinstance(m, DropPath):
                m.rate = 0.0
        carried["variables"] = _carried_variables(trainer.model, jcfg)  # the seed-0 weights, before the step

    # The port's draws: the JAX step's, from the key the JAX script passes
    # (folded with the device index by its shard_map step).
    noise, indices = _jax_draws(jcfg, PHASE, jax.random.fold_in(jax.random.PRNGKey(123), 0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_ground_plane, "draw_sample_idx", lambda *a, **k: torch.tensor(indices.pop(0)))
        mp.setattr(t_losses, "draw_automask_noise", lambda *a, **k: torch.tensor(noise.pop(0)))
        port = tgc.run(port_args, setup=setup)
    assert not indices and not noise
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DYNAMO_FORCE_PLATFORM", "cpu")  # what the JAX script sets for --platform cpu
        mp.setattr(j_layers.DropPath, "__call__", lambda self, x, train=False: x)
        mp.setattr(JTrainer, "_init_variables", lambda self: carried["variables"])
        jgc.run(jax_args)
    return port, json.loads((out / "jax.json").read_text()), out


def test_the_port_writes_the_jax_scripts_keys(dumps):
    port, ref, out = dumps
    assert json.loads((out / "port.json").read_text()) == port
    assert port.keys() == ref.keys() == {"platform", "phase", "losses", "update_norms"}
    assert port["platform"] == "cpu" and port["phase"] == ref["phase"] == PHASE
    assert port["losses"].keys() == ref["losses"].keys()
    assert port["update_norms"].keys() == ref["update_norms"].keys()
    text = io.StringIO()
    with redirect_stdout(text):
        jgc.diff([str(out / "jax.json"), str(out / "port.json")])
    lines = text.getvalue().splitlines()
    assert lines[0].split()[1:3] == ["cpu", "cpu"]
    assert len(lines) == 1 + len(ref["losses"]) + len(ref["update_norms"])
    mine = io.StringIO()
    with redirect_stdout(mine):
        tgc.diff([str(out / "jax.json"), str(out / "port.json")])
    assert mine.getvalue() == text.getvalue()


def test_losses_and_update_norms_match_the_jax_script(dumps):
    port, ref, _ = dumps
    for k, v in ref["losses"].items():
        # test_torch_train_step.py's tolerance for the loss terms.
        assert port["losses"][k] == pytest.approx(v, rel=1e-4, abs=1e-7), k
    for k, v in ref["update_norms"].items():
        # Adam's first step moves each weight by ~lr * sign(g): the norm
        # counts the weights, and the few whose gradient round-off flips
        # (test_torch_train_step.py: at least half of each module's entries
        # agree to 1e-3, most of the rest sit near a zero of the gradient)
        # move it by little.
        assert v > 0 and port["update_norms"][k] == pytest.approx(v, rel=1e-4), k  # found 1.9e-5
