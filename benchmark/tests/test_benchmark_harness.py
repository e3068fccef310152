"""The harness finds every cell's and metric's files by name, refuses to
run without a card, and, driven on the CPU with the program's step broken
underneath, reports ``correct`` false for each fault a one-card training
cell can have."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import check, run, spec
from benchmark.tests.conftest import tiny_cell

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert set(cell.limits) == set(check.NUMBERS)
    assert cell.end_to_end and cell.per_layer
    assert cell.config["reduced"] == []


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric_reader(metric))


def test_config_files_are_named_by_their_entries():
    for c in BENCH["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            doc = json.load(f)
        assert doc["name"] == c["name"] and doc["source"] == c["source"] and doc["reduced"] == c["reduced"]


def test_command_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "2147483659",
                           "--seconds", "1", "--trace", "0"], cwd=spec.ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def _unchanged_state(trainer):
    """A step that computes its losses and returns the state unchanged."""
    def step(batch, generator, step):
        trainer.model.train()
        _, losses = trainer._forward_losses(trainer.process_inputs_device(batch), generator, step)
        return {k: v.detach() for k, v in losses.items()}
    trainer.train_step = step


def _half_batch(trainer):
    """A step that leaves out half of the batch: its mean is over the rest."""
    original = trainer.train_step

    def step(batch, generator, step):
        rows = next(iter(batch.values())).shape[0] // 2
        return original({k: v[:rows] for k, v in batch.items()}, generator, step)
    trainer.train_step = step


@pytest.mark.parametrize("fault", [None, _unchanged_state, _half_batch], ids=["sound", "unchanged_state", "half_batch"])
def test_a_broken_step_is_not_correct(host_timing, fault):
    cell = tiny_cell("litemono-kitti-b3", batch=4)
    result, compared = run.run_cell(cell, 2**31 + 11, 0.2, trace=False, device="cpu", patch=fault)
    assert compared, "no number is compared"
    assert result["correct"] is (fault is None), compared
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(result)[-1] == "check"


def test_traced_run_on_the_cpu_reads_no_device_metric(host_timing):
    result, _ = run.run_cell(tiny_cell("monodepthv2-kitti-b3"), 7, 0.2, trace=True, device="cpu")
    device_metrics = {m["name"] for m in BENCH["per_layer"] if m["source"] == "device_trace"}
    assert not device_metrics & set(result["metrics"])
    assert result["device"]["platform"] == "cpu" and result["device"]["busy_s"] == 0.0


@pytest.mark.parametrize("change,reads", [
    ({}, 0.0), ({"loss_term/d_ground": 0.75}, 0.25), ({"loss_term/p_photo": float("nan")}, check.NOT_FINITE),
], ids=["same", "one_term_off", "not_finite"])
def test_terms_gap_reads_the_worst_term(change, reads):
    ref = {"loss": 1.0, "loss_term/p_photo": 2.0, "loss_term/d_ground": 1.0, "loss_term/m_smooth": 0.001}
    prog = dict(ref, **change)
    assert min(max(check._term_gaps(prog, ref)), check.NOT_FINITE) == pytest.approx(reads)


def test_a_term_the_program_lacks_is_not_finite():
    assert check._term_gaps({"loss": 1.0}, {"loss": 1.0, "loss_term/d_ground": 0.5}) == [float("inf")]


def test_nudge_moves_one_image_by_one_ulp():
    from benchmark import calibrate, inputs
    from benchmark.tests.conftest import TINY

    opts = dict(spec.load_cell("litemono-kitti-b3").options, batch_size=2, **TINY)
    batches = inputs.make_batches(opts, 2, 5, "cpu")
    out = calibrate.nudged(batches)
    image = batches[0][calibrate.NUDGED]
    assert torch.equal(out[0][calibrate.NUDGED], torch.nextafter(image, torch.full_like(image, 2.0)))
    assert bool((out[0][calibrate.NUDGED] > image).all())
    assert all(out[0][k] is v for k, v in batches[0].items() if k != calibrate.NUDGED)
    assert out[1] == batches[1]


@pytest.mark.cuda
def test_control_on_the_card_fails_where_the_program_passes():
    """On the card, at the cell's own size: the program's first steps meet
    every limit, and the TF32 control fails one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from benchmark import calibrate

    cell = spec.load_cell("litemono-kitti-b3")
    lines = {d["variant"]: d for d in calibrate.readings(cell, [2**31 + 3], controls=1)}
    limits = {k: v for k, v in cell.limits.items() if v is not None}
    assert all(lines["program"][k] <= v for k, v in limits.items()), lines["program"]
    assert any(lines["control_tf32"][k] > v for k, v in limits.items()), lines["control_tf32"]
