"""The port's entry point on the CPU: ``dynamo_depth_torch.train.main`` runs
the four-phase curriculum on ``assets/tiny_kitti`` at 32x64, batch 1, two
steps per phase, and writes a checkpoint folder per phase, the last of which
the JAX package's ``Trainer`` loads through its ``load_model``."""

import json
import os.path as osp
import types

import jax
import numpy as np
import pytest

from dynamo_depth_torch import train as train_entry
from dynamo_depth_torch.models.model import MODULE_NAMES
from dynamo_depth_torch.training.trainer import PHASES
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.models.convert import convert_module
from dynamo_depth_tpu.training.trainer import Trainer as JTrainer
from torch_test_threads import two_torch_threads  # noqa: F401

ASSETS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "assets")
SEQ = "2011_09_26/2011_09_26_drive_0001_sync"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("curriculum")
    (root / "splits" / "tiny").mkdir(parents=True)
    for which in ("train", "val"):
        (root / "splits" / "tiny" / f"{which}_files.txt").write_text(
            "".join(f"{SEQ} {i} {s}\n" for i in (0, 1) for s in "lr"))
    argv = ["-d", "kitti", "-n", "tiny", "--data_path", osp.join(ASSETS, "tiny_kitti") + "/", "--split", "tiny",
            "--height", "32", "--width", "64", "-b", "1", "--weights_init", "scratch",
            "--epoch_schedules", "1", "1", "1", "1", "--epoch-size", "2", "--log_frequency", "1",
            "--log_dir", str(root / "logs"), "--num_workers", "1", "--print_opt", ""]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DYNAMO_SPLITS_DIR", str(root / "splits"))
        trainer = train_entry.main(argv, device="cpu")
    return types.SimpleNamespace(trainer=trainer, models=root / "logs" / "tiny" / "models")


def test_four_phases_write_four_checkpoint_folders(run):
    expected = {f"{m}.pth" for m in MODULE_NAMES} | {"adam.pth", "opt.json"}
    assert sorted(p.name for p in run.models.iterdir()) == sorted([f"{p}_00" for p in PHASES] + ["opt.json"])
    for phase in PHASES:
        assert {p.name for p in (run.models / f"{phase}_00").iterdir()} == expected, phase
    opt = json.loads((run.models / "opt.json").read_text())
    assert (opt["height"], opt["width"], opt["epoch_schedules"]) == (32, 64, [1, 1, 1, 1])


def test_every_phase_trained_and_validated(run):
    history = run.trainer.history
    for phase in PHASES:
        train = [h["scalars"] for h in history if h["mode"] == "train" and h["phase"] == phase]
        val = [h["scalars"] for h in history if h["mode"] == "val" and h["phase"] == phase]
        assert len(train) == len(val) == 2, phase
        assert all(np.isfinite(list(s.values())).all() for s in train + val), phase
        # Validation scores the depth against the fixture's LiDAR points.
        assert all(0 < s["de:abs_rel"] < 10 and 0 <= s["da:a1"] <= 1 for s in val), phase
    times = [h for h in history if h["mode"] == "time"]
    assert [h["phase"] for h in times] == [p for p in PHASES for _ in range(2)]
    assert run.trainer.g_step == 8


def test_the_jax_trainer_loads_the_last_folder(run):
    folder = str(run.models / "fine_tune_00")
    cfg = JConfig(dataset="kitti", height=32, width=64, batch_size=1, weights_init="scratch", num_devices=1,
                  load_ckpt=folder)
    variables = JTrainer(cfg).variables
    for m in MODULE_NAMES:
        sd = {k: v.numpy() for k, v in getattr(run.trainer.model, m).state_dict().items()}
        params, stats = convert_module(m, sd, cfg)
        for col, ref in (("params", params), ("batch_stats", stats)):
            if not ref:
                continue
            ref_leaves = dict(jax.tree_util.tree_leaves_with_path(ref))
            got_leaves = dict(jax.tree_util.tree_leaves_with_path(variables[col][m]))
            assert ref_leaves.keys() == got_leaves.keys(), (m, col)
            for k in ref_leaves:
                np.testing.assert_array_equal(np.asarray(got_leaves[k]), ref_leaves[k], err_msg=f"{m} {k}")


def test_profile_writes_a_trace_of_the_phase(run, tmp_path, monkeypatch):
    monkeypatch.setenv("DYNAMO_SPLITS_DIR", str(run.models.parents[2] / "splits"))
    argv = ["-d", "kitti", "-n", "prof", "--data_path", osp.join(ASSETS, "tiny_kitti") + "/", "--split", "tiny",
            "--height", "32", "--width", "64", "-b", "1", "--weights_init", "scratch",
            "--epoch_schedules", "0", "0", "0", "1", "--epoch-size", "1", "--log_dir", str(tmp_path),
            "--num_workers", "1", "--print_opt", "", "--profile"]
    train_entry.main(argv, device="cpu")
    trace = tmp_path / "prof" / "traces" / "fine_tune" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("train_step" in e.get("name", "") or "conv" in e.get("name", "") for e in events)
