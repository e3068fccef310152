"""The port's checkpoints: per-module ``.pth`` folders in the reference's
layout, on the CPU. Round trip, a missing module, a partial load, the
height/width warning, the JAX package reading the port's folder, and an
``adam.pth`` resume that gives the step an uninterrupted run gives."""

import types

import jax
import numpy as np
import pytest
import torch

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.models.model import MODULE_NAMES, DynamoModel
from dynamo_depth_torch.training import checkpoint as ckpt
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_tpu.models.convert import convert_module, convert_torch_checkpoint
from torch_test_threads import two_torch_threads  # noqa: F401

H, W = 32, 64
KW = dict(dataset="kitti", height=H, width=W, batch_size=2, weights_init="scratch")


def _model(seed):
    torch.manual_seed(seed)
    return DynamoModel(drop_path_rate=0.0)


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_round_trip(tmp_path):
    src, dst = _model(0), _model(1)
    ckpt.save_model(src, str(tmp_path), height=H, width=W)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(f"{m}.pth" for m in MODULE_NAMES)  # written whole: no temporary file left
    ckpt.load_model(dst, str(tmp_path), height=H, width=W)
    _assert_same_state(src, dst)
    # Encoder files carry the training size, as the reference writes them.
    for m in MODULE_NAMES:
        sd = torch.load(tmp_path / f"{m}.pth", weights_only=True)
        assert ((sd.get("height"), sd.get("width")) == (H, W)) == m.endswith("_enc"), m


def test_missing_module_is_skipped(tmp_path, capsys):
    src, dst = _model(0), _model(1)
    before = {k: v.clone() for k, v in dst.pose_dec.state_dict().items()}
    ckpt.save_model(src, str(tmp_path), height=H, width=W)
    (tmp_path / "pose_dec.pth").unlink()
    ckpt.load_model(dst, str(tmp_path), height=H, width=W)
    assert "Loading pose_dec weights... FAILED :: Path" in capsys.readouterr().out
    for k, v in dst.pose_dec.state_dict().items():
        assert torch.equal(v, before[k]), k
    for m in MODULE_NAMES:
        if m != "pose_dec":
            _assert_same_state(getattr(src, m), getattr(dst, m))


def test_partial_load_on_mismatch(tmp_path, capsys):
    src, dst = _model(0), _model(1)
    ckpt.save_model(src, str(tmp_path), height=H, width=W)
    sd = torch.load(tmp_path / "motion_dec.pth", weights_only=True)
    wrong = next(k for k, v in sd.items() if k.endswith("weight") and v.ndim == 4)
    sd[wrong] = torch.zeros(1, 2, 3)  # another shape
    sd["not_a_key"] = torch.zeros(2)
    torch.save(sd, tmp_path / "motion_dec.pth")
    keep = dst.motion_dec.state_dict()[wrong].clone()
    ckpt.load_model(dst, str(tmp_path), height=H, width=W)
    out = capsys.readouterr().out
    assert "Loading motion_dec weights... PARTIAL ::" in out
    n = len(dst.motion_dec.state_dict())
    assert f"{n - 1} matched, 2 skipped" in out
    loaded = dst.motion_dec.state_dict()
    assert torch.equal(loaded[wrong], keep)
    for k, v in src.motion_dec.state_dict().items():
        if k != wrong:
            assert torch.equal(loaded[k], v), k


def test_height_width_warning(tmp_path, capsys):
    ckpt.save_model(_model(0), str(tmp_path), height=H, width=W)
    ckpt.load_model(_model(1), str(tmp_path), height=H, width=W)
    assert "WARNING" not in capsys.readouterr().out
    ckpt.load_model(_model(1), str(tmp_path), height=2 * H, width=W)
    assert f"|- === WARNING: opt ({2 * H},{W}) != loaded ({H},{W})" in capsys.readouterr().out


def test_the_jax_package_reads_the_ports_folder(tmp_path):
    model = _model(0)
    ckpt.save_model(model, str(tmp_path), height=H, width=W)
    cfg = types.SimpleNamespace(depth_model="litemono", scales=[0, 1, 2], encoder_num_layers=18)
    got = convert_torch_checkpoint(str(tmp_path), {}, cfg, verbose=False)
    for m in MODULE_NAMES:
        sd = {k: v.numpy() for k, v in getattr(model, m).state_dict().items()}
        params, stats = convert_module(m, sd, cfg)
        for col, ref in (("params", params), ("batch_stats", stats)):
            if not ref:
                assert m not in got.get(col, {})
                continue
            ref_leaves = dict(jax.tree_util.tree_leaves_with_path(ref))
            got_leaves = dict(jax.tree_util.tree_leaves_with_path(got[col][m]))
            assert ref_leaves.keys() == got_leaves.keys(), (m, col)
            for k in ref_leaves:
                np.testing.assert_array_equal(np.asarray(got_leaves[k]), ref_leaves[k], err_msg=f"{m} {k}")


def _step(trainer, seed, step):
    batch = trainer.to_device(synthetic_batch(trainer.cfg, 2, H, W, seed=seed))
    return trainer.train_step(batch, torch.Generator().manual_seed(seed), step)


@pytest.mark.parametrize("phase", ["fine_tune", "motion_init"])
def test_adam_resume_gives_the_uninterrupted_step(tmp_path, phase):
    def trainer(**kw):
        return Trainer(TConfig(**KW, **kw), device="cpu", phase=phase, steps_per_epoch=4, drop_path_rate=0.0)

    whole = trainer()
    _step(whole, 1, 0)
    _step(whole, 2, 1)

    first = trainer()
    _step(first, 1, 0)
    folder = str(tmp_path / f"{phase}_00")
    ckpt.save_model(first.model, folder, height=H, width=W)
    ckpt.save_opt_state(first.optimizer, folder)

    resumed = trainer(load_ckpt=folder)
    resumed.load_optimizer(folder)
    assert resumed.opt_steps == 1
    _step(resumed, 2, 1)
    _assert_same_state(whole.model, resumed.model)
    # Without the optimizer state the second step is Adam's first again.
    fresh = trainer(load_ckpt=folder)
    _step(fresh, 2, 1)
    diff = [k for k, v in whole.model.state_dict().items() if not torch.equal(v, fresh.model.state_dict()[k])]
    assert any(k.startswith("motion_dec.") for k in diff)
