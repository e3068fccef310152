"""The port's training visualisation against the JAX package's, on the CPU,
with a recording stand-in for wandb in both packages.

LiteMono at 32x64, batch 2: the port takes one step of the phase from seed
weights (its BatchNorm statistics then hold one batch's), the weights are
carried into the JAX package by its own torch -> flax converter, and both
``log_vis`` render the same batch: the JAX package's through its
``built["vis_fn"]``. Also ``log_scalars``' wandb entries, ``setup_logging``
where wandb fails, and the two cases where ``log_vis`` must not run.
"""

import os.path as osp
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch import train as train_entry
from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.models.model import MODULE_NAMES
from dynamo_depth_torch.parallel import dist as pdist
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.models.convert import convert_module
from dynamo_depth_tpu.training.trainer import Trainer as JTrainer
from torch_test_threads import two_torch_threads  # noqa: F401

B, H, W = 2, 32, 64
KW = dict(dataset="kitti", height=H, width=W, batch_size=B, weights_init="scratch")
ASSETS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "assets")
SEQ = "2011_09_26/2011_09_26_drive_0001_sync"


class RecordingWandb(types.ModuleType):
    """What the trainers call of wandb, recorded: ``init``'s keywords,
    ``log``'s dicts and steps; ``Image`` keeps its array."""

    def __init__(self, init_error=None):
        super().__init__("wandb")
        self.inits, self.logs, self.init_error = [], [], init_error

    def init(self, **kwargs):
        if self.init_error is not None:
            raise self.init_error
        self.inits.append(kwargs)

    def log(self, data, step=None):
        self.logs.append((data, step))

    def Image(self, array):  # noqa: N802 - wandb's name
        return np.array(array)


def _carried_variables(model, cfg):
    """The port model's weights as the JAX package's variables, through its
    own converter (copies: later steps of the model do not move them)."""
    params, stats = {}, {}
    for m in MODULE_NAMES:
        sd = {k: v.detach().numpy().copy() for k, v in getattr(model, m).state_dict().items()}
        params[m], s = convert_module(m, sd, cfg)
        if s:
            stats[m] = s
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module", params=["disp_init", "fine_tune"])
def both(request):
    """One port step of the phase, then the JAX ``Trainer`` holding the
    stepped weights (its initialisation replaced by them: the JAX init at
    this size is a long op-by-op run, and the weights are replaced anyway)."""
    phase = request.param
    tcfg = TConfig(**KW)
    trainer = Trainer(tcfg, device="cpu", phase=phase, steps_per_epoch=100, drop_path_rate=0.0)
    batch = synthetic_batch(tcfg, B, H, W)
    losses = trainer.train_step(trainer.to_device(batch), torch.Generator().manual_seed(0), 5)
    jcfg = JConfig(**KW, num_devices=1)
    variables = _carried_variables(trainer.model, jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "_init_variables", lambda self: variables)
        jtrainer = JTrainer(jcfg)
    return types.SimpleNamespace(phase=phase, trainer=trainer, jtrainer=jtrainer, batch=batch, losses=losses,
                                 variables=variables)


def _grids(stub, mode="train"):
    (package, step), = stub.logs
    return step, np.stack([package[f"vis/{mode}_{j}"] for j in range(len(package))])


def test_log_vis_grids_match_the_jax_packages(both):
    jstub, tstub = RecordingWandb(), RecordingWandb()
    both.jtrainer._wandb, both.trainer._wandb = jstub, tstub
    both.jtrainer.g_step = both.trainer.g_step = 3
    built = both.jtrainer._build_phase(both.phase, 100)
    jbatch = jax.tree.map(jnp.asarray, both.batch)
    both.jtrainer.log_vis("train", built, both.variables["params"], both.variables["batch_stats"], jbatch)
    modes = {m: m.training for m in both.trainer.model.modules()}
    both.trainer.log_vis("train", both.trainer.to_device(both.batch))
    assert {m: m.training for m in both.trainer.model.modules()} == modes  # every module's mode restored

    (jstep, ref), (tstep, got) = _grids(jstub), _grids(tstub)
    assert jstep == tstep == 3
    assert got.shape == ref.shape == (B, 3 * H, 3 * W, 3) and got.dtype == np.float32
    assert 0 <= got.min() and got.max() <= 1
    diff = np.abs(got - ref)
    # Rows 1-2 (images, reconstruction, L1, disparity, mask, depth): float32
    # round-off of two networks' forwards, ~1e-5 (found 9e-6).
    assert diff[:, :2 * H].max() <= 1e-4, diff[:, :2 * H].max()
    # Row 3 (the colour wheels): their hue is the angle of the flow, which
    # round-off turns freely near the focus of expansion, where the flow
    # vanishes; elsewhere within 1e-4 (found 5.7e-5). As the eval tests hold
    # frames: 99.9% of the values within one level of 255.
    assert (diff[:, 2 * H:] <= 1 / 255).mean() >= 0.999
    assert np.median(diff[:, 2 * H:]) <= 1e-4


def test_log_scalars_match_the_jax_packages(both):
    jstub, tstub = RecordingWandb(), RecordingWandb()
    both.jtrainer._wandb, both.trainer._wandb = jstub, tstub
    both.jtrainer.g_step = both.trainer.g_step = 7
    both.jtrainer.log_scalars("val", {k: np.asarray(v.numpy()) for k, v in both.losses.items()})
    both.trainer.log_scalars("val", both.losses)
    assert tstub.logs == jstub.logs
    (package, step), = tstub.logs
    assert step == 7 and "val_loss" in package and "val_loss_term/p_photo" in package
    assert both.trainer.history[-1]["scalars"]["loss"] == package["val_loss"]


def _argv(root, *extra):
    return ["-d", "kitti", "-n", "vis", "--data_path", osp.join(ASSETS, "tiny_kitti") + "/", "--split", "tiny",
            "--height", str(H), "--width", str(W), "-b", "1", "--weights_init", "scratch",
            "--epoch_schedules", "1", "0", "0", "0", "--epoch-size", "1", "--log_frequency", "1",
            "--log_dir", str(root / "logs"), "--num_workers", "1", "--print_opt", "", *extra]


@pytest.fixture
def splits(tmp_path, monkeypatch):
    """A split over two tiny_kitti frames; the run's checkpoint folders
    (~340 MB) are deleted afterwards."""
    (tmp_path / "splits" / "tiny").mkdir(parents=True)
    for which in ("train", "val"):
        (tmp_path / "splits" / "tiny" / f"{which}_files.txt").write_text(f"{SEQ} 0 l\n{SEQ} 1 l\n")
    monkeypatch.setenv("DYNAMO_SPLITS_DIR", str(tmp_path / "splits"))
    yield tmp_path
    shutil.rmtree(tmp_path / "logs", ignore_errors=True)


@pytest.mark.parametrize("case", ["visualised", "init_raises", "absent", "no_train_vis"])
def test_the_entry_point_trains_with_or_without_wandb(splits, monkeypatch, case):
    stub = RecordingWandb(init_error=RuntimeError("no network") if case == "init_raises" else None)
    # sys.modules[name] = None makes ``import wandb`` raise ImportError.
    monkeypatch.setitem(sys.modules, "wandb", None if case == "absent" else stub)
    trainer = train_entry.main(_argv(splits, *(["--no_train_vis"] if case == "no_train_vis" else [])), device="cpu")
    assert [h["phase"] for h in trainer.history if h["mode"] == "train"] == ["disp_init"]
    if case != "visualised":
        assert trainer._wandb is None and not stub.logs
        assert stub.inits == []
        return
    assert stub.inits == [{"project": "Dynamo", "name": "vis", "notes": trainer.cfg.comment,
                           "config": trainer.cfg.to_dict()}]
    train, vis, val = stub.logs  # log_scalars, log_vis, then validation's log_scalars, at step 0
    assert [step for _, step in stub.logs] == [0, 0, 0]
    assert "train_loss" in train[0] and "val_loss" in val[0] and "val_de:abs_rel" in val[0]
    assert list(vis[0]) == ["vis/train_0"]
    grid = vis[0]["vis/train_0"]
    assert grid.shape == (3 * H, 3 * W, 3) and np.isfinite(grid).all() and 0 <= grid.min() and grid.max() <= 1


def test_log_vis_runs_on_rank_0_only(monkeypatch):
    trainer = Trainer(TConfig(**KW), device="cpu", phase="fine_tune", drop_path_rate=0.0)
    stub = RecordingWandb()
    trainer._wandb = stub
    monkeypatch.setattr(pdist, "is_main_process", lambda: False)
    monkeypatch.setattr(trainer, "vis_grids", lambda batch: pytest.fail("rendered on rank 1"))
    trainer.log_vis("train", {})
    assert not stub.logs
