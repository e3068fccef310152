"""Rules the port keeps: no JAX, the card by default, plain versions only
for CPU tensors."""

import ast
import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dynamo_depth_torch
from dynamo_depth_torch.config import DynamoConfig
from dynamo_depth_torch.ops.kernels import launch_counts, photometric, reset_launch_counts, warp
from dynamo_depth_torch.training import trainer as trainer_mod

PKG_DIR = Path(dynamo_depth_torch.__file__).parent
ROOT = PKG_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "dynamo_depth_tpu")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG_DIR)], prefix="dynamo_depth_torch."))


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_all_modules()!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(sys.modules)); sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_module_imports_jax():
    for path in PKG_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_every_module_imports_here():
    for m in _all_modules():
        importlib.import_module(m)


def test_trainer_needs_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DynamoConfig(dataset="kitti", height=32, width=64, batch_size=1, weights_init="scratch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer_mod.Trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer_mod.resolve_device("cuda")
    assert trainer_mod.resolve_device("cpu") == torch.device("cpu")


def test_the_entry_point_needs_the_card_unless_asked_for_cpu(monkeypatch, tmp_path):
    from dynamo_depth_torch import train as train_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(trainer_mod.Trainer, "train", lambda self: pytest.fail("trained without a card"))
    argv = ["-d", "kitti", "--height", "32", "--width", "64", "--weights_init", "scratch", "--log_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_entry.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_entry.main(argv, device="cuda")


@pytest.mark.parametrize("entry", ["eval.depth", "eval.motion_segmentation", "eval.odometry", "eval.visualize",
                                   "quick_demo"])
def test_the_eval_entry_points_need_the_card_unless_asked_for_cpu(monkeypatch, tmp_path, entry):
    module = importlib.import_module(f"dynamo_depth_torch.{entry}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-d", "waymo", "--height", "32", "--width", "64", "--weights_init", "scratch", "--eval_dir", str(tmp_path)]
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(argv, device=device)


def test_trainer_refuses_what_is_not_ported():
    cfg = DynamoConfig(dataset="kitti", height=32, width=64, batch_size=1)  # weights_init="pretrained"
    with pytest.raises(NotImplementedError):
        trainer_mod.Trainer(cfg, device="cpu")
    # monodepthv2 and bfloat16 are ported: they build.
    cfg = DynamoConfig(dataset="kitti", height=64, width=96, batch_size=1, weights_init="scratch",
                       depth_model="monodepthv2", compute_dtype="bfloat16")
    assert trainer_mod.Trainer(cfg, device="cpu").compute_dtype == torch.bfloat16
    # One card per process: two devices need a launch of two processes.
    cfg = DynamoConfig(dataset="kitti", height=32, width=64, batch_size=1, weights_init="scratch", num_devices=2)
    with pytest.raises(ValueError, match="world size is 1"):
        trainer_mod.Trainer(cfg, device="cpu")


def test_train_visualisation_is_refused_where_wandb_imports(monkeypatch, tmp_path):
    # Nothing is refused any more: where wandb imports, setup_logging starts
    # its run (the JAX package's semantics); --no_train_vis starts none.
    cfg = DynamoConfig(dataset="kitti", height=32, width=64, batch_size=1, weights_init="scratch",
                       log_dir=str(tmp_path), print_opt=False)
    trainer = trainer_mod.Trainer(cfg, device="cpu")
    inits = []
    stub = type(sys)("wandb")
    stub.init = lambda **kwargs: inits.append(kwargs)
    monkeypatch.setitem(sys.modules, "wandb", stub)
    trainer.setup_logging()
    assert trainer._wandb is stub and inits[0]["project"] == "Dynamo"
    trainer.cfg.no_train_vis = True
    trainer.setup_logging()
    assert trainer._wandb is None and len(inits) == 1
    assert (tmp_path / cfg.model_name / "models" / "opt.json").exists()


def test_cpu_tensors_take_the_plain_path():
    reset_launch_counts()
    img = torch.rand(1, 3, 6, 8, requires_grad=True)
    grid = (torch.rand(1, 5, 7, 2) * 2 - 1).requires_grad_()
    warp.grid_sample(img, grid).sum().backward()
    pred = torch.rand(1, 3, 6, 8, requires_grad=True)
    photometric.reprojection_loss(pred, torch.rand(1, 3, 6, 8)).sum().backward()
    assert launch_counts() == {"warp_fwd": 0, "warp_bwd": 0, "photometric_fwd": 0, "photometric_bwd": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    # A wrapper called directly checks its tensors before it builds or
    # launches anything.
    x = torch.rand(1, 3, 6, 8)
    with pytest.raises(ValueError, match="CUDA"):
        warp.warp_fwd(x, torch.rand(1, 5, 7, 2))
    with pytest.raises(ValueError, match="CUDA"):
        photometric.photometric_fwd(x, x, 0.85)
    with pytest.raises(ValueError):
        warp.grid_sample(torch.rand(1, 3, 1, 8), torch.rand(1, 5, 7, 2))
    assert all(v == 0 for v in launch_counts().values())
