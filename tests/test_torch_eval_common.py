"""Shared set-up of the port's eval tests (this file holds no test): a
seeded port checkpoint at 32x64 in the reference's folder layout, splits
over the vendored fixtures, an 8-frame Waymo segment for odometry, and
runners for both packages' CLIs.

Both packages score the same checkpoint folder: the port loads its own
``.pth`` files, the JAX package converts them (``convert_torch_checkpoint``).
The JAX CLIs read ``sys.argv``; the port's take ``argv`` and run on the CPU
here.
"""

import os
import os.path as osp
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from dynamo_depth_torch.models.model import DynamoModel
from dynamo_depth_torch.training import checkpoint as ckpt

H, W = 32, 64
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
ASSETS = osp.join(ROOT, "assets")
KITTI_SEQ = "2011_09_26/2011_09_26_drive_0001_sync"
WAYMO_SEG = "val/segment-0000000000_tiny_fixture"
NUSC_SCENE = "scenes/scene-0001"
ODOM_SEG = "val/segment-0000000001_eight_frames"
ODOM_FRAMES = 8


def save_checkpoint(root, seed=0, depth_model="litemono"):
    """A port model from ``seed`` saved as ``<root>/logs/tiny/models/
    fine_tune_00`` (the eval CLIs name their outputs after that path), with
    BatchNorm statistics that are not the initial ones, so that eval mode
    is seen to use them."""
    torch.manual_seed(seed)
    model = DynamoModel(depth_model=depth_model, scales=(0, 1, 2, 3) if depth_model == "monodepthv2" else (0, 1, 2),
                        drop_path_rate=0.0)
    gen = torch.Generator().manual_seed(seed)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    folder = osp.join(str(root), "logs", "tiny", "models", "fine_tune_00")
    ckpt.save_model(model, folder, height=H, width=W)
    return folder


def write_splits(root):
    """``<root>/splits/<name>/{test,test_mask}_files.txt`` for each fixture."""
    splits = {
        "kitti": {"test": [f"{KITTI_SEQ} {i} l" for i in range(3)]},
        "waymo": {"test": [f"{WAYMO_SEG} {i}" for i in range(3)], "test_mask": [f"{WAYMO_SEG} {i}" for i in range(3)]},
        "nuscenes": {"test": [f"{NUSC_SCENE} 0"], "test_mask": [f"{NUSC_SCENE} 0"]},
        "odom": {"test": [f"{ODOM_SEG} {i}" for i in range(ODOM_FRAMES)]},
    }
    for name, files in splits.items():
        d = root / "splits" / name
        d.mkdir(parents=True, exist_ok=True)
        for which, lines in files.items():
            (d / f"{which}_files.txt").write_text("".join(line + "\n" for line in lines))
    return str(root / "splits")


def build_odometry_segment(data_root):
    """An 8-frame Waymo segment under ``data_root`` (a copy of the
    fixture's images, cycled, and its intrinsics) with 8 ground-truth poses,
    so that 5-frame tracks form: the fixture's 3 frames leave one non-edge
    frame and no track."""
    src = osp.join(ASSETS, "tiny_waymo", WAYMO_SEG, "FRONT", "rgb")
    dst = osp.join(str(data_root), ODOM_SEG, "FRONT")
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(osp.join(dst, "rgb", "downsample"))
    for i in range(ODOM_FRAMES):
        shutil.copy(osp.join(src, "downsample", f"{i % 3:06}.jpg"), osp.join(dst, "rgb", "downsample", f"{i:06}.jpg"))
    shutil.copy(osp.join(src, "cam.json"), osp.join(dst, "rgb", "cam.json"))
    rng = np.random.RandomState(8)
    poses = []
    pose = np.eye(4)
    for _ in range(ODOM_FRAMES):
        step = np.eye(4)
        a = rng.uniform(-0.02, 0.02)
        step[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        step[:3, 3] = [rng.uniform(-0.1, 0.1), rng.uniform(-0.05, 0.05), rng.uniform(0.5, 1.5)]
        pose = pose @ step
        poses.append(pose.reshape(-1))
    np.savetxt(osp.join(dst, "odometry.txt"), np.array(poses))
    return str(data_root)


def cli_argv(dataset, data_path, split, folder, eval_dir, batch_size=2):
    return ["-d", dataset, "--data_path", data_path + "/", "--split", split, "-l", folder,
            "--height", str(H), "--width", str(W), "-b", str(batch_size), "--num_devices", "1",
            "--num_workers", "1", "--eval_dir", str(eval_dir)]


def run_jax_cli(module, argv):
    """``main()`` of a JAX package CLI with ``argv`` as its command line."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [module.__file__] + list(argv))
        return module.main()


_NUM = re.compile(r"-?\d+\.\d+")


def table_numbers(lines):
    """The numbers of a depth table's OVERALL/BG/STATIC/MOT rows, by row."""
    rows = {}
    for line in lines:
        name = line.split()[0] if line.split() else ""
        if name in ("OVERALL", "BG", "STATIC", "MOT"):
            rows[name] = [float(x) for x in _NUM.findall(line)]
    return rows
