"""The port's odometry CLI against the JAX package's, on the CPU: both score
one seeded checkpoint folder (32x64) on an 8-frame Waymo segment built from
the vendored fixture's frames with 8 ground-truth poses (the fixture's own 3
frames form no 5-frame track, and there both CLIs fail alike)."""

import re

import numpy as np
import pytest

import eval.odometry as jodom
from dynamo_depth_torch.eval import odometry as todom
from test_torch_eval_common import (
    ASSETS,
    build_odometry_segment,
    cli_argv,
    run_jax_cli,
    save_checkpoint,
    write_splits,
)
from torch_test_threads import two_torch_threads  # noqa: F401

REL = "tiny_waymo/odometry/record_fine_tune_00-5"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_odometry")
    return root, save_checkpoint(root), write_splits(root), build_odometry_segment(root / "data")


def test_dump_xyz_and_compute_ate():
    rng = np.random.RandomState(0)
    transforms = []
    for _ in range(4):
        T = np.eye(4)
        T[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
        T[:3, 3] = rng.randn(3)
        transforms.append(T)
    xyz = np.array(todom.dump_xyz(transforms))
    np.testing.assert_array_equal(xyz, np.array(jodom.dump_xyz(transforms)))
    assert xyz.shape == (5, 3)
    gt = np.concatenate([np.zeros((1, 3)), rng.randn(4, 3)])
    assert todom.compute_ate(gt, xyz) == jodom.compute_ate(gt, xyz)
    # A track from the origin that is the ground truth scaled has no error.
    assert todom.compute_ate(gt, 2.5 * gt) == pytest.approx(0.0, abs=1e-12)


_FLOAT = r"-?\d+\.\d+(?:e-?\d+)?"


def _numbers(text):
    return [float(x) for x in re.findall(_FLOAT, text)]


def test_records_match_the_jax_packages(setup, monkeypatch):
    root, folder, splits, data = setup
    monkeypatch.setenv("DYNAMO_SPLITS_DIR", splits)
    got = todom.main(cli_argv("waymo", data, "odom", folder, root / "port", batch_size=4), device="cpu")
    run_jax_cli(jodom, cli_argv("waymo", data, "odom", folder, root / "jax", batch_size=4))
    port_npy, jax_npy = np.load(root / "port" / f"{REL}.npy"), np.load(root / "jax" / f"{REL}.npy")
    assert port_npy.shape == jax_npy.shape == (4, 2)  # 6 non-edge frames: 4 tracks of 5 poses
    np.testing.assert_allclose(port_npy, jax_npy, rtol=1e-4)
    np.testing.assert_array_equal(port_npy, np.stack([got["ates"], got["speeds"]], 1))
    port_txt, jax_txt = (root / "port" / f"{REL}.txt").read_text(), (root / "jax" / f"{REL}.txt").read_text()
    assert re.sub(_FLOAT, "#", port_txt) == re.sub(_FLOAT, "#", jax_txt)
    a, b = _numbers(port_txt), _numbers(jax_txt)
    assert len(a) == len(b) == 14  # the segment's 4 and the summary's 2 x 5
    # The segment line prints 3 decimals; the summary prints every digit.
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3 + 1e-9)
    summary = port_txt.split("ATE Trajectory error")[1]
    np.testing.assert_allclose(_numbers(summary), _numbers(jax_txt.split("ATE Trajectory error")[1]), rtol=1e-4)


def test_a_segment_without_a_track_fails_as_in_the_jax_package(setup, monkeypatch):
    root, folder, splits, _ = setup
    monkeypatch.setenv("DYNAMO_SPLITS_DIR", splits)
    data = f"{ASSETS}/tiny_waymo"
    with pytest.raises(ValueError):
        todom.main(cli_argv("waymo", data, "waymo", folder, root / "port3"), device="cpu")
    with pytest.raises(ValueError):
        run_jax_cli(jodom, cli_argv("waymo", data, "waymo", folder, root / "jax3"))
