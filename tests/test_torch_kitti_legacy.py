"""The port's legacy KITTI datasets against the JAX package's, on a raw-layout
fixture built in ``tmp_path``: images, a velodyne scan with its two
calibration files, an odometry sequence and an annotated depth map. Each
dataset's items and depth maps must be equal, flipped and not."""

import numpy as np
import pytest
from PIL import Image

from dynamo_depth_torch.data import kitti_legacy as tl
from dynamo_depth_tpu.data import kitti_legacy as jl

DATE, DRIVE = "2011_09_26", "2011_09_26_drive_0001_sync"
FOLDER = f"{DATE}/{DRIVE}"
FRAMES = (0, 1, 2)
CAM_TO_CAM = """calib_time: 09-Jan-2012 13:57:47
S_rect_02: 1.242000e+03 3.750000e+02
R_rect_00: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 9.999421e-01 -4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01
P_rect_02: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 0.000000e+00 7.215377e+02 1.728540e+02 2.163791e-01 0.000000e+00 0.000000e+00 1.000000e+00 2.745884e-03
P_rect_03: 7.215377e+02 0.000000e+00 6.095593e+02 -3.395242e+02 0.000000e+00 7.215377e+02 1.728540e+02 2.199936e+00 0.000000e+00 0.000000e+00 1.000000e+00 2.729905e-03
"""
VELO_TO_CAM = """calib_time: 15-Mar-2012 11:37:16
R: 7.533745e-03 -9.999714e-01 -6.166020e-04 1.480249e-02 7.280733e-04 -9.998902e-01 9.998621e-01 7.523790e-03 1.480755e-02
T: -4.069766e-03 -7.631618e-02 -2.717806e-01
"""


def _image(rng, path):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((rng.rand(40, 120, 3) * 255).astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_raw")
    rng = np.random.RandomState(0)
    drive = root / DATE / DRIVE
    for i in FRAMES:
        for cam in (2, 3):
            _image(rng, drive / f"image_0{cam}" / "data" / f"{i:010d}_192.jpg")
            _image(rng, drive / f"image_0{cam}" / "data" / f"{i:010d}.jpg")
            _image(rng, root / "sequences" / "00" / f"image_{cam}" / f"{i:06d}.jpg")
    (root / DATE / "calib_cam_to_cam.txt").write_text(CAM_TO_CAM)
    (root / DATE / "calib_velo_to_cam.txt").write_text(VELO_TO_CAM)
    # A scan ahead of the car: x forward 2-60 m, y left, z up, reflectance;
    # a few points behind it and a few duplicates of one pixel.
    n = 3000
    pts = np.stack([rng.uniform(-5, 60, n), rng.uniform(-15, 15, n), rng.uniform(-2, 1, n), rng.rand(n)], 1)
    pts[-20:] = pts[-21] + rng.uniform(0, 1e-3, (20, 4))
    (drive / "velodyne_points" / "data").mkdir(parents=True)
    pts.astype(np.float32).tofile(drive / "velodyne_points" / "data" / f"{1:010d}.bin")
    for cam in (2, 3):
        gt = np.where(rng.rand(100, 300) < 0.1, rng.randint(256, 80 * 256, (100, 300)), 0).astype(np.uint16)
        path = drive / "proj_depth" / "groundtruth" / f"image_0{cam}" / f"{1:010d}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(gt).save(path)
    return root


def _pair(name, root, lines, is_train):
    kw = dict(data_path=str(root) + "/", filenames=lines, height=32, width=64, cam_name="", img_type="",
              frame_idxs=[0, -1, 1], num_scales=3, is_train=is_train)
    return getattr(tl, name)(**kw), getattr(jl, name)(**kw)


LINES = {"KITTIRAWDataset": [f"{FOLDER} 1 l", f"{FOLDER} 1 r"], "KITTIDepthDataset": [f"{FOLDER} 1 l", f"{FOLDER} 1 r"],
         "KITTIOdomDataset": ["0 1 l", "0 1 r"]}


@pytest.mark.parametrize("name", sorted(LINES))
def test_items_match_the_jax_packages(root, name):
    port, ref = _pair(name, root, LINES[name], is_train=True)
    flips = set()
    for index in range(len(LINES[name])):
        for seed in range(4):
            got = port.get_item(index, np.random.RandomState(seed))
            want = ref.get_item(index, np.random.RandomState(seed))
            flips.add(np.random.RandomState(seed).rand() > 0.5)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {index} {seed} {k}")
    assert flips == {True, False}


@pytest.mark.parametrize("name", ["KITTIRAWDataset", "KITTIDepthDataset"])
def test_depth_maps_match_the_jax_packages(root, name):
    port, ref = _pair(name, root, LINES[name], is_train=False)
    for side in "lr":
        for flip in (False, True):
            got = port.get_depth(FOLDER, 1, side, flip)
            want = ref.get_depth(FOLDER, 1, side, flip)
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            assert (got > 0).sum() > 50  # the fixture's points land in the image
    assert port.get_gt_dim(FOLDER, 1, "l") == ref.get_gt_dim(FOLDER, 1, "l") == (375, 1242)


def test_check_depth_and_the_registry(root):
    port, ref = _pair("KITTIRAWDataset", root, LINES["KITTIRAWDataset"], is_train=False)
    assert port.check_depth() and ref.check_depth()
    missing, _ = _pair("KITTIRAWDataset", root, [f"{FOLDER} 2 l"], is_train=False)
    assert not missing.check_depth()
    from dynamo_depth_torch.data import DATASETS

    assert not any(issubclass(cls, tl.KITTIDatasetOld) for cls in DATASETS.values())
    assert tl._HAS_SKIMAGE == jl._HAS_SKIMAGE
