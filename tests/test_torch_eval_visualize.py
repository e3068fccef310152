"""The port's visualisation CLI and quick demo against the JAX package's, on
the CPU: both render one seeded checkpoint folder (32x64), the CLI on the
vendored Waymo fixture and the demo on the vendored nuScenes scene's
non-edge frame, and their uint8 frames agree within one level."""

import os.path as osp
import sys

import numpy as np
import pytest
from PIL import Image

import eval.visualize as jvisualize
import quick_demo as jdemo
from dynamo_depth_torch import quick_demo as tdemo
from dynamo_depth_torch.config import parse_config as tparse
from dynamo_depth_torch.data.loader import collate
from dynamo_depth_torch.eval import visualize as tvisualize
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_torch.utils import vis as tvis
from dynamo_depth_tpu.config import parse_config as jparse
from dynamo_depth_tpu.training.trainer import Trainer as JTrainer
from test_torch_eval_common import ASSETS, H, W, NUSC_SCENE, WAYMO_SEG, cli_argv, run_jax_cli, save_checkpoint, write_splits
from torch_test_threads import two_torch_threads  # noqa: F401

DEMO_FILES = [f"{NUSC_SCENE} 1"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_vis")
    return root, save_checkpoint(root), write_splits(root)


def _assert_frames_agree(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    diff = np.abs(a.astype(int) - b.astype(int))
    assert (diff <= 1).mean() >= 0.999, f"{(diff > 1).sum()} pixels more than one level apart (max {diff.max()})"


def _png_frames(folder):
    return [np.asarray(Image.open(p)) for p in sorted(folder.iterdir())]


def test_video_frames_match_the_jax_packages(setup, monkeypatch):
    root, folder, splits = setup
    monkeypatch.setenv("DYNAMO_SPLITS_DIR", splits)
    argv = lambda name: cli_argv("waymo", f"{ASSETS}/tiny_waymo", "waymo", folder, root / name)  # noqa: E731
    got = tvisualize.main(argv("port"), device="cpu")
    run_jax_cli(jvisualize, argv("jax"))
    frames, written = got[WAYMO_SEG]
    assert len(frames) == 1 and frames[0].shape == (H, 5 * W, 3)  # one non-edge frame, five columns
    name = WAYMO_SEG.split("/")[1]
    rel = osp.join("tiny_waymo", "vis", "fine_tune_00")
    # No mp4 encoder here: both write the frames as PNGs.
    assert written == str(root / "port" / rel / f"{name}_frames")
    port_frames = _png_frames(root / "port" / rel / f"{name}_frames")
    jax_frames = _png_frames(root / "jax" / rel / f"{name}_frames")
    assert len(port_frames) == len(jax_frames) == 1
    np.testing.assert_array_equal(port_frames[0], frames[0])
    _assert_frames_agree(port_frames[0], jax_frames[0])


def test_quick_demo_matches_the_jax_packages(setup, monkeypatch):
    root, folder, _ = setup
    argv = ["-l", folder, "--data_path", f"{ASSETS}/tiny_nuscenes/", "--height", str(H), "--width", str(W),
            "--num_devices", "1"]
    got = tdemo.main(argv + ["--out", str(root / "demo_port")], device="cpu", filenames=DEMO_FILES)
    monkeypatch.setattr(jdemo, "DEFAULT_FILENAMES", DEMO_FILES)
    jdemo.main(argv + ["--out", str(root / "demo_jax")])
    assert tdemo.DEFAULT_FILENAMES == ["scenes/scene-0099 85", "scenes/scene-0104 2"]
    port_png = np.asarray(Image.open(root / "demo_port" / "demo_0.png"))
    np.testing.assert_array_equal(port_png, got[0])
    _assert_frames_agree(port_png, np.asarray(Image.open(root / "demo_jax" / "demo_0.png")))


def test_get_vis_columns_match_the_jax_packages(setup):
    """Each raw column of one batch, before the colour coding."""
    _, folder, _ = setup
    argv = ["-d", "nuscenes", "-l", folder, "--data_path", f"{ASSETS}/tiny_nuscenes/", "--height", str(H),
            "--width", str(W), "--num_devices", "1", "-b", "1"]
    tcfg, jcfg = tparse(argv), jparse(argv)
    trainer, jtrainer = Trainer(tcfg, device="cpu"), JTrainer(jcfg)
    batch = collate([trainer.get_dataset(DEMO_FILES, img_type=tcfg.eval_img_type).get_item(0)])
    items = ("img", "ref_img", "disp", "mask", "ego_flow", "ind_flow", "comp_flow", "samp_flow")
    got = tvisualize.get_vis(tcfg, trainer, batch, -1, items=items)
    ref = jvisualize.get_vis(jcfg, jtrainer, batch, -1, items=items)
    assert got.keys() == ref.keys() == set(items)
    for k in items:
        if isinstance(ref[k], dict):
            assert got[k]["mag"] == pytest.approx(ref[k]["mag"], rel=1e-4), k
            np.testing.assert_allclose(tvis.hsv_to_rgb(got[k]["hsv"]), tvis.hsv_to_rgb(ref[k]["hsv"]),
                                       rtol=0, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5, err_msg=k)


def test_make_mp4_writes_frames_without_imageio(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "imageio", None)  # import fails
    frames = [np.full((4, 6, 3), i, np.uint8) for i in range(3)]
    written = tvis.make_mp4(frames, str(tmp_path / "clip"), bgr=False)
    assert written == str(tmp_path / "clip_frames")
    assert sorted(p.name for p in (tmp_path / "clip_frames").iterdir()) == ["000000.png", "000001.png", "000002.png"]
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "clip_frames" / "000002.png")), frames[2])
    assert "wrote 3 PNG frames" in capsys.readouterr().out
    with pytest.raises(ValueError):
        tvis.make_mp4(frames, str(tmp_path / "clip.avi"))
