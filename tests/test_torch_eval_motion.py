"""The port's motion-segmentation CLI against the JAX package's, on the CPU:
both score one seeded checkpoint folder (32x64) on the vendored Waymo
fixture, whose one non-edge frame is upsampled to 1920x1280. The JAX CLI's
per-threshold counts and its false-positive tally are read where it hands
them on (``pr_sweep_counts``, ``pyplot.bar``); its npz is read from disk."""

import contextlib
import io

import matplotlib
import numpy as np
import pytest

import eval.motion_segmentation as jmot
from dynamo_depth_torch.data.categories import WAYMO_CATEGORIES
from dynamo_depth_torch.eval import motion_segmentation as tmot
from test_torch_eval_common import ASSETS, cli_argv, run_jax_cli, save_checkpoint, write_splits
from torch_test_threads import two_torch_threads  # noqa: F401

matplotlib.use("Agg")
from matplotlib import pyplot  # noqa: E402

PIXELS = 1280 * 1920  # one frame at Waymo's full resolution
REL = "tiny_waymo/mot_seg"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_motion")
    folder = save_checkpoint(root)
    recorded = {"counts": [], "bars": []}
    j_sweep, bar = jmot.pr_sweep_counts, pyplot.bar

    def sweep(*args):
        out = j_sweep(*args)
        recorded["counts"].append([np.asarray(x, np.float64) for x in out])
        return out

    def record_bar(cats, heights, *args, **kwargs):
        recorded["bars"].append((list(cats), list(heights)))
        return bar(cats, heights, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DYNAMO_SPLITS_DIR", write_splits(root))
        mp.setattr(jmot, "pr_sweep_counts", sweep)
        mp.setattr(pyplot, "bar", record_bar)
        argv = lambda name: cli_argv("waymo", f"{ASSETS}/tiny_waymo", "waymo", folder, root / name)  # noqa: E731
        port = tmot.main(argv("port"), device="cpu")
        port_bar = recorded["bars"].pop()
        run_jax_cli(jmot, argv("jax"))
        jax_bar = recorded["bars"].pop()
        mp.setattr(tmot, "pyplot", lambda: None)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            bare = tmot.main(argv("bare"), device="cpu")
        bare["printed"] = printed.getvalue().splitlines()
    jax_counts = np.sum(recorded["counts"], axis=0)
    return root, port, port_bar, bare, dict(zip(("tp", "fp", "fn"), jax_counts)), jax_bar


def test_pr_record_matches_the_jax_packages(runs):
    root, port, _, _, jax_counts, _ = runs
    got, ref = np.load(root / "port" / REL / "pr_record_fine_tune_00.npz"), np.load(root / "jax" / REL / "pr_record_fine_tune_00.npz")
    assert sorted(got.files) == sorted(ref.files) == ["f1", "precision", "recall", "thrds"]
    np.testing.assert_array_equal(got["thrds"], ref["thrds"])
    for k in ("precision", "recall", "f1"):
        assert got[k].shape == ref[k].shape == (150,)
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-3, err_msg=k)
    for k in ("tp", "fp", "fn"):
        np.testing.assert_allclose(port[k], jax_counts[k], rtol=0, atol=1e-3 * PIXELS, err_msg=k)
    # Every labelled pixel is counted: tp + fn is the moving pixels at each threshold.
    assert len(set(port["tp"] + port["fn"])) == 1


def test_false_positive_tally_matches_the_jax_packages(runs):
    _, port, port_bar, _, _, jax_bar = runs
    tally = port["fp_tally"]
    assert tally["total"] == sum(v for k, v in tally.items() if k != "total") > 0
    assert port_bar == jax_bar
    assert sorted(port_bar[0]) == sorted(WAYMO_CATEGORIES[int(k)] for k in tally if k != "total")


def test_both_pdfs_are_written(runs):
    root, port, _, _, _, _ = runs
    pdfs = [str(root / "port" / REL / f"{k}_fine_tune_00.pdf") for k in ("pr_curve", "fp_tally")]
    assert port["pdfs"] == pdfs and port["missing"] == []
    for name in ("pr_curve", "fp_tally"):
        for side in ("port", "jax"):
            assert (root / side / REL / f"{name}_fine_tune_00.pdf").read_bytes()[:5] == b"%PDF-"


def test_without_matplotlib_the_records_are_written_and_the_pdfs_named(runs):
    root, port, _, bare, _, _ = runs
    for path in bare["missing"]:
        assert sum(line.startswith("matplotlib is not installed") and path in line for line in bare["printed"]) == 1
    assert bare["pdfs"] == [] and [p.rsplit("/", 1)[1] for p in bare["missing"]] == [
        "pr_curve_fine_tune_00.pdf", "fp_tally_fine_tune_00.pdf"]
    assert not (root / "bare" / REL / "pr_curve_fine_tune_00.pdf").exists()
    got, ref = np.load(root / "bare" / REL / "pr_record_fine_tune_00.npz"), np.load(port["npz"])
    for k in ref.files:
        np.testing.assert_array_equal(got[k], ref[k])
    assert bare["fp_tally"] == port["fp_tally"]
