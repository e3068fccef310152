"""The port's depth evaluation CLI against the JAX package's, on the CPU:
both score one seeded checkpoint folder (32x64) on the vendored fixtures,
Part 1 on all three datasets and Part 2 (per motion class) on Waymo and
nuScenes, and their tables agree to the 3 decimals they print."""

import numpy as np
import pytest

import eval.depth as jdepth
from dynamo_depth_torch.eval import depth as tdepth
from test_torch_eval_common import ASSETS, cli_argv, run_jax_cli, save_checkpoint, table_numbers, write_splits
from torch_test_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_depth")
    return root, save_checkpoint(root), write_splits(root)


def test_sample_mask_at_points():
    rng = np.random.RandomState(0)
    mask = rng.randint(0, 4, (2, 30, 50)).astype(np.uint8)
    pts = np.stack([rng.uniform(-3, 33, (2, 40)), rng.uniform(-3, 53, (2, 40)), rng.rand(2, 40)], -1).astype(np.float32)
    out = tdepth.sample_mask_at_points(mask, pts)
    np.testing.assert_array_equal(out, jdepth.sample_mask_at_points(mask, pts))
    assert out.dtype == np.int32 and out.shape == (2, 40)


@pytest.mark.parametrize("dataset,batch_size", [("kitti", 2), ("waymo", 2), ("nuscenes", 1)])
def test_depth_tables_match_the_jax_packages(setup, monkeypatch, capsys, dataset, batch_size):
    root, folder, splits = setup
    monkeypatch.setenv("DYNAMO_SPLITS_DIR", splits)
    data = f"{ASSETS}/tiny_{dataset}"
    got = tdepth.main(cli_argv(dataset, data, dataset, folder, root / "port", batch_size), device="cpu")
    # The model is built with frame 0 only, and loads all seven modules.
    assert "FAILED" not in capsys.readouterr().out
    run_jax_cli(jdepth, cli_argv(dataset, data, dataset, folder, root / "jax", batch_size))
    rel = f"tiny_{dataset}/depth/fine_tune_00.txt"
    port_lines = (root / "port" / rel).read_text().splitlines()
    jax_lines = (root / "jax" / rel).read_text().splitlines()
    assert got["path"] == str(root / "port" / rel)

    # Same text apart from the numbers, which agree to the printed 0.001.
    def text(lines):
        return [line for line in lines if not line.strip() or line.split()[0] not in ("OVERALL", "BG", "STATIC", "MOT")]

    assert text(port_lines) == text(jax_lines)
    port_rows, jax_rows = table_numbers(port_lines), table_numbers(jax_lines)
    assert port_rows.keys() == jax_rows.keys() == ({"OVERALL"} if dataset == "kitti" else {"OVERALL", "BG", "STATIC", "MOT"})
    for row in jax_rows:
        assert len(port_rows[row]) == 7
        np.testing.assert_allclose(port_rows[row], jax_rows[row], rtol=0, atol=1e-3 + 1e-9, err_msg=row)
    assert all(np.isfinite(v).all() for v in port_rows.values())
