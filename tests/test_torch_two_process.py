"""The port's two-process drive on the CPU (``dynamo_depth_torch/bench/
two_process_drive.py``) at its smallest size, and its 2-rank ``eval.depth``
table held against the JAX CLI's table of the same checkpoint folder.

The drive trains ``disp_init`` (2 steps, 32x64) as one process at batch 2
and as two torchrun processes at batch 1 over gloo, and evaluates the
one-process run's folder in both topologies: depth on tiny_kitti and
tiny_waymo, motion segmentation on tiny_waymo and odometry on an 8-frame
segment; it must print ``ALL PASS``.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import eval.depth as jdepth
from dynamo_depth_torch.bench import two_process_drive as drive
from test_torch_eval_common import ROOT, run_jax_cli, table_numbers


@pytest.fixture(scope="module")
def drive_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("two_proc")
    proc = subprocess.run([sys.executable, "-m", "dynamo_depth_torch.bench.two_process_drive", "--out", str(out)],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                          timeout=600)
    yield out, proc
    shutil.rmtree(out)  # the checkpoint folders


def test_the_two_process_drive_passes(drive_run):
    _, proc = drive_run
    tail = "\n".join((proc.stdout + proc.stderr).splitlines()[-40:])
    assert proc.returncode == 0, tail
    assert "ALL PASS" in proc.stdout and "FAIL " not in proc.stdout, tail
    assert proc.stdout.count("PASS  ") == 9, tail


def test_the_two_rank_table_matches_the_jax_clis(drive_run, monkeypatch):
    """Part 1 and Part 2 on tiny_waymo, from the drive's folder."""
    out, proc = drive_run
    assert proc.returncode == 0, proc.stdout[-2000:]
    ckpt = out / "single_rank0" / "logs" / "drive" / "models" / "disp_init_00"
    monkeypatch.setenv("DYNAMO_SPLITS_DIR", str(out / "splits"))
    run_jax_cli(jdepth, ["-d", "waymo", "--data_path", f"{drive.ASSETS / 'tiny_waymo'}/", "--split", "tiny_waymo",
                         "-l", str(ckpt), "--height", "32", "--width", "64", "-b", "2", "--num_devices", "1",
                         "--num_workers", "1", "--eval_dir", str(out / "eval_jax")])
    rel = drive.table_path(out, "multi", 0, "waymo", ckpt).relative_to(out / "eval_multi_rank0")
    port_lines = (out / "eval_multi_rank0" / rel).read_text().splitlines()
    jax_lines = (out / "eval_jax" / rel).read_text().splitlines()

    def text(lines):  # the lines without numbers
        return [line for line in lines if not line.strip() or line.split()[0] not in ("OVERALL", "BG", "STATIC", "MOT")]

    assert text(port_lines) == text(jax_lines)
    port_rows, jax_rows = table_numbers(port_lines), table_numbers(jax_lines)
    assert port_rows.keys() == jax_rows.keys() == {"OVERALL", "BG", "STATIC", "MOT"}
    for row in jax_rows:
        assert len(port_rows[row]) == 7
        np.testing.assert_allclose(port_rows[row], jax_rows[row], rtol=0, atol=1e-3 + 1e-9, err_msg=row)
