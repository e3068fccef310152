"""The port's reader of its own profiler trace, ``bench/profile_top_ops.py``:
on the trace a ``--profile`` run of one CPU step writes (no device events:
an empty table), and on a small hand-made Chrome trace with kernels, copies
and the runtime calls that launched them, whose totals and ``--by-op``
rollup are known."""

import json
import os.path as osp
import shutil

import pytest

from dynamo_depth_torch import train as train_entry
from dynamo_depth_torch.bench import profile_top_ops as pto
from torch_test_threads import two_torch_threads  # noqa: F401

ASSETS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "assets")
SEQ = "2011_09_26/2011_09_26_drive_0001_sync"


def test_a_cpu_profile_reads_as_an_empty_table(tmp_path, monkeypatch, capsys):
    (tmp_path / "splits" / "tiny").mkdir(parents=True)
    for which in ("train", "val"):
        (tmp_path / "splits" / "tiny" / f"{which}_files.txt").write_text(f"{SEQ} 0 l\n{SEQ} 1 l\n")
    monkeypatch.setenv("DYNAMO_SPLITS_DIR", str(tmp_path / "splits"))
    argv = ["-d", "kitti", "-n", "prof", "--data_path", osp.join(ASSETS, "tiny_kitti") + "/", "--split", "tiny",
            "--height", "32", "--width", "64", "-b", "1", "--weights_init", "scratch", "--epoch_schedules", "0", "0",
            "0", "1", "--epoch-size", "1", "--log_dir", str(tmp_path / "logs"), "--num_workers", "1", "--print_opt", "",
            "--profile", "--no_train_vis"]
    train_entry.main(argv, device="cpu")
    shutil.rmtree(tmp_path / "logs" / "prof" / "models")  # the checkpoint folder (~340 MB): not needed here
    folder = tmp_path / "logs" / "prof" / "traces" / "fine_tune"
    assert any(e.get("cat") == "cpu_op" for e in pto.load_trace(str(folder))["traceEvents"])
    capsys.readouterr()
    for flags in ([], ["--by-op"], ["--copies"]):
        summary = pto.main([str(folder), "8", *flags])
        assert summary["kernels"] == summary["by_op"] == summary["copies"] == {} and summary["total_ms"] == 0
        assert "no device events in the trace" in capsys.readouterr().out


def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur, "args": args}


# Host thread (pid 1): aten::conv2d > aten::cudnn_convolution launches a
# cuDNN kernel (correlation 1); aten::add_ launches an elementwise kernel
# twice (2, 3); a port kernel is launched from Python, inside no aten::
# operator (4); aten::copy_ issues a copy (5). The device (pid 0) runs them.
TRACE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}},
    _x("cpu_op", "aten::conv2d", 0, 100),
    _x("cpu_op", "aten::convolution", 1, 98),
    _x("cpu_op", "aten::cudnn_convolution", 2, 90),
    _x("cuda_runtime", "cudaLaunchKernel", 10, 5, correlation=1),
    _x("cpu_op", "aten::add_", 120, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 121, 3, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 130, 3, correlation=3),
    _x("cpu_op", "autograd::engine::evaluate_function: WarpFunctionBackward", 150, 30),
    _x("cuda_runtime", "cudaLaunchKernel", 160, 4, correlation=4),
    _x("cpu_op", "aten::copy_", 200, 50),
    _x("cuda_runtime", "cudaMemcpyAsync", 205, 10, correlation=5),
    _x("kernel", "sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc", 20, 400, pid=0, tid=7, correlation=1),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>", 500, 30,
       pid=0, tid=7, correlation=2),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>", 540, 50,
       pid=0, tid=7, correlation=3),
    _x("kernel", "void warp_bwd_kernel<3, false, true>(WarpArgs)", 600, 8, pid=0, tid=7, correlation=4),
    _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 700, 12, pid=0, tid=8, correlation=5, bytes=2 ** 20),
    _x("gpu_memset", "Memset (Device)", 720, 2, pid=0, tid=8, bytes=4096),
]}


@pytest.fixture
def trace_path(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(TRACE))
    return path


def test_totals_categories_and_kernels(trace_path, capsys):
    summary = pto.main([str(trace_path)])
    assert summary["total_ms"] == pytest.approx((400 + 30 + 50 + 8 + 12 + 2) / 1e3)
    add = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"
    assert summary["kernels"][add] == [pytest.approx(0.08), 2]
    assert summary["categories"] == {"convolution/GEMM": [pytest.approx(0.4), 1],
                                     "elementwise": [pytest.approx(0.08), 2], "warp_bwd": [pytest.approx(0.008), 1],
                                     "memcpy/memset": [pytest.approx(0.014), 2]}
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == "total device time: 0.502 ms in 6 events, 5 distinct kernels"
    assert "sm90_xmma_fprop" in lines[2] and "79.68" in lines[2]  # first by time: 400 of 502 us
    assert "warp_bwd" in out.split("category rollup:")[1]


def test_by_op_rolls_up_by_the_launching_aten_operator(trace_path, capsys):
    summary = pto.main([str(trace_path), "--by-op"])
    assert summary["by_op"] == {
        "aten::cudnn_convolution": [pytest.approx(0.4), 1],  # the innermost aten:: operator
        "aten::add_": [pytest.approx(0.08), 2],
        "warp_bwd": [pytest.approx(0.008), 1],  # launched outside any aten:: operator
        "aten::copy_": [pytest.approx(0.012), 1],
        "<no aten op> Memset (Device)": [pytest.approx(0.002), 1],  # no correlation id
    }
    assert "launching operator" in capsys.readouterr().out


def test_copies(trace_path, capsys):
    summary = pto.main([str(trace_path), "3", "--copies"])
    assert summary["copies"] == {"Memcpy HtoD (Pinned -> Device)": [pytest.approx(0.012), 1, 2 ** 20],
                                 "Memset (Device)": [pytest.approx(0.002), 1, 4096]}
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "memcpy/memset: 0.014 ms of 0.502 ms device time"
    assert "1.00  Memcpy HtoD" in out
