"""The kernels' byte and operation counts, the trace's reduction and every
per-layer reader on a small trace made by hand."""

import pytest

from benchmark import roofline, spec
from benchmark import trace as tr
from benchmark.program import Window

H100 = roofline.peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("kernel,B,bound_ms", [
    ("warp_fwd", 3, 0.0035), ("warp_bwd", 3, 0.0044), ("photometric_fwd", 3, 0.0031), ("photometric_bwd", 3, 0.0044),
    ("warp_fwd_bf16", 8, 0.0076), ("warp_bwd_bf16", 8, 0.0100),
])
def test_bounds_are_the_bytes_bounds_of_the_kernel_table(kernel, B, bound_ms):
    """PERF.md's table of kernels: the bound of one launch at 192x640, C=3."""
    assert round(1e3 * roofline.least_seconds(kernel, (B, 3, 192, 640), H100), 4) == bound_ms
    nbytes, ops = roofline.kernel_work(kernel, B, 3, 192, 640)
    assert ops / H100["fp32_flops"] < nbytes / H100["hbm_bytes_per_s"]


def test_peaks_only_for_a_card_in_the_table():
    assert roofline.peaks("NVIDIA H100 PCIe") is None and roofline.peaks("cpu") is None


def _x(name, cat, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# A profiled step: a convolution launched inside aten::conv2d, an
# elementwise kernel inside aten::add, K1 launched outside any aten::
# operator (as the port launches it, through ctypes) and a memcpy whose
# launch the trace lost. Busy 65 us of a 120 us span.
TRACE = {"traceEvents": [
    _x("aten::conv2d", "cpu_op", 0, 50), _x("cudaLaunchKernel", "cuda_runtime", 10, 5, corr=1),
    _x("aten::add", "cpu_op", 60, 20), _x("cudaLaunchKernel", "cuda_runtime", 65, 5, corr=2),
    _x("cudaLaunchKernel", "cuda_runtime", 90, 5, corr=3),
    _x("cudnn_convolution_fwd_kernel", "kernel", 100, 40, corr=1, tid=7),
    _x("void at::native::vectorized_elementwise_kernel<4>", "kernel", 150, 10, corr=2, tid=7),
    _x("void warp_fwd_kernel<float>(WarpArgs)", "kernel", 200, 10, corr=3, tid=7),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 215, 5, corr=4, tid=7),
]}


@pytest.fixture
def record():
    window = Window(steps=10, seconds=2.0, periods_ms=[190.0] * 8 + [210.0, 230.0], host_spans_ms=[100.0, 200.0],
                    failed=0)
    return tr.make_record(window=window, setup_s=21.5, shape=(3, 3, 192, 640), device={"name": "NVIDIA H100 80GB HBM3"},
                          trace=TRACE, steps=1, flops_per_step=1e12)


@pytest.mark.parametrize("metric,expected", [
    ("dispatch.launches_per_step", 4.0),
    ("device.idle_pct", 100.0 * (1 - 65e-6 / 0.2)),
    ("convgemm.device_ms_per_step", 0.040),
    ("kernels_roofline", 100.0 * (11_796_480 / 3.35e12) / 10e-6),
    ("step.mfu_pct", 100.0 * 1e12 * 10 / 2.0 / 67e12),
    ("dispatch.host_ms_per_step", 150.0),
    ("examples_per_s", 15.0),
    ("step_ms_p90", 212.0),
    ("setup_s", 21.5),
])
def test_each_reader_on_a_hand_made_trace(record, metric, expected):
    assert spec.metric_reader(metric)(record) == pytest.approx(expected, rel=1e-12)


@pytest.mark.parametrize("metric", [m["name"] for m in spec.load_benchmark()["end_to_end"] + spec.load_benchmark()["per_layer"]
                                    if m["name"].endswith(".device_bound")])
def test_a_split_metric_reads_as_the_metric_it_splits(record, metric):
    assert spec.metric_reader(metric)(record) == spec.metric_reader(metric.rsplit(".", 1)[0])(record)


def test_a_metric_with_no_reader_is_refused():
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("step.flops_util")


def test_readers_find_nothing_in_a_trace_without_device_events(record):
    record["device_events"] = []
    for metric in ("dispatch.launches_per_step", "device.idle_pct", "convgemm.device_ms_per_step", "kernels_roofline"):
        assert spec.metric_reader(metric)(record) is None


def test_breakdown_names_gaps_by_the_operator_the_device_waited_for(record):
    b = tr.breakdown(record)
    assert b["idle_gaps"] == [["before cudaLaunchKernel", 40e-6], ["before aten::add", 10e-6], ["before ?", 5e-6]]
    assert b["device_ops"][0] == ["cudnn_convolution_fwd_kernel", 40e-6]
    assert tr.busy_and_window(record) == pytest.approx((65e-6, 120e-6))


@pytest.mark.parametrize("name,expected", [
    ("void warp_fwd_kernel<float>(WarpArgs)", "warp_fwd"),
    ("void warp_fwd_kernel<__nv_bfloat16>(WarpArgs)", "warp_fwd_bf16"),
    ("void warp_bwd_kernel<__nv_bfloat16, 3, false, true>(BwdArgs)", "warp_bwd_bf16"),
    ("photometric_bwd_kernel(float const*)", "photometric_bwd"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n", "convolution/GEMM"),
])
def test_classifier_names_the_port_kernels_and_their_instances(name, expected):
    assert tr.classify(name) == expected
