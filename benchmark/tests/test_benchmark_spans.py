"""``benchmark/spans.py`` on a hand-built Chrome trace of one step: the
blocking calls, attribution to the innermost span, the backward mapped to
its forward span by sequence number, the idle gaps; the record's keys;
``span_table`` driven on the CPU."""

import pytest

from benchmark import spans, trace
from benchmark.tests.conftest import tiny_cell

MAIN, AUTOGRAD, STREAM = (1, 10), (1, 20), (0, 7)


def _x(cat, name, ts, dur, where, **args):
    pid, tid = where
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur, "args": args}


def _span(name, ts, dur):
    return _x("user_annotation", name, ts, dur, MAIN)


def _launch(corr, ts, where=MAIN, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, ts, 2, where, correlation=corr)


def _kernel(corr, name, ts, dur, cat="kernel"):
    return _x(cat, name, ts, dur, STREAM, correlation=corr)


def _step_trace():
    """One step: pyramid, view synthesis, the losses holding the ground
    plane, backward on autograd's thread, the optimizer; then one launch
    and one synchronize after the step, outside every span."""
    seq = "Sequence number"
    events = [
        _span("dynamo.train_step", 0, 1000), _span("dynamo.pyramid", 10, 90), _span("dynamo.view_synthesis", 100, 200),
        _span("dynamo.losses", 300, 200), _span("dynamo.ground_plane", 350, 100), _span("dynamo.backward", 500, 300),
        _span("dynamo.optimizer", 800, 150),
        # forward: the pyramid's mm makes no graph node; the warp's and the ground plane's mul do
        _x("cpu_op", "aten::mm", 20, 10, MAIN, **{seq: 6}), _launch(1, 25), _kernel(1, "gemm_a", 30, 50),
        _x("cpu_op", "WarpFunction", 150, 20, MAIN, **{seq: 6}), _launch(2, 155),
        _kernel(2, "warp_fwd_kernel<float>", 200, 20),
        _x("cpu_op", "aten::mul", 360, 10, MAIN, **{seq: 7}), _launch(3, 365), _kernel(3, "elementwise_mul", 220, 30),
        _launch(4, 305, name="cudaMemcpyAsync"), _kernel(4, "Memcpy HtoD (Pageable -> Device)", 260, 2, "gpu_memcpy"),
        _launch(5, 310, name="cudaStreamSynchronize"), _launch(6, 320, name="cudaMemcpy"),
        # backward, on autograd's thread
        _x("cpu_op", "autograd::engine::evaluate_function: WarpFunctionBackward", 600, 50, AUTOGRAD, **{seq: 6}),
        _launch(7, 610, AUTOGRAD), _kernel(7, "warp_bwd_kernel<float>", 620, 10),
        _x("cpu_op", "autograd::engine::evaluate_function: MulBackward0", 660, 20, AUTOGRAD, **{seq: 7}),
        _launch(8, 665, AUTOGRAD), _kernel(8, "elementwise_mul_bwd", 670, 5),
        _x("cpu_op", "autograd::engine::evaluate_function: torch::autograd::AccumulateGrad", 700, 20, AUTOGRAD,
           **{seq: 2**64 - 1}),
        _launch(9, 705, AUTOGRAD), _kernel(9, "elementwise_acc", 710, 5),
        _launch(10, 810), _kernel(10, "multi_tensor_apply_kernel", 900, 40),
        # after the step
        _launch(11, 1050, name="cudaDeviceSynchronize"), _launch(12, 1090), _kernel(12, "elementwise_after", 1100, 5),
    ]
    return {"traceEvents": events + [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 10, "args": {"name": "main"}}]}


@pytest.fixture(scope="module")
def view():
    return spans.program_view(_step_trace())


def test_blocking_calls_inside_the_step_are_counted_by_span(view):
    assert view["steps"] == 1
    assert view["syncs"] == 2
    assert [(b.name, b.span) for b in view["blocking"]] == [
        ("cudaStreamSynchronize", "dynamo.losses"), ("cudaMemcpy", "dynamo.losses"), ("cudaDeviceSynchronize", None)]
    assert view["spans"]["dynamo.losses"]["syncs"] == 2
    assert not spans.is_blocking("cudaMemcpyAsync") and spans.is_blocking("cudaMemcpy2D")


def test_device_time_goes_to_the_innermost_span(view):
    rows = view["spans"]
    assert rows["dynamo.pyramid"]["device_ms"] == pytest.approx(0.050)
    assert rows["dynamo.losses"]["device_ms"] == pytest.approx(0.002)  # the memcpy; the mul is the ground plane's
    assert rows["dynamo.optimizer"]["launches"] == 1
    assert view["unattributed_ms"] == pytest.approx(0.005)
    assert view["device_ms"] == pytest.approx(sum(r["device_ms"] for r in rows.values()) + 0.005)


def test_backward_is_mapped_to_its_forward_span_by_sequence_number(view):
    rows = view["spans"]
    assert rows["dynamo.view_synthesis"]["device_ms"] == pytest.approx(0.020 + 0.010)
    assert rows["dynamo.ground_plane"]["device_ms"] == pytest.approx(0.030 + 0.005)
    assert rows["dynamo.backward"]["device_ms"] == pytest.approx(0.005)  # AccumulateGrad: no forward op
    assert view["port_kernels"] == {"dynamo.view_synthesis": 2}
    assert spans.synthesis_losses_device_ms(view) == pytest.approx(0.030 + 0.035 + 0.002)


def test_an_idle_gap_goes_to_the_span_of_the_launch_that_ends_it(view):
    rows = view["spans"]
    assert rows["dynamo.view_synthesis"]["idle_ms"] == pytest.approx(0.120)
    assert rows["dynamo.losses"]["idle_ms"] == pytest.approx(0.010)
    assert rows["dynamo.backward"]["idle_ms"] == pytest.approx(0.358 + 0.040 + 0.035)  # issued from autograd's thread
    assert rows["dynamo.optimizer"]["idle_ms"] == pytest.approx(0.185)
    # each with the span the step's thread was in when the card fell idle
    assert view["gaps"][0] == [pytest.approx(0.358), "cudaLaunchKernel", "dynamo.backward", "dynamo.view_synthesis"]
    assert [pytest.approx(0.120), "cudaLaunchKernel", "dynamo.view_synthesis", "dynamo.pyramid"] in view["gaps"]
    assert [pytest.approx(0.160), "cudaLaunchKernel", None, "dynamo.optimizer"] in view["gaps"]  # ends after the step
    assert [pytest.approx(0.010), "cudaMemcpyAsync", "dynamo.losses", "dynamo.view_synthesis"] in view["gaps"]


def test_a_trace_without_the_program_spans_has_no_view():
    events = [e for e in _step_trace()["traceEvents"] if e.get("cat") != "user_annotation"]
    assert spans.program_view({"traceEvents": events}) is None


def test_the_record_reads_the_same_trace_as_before():
    class Window:
        steps, seconds, periods_ms, host_spans_ms = 2, 0.5, [250.0, 250.0], [200.0, 210.0]

    record = trace.make_record(window=Window, setup_s=1.0, shape=(3, 3, 192, 640), device={"name": "x"},
                               trace=_step_trace(), steps=1, flops_per_step=1.0)
    assert list(record) == ["setup_s", "image_shape", "device", "window", "profiled_steps", "device_events",
                            "flops_per_step"]
    assert len(record["device_events"]) == 9
    device_ms = spans.program_view(_step_trace())["device_ms"]
    assert sum(e["dur"] for e in record["device_events"]) / 1e3 == pytest.approx(device_ms)
    assert trace.breakdown(record)["idle_gaps"][0] == ["before cudaLaunchKernel", pytest.approx(358e-6)]


def test_recorded_view_means_over_steps_with_self_time():
    ms = 1_000_000
    rec = [("dynamo.train_step", -1, 0, 0, 10 * ms), ("dynamo.losses", 0, 0, 1 * ms, 5 * ms),
           ("dynamo.ground_plane", 1, 0, 2 * ms, 3 * ms), ("dynamo.ground_plane", 1, 0, 3 * ms, 4 * ms),
           ("dynamo.train_step", -1, 1, 20 * ms, 26 * ms), ("dynamo.losses", 4, 1, 21 * ms, 23 * ms)]
    out = spans.recorded_view(rec)
    assert out["dynamo.train_step"] == {"host_ms": pytest.approx(8.0), "self_ms": pytest.approx(5.0)}
    assert out["dynamo.losses"] == {"host_ms": pytest.approx(3.0), "self_ms": pytest.approx(2.0)}
    assert out["dynamo.ground_plane"]["host_ms"] == pytest.approx(1.0)
    assert spans.host_ms(out, ("dynamo.losses", "dynamo.optimizer")) == pytest.approx(3.0)
    assert spans.host_ms(out, ("dynamo.optimizer",)) is None
    assert spans.recorded_view([]) == {}


def test_span_table_on_the_cpu(host_timing):
    from benchmark import span_table

    result, chrome = span_table.measure(tiny_cell("monodepthv2-kitti-b3"), 2**31 + 5, 2, device="cpu")
    assert len(result["host_ms_per_step"]["on"]) == len(result["host_ms_per_step"]["off"]) == 2
    assert set(result["recorded"]) == {"dynamo.train_step", "dynamo.pyramid", "dynamo.networks",
                                       "dynamo.view_synthesis", "dynamo.losses", "dynamo.ground_plane",
                                       "dynamo.backward", "dynamo.optimizer", "dynamo.batch_stats"}
    assert result["trace"]["steps"] == 1 and result["trace"]["device_ms"] == 0.0  # no card, no device event
    assert result["metrics"]["optimizer.host_ms_per_step"] > 0
    assert len(span_table.lines(result)) == 9
