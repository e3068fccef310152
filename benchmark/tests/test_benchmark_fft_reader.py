"""The reader of ``convgemm.fft_ms_per_step`` on a small trace made by hand:
cuDNN's FFT-path and Winograd kernels count, its implicit-GEMM kernels and
everything else do not."""

import pytest

from benchmark import spec
from benchmark import trace as tr
from benchmark.program import Window

# Kernel names as the profiler gives them on an H100 (shortened), and their
# device µs in one profiled step.
FFT_PATH = [
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_tn_n_tilesize32x32x8_stage3_warpsize1x2x1_ffma_aligna8_alignc8", 300),
    ("void fft2d_r2c_32x32<float, false, 0u, false>(float2*, float const*, int, int, int, int, int)", 40),
    ("void fft2d_c2r_32x32<float, false, false, 0u, false, false>(float*, float2 const*, int, int)", 30),
    ("void DSE::regular_fft_pad<0, 1, 256, 16, 16, 1, float, float, float2>(float2*, float*, int)", 20),
    ("void DSE::vector_fft<0, 1, 256, 16, 16, 1, float, float, float2>(float2*, float2, int, int3)", 8),
    ("void cudnn::winograd_nonfused::winogradForwardData4x4<float, float>(cudnn::winograd_nonfused::Params)", 2),
]
OTHERS = [
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc_tilesize128x128x8_stage3_warpsize2x2x1", 500),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_f32f32_f32_nhwckrsc_nhwc_tilesize64x64x8_stage3", 200),
    ("sm80_xmma_dgrad_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tilesize64x32x8_stage5_warpsize2x1x1", 100),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>", 50),
    ("void cudnn::bn_bw_1C11_kernel_new<float, float, float2, 512, true, 1>(float, float)", 10),
]


def _record(kernels, steps=2):
    events, ts = [], 0
    for _ in range(steps):
        for name, dur in kernels:
            events.append({"ph": "X", "name": name, "cat": "kernel", "ts": ts, "dur": dur, "pid": 1, "tid": 7})
            ts += dur + 1
    events.append({"ph": "X", "name": "Memcpy DtoD (fft)", "cat": "gpu_memcpy", "ts": ts, "dur": 5, "pid": 1, "tid": 7})
    window = Window(steps=10, seconds=2.0, periods_ms=[200.0] * 10, host_spans_ms=[150.0], failed=0)
    return tr.make_record(window=window, setup_s=20.0, shape=(12, 3, 192, 640), device={"name": "NVIDIA H100 80GB HBM3"},
                          trace={"traceEvents": events}, steps=steps)


@pytest.mark.parametrize("metric", ["convgemm.fft_ms_per_step", "convgemm.fft_ms_per_step.device_bound"])
def test_fft_path_kernels_count_and_implicit_gemm_kernels_do_not(metric):
    read = spec.metric_reader(metric)
    assert read(_record(FFT_PATH + OTHERS)) == pytest.approx(sum(d for _, d in FFT_PATH) / 1e3, rel=1e-12)
    assert read(_record(OTHERS)) == 0.0
    assert read(_record([])) == 0.0  # a memcpy alone


def test_every_counted_kernel_is_one_the_convolution_reader_counts():
    """The FFT time is a part of ``convgemm.device_ms_per_step``."""
    record = _record(FFT_PATH + OTHERS)
    fft = spec.metric_reader("convgemm.fft_ms_per_step")(record)
    assert all(tr.classify(name) == "convolution/GEMM" for name, _ in FFT_PATH)
    assert fft < spec.metric_reader("convgemm.device_ms_per_step")(record)


def test_nothing_is_read_without_device_events():
    record = _record(OTHERS)
    record["device_events"] = []
    assert spec.metric_reader("convgemm.fft_ms_per_step")(record) is None
