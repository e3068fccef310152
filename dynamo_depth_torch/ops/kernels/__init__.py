"""Hand-written CUDA kernels of the view-synthesis hot path, with their
plain PyTorch versions and launch counters.

    K1 warp_fwd, K2 warp_bwd                 -> ops/kernels/warp.py, csrc/warp.cu
    K3 photometric_fwd, K4 photometric_bwd   -> ops/kernels/photometric.py, csrc/photometric.cu

Each wrapper adds one to its counter where it launches its kernel and
nowhere else, so a run can show which kernels its main path went through.
"""

from dynamo_depth_torch.ops.kernels import photometric, warp

_COUNTERS = (warp.LAUNCHES, photometric.LAUNCHES)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    out = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
