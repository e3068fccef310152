"""Peaks of the card, and the bytes and operations of the program's four
CUDA kernels, worked out from the cell's shapes.

Peaks are NVIDIA's published figures for the H100 SXM (dense, at the full
700 W power limit). A kernel's least time is the larger of the bytes it
needs over the memory bandwidth and its operations over the float32 peak:
each input byte read once and each output byte written once, whatever the
kernel reads again.
"""

from __future__ import annotations

from typing import Optional

# name fragments of torch.cuda.get_device_name() -> peaks
PEAKS = {
    "H100": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> Optional[dict]:
    """The peaks of the card ``device_name`` names; None for a card the
    table does not hold."""
    for fragment, p in PEAKS.items():
        if fragment in device_name and "PCIe" not in device_name:
            return p
    return None


_F32, _BF16 = 4, 2


def kernel_work(kernel: str, B: int, C: int, H: int, W: int) -> tuple:
    """(bytes, operations) of one launch of a port kernel on ``(B, C, H,
    W)`` float32 images (a ``_bf16`` instance reads a bfloat16 image) and a
    ``(B, H, W, 2)`` float32 grid.

    - ``warp_fwd``: image and grid in, the warped image out; per pixel 12
      operations of coordinates, per channel 6 of the two-level lerp.
    - ``warp_bwd``: image, grid and the output's gradient in, the grid's
      gradient out (the source image takes none in the step); per pixel 12,
      per channel 10.
    - ``photometric_fwd``: the two images in, one error map out; per pixel
      and channel 40 (five 3x3 box sums, SSIM, L1), per pixel 4.
    - ``photometric_bwd``: the two images and the map's gradient in, the
      prediction's gradient out; per pixel and channel 100, per pixel 4.
    """
    px = B * H * W
    image = _BF16 if kernel.endswith("_bf16") else _F32
    grid = px * 2 * _F32
    plane = px * C * _F32
    base = kernel.removesuffix("_bf16")
    if base == "warp_fwd":
        return px * C * image + grid + plane, px * (12 + 6 * C)
    if base == "warp_bwd":
        return px * C * image + grid + plane + grid, px * (12 + 10 * C)
    if base == "photometric_fwd":
        return 2 * plane + px * _F32, px * (4 + 40 * C)
    if base == "photometric_bwd":
        return 2 * plane + px * _F32 + plane, px * (4 + 100 * C)
    raise ValueError(f"no work counted for kernel {kernel!r}")


def least_seconds(kernel: str, shape: tuple, card: dict) -> float:
    nbytes, ops = kernel_work(kernel, *shape)
    return max(nbytes / card["hbm_bytes_per_s"], ops / card["fp32_flops"])
