"""NHWC <-> NCHW for tensors and numpy arrays.

The JAX package keeps images channels-last; the port keeps them
channels-first. Tests convert at the boundary with these helpers. Sample
grids ``(B, H, W, 2)`` and point clouds ``(B, N, 3)`` are coordinate lists,
not images, and keep their layout in both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def nhwc_to_nchw(x):
    """(B, H, W, C) -> (B, C, H, W) for a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.permute(0, 3, 1, 2).contiguous()
    return np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2)))


def nchw_to_nhwc(x):
    """(B, C, H, W) -> (B, H, W, C) for a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.permute(0, 2, 3, 1).contiguous()
    return np.ascontiguousarray(np.transpose(np.asarray(x), (0, 2, 3, 1)))
