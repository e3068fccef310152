"""NHWC <-> NCHW for tensors and numpy arrays.

The JAX package keeps images channels-last; the port keeps them
channels-first. Tests convert at the boundary with these helpers, and the
eval CLIs' host code, which keeps the JAX package's layout, takes the
model's outputs through :func:`outputs_to_host`. Sample grids ``(B, H, W,
2)`` and point clouds ``(B, N, 3)`` are coordinate lists, not images, and
keep their layout in both packages.
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


def outputs_to_host(outputs):
    """The model's outputs on the device -> numpy in the JAX package's
    layout: the 4-D ones, which are images (disparity, flow, mask), become
    (B, H, W, C); poses and matrices keep their shape."""
    return {k: (nchw_to_nhwc(v) if v.dim() == 4 else v).detach().cpu().numpy() for k, v in outputs.items()}
