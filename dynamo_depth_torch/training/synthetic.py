"""A fixed synthetic training batch, and a sample grid that stands in for
a trained model's ego-motion.

:func:`synthetic_batch` is the port's own copy of
``__graft_entry__.py::_synthetic_batch``: the same numpy draws in the same
order and the same layout, images (B, H, W, 3) as the data loader gives
them, so both packages can be fed one batch. ``Trainer.to_device`` makes the
images NCHW on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_depth_torch.ops.geometry import backproject, project, transformation_from_parameters

# Normalized KITTI intrinsics of the synthetic batch (scale 0 multiplies the
# first row by the width and the second by the height).
K_NORM = np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)


def synthetic_batch(cfg, batch_size, height, width, seed=0):
    """{('color_aug', f, 0), ('color', f, 0): (B, H, W, 3), ('ts', f): (B,),
    ('K', s), ('inv_K', s): (B, 4, 4)} as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    batch = {}
    for f in cfg.frame_ids:
        batch[("color_aug", f, 0)] = rng.rand(batch_size, height, width, 3).astype(np.float32)
        batch[("color", f, 0)] = rng.rand(batch_size, height, width, 3).astype(np.float32)
        batch[("ts", f)] = np.ones((batch_size,), np.float32)
    for s in cfg.scales:
        K = K_NORM.copy()
        K[0] *= width // (2 ** s)
        K[1] *= height // (2 ** s)
        batch[("K", s)] = np.broadcast_to(K, (batch_size, 4, 4)).copy()
        batch[("inv_K", s)] = np.broadcast_to(np.linalg.pinv(K), (batch_size, 4, 4)).copy()
    return batch


def ego_motion_grid(batch_size, height, width, seed=0):
    """A sample grid that stands in for a trained model's ego-motion: the
    pixels of a smooth random depth map of 5 to 80 m, backprojected with the
    KITTI intrinsics, moved by a camera that drives about 1 m forward with a
    small yaw, and projected again (``backproject`` and ``project``, as view
    synthesis does).
    -> ``(B, H, W, 2)`` float32 on the CPU, in [-1, 1] where the sample lands
    inside the source image."""
    rng = np.random.RandomState(seed)
    K = K_NORM.copy()
    K[0] *= width
    K[1] *= height
    K = torch.from_numpy(np.broadcast_to(K, (batch_size, 4, 4)).copy())
    # Disparity uniform between 1/80 and 1/5, smooth over ~32-pixel cells.
    coarse = torch.from_numpy(rng.rand(batch_size, 1, max(height // 32, 2), max(width // 32, 2)).astype(np.float32))
    u = F.interpolate(coarse, size=(height, width), mode="bilinear", align_corners=False)
    depth = 1.0 / (1.0 / 80.0 + u * (1.0 / 5.0 - 1.0 / 80.0))
    yaw = rng.uniform(-0.01, 0.01, batch_size)
    axisangle = torch.from_numpy(np.stack([np.zeros_like(yaw), yaw, np.zeros_like(yaw)], -1).astype(np.float32))
    # Points come ~1 m closer: the camera drove forward.
    shift = np.stack([rng.uniform(-0.05, 0.05, batch_size), rng.uniform(-0.02, 0.02, batch_size),
                      -rng.uniform(0.9, 1.1, batch_size)], -1)
    T = transformation_from_parameters(axisangle, torch.from_numpy(shift.astype(np.float32)))
    grid, _ = project(backproject(depth, torch.linalg.inv(K)), K, T, height=height, width=width)
    return grid.contiguous()
