"""A fixed synthetic training batch in NCHW.

The port's own copy of ``__graft_entry__.py::_synthetic_batch``: the same
numpy draws in the same order (so both packages can be fed one batch), with
images transposed to (B, 3, H, W).
"""

from __future__ import annotations

import numpy as np


def synthetic_batch(cfg, batch_size, height, width, seed=0):
    """{('color_aug', f, 0), ('color', f, 0): (B, 3, H, W), ('ts', f): (B,),
    ('K', s), ('inv_K', s): (B, 4, 4)} as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    batch = {}
    for f in cfg.frame_ids:
        batch[("color_aug", f, 0)] = rng.rand(batch_size, height, width, 3).astype(np.float32).transpose(0, 3, 1, 2).copy()
        batch[("color", f, 0)] = rng.rand(batch_size, height, width, 3).astype(np.float32).transpose(0, 3, 1, 2).copy()
        batch[("ts", f)] = np.ones((batch_size,), np.float32)
    K0 = np.array([[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    for s in cfg.scales:
        K = K0.copy()
        K[0] *= width // (2 ** s)
        K[1] *= height // (2 ** s)
        batch[("K", s)] = np.broadcast_to(K, (batch_size, 4, 4)).copy()
        batch[("inv_K", s)] = np.broadcast_to(np.linalg.pinv(K), (batch_size, 4, 4)).copy()
    return batch
