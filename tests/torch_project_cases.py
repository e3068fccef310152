"""``ops.geometry.project`` as it was before its divisor was memoised, and a
check that today's is bit-equal to it, forward and backward: shared by the
CPU tests (``test_torch_geometry.py``) and the card's
(``test_torch_no_sync.py``). Imports no JAX."""

import torch

from dynamo_depth_torch.ops import geometry as tg


def project_fresh(points, K, T=None, *, height, width, eps=1e-7):
    """``project`` dividing by a fresh ``torch.tensor`` on every call."""
    B = points.shape[0]
    moved = points if T is None else tg._bmv(T[:, :3, :3], points) + T[:, None, :3, 3]
    uvw = tg._bmv(K[:, :3, :3], moved) + K[:, None, :3, 3]
    pix = uvw[..., :2] / (uvw[..., 2:3] + eps)
    pix = pix / torch.tensor([width - 1, height - 1], dtype=pix.dtype, device=pix.device)
    pix = (pix - 0.5) * 2.0
    return pix.reshape(B, height, width, 2), moved - points


def project_inputs(height, width, dtype, device, batch=2, seed=0):
    """Camera points of a random depth map, KITTI-like intrinsics and a
    small camera motion, in ``dtype`` on ``device``."""
    g = torch.Generator().manual_seed(seed)
    K = torch.tensor([[0.58 * width, 0, 0.5 * width, 0], [0, 1.92 * height, 0.5 * height, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], dtype=torch.float64)
    inv_K = torch.linalg.inv(K).float().expand(batch, 4, 4)
    depth = torch.rand(batch, 1, height, width, generator=g) * 20 + 1
    points = tg.backproject(depth, inv_K)
    T = tg.transformation_from_parameters(torch.randn(batch, 3, generator=g) * 0.05,
                                          torch.randn(batch, 3, generator=g) * 0.2)
    as_dev = lambda t: t.to(device=device, dtype=dtype).contiguous()  # noqa: E731
    return as_dev(points), as_dev(K.float().expand(batch, 4, 4)), as_dev(T)


def assert_project_bit_equal(height, width, dtype, device):
    """``project``'s coordinates, flow and the gradients through both to
    the points, ``K`` and ``T`` are ``torch.equal`` to ``project_fresh``'s,
    with and without ``T``."""
    points, K, T = project_inputs(height, width, dtype, device)
    g = torch.Generator().manual_seed(1)
    w_pix = torch.randn(points.shape[0], height, width, 2, generator=g).to(device=device, dtype=dtype)
    w_flow = torch.randn(points.shape, generator=g).to(device=device, dtype=dtype)
    for motion in (None, T):
        results = []
        for fn in (tg.project, project_fresh):
            leaves = [t.clone().requires_grad_(True) for t in (points, K) + (() if motion is None else (motion,))]
            pix, flow = fn(*leaves, height=height, width=width)
            grads = torch.autograd.grad((pix * w_pix).sum() + (flow * w_flow).sum(), leaves)
            results.append((pix, flow) + grads)
        for got, want in zip(*results):
            assert got.dtype == want.dtype and torch.equal(got, want)
