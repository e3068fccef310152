"""Batched RANSAC ground-plane estimation (port of
``dynamo_depth_tpu.ops.ground_plane``, reference ``tools.py:76-164``).

Every hypothesis is solved as one batched 3x3 normal-equation system and
scored in one contraction. All products are written as exact-fp32
multiply-adds: the 5-point solve (AtA entries O(1e2), regularizer 1e-6)
loses the plane in reduced precision, which the JAX package measured as an
81% error in ``d_ground`` on the TPU. The hypothesis draw is
:func:`draw_sample_idx`, which takes a ``torch.Generator``.
"""

from __future__ import annotations

import torch


def draw_sample_idx(batch: int, total: int, num_candidates: int, generator, device):
    """(batch, total) uniform indices in [0, num_candidates), with
    replacement — np.random.choice(N, T, replace=True) at tools.py:126."""
    return torch.randint(0, num_candidates, (batch, total), generator=generator, device=device)


def _inv3x3(m):
    """Closed-form adjugate inverse of a (..., 3, 3) batch."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = torch.stack([
        torch.stack([co_a, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([co_b, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([co_c, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _mm(a, b):
    """Exact-fp32 batched matmul of small matrices (..., n, k) x (..., k, m)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _dot3(a, w):
    """Exact-fp32 ``sum_k a[..., k] * w[..., k]`` with broadcasting, without
    materializing the (..., 3) product."""
    return a[..., 0] * w[..., 0] + a[..., 1] * w[..., 1] + a[..., 2] * w[..., 2]


def _plane_AB(points, vertical_axis=1):
    """Split points (..., 3) into A (..., 3) = [x, z, 1] and b (..., 1) = y for
    the plane model y = w1*x + w2*z + w3 (tools.py:156-164)."""
    b = points[..., vertical_axis:vertical_axis + 1]
    others = [points[..., i:i + 1] for i in range(3) if i != vertical_axis]
    return torch.cat(others + [torch.ones_like(b)], dim=-1), b


def ground_plane_fit(
    points,
    generator=None,
    *,
    num_points_per_it=5,
    max_it=100,
    tol=0.005,
    g_prior=0.4,
    vertical_axis=1,
    score_mode="per_batch",
    sample_idx=None,
):
    """Estimate a ground plane per batch element and point-to-plane distances.

    :param points: ``(B, H, W, 3)`` camera-frame points
    :param generator: ``torch.Generator`` for the hypothesis draw
    :param sample_idx: ``(B, num_points_per_it * max_it)`` indices overriding
        the draw
    :return: (dist ``(B, 1, H, W)``, plane_param ``(B, 3, 1)``), both detached.
    """
    points = points.detach()
    B, H, W, _ = points.shape
    gh = int(g_prior * H)
    N = gh * W
    candidates = points[:, H - gh:].reshape(B, N, 3)  # bottom rows
    T = num_points_per_it * max_it

    idx = draw_sample_idx(B, T, N, generator, points.device) if sample_idx is None else sample_idx
    samp = torch.gather(candidates, 1, idx.long()[..., None].expand(B, T, 3))
    samp = samp.reshape(B * max_it, num_points_per_it, 3)

    A, b = _plane_AB(samp, vertical_axis)  # (BM, n, 3), (BM, n, 1)
    At = A.transpose(1, 2)
    # NOTE: the reference adds the scalar 1e-6 to every entry of AtA (not to
    # the diagonal) — tools.py:152; replicated for parity.
    w = _mm(_mm(_inv3x3(_mm(At, A) + 1e-6), At), b)  # (BM, 3, 1)

    Ac, bc = _plane_AB(candidates, vertical_axis)  # (B, N, 3), (B, N, 1)
    w_b = w.reshape(B, max_it, 3)
    if score_mode == "per_batch":
        # dist[b, m, n] = A[b, n, :] . w[b, m, :] - y[b, n]
        dist = _dot3(Ac[:, None], w_b[:, :, None]) - bc[:, None, :, 0]
        inlier_frac = torch.mean((torch.abs(dist) < tol).to(points.dtype), dim=2)  # (B, M)
    elif score_mode == "reference":
        # Reference pairing (tools.py:130-133): flat hypothesis i = b*max_it+m
        # is scored against batch element i % B.
        pair = torch.arange(B * max_it, device=points.device) % B
        dist = _dot3(Ac[pair], w.reshape(B * max_it, 1, 3)) - bc[pair][..., 0]
        inlier_frac = torch.mean((torch.abs(dist) < tol).to(points.dtype), dim=1).reshape(B, max_it)
    else:
        raise ValueError(f"score_mode {score_mode!r} not recognized")
    best = torch.argmax(inlier_frac, dim=1)  # (B,) first maximum, as jnp.argmax
    best_w = w_b[torch.arange(B, device=points.device), best]  # (B, 3)

    Aall, ball = _plane_AB(points.reshape(B, H * W, 3), vertical_axis)
    d = _dot3(Aall, best_w[:, None]) - ball[..., 0]
    return d.reshape(B, 1, H, W), best_w[..., None]
