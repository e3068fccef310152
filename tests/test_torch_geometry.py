"""The port's geometry and RANSAC ground plane against the JAX package, on
the CPU. The RANSAC indices come from the test and go to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.ops import geometry as tg
from dynamo_depth_torch.ops.ground_plane import ground_plane_fit as t_fit
from dynamo_depth_tpu.ops import geometry as jg
from dynamo_depth_tpu.ops.ground_plane import ground_plane_fit as j_fit
from torch_project_cases import assert_project_bit_equal, project_inputs

# Exact-fp32 products on both sides, summed in another order: ~1e-6 relative.
RTOL, ATOL = 1e-5, 1e-6


def _K(h, w):
    K = np.array([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    return K, np.linalg.pinv(K).astype(np.float32)


def test_disp_depth_roundtrip(rng):
    disp = rng.rand(2, 1, 5, 7).astype(np.float32)
    s_ref, d_ref = jg.disp_to_depth(jnp.asarray(disp), 0.1, 100.0)
    s, d = tg.disp_to_depth(torch.tensor(disp), 0.1, 100.0)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=RTOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=RTOL)
    back = tg.depth_to_disp(d, 0.1, 100.0)
    np.testing.assert_allclose(back.numpy(), np.asarray(jg.depth_to_disp(d_ref, 0.1, 100.0)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters(rng, invert):
    aa = (rng.randn(4, 3) * 0.3).astype(np.float32)
    tr = rng.randn(4, 3).astype(np.float32)
    ref = jg.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr), invert=invert)
    out = tg.transformation_from_parameters(torch.tensor(aa), torch.tensor(tr), invert=invert)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg.rot_from_axisangle(torch.tensor(aa)).numpy(),
                               np.asarray(jg.rot_from_axisangle(jnp.asarray(aa))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tg.translation_matrix(torch.tensor(tr)).numpy(),
                               np.asarray(jg.translation_matrix(jnp.asarray(tr))))


def test_backproject_project(rng):
    B, H, W = 2, 6, 8
    K, inv_K = _K(H, W)
    K = np.broadcast_to(K, (B, 4, 4)).copy()
    inv_K = np.broadcast_to(inv_K, (B, 4, 4)).copy()
    depth = (rng.rand(B, 1, H, W) * 20 + 1).astype(np.float32)
    T = np.asarray(jg.transformation_from_parameters(
        jnp.asarray(rng.randn(B, 3) * 0.05, jnp.float32), jnp.asarray(rng.randn(B, 3) * 0.2, jnp.float32)))

    np.testing.assert_array_equal(tg.pixel_grid(H, W).numpy(), np.asarray(jg.pixel_grid(H, W)))
    pts_ref = jg.backproject(jnp.asarray(depth[:, 0]), jnp.asarray(inv_K))
    pts = tg.backproject(torch.tensor(depth), torch.tensor(inv_K))
    np.testing.assert_allclose(pts.numpy(), np.asarray(pts_ref), rtol=RTOL, atol=ATOL)
    for Tm in (None, T):
        pix_ref, flow_ref = jg.project(pts_ref, jnp.asarray(K), None if Tm is None else jnp.asarray(Tm), height=H, width=W)
        pix, flow = tg.project(pts, torch.tensor(K), None if Tm is None else torch.tensor(Tm), height=H, width=W)
        np.testing.assert_allclose(pix.numpy(), np.asarray(pix_ref), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(flow.numpy(), np.asarray(flow_ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("score_mode", ["per_batch", "reference"])
def test_ground_plane_fit(rng, score_mode):
    B, H, W = 2, 20, 16
    # A noisy ground plane y = 0.02 x - 0.01 z + 1.5 in the bottom rows,
    # clutter above it.
    x = rng.uniform(-5, 5, (B, H, W))
    z = rng.uniform(2, 30, (B, H, W))
    y = 0.02 * x - 0.01 * z + 1.5 + rng.randn(B, H, W) * 0.002
    y[:, : H // 2] = rng.uniform(-3, 1, (B, H // 2, W))
    pts = np.stack([x, y, z], -1).astype(np.float32)
    gh = int(0.4 * H)
    idx = rng.randint(0, gh * W, (B, 5 * 100)).astype(np.int32)

    d_ref, w_ref = j_fit(jnp.asarray(pts), jax.random.PRNGKey(0), score_mode=score_mode, sample_idx=jnp.asarray(idx))
    d, w = t_fit(torch.tensor(pts), None, score_mode=score_mode, sample_idx=torch.tensor(idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-4, atol=1e-5)
    # dist is (B, 1, H, W) in the port, (B, H, W, 1) in the JAX package.
    np.testing.assert_allclose(d.numpy()[:, 0], np.asarray(d_ref)[..., 0], rtol=1e-4, atol=1e-5)


def test_ground_plane_draw_uses_generator():
    pts = torch.rand(2, 10, 8, 3)
    a = t_fit(pts, torch.Generator().manual_seed(3))[1]
    b = t_fit(pts, torch.Generator().manual_seed(3))[1]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("height,width", [(192, 640), (7, 13)])
def test_project_divisor_memoised(height, width, dtype):
    """``project`` divides by one memoised ``[W - 1, H - 1]`` per size and
    dtype, which carries no gradient, and is bit-equal to dividing by a
    fresh tensor, forward and backward."""
    cpu = torch.device("cpu")
    tg._pixel_scale.cache_clear()
    assert_project_bit_equal(height, width, dtype, cpu)
    info = tg._pixel_scale.cache_info()
    assert (info.misses, info.hits) == (1, 1), "two calls, one divisor"
    divisor = tg._pixel_scale(width, height, dtype, cpu)
    assert divisor is tg._pixel_scale(width, height, dtype, cpu)
    assert not divisor.requires_grad and divisor.dtype == dtype
    assert torch.equal(divisor, torch.tensor([width - 1, height - 1], dtype=dtype))


def test_project_divisor_from_inference_mode_serves_autograd():
    """A divisor first built under ``torch.inference_mode`` can still be
    saved for a later backward."""
    tg._pixel_scale.cache_clear()
    points, K, _ = project_inputs(5, 6, torch.float32, torch.device("cpu"))
    with torch.inference_mode():
        tg.project(points, K, height=5, width=6)
    points.requires_grad_(True)
    pix, _ = tg.project(points, K, height=5, width=6)
    pix.sum().backward()
    assert torch.isfinite(points.grad).all()
