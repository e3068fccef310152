"""NaN robustness of the port's ground-plane depth
(``dynamo_depth_torch/training/losses.py::process_ground``), the port of
``tests/test_ground_nan.py``.

A ray parallel to the fitted plane makes the ground-depth denominator 0;
with ``w3 + gp_tol == 0`` that is 0/0, which the range check cannot catch
(NaN compares false) and which reaches the gradient through ``where``
unless the denominator itself is made safe (the double ``where``). The same
fake fit and the same 1x8x12 disparity as the JAX test: the value and the
gradient are finite, and equal to the JAX package's on the same input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.training import losses as t_losses
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.training import losses as j_losses

B, H, W = 1, 8, 12


def _port_value_and_grad(cfg, disp_nhwc):
    disp = torch.from_numpy(disp_nhwc).permute(0, 3, 1, 2).contiguous().requires_grad_()
    inputs = {("inv_K", 0): torch.eye(4).expand(B, 4, 4)}
    _, disp_diff, _ = t_losses.process_ground(cfg, inputs, {("disp", 0, 0): disp}, 0, torch.Generator())
    loss = torch.mean(torch.minimum(disp_diff, torch.zeros_like(disp_diff)))
    (grad,) = torch.autograd.grad(loss, disp)
    return loss.item(), grad.permute(0, 2, 3, 1).numpy()


def _jax_value_and_grad(cfg, disp_nhwc):
    inputs = {("inv_K", 0): jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (B, 4, 4))}

    def loss_of(disp):
        _, disp_diff, _ = j_losses.process_ground(cfg, inputs, {("disp", 0, 0): disp}, 0, jax.random.PRNGKey(0))
        return jnp.mean(jnp.minimum(disp_diff, 0.0))

    val, grad = jax.value_and_grad(loss_of)(jnp.asarray(disp_nhwc))
    return float(val), np.asarray(grad)


def test_process_ground_nan_safe_value_and_grad(monkeypatch, rng):
    tcfg = TConfig(dataset="kitti", height=H, width=W, scales=[0], no_train_vis=True)
    jcfg = JConfig(dataset="kitti", height=H, width=W, scales=[0], no_train_vis=True)
    assert tcfg.gp_tol == jcfg.gp_tol

    # The plane makes denom = vy - vx * w1 - vz * w2 = y - 1 zero on pixel
    # row 1 (identity inv_K: the rays are the raw [x, y, 1] grid), and
    # w3 + gp_tol == 0: 0/0 in the unguarded form.
    def t_fit(pts, generator, **kw):
        return torch.zeros(pts.shape[:-1]), torch.tensor([[0.0, 1.0, -tcfg.gp_tol]])

    def j_fit(pts, rng, **kw):
        return jnp.zeros(pts.shape[:-1], jnp.float32), jnp.asarray([[0.0, 1.0, -jcfg.gp_tol]], jnp.float32)

    monkeypatch.setattr(t_losses, "ground_plane_fit", t_fit)
    monkeypatch.setattr(j_losses, "ground_plane_fit", j_fit)

    disp = rng.rand(B, H, W, 1).astype(np.float32) * np.float32(0.3)
    val, grad = _port_value_and_grad(tcfg, disp)
    assert np.isfinite(val), val
    assert np.isfinite(grad).all()
    ref_val, ref_grad = _jax_value_and_grad(jcfg, disp)
    # float32 geometry in another order of operations
    np.testing.assert_allclose(val, ref_val, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(grad, ref_grad, rtol=1e-5, atol=1e-7)
