"""The eval path's building blocks in the port against the JAX package's, on
the CPU: the PR-sweep counts (exactly equal, also where a batch passes 2^24
pixels and the float32 sums round), the bilinear upsampling to each
dataset's full resolution, the visualisation helpers, and
``Trainer.predict`` for the three flag settings, from one checkpoint folder
that both packages load."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.ops import seg_metrics as tseg
from dynamo_depth_torch.ops import warp as tw
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_torch.utils import vis as tvis
from dynamo_depth_torch.utils.layout import nchw_to_nhwc, nhwc_to_nchw, outputs_to_host
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.ops import warp as jw
from dynamo_depth_tpu.ops.seg_metrics import pr_sweep_counts as j_pr_sweep_counts
from dynamo_depth_tpu.training.trainer import Trainer as JTrainer
from dynamo_depth_tpu.utils import vis as jvis
from test_torch_eval_common import H, W, save_checkpoint
from torch_test_threads import two_torch_threads  # noqa: F401

NUM_THRD = 150
EPS = 1 / (NUM_THRD - 1)
THRDS = np.linspace(0 - EPS, 1 - EPS, NUM_THRD).astype(np.float32)


def _sweep_both(pred, gt, weight=None, thrds=THRDS):
    j = j_pr_sweep_counts(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(thrds),
                          None if weight is None else jnp.asarray(weight))
    t = tseg.pr_sweep_counts(torch.as_tensor(pred), torch.as_tensor(gt), torch.as_tensor(thrds),
                             None if weight is None else torch.as_tensor(weight))
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("case", ["at_thresholds", "labels_1_2_3", "zero_weights", "no_weights", "short_sweep"])
def test_pr_sweep_counts_equal_the_jax_packages(case):
    rng = np.random.RandomState(0)
    B, h, w = 4, 24, 40
    pred = rng.rand(B, h, w).astype(np.float32)
    gt = rng.randint(1, 4, (B, h, w)).astype(np.uint8)
    weight = np.ones((B,), np.float32)
    thrds = THRDS
    if case == "at_thresholds":
        # pred > t is strict: a pixel exactly at a threshold stays below it.
        pred.reshape(-1)[: 2 * NUM_THRD] = np.tile(THRDS, 2)
    elif case == "labels_1_2_3":
        gt[0] = 1
        gt[1] = 2
        gt[2] = 3
    elif case == "zero_weights":
        weight[[1, 3]] = 0.0
    elif case == "short_sweep":
        thrds = np.sort(rng.rand(7).astype(np.float32))
    j, t = _sweep_both(pred, gt, None if case == "no_weights" else weight, thrds)
    for name, a, b in zip(("tp", "fp", "fn"), j, t):
        assert b.dtype == np.float32 and b.shape == (len(thrds),)
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_pr_sweep_counts_round_as_the_jax_packages_above_2_24_pixels():
    rng = np.random.RandomState(1)
    B, h, w = 4, 1500, 3000  # 18.0M pixels
    pred = rng.rand(B, h, w).astype(np.float32)
    # Mostly moving: the tp and valid sums both pass 2^24.
    gt = np.where(rng.rand(B, h, w) < 0.95, 1, rng.randint(2, 4, (B, h, w))).astype(np.uint8)
    j, t = _sweep_both(pred, gt)
    for name, a, b in zip(("tp", "fp", "fn"), j, t):
        np.testing.assert_array_equal(b, a, err_msg=name)
    # The case is one where float32 rounds: the exact count differs.
    b = np.searchsorted(THRDS, pred.reshape(B, -1), side="left")
    exact_tp = np.array([((b > i) & (gt.reshape(B, -1) == 1)).sum() for i in range(0, NUM_THRD, 37)])
    assert exact_tp.max() > 2 ** 24
    assert (j[0][::37].astype(np.int64) != exact_tp).any()


@pytest.mark.parametrize("n", [7, 151, 300, 5000])
def test_cumulative_and_total_sums_in_xlas_order(n):
    x = np.random.RandomState(n).randint(1, 3_000_000, n).astype(np.float32)
    np.testing.assert_array_equal(tseg._cumsum_f32(torch.as_tensor(x)).numpy(), np.asarray(jnp.cumsum(x)))
    assert float(tseg._sum_f32(torch.as_tensor(x))) == float(jnp.sum(jnp.asarray(x)))


@pytest.mark.parametrize("full_hw", [(375, 1242), (1280, 1920), (900, 1600)], ids=["kitti", "waymo", "nuscenes"])
def test_resize_bilinear_to_full_resolution(full_hw):
    x = np.random.RandomState(2).rand(2, 192, 640, 1).astype(np.float32)
    ref = np.asarray(jw.resize_bilinear(jnp.asarray(x), full_hw))
    out = nchw_to_nhwc(tw.resize_bilinear(torch.as_tensor(nhwc_to_nchw(x)), full_hw).numpy())
    assert out.shape == ref.shape == (2,) + full_hw + (1,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_colour_wheel_helpers():
    rng = np.random.RandomState(3)
    flow = rng.randn(2, 12, 20, 2).astype(np.float32)
    flow[0, 0, :4] = [[0, 0], [1, 0], [0, -1], [-2, 0]]  # zero and on-axis vectors
    for a, b in zip(tvis.cart2polar(flow), jvis.cart2polar(flow)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    hsv = rng.rand(2, 12, 20, 3).astype(np.float32)
    np.testing.assert_allclose(tvis.hsv_to_rgb(hsv), jvis.hsv_to_rgb(hsv), rtol=0, atol=1e-5)
    for max_mag in (None, 2.5):
        rgb, hsv_t, mag_t = tvis.flow_vis(flow, max_mag)
        rgb_j, hsv_j, mag_j = jvis.flow_vis(flow, max_mag)
        np.testing.assert_allclose(rgb, rgb_j, rtol=0, atol=1e-5)
        np.testing.assert_allclose(hsv_t, hsv_j, rtol=0, atol=1e-5)
        assert mag_t == pytest.approx(mag_j, rel=1e-6)
    np.testing.assert_array_equal(tvis.make_ind_map(12, 20), jvis.make_ind_map(12, 20))


@pytest.mark.parametrize("cmap,vminmax", [("plasma", (0, 1)), ("hot", (0, 1.0)), ("plasma", None), ("hot", None)])
def test_score_map_vis_matches_matplotlib(cmap, vminmax):
    x = np.random.RandomState(4).rand(1, 12, 20, 1).astype(np.float32)
    x[0, 0, :3, 0] = [0.0, 1.0, 0.5]
    np.testing.assert_allclose(tvis.score_map_vis(x, cmap, vminmax=vminmax), jvis.score_map_vis(x, cmap, vminmax=vminmax),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("motion,cam", [(False, True), (True, False), (True, True)])
def test_vis_motion(motion, cam):
    rng = np.random.RandomState(5)
    B, h, w = 2, 16, 24
    depth = (rng.rand(B, h, w, 1) * 40 + 2).astype(np.float32)
    K = np.tile(np.array([[0.6 * w, 0, 0.5 * w, 0], [0, 1.2 * h, 0.5 * h, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                         np.float32), (B, 1, 1))
    inv_K = np.linalg.pinv(K).astype(np.float32)
    motion_map = (rng.randn(B, h, w, 3) * 0.3).astype(np.float32) if motion else None
    camTcam = None
    if cam:
        camTcam = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
        camTcam[:, :3, 3] = rng.randn(B, 3) * 0.5
    hsv, mag = tvis.vis_motion(depth, K, inv_K, motion_map=motion_map, camTcam=camTcam)
    hsv_j, mag_j = jvis.vis_motion(depth, K, inv_K, motion_map=motion_map, camTcam=camTcam)
    assert mag == pytest.approx(mag_j, rel=1e-5)
    np.testing.assert_allclose(hsv[..., 1:], hsv_j[..., 1:], rtol=0, atol=1e-5)
    # The hue of a vector near zero (the ego-motion's focus of expansion)
    # turns with round-off, at a value that renders it white: compare the
    # colours the frames show.
    np.testing.assert_allclose(tvis.hsv_to_rgb(hsv), jvis.hsv_to_rgb(hsv_j), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    folder = save_checkpoint(tmp_path_factory.mktemp("predict"))
    kw = dict(dataset="kitti", height=H, width=W, batch_size=2, load_ckpt=folder)
    return types.SimpleNamespace(
        port=Trainer(TConfig(**kw), device="cpu"),
        jax=JTrainer(JConfig(**kw, num_devices=1)),
    )


@pytest.mark.parametrize("flags", [(False, False), (True, False), (True, True)], ids=["depth_pose", "flow", "flow_mask"])
def test_predict_matches_the_jax_packages(trainers, flags):
    rng = np.random.RandomState(6)
    batch = {("color_aug", f, 0): rng.rand(2, H, W, 3).astype(np.float32) for f in (0, -1, 1)}
    batch["depth_gt"] = np.zeros((2, 5, 3), np.float32)  # host-only keys are left out
    out = outputs_to_host(trainers.port.predict(batch, *flags))
    ref = jax.tree.map(np.asarray, dict(trainers.jax.predict(batch, *flags)))
    assert out.keys() == ref.keys()
    assert any(k[0] == "motion_mask" for k in out) == flags[1]
    assert any(k[0] == "complete_flow" for k in out) == flags[0]
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        scale = max(float(np.abs(ref[k]).max()), 1e-6)
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-4, atol=1e-4 * scale, err_msg=str(k))


def test_predict_runs_in_eval_mode_and_restores_the_mode(trainers):
    model = trainers.port.model
    batch = {("color_aug", f, 0): np.random.RandomState(7).rand(2, H, W, 3).astype(np.float32) for f in (0, -1, 1)}
    model.train()
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    first = trainers.port.predict(batch, True, True)
    assert model.training
    again = trainers.port.predict(batch, True, True)
    # Running statistics used, not updated; no drop-path draw; no graph.
    assert all(torch.equal(model.state_dict()[k], v) for k, v in stats.items())
    assert all(torch.equal(first[k], again[k]) and not first[k].requires_grad for k in first)
    model.eval()
    trainers.port.predict(batch)
    assert not model.training
    with pytest.raises(ValueError, match="color_aug"):
        trainers.port.predict({"depth_gt": batch[("color_aug", 0, 0)]})
