"""The port's depth metrics against the JAX package's, on the LiDAR points
and masks of ``assets/tiny_kitti``."""

import os.path as osp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.data import KITTIDataset
from dynamo_depth_torch.data.loader import collate
from dynamo_depth_torch.ops import metrics as tm
from dynamo_depth_torch.utils.layout import nhwc_to_nchw
from dynamo_depth_tpu.ops import metrics as jm
from torch_test_threads import two_torch_threads  # noqa: F401

ASSETS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "assets")
SEQ = "2011_09_26/2011_09_26_drive_0001_sync"
H, W = 64, 192


@pytest.fixture(scope="module")
def kitti_batch():
    ds = KITTIDataset(
        data_path=osp.join(ASSETS, "tiny_kitti") + "/", filenames=[f"{SEQ} {i} {s}" for i in (0, 1) for s in "lr"],
        height=H, width=W, cam_name="image_02", img_type="downsample", frame_idxs=[0, -1, 1], num_scales=1,
        img_ext=".jpg", load_depth=True, load_mask=True,
    )
    batch = collate([ds[i] for i in range(len(ds))])
    # The mask label under each LiDAR point (padding rows read pixel 0, 0):
    # the fixture's motion masks are all 0, its semantic masks hold 0 and 1.
    pts = batch["depth_gt"]
    rows, cols = pts[..., 0].astype(np.int64), pts[..., 1].astype(np.int64)
    batch["mask_pts"] = np.stack([m[r, c] for m, r, c in zip(batch["sem_mask"], rows, cols)]).astype(np.int32)
    return batch


@pytest.mark.parametrize("weighted", [False, True])
def test_depth_metrics_with_labels_match_the_jax_packages(kitti_batch, weighted):
    b = kitti_batch
    B = b["depth_gt"].shape[0]
    assert b["depth_valid"].sum(1).min() > 100
    labels = tuple(sorted(set(np.unique(b["mask_pts"][b["depth_valid"] > 0]).tolist())))
    assert len(labels) > 1
    disp = np.random.RandomState(0).uniform(0.01, 0.5, (B, H, W, 1)).astype(np.float32)
    weight = np.array([1.0, 0.0, 1.0, 1.0][:B], np.float32) if weighted else None
    cfg = TConfig(dataset="kitti")
    kw = dict(min_depth=cfg.eval_min_depth, max_depth=float(cfg.eval_max_depth), labels=labels)
    ref = jm.depth_metrics(
        jnp.asarray(disp), jnp.asarray(b["depth_gt"]), jnp.asarray(b["depth_valid"]), jnp.asarray(b["gt_dim"]),
        np.asarray(cfg.eval_img_bound, np.float32), mask_pts=jnp.asarray(b["mask_pts"]),
        sample_weight=None if weight is None else jnp.asarray(weight), **kw,
    )
    got = tm.depth_metrics(
        torch.from_numpy(nhwc_to_nchw(disp)), b["depth_gt"], b["depth_valid"], b["gt_dim"], cfg.eval_img_bound,
        mask_pts=b["mask_pts"], sample_weight=weight, **kw,
    )
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        r, g = (r, g) if isinstance(r, tuple) else ((r,), (g,))
        for rv, gv in zip(r, g):
            # float32 sums over ~1e4 points in another order.
            np.testing.assert_allclose(float(gv), float(rv), rtol=1e-5, atol=1e-7, err_msg=k)


def test_compute_errors_matches_the_jax_packages(rng):
    gt = rng.uniform(1, 80, (3, 500)).astype(np.float32)
    pred = (gt * rng.uniform(0.5, 1.5, gt.shape)).astype(np.float32)
    valid = rng.rand(*gt.shape) < 0.7
    for i in range(3):
        ref, ref_cnt = jm.compute_errors(jnp.asarray(gt[i]), jnp.asarray(pred[i]), jnp.asarray(valid[i]))
        got, got_cnt = tm.compute_errors(torch.from_numpy(gt[i]), torch.from_numpy(pred[i]), torch.from_numpy(valid[i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
        assert float(got_cnt) == float(ref_cnt)
    # Batched along the leading axis, as depth_metrics calls it.
    got, _ = tm.compute_errors(torch.from_numpy(gt), torch.from_numpy(pred), torch.from_numpy(valid))
    assert got.shape == (3, 7)
