"""What a run logs at world size 2 against the JAX package, which validates
and visualises the global batch: two port ranks over gloo on the CPU (rank
code in ``tests/torch_ddp_workers.py::monitoring_rank``), LiteMono at 64x96,
2 rows per rank (at 1 row per rank the ResNet bottom level is 1x2).

- Validation (``Trainer.val``) in ``mask_init`` and ``fine_tune``: both
  ranks log the same scores, and every loss term that RANSAC does not enter
  matches the JAX package's ``eval_step`` on the 4 global rows (``d_ground``,
  and in ``fine_tune`` the totals it enters, are left out: the draws differ);
  the depth metrics count each row once.
- The visualisation (``setup_logging``, ``log_vis``): rank 0's grids match
  the JAX package's ``log_vis`` of the global rows, whose L1 panel and colour
  wheels are scaled by maxima over all 4; where one rank's wandb does not
  start, both ranks follow rank 0's answer and nothing hangs (the ranks run
  under ``pdist.join_ranks``' time limit, which kills them).

The data shows what differs where each rank scored its own rows: rank 0's
rows are flat grey images at timestamp 1, rank 1's textured ones at
timestamp 20, so rank 1's complete flow, 2D displacement, L1 error and
independent flow are the larger, and m_sparsity's static threshold
``mean(disp_mag)`` splits the pixels of one rank otherwise than the global
mean does. The carried weights are the port's seed init with the motion
mask's output layers scaled by 30, so that its logits, and the BCE that
m_sparsity averages over the static pixels, vary with the pixel (at random
init they are nearly constant, and where the threshold falls barely
matters).
"""

import pickle
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.ops.metrics import DEPTH_METRIC_NAMES, depth_metrics
from dynamo_depth_torch.training.losses import LOSS_TERMS
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_torch.training.trainer import Trainer
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from test_torch_ddp import _bare_jax_trainer
from test_torch_train_vis import RecordingWandb, _carried_variables
from torch_ddp_workers import join_ranks, monitoring_rank, start_ranks
from torch_test_threads import two_torch_threads  # noqa: F401

WORLD, B, H, W = 2, 2, 64, 96
KW = dict(dataset="kitti", height=H, width=W, batch_size=B, weights_init="scratch")
PHASES = ("mask_init", "fine_tune")
STEP, STEPS_PER_EPOCH = 5, 100
MASK_GAIN, RANK1_TS = 30.0, 20.0
LIDAR_KEYS = ("depth_gt", "depth_valid", "gt_dim")
# log_vis cases: the ranks whose wandb.init raises
VIS_CASES = {"both start": (), "rank 1 fails": (1,), "rank 0 fails": (0,)}


def global_rows(cfg):
    """The 4 global rows (rank r's are rows 2r, 2r + 1), with LiDAR points."""
    batch = synthetic_batch(cfg, WORLD * B, H, W)
    for f in cfg.frame_ids:
        batch[("ts", f)][B:] = RANK1_TS
        for key in (("color", f, 0), ("color_aug", f, 0)):
            batch[key][:B] = batch[key][:B].mean(axis=(1, 2), keepdims=True) * 0.5 + 0.25
    rng = np.random.RandomState(1)
    n = 400
    batch["depth_gt"] = np.stack([rng.uniform(0, 375, (WORLD * B, n)), rng.uniform(0, 1242, (WORLD * B, n)),
                                  rng.uniform(2, 60, (WORLD * B, n))], -1).astype(np.float32)
    batch["depth_valid"] = np.ones((WORLD * B, n), np.float32)
    batch["gt_dim"] = np.tile(np.array([375, 1242], np.int32), (WORLD * B, 1))
    return batch


def carried_model(cfg):
    """The port's seed init, the motion mask's output layers scaled."""
    model = Trainer(cfg, device="cpu", drop_path_rate=0.0).model
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k.startswith("motion_mask.refine_motion_redu"):
                p.mul_(MASK_GAIN)
    return model


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' records, while the JAX package validates and
    visualises the same rows from the same weights."""
    out = tmp_path_factory.mktemp("ddp_monitoring")
    tcfg = TConfig(**KW)
    model = carried_model(tcfg)
    batch = global_rows(tcfg)
    (out / "inputs.pkl").write_bytes(pickle.dumps({
        "cfg": KW, "phases": PHASES, "batch": batch, "step": STEP, "steps_per_epoch": STEPS_PER_EPOCH,
        "state": {k: v.numpy() for k, v in model.state_dict().items()}, "vis_cases": VIS_CASES}))
    ranks_running = start_ranks(monitoring_rank, (str(out),), WORLD)
    try:
        jcfg = JConfig(**KW, num_devices=1)
        variables = _carried_variables(model, jcfg)
        jt = _bare_jax_trainer(jcfg)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k not in LIDAR_KEYS}
        jax_val = {}
        for phase in PHASES:
            built = jt._build_phase(phase, STEPS_PER_EPOCH)
            losses, disp_scaled = built["eval_fn"](variables, jbatch, jax.random.PRNGKey(0), jnp.int32(STEP))
            jax_val[phase] = ({k: float(v) for k, v in losses.items()}, np.asarray(disp_scaled))
        jt.B, jt.g_step, jt._wandb = B, 3, RecordingWandb()
        jt.log_vis("train", built, variables["params"], variables["batch_stats"], jbatch)  # fine_tune's
    finally:
        join_ranks(ranks_running)
    ranks = [pickle.loads((out / f"monitoring_rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    shutil.rmtree(out)  # the ranks' opt.json folders
    (package, step), = jt._wandb.logs
    return types.SimpleNamespace(ranks=ranks, jax_val=jax_val, batch=batch, cfg=tcfg, jax_vis=(package, step))


@pytest.mark.parametrize("phase", PHASES)
def test_validation_scores_the_global_batch_on_every_rank(run, phase):
    r0, r1 = (rec["val"][phase] for rec in run.ranks)
    assert r0 == r1
    ref, _ = run.jax_val[phase]
    compared = [f"loss_term/{t}" for t in LOSS_TERMS if t != "d_ground"]
    if phase == "mask_init":  # no d_ground: the totals too
        compared += ["loss"] + [f"loss_term/{s}" for s in run.cfg.scales]
    assert r0["loss_term/m_sparsity"] > 0
    for k in compared:
        # test_torch_train_step.py's tolerance for the losses
        np.testing.assert_allclose(r0[k], ref[k], rtol=1e-4, atol=1e-7, err_msg=k)


def test_validation_depth_metrics_count_each_row_once(run):
    """The ranks' depth metrics are those of the 4 rows' disparity (the JAX
    package's, scored by the port's metrics on its own)."""
    _, disp_scaled = run.jax_val["fine_tune"]
    cfg = run.cfg
    ref = depth_metrics(torch.from_numpy(disp_scaled.copy()).permute(0, 3, 1, 2), *(run.batch[k] for k in LIDAR_KEYS),
                        cfg.eval_img_bound, min_depth=cfg.eval_min_depth, max_depth=float(cfg.eval_max_depth))
    for rec in run.ranks:
        for k in DEPTH_METRIC_NAMES:
            np.testing.assert_allclose(rec["val"]["fine_tune"][k], float(ref[k]), rtol=1e-4, err_msg=k)


def _grids(logs):
    (package, step), = logs
    return step, np.stack([package[f"vis/train_{j}"] for j in range(len(package))])


def test_rank_0s_grids_are_scaled_by_the_global_batch(run):
    jstep, ref = _grids([run.jax_vis])
    tstep, got = _grids(run.ranks[0]["vis"]["both start"])
    assert jstep == tstep == 3 and not run.ranks[1]["vis"]["both start"]
    assert got.shape == ref.shape == (B, 3 * H, 3 * W, 3) and got.dtype == np.float32
    diff = np.abs(got - ref)
    # test_torch_train_vis.py's tolerances: rows 1-2 float32 round-off of
    # the forwards; the wheels' hue turns with round-off where the flow
    # vanishes.
    assert diff[:, :2 * H].max() <= 1e-4, diff[:, :2 * H].max()
    assert (diff[:, 2 * H:] <= 1 / 255).mean() >= 0.999
    assert np.median(diff[:, 2 * H:]) <= 1e-4


@pytest.mark.parametrize("case", ["rank 1 fails", "rank 0 fails"])
def test_the_ranks_follow_rank_0s_wandb(run, case):
    """Rank 1's failed start does not keep it out of the reduction (rank 0
    logs the same grids as when both start); rank 0's failed start turns the
    visualisation off on both ranks. Neither hangs."""
    r0, r1 = (rec["vis"][case] for rec in run.ranks)
    assert not r1
    if case == "rank 0 fails":
        assert not r0
        return
    (_, got), (_, ref) = _grids(r0), _grids(run.ranks[0]["vis"]["both start"])
    assert np.array_equal(got, ref)
