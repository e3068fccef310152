"""The port's data parallelism on the CPU: two ranks over gloo, each a
process spawned by ``torch.multiprocessing`` (``tests/torch_ddp_workers.py``),
LiteMono at 32x64, drop-path 0.

- One ``disp_init`` and one ``fine_tune`` step of two port ranks against the
  JAX package's ``shard_map`` step at ``num_devices=2`` on the virtual CPU
  mesh (``Trainer._build_phase``), from the same weights, rank r fed device
  r's rows and device r's draws (``fold_in(rng, r)``): losses, gradients,
  parameters after Adam and BatchNorm statistics, at the tolerances of
  ``test_torch_train_step.py``; both ranks bit-equal. Batch 2 per rank, as
  that file's one-device step: with one row, BatchNorm's statistics over
  the encoders' 1x2 bottom level make the step ill-conditioned, and the
  two packages' c_consistency then differs by 2.3e-4 on one device too.
- Batch 1 per rank from here on.
- Two steps in each of two phases from the entry point: the wrapper is
  rebuilt per phase, frozen modules stay as they are, rank 0 alone writes
  the checkpoints (reference keys), which the JAX ``Trainer`` loads.
- The launch environment and the replication check.
"""

import pickle
import shutil
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_depth_torch.config import DynamoConfig as TConfig
from dynamo_depth_torch.models.convert import load_jax_variables
from dynamo_depth_torch.models.model import MODULE_NAMES, DynamoModel, modules_for_networks
from dynamo_depth_torch.parallel import dist as pdist
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_torch.training.trainer import PHASE_SPEC
from dynamo_depth_tpu.config import DynamoConfig as JConfig
from dynamo_depth_tpu.models import layers as j_layers
from dynamo_depth_tpu.models.convert import convert_module
from dynamo_depth_tpu.parallel.mesh import batch_sharding, make_mesh
from dynamo_depth_tpu.training.trainer import Trainer as JTrainer
from dynamo_depth_tpu.training.trainer import partition_params
from test_torch_eval_common import ASSETS, KITTI_SEQ
from test_torch_train_step import KW, STEP, STEPS_PER_EPOCH, _jax_draws, _leaves, init_variables, jax_model
from torch_ddp_workers import curriculum_rank, join_ranks, run_ranks, start_ranks, step_rank
from torch_test_threads import two_torch_threads  # noqa: F401

WORLD = 2
KW_STEP = dict(KW, batch_size=2)  # rows per rank, per device
PHASES = ("disp_init", "fine_tune")


def _bare_jax_trainer(cfg):
    """The JAX ``Trainer`` with what ``_build_phase`` and ``load_model`` read,
    without its model init."""
    jt = JTrainer.__new__(JTrainer)
    jt.cfg, jt.mesh, jt.model = cfg, make_mesh(cfg.num_devices), jax_model(cfg)
    jt.H, jt.W, jt.variables, jt._step_cache = cfg.height, cfg.width, {}, {}
    return jt


def _jax_step(jt, phase, variables, batch, rng):
    """The JAX package's compiled shard_map step of ``phase`` over the
    2-device mesh (drop-path off, the caller's patch); -> (losses, new
    params, new batch stats, pmean-ed gradients read back from Adam's first
    moment)."""
    built = jt._build_phase(phase, STEPS_PER_EPOCH)
    t_params, f_params = partition_params(variables["params"], built["trainable_modules"])
    opt_state = built["tx"].init(t_params)
    copy = lambda tree: jax.tree.map(jnp.array, tree)  # noqa: E731 (the step donates its inputs)
    sharded = {k: jax.device_put(v, batch_sharding(jt.mesh)) for k, v in batch.items()}
    t_new, bs_new, opt_new, losses = built["step_fn"](
        copy(t_params), f_params, copy(variables["batch_stats"]), opt_state, sharded, rng, jnp.int32(STEP))
    # Adam's first moment after one step is (1 - b1) * g.
    grads = jax.tree.map(lambda mu: np.asarray(mu) / np.float32(1 - 0.9), opt_new[0].mu)
    return jax.tree.map(np.asarray, (losses, {**f_params, **t_new}, bs_new)) + (grads,)


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """Both phases' steps: the port's two ranks run while the JAX steps
    compile."""
    out = tmp_path_factory.mktemp("ddp_step")
    jcfg = JConfig(**KW_STEP, num_devices=WORLD)
    tcfg = TConfig(**KW_STEP)
    variables = init_variables(JConfig(**KW_STEP))
    batch = synthetic_batch(tcfg, WORLD * tcfg.batch_size, tcfg.height, tcfg.width)
    rng = jax.random.PRNGKey(7)
    model = DynamoModel(drop_path_rate=0.0)
    load_jax_variables(model, variables["params"], variables["batch_stats"], tcfg)
    draws = {p: [_jax_draws(jcfg, p, jax.random.fold_in(rng, r)) for r in range(WORLD)] for p in PHASES}
    (out / "inputs.pkl").write_bytes(pickle.dumps({
        "cfg": KW_STEP, "phases": PHASES, "batch": batch, "draws": draws, "step": STEP,
        "steps_per_epoch": STEPS_PER_EPOCH, "state": {k: v.numpy() for k, v in model.state_dict().items()}}))
    ranks_running = start_ranks(step_rank, (str(out),), WORLD)
    try:
        jt = _bare_jax_trainer(jcfg)
        with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(len(PHASES)) as pool:
            mp.setattr(j_layers.DropPath, "__call__", lambda self, x, train=False: x)
            # The two phases compile at once: XLA compiles outside the GIL.
            futures = {p: pool.submit(_jax_step, jt, p, variables, batch, rng) for p in PHASES}
            jax_out = {p: f.result() for p, f in futures.items()}
    finally:
        join_ranks(ranks_running)
    ranks = [pickle.loads((out / f"step_rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    shutil.rmtree(out)  # a few hundred MB of weights
    return types.SimpleNamespace(jax=jax_out, ranks=ranks, variables=variables, cfg=tcfg)


def _module_tree(state, module_name, cfg):
    """A module's entries of a port state dict as the flax (params,
    batch_stats) trees, through the JAX package's converter."""
    prefix = module_name + "."
    sd = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    return convert_module(module_name, sd, cfg)


_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _grad_state(rec):
    """Rank 0's gradients in its state dict's layout (0 where a parameter
    took none; buffers as they are)."""
    return {k: v if k.endswith(_BUFFERS) else rec["grads"].get(k, np.zeros_like(v)) for k, v in rec["state"].items()}


@pytest.mark.parametrize("phase", PHASES)
def test_both_ranks_end_the_step_bit_equal(step_run, phase):
    r0, r1 = (rank[phase] for rank in step_run.ranks)
    assert r0["wrapper"] == r1["wrapper"] == "DistributedDataParallel"
    assert r0["losses"] == r1["losses"]
    # Fingerprints of every parameter and buffer, and of the gradients.
    assert r0["fingerprints"] == r1["fingerprints"]


@pytest.mark.parametrize("phase", PHASES)
def test_the_wrapper_averages_the_ranks_gradients(step_run, phase):
    # DDP's bucketed all-reduce gives the mean of each rank's own gradient
    # (what pmean(grads) is to the JAX step): to the order in which autograd
    # sums a weight's uses (the motion encoder runs once per source frame),
    # a few float32 ulps; the parameters that take no gradient without the
    # wrapper (LiteMono's DilatedConv.norm, which the forward never uses)
    # take none with it.
    for rank in step_run.ranks:
        ddp_keys, own_keys = rank[phase]["own_grad_keys"]
        assert ddp_keys == own_keys
        assert rank[phase]["own_grad_err"] <= 1e-5


@pytest.mark.parametrize("phase", PHASES)
def test_losses_match_the_jax_step(step_run, phase):
    ref = step_run.jax[phase][0]
    got = step_run.ranks[0][phase]["losses"]
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4, atol=1e-7, err_msg=k)


# The pose encoder's gradient (a ResNet-18 whose bottom level is 1x2 at
# 32x64, normalised over 4 values per channel) is where the packages part:
# in disp_init the JAX package's float32 step lies 2.30e-3 of the norm from
# the port's float64 step, the port's own float32 step 7.7e-6 (as for the
# ResNet depth encoder in test_torch_monodepthv2.py); in fine_tune, whose float64 step
# takes other discrete choices, the two float32 steps lie 1.03e-3 apart.
# Fewer entries of those modules then agree to 1e-3 (found: 0.17 of the pose
# encoder's bn1 bias in disp_init; 0.33 and 0.34 of a motion-decoder bias and
# a pose-encoder BatchNorm scale in fine_tune).
GRAD_TOL = {("disp_init", "pose_enc"): 4e-3, ("fine_tune", "pose_enc"): 2e-3}
MIN_AGREE = {("disp_init", "pose_enc"): 0.1, ("fine_tune", "pose_enc"): 0.25, ("fine_tune", "motion_dec"): 0.25}


@pytest.mark.parametrize("phase", PHASES)
def test_gradients_and_params_after_adam_match_the_jax_step(step_run, phase):
    r = step_run.ranks[0][phase]
    _, ref_params, _, ref_grads = step_run.jax[phase]
    lr = step_run.cfg.learning_rate * PHASE_SPEC[phase][3]
    trainable = modules_for_networks(PHASE_SPEC[phase][2])
    for module_name in MODULE_NAMES:
        old = _leaves(step_run.variables["params"][module_name])
        got = _leaves(_module_tree(r["state"], module_name, step_run.cfg)[0])
        ref_new = _leaves(ref_params[module_name])
        assert got.keys() == ref_new.keys() == old.keys(), module_name
        if module_name not in trainable:  # frozen: not updated, bit for bit
            for k in old:
                np.testing.assert_array_equal(got[k], old[k], err_msg=f"{module_name} {k}")
                np.testing.assert_array_equal(ref_new[k], old[k], err_msg=f"{module_name} {k}")
            continue
        got_grad = _leaves(_module_tree(_grad_state(r), module_name, step_run.cfg)[0])
        ref_grad = _leaves(ref_grads[module_name])
        # The averaged gradient of a module: ~1e-5 of its norm apart (the
        # one-device step's tolerance).
        diff = np.sqrt(sum(np.sum((got_grad[k] - ref_grad[k]) ** 2) for k in ref_grad))
        norm = np.sqrt(sum(np.sum(ref_grad[k] ** 2) for k in ref_grad))
        assert norm > 0 and diff / norm < GRAD_TOL.get((phase, module_name), 1e-3), (module_name, diff / norm)
        for k in ref_new:
            d_ref, d_got = ref_new[k] - old[k], got[k] - old[k]
            tol = 1e-2 * lr + 2 * np.spacing(np.maximum(np.abs(old[k]), np.abs(got[k])))
            g = got_grad[k]
            assert np.all(np.abs(d_got + lr * g / (np.abs(g) + 1e-8)) <= tol), (module_name, k)
            agree = np.abs(g - ref_grad[k]) <= 1e-3 * np.abs(ref_grad[k])
            assert agree.mean() > MIN_AGREE.get((phase, module_name), 0.5), (module_name, k, agree.mean())
            assert np.all(np.abs(d_got - d_ref)[agree] <= tol[agree]), (module_name, k)


@pytest.mark.parametrize("phase", PHASES)
def test_batch_stats_are_the_mean_over_ranks_and_match_the_jax_step(step_run, phase):
    r0, r1 = (rank[phase] for rank in step_run.ranks)
    stats = r0["local_stats"]
    assert stats and stats.keys() == r1["local_stats"].keys()
    moved = 0
    for k in stats:
        # The mean of the two ranks' statistics, not rank 0's.
        np.testing.assert_array_equal(r0["state"][k], (stats[k] + r1["local_stats"][k]) / np.float32(2), err_msg=k)
        moved += not np.array_equal(stats[k], r1["local_stats"][k])
    assert moved > 0
    ref_bs = step_run.jax[phase][2]
    for module_name in ("depth_enc", "pose_enc", "motion_enc"):
        got = _leaves(_module_tree(r0["state"], module_name, step_run.cfg)[1])
        ref = _leaves(ref_bs.get(module_name, step_run.variables["batch_stats"][module_name]))
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5 * np.max(np.abs(ref[k])), err_msg=str(k))


# ---------------------------------------------------------------- curriculum

CURRICULUM = ("disp_init", "motion_init")


@pytest.fixture(scope="module")
def curriculum(tmp_path_factory):
    """Two steps of disp_init and of motion_init from the entry point on
    tiny_kitti, each rank writing under its own log folder."""
    root = tmp_path_factory.mktemp("ddp_curriculum")
    (root / "splits" / "tiny").mkdir(parents=True)
    for which in ("train", "val"):
        (root / "splits" / "tiny" / f"{which}_files.txt").write_text(
            "".join(f"{KITTI_SEQ} {i} {s}\n" for i in (0, 1) for s in "lr"))
    argv = ["-d", "kitti", "-n", "tiny", "--data_path", f"{ASSETS}/tiny_kitti/", "--split", "tiny",
            "--height", "32", "--width", "64", "-b", "1", "--weights_init", "scratch", "--num_devices", str(WORLD),
            "--epoch_schedules", "1", "1", "0", "0", "--epoch-size", "2", "--log_frequency", "1",
            "--num_workers", "1", "--print_opt", "", "--no_train_vis"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DYNAMO_SPLITS_DIR", str(root / "splits"))
        run_ranks(curriculum_rank, (str(root), argv), WORLD)
    ranks = [pickle.loads((root / f"curriculum_rank{r}.pkl").read_bytes()) for r in range(WORLD)]
    yield types.SimpleNamespace(root=root, ranks=ranks)
    shutil.rmtree(root)  # the checkpoint folders


def test_a_wrapper_per_phase_over_the_bare_model(curriculum):
    for rec in curriculum.ranks:
        assert [s["phase"] for s in rec["steps"]] == [p for p in CURRICULUM for _ in range(2)]
        assert all(s["type"] == "DistributedDataParallel" and s["module_is_model"] for s in rec["steps"])
        wrappers = [s["wrapper"] for s in rec["steps"]]
        assert wrappers[0] == wrappers[1] and wrappers[2] == wrappers[3] and wrappers[1] != wrappers[2]
        assert rec["local_world_size"] == WORLD and rec["global_B"] == WORLD


def test_each_phase_moves_its_modules_only_and_the_ranks_stay_equal(curriculum):
    r0, r1 = curriculum.ranks
    for phase in CURRICULUM:
        assert r0["phases"][phase]["moved"] == sorted(modules_for_networks(PHASE_SPEC[phase][2])), phase
        assert r0["phases"][phase] == r1["phases"][phase], phase  # parameters and buffers alike
    # The validation scores are the global batch's, the same on both ranks.
    val = [[h["scalars"] for h in rec["history"] if h["mode"] == "val"] for rec in (r0, r1)]
    assert len(val[0]) == 4 and val[0] == val[1]
    assert all(0 < s["de:abs_rel"] < 10 for s in val[0])


def test_check_replicated_raises_where_one_rank_differs(curriculum):
    for rec in curriculum.ranks:
        assert "differ from rank 0's" in rec["replication_error"] and "1 of 2 ranks" in rec["replication_error"]


def test_rank_0_alone_writes_checkpoints_the_jax_trainer_loads(curriculum):
    models = curriculum.root / "rank0" / "tiny" / "models"
    assert sorted(p.name for p in models.iterdir()) == sorted([f"{p}_00" for p in CURRICULUM] + ["opt.json"])
    assert not (curriculum.root / "rank1").exists()
    folder = models / "motion_init_00"
    model = DynamoModel(drop_path_rate=0.0)
    saved = {}
    for m in MODULE_NAMES:  # the reference's keys: the bare module's, no "module." prefix
        module_file = torch.load(folder / f"{m}.pth", map_location="cpu")
        assert {k for k in module_file if k not in ("height", "width")} == set(getattr(model, m).state_dict())
        saved.update({f"{m}.{k}": v for k, v in module_file.items() if k not in ("height", "width")})
    model.load_state_dict(saved)
    assert pdist.state_fingerprint(model).tolist() == curriculum.ranks[0]["phases"]["motion_init"]["fingerprint"]
    state = {k: v.numpy() for k, v in saved.items()}
    cfg = JConfig(dataset="kitti", height=32, width=64, batch_size=1, weights_init="scratch", num_devices=1,
                  load_ckpt=str(folder))
    jt = _bare_jax_trainer(cfg)
    jt.load_model()
    for m in MODULE_NAMES:
        params, stats = _module_tree(state, m, cfg)
        for col, ref in (("params", params), ("batch_stats", stats)):
            if ref:
                got = _leaves(jt.variables[col][m])
                assert got.keys() == _leaves(ref).keys(), (m, col)
                for k, v in _leaves(ref).items():
                    np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=f"{m} {k}")


# --------------------------------------------------------- the environment

def _clear_launch_env(monkeypatch):
    for name in pdist.LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("present", [("RANK",), ("MASTER_ADDR", "MASTER_PORT"),
                                     ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")])
def test_a_partial_launch_environment_is_refused(monkeypatch, present):
    _clear_launch_env(monkeypatch)
    values = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}
    for name in present:
        monkeypatch.setenv(name, values[name])
    missing = [n for n in pdist.LAUNCH_ENV if n not in present]
    with pytest.raises(RuntimeError, match="incomplete") as err:
        pdist.init_distributed("cpu")
    assert all(n in str(err.value) for n in missing)


def test_no_launch_environment_is_one_process(monkeypatch):
    _clear_launch_env(monkeypatch)
    assert pdist.init_distributed("cpu") is False
    assert (pdist.rank(), pdist.world_size(), pdist.local_rank(), pdist.is_main_process()) == (0, 1, 0, True)
    t = torch.tensor([1.0, 3.0])
    assert pdist.all_reduce_mean([t])[0] is t and t.tolist() == [1.0, 3.0]
    pdist.barrier()
    pdist.check_replicated(torch.nn.Linear(2, 2))


def test_state_fingerprint_discriminates():
    def module(weight):
        m = torch.nn.Module()
        m.register_buffer("w", weight)
        return m

    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    fp = pdist.state_fingerprint(module(base))
    assert fp.shape == (4,) and fp.dtype == torch.int64 and bool(((fp >= 0) & (fp < 2 ** 16)).all())
    assert torch.equal(fp, pdist.state_fingerprint(module(base.clone())))
    changed = base.clone()
    changed[0, 0] += 1e-7 if changed[0, 0] else 1e-30
    for other in (changed, base.reshape(3, 2), base.double()):
        assert not torch.equal(fp, pdist.state_fingerprint(module(other)))
