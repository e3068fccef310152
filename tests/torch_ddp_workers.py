"""Rank processes of ``tests/test_torch_ddp.py`` and the other multi-process
tests (this file holds no test).

Each ``*_rank`` function runs in a process that ``pdist.start_ranks``
spawned with torchrun's environment: it joins the gloo group through
``init_distributed``, runs the port on the CPU with one thread, and pickles
what it saw into ``out_dir``. ``init_fingerprints`` runs in a spawned
process without a group. Only the port is imported here, so a process
starts without JAX.
"""

import os
import pickle
from pathlib import Path

import torch
import torch.distributed as dist

from dynamo_depth_torch.parallel import dist as pdist


def start_ranks(fn, args, world=2):
    """Start ``fn(*args)`` on ``world`` spawned ranks (``pdist.start_ranks``)."""
    return pdist.start_ranks(fn, args, world)


def join_ranks(ctx, timeout=300):
    pdist.join_ranks(ctx, timeout)


def run_ranks(fn, args, world=2, timeout=300):
    pdist.spawn_ranks(fn, args, world, timeout)


def _join():
    """Join the launch's gloo group on one thread -> (rank, world)."""
    torch.set_num_threads(1)
    assert pdist.init_distributed("cpu")
    assert dist.get_backend() == "gloo"
    return pdist.rank(), pdist.world_size()


def _numpy_state(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def _fingerprint(tensors):
    """``state_fingerprint`` of a dict of tensors."""
    holder = torch.nn.Module()
    for i, (k, v) in enumerate(sorted(tensors.items())):
        holder.register_buffer(f"t{i}", v.detach())
    return pdist.state_fingerprint(holder).tolist()


def step_rank(out_dir):
    """One step of each phase of ``inputs.pkl`` from its weights, on this
    rank's rows, with the JAX draws of this rank's device injected."""
    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.ops import ground_plane
    from dynamo_depth_torch.training import losses as losses_mod
    from dynamo_depth_torch.training.trainer import Trainer

    rank, world = _join()
    inputs = pickle.loads((Path(out_dir) / "inputs.pkl").read_bytes())
    cfg = DynamoConfig(**inputs["cfg"])
    local = {k: v[rank * cfg.batch_size:(rank + 1) * cfg.batch_size] for k, v in inputs["batch"].items()}
    records = {}
    for phase in inputs["phases"]:
        trainer = Trainer(cfg, device="cpu", phase=phase, steps_per_epoch=inputs["steps_per_epoch"],
                          drop_path_rate=0.0)
        trainer.model.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["state"].items()})
        noise, indices = [], []
        ground_plane.draw_sample_idx = lambda *a, **k: torch.tensor(indices.pop(0))
        losses_mod.draw_automask_noise = lambda *a, **k: torch.tensor(noise.pop(0))

        def inject_draws():
            for queue, drawn in zip((noise, indices), inputs["draws"][phase][rank]):
                queue[:] = list(drawn)

        # This rank's own gradient, without the wrapper, then averaged over
        # the ranks here; the weights and statistics are restored after.
        saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        inject_draws()
        trainer.model.train()
        _, own = trainer._forward_losses(trainer.process_inputs_device(trainer.to_device(local)),
                                         torch.Generator().manual_seed(0), inputs["step"], trainer.model)
        own["loss"].backward()
        own_grads = {k: p.grad.clone() for k, p in trainer.model.named_parameters() if p.grad is not None}
        pdist.all_reduce_mean(list(own_grads.values()))
        trainer.model.zero_grad(set_to_none=True)
        trainer.model.load_state_dict(saved)

        inject_draws()
        local_stats = {}
        average = trainer._average_batch_stats

        def record_then_average():
            local_stats.update({k: v.numpy().copy() for k, v in trainer.model.named_buffers()
                                if k.endswith(("running_mean", "running_var"))})
            average()

        trainer._average_batch_stats = record_then_average
        losses = trainer.train_step(trainer.to_device(local), torch.Generator().manual_seed(0), inputs["step"])
        assert not indices and not noise, "every scale drew its RANSAC hypotheses and automask noise once"
        grads = {k: p.grad for k, p in trainer.model.named_parameters() if p.grad is not None}
        records[phase] = {
            "losses": {k: v.item() for k, v in losses.items()},
            "local_stats": local_stats,
            "wrapper": type(trainer.ddp).__name__,
            "fingerprints": (pdist.state_fingerprint(trainer.model).tolist(), _fingerprint(grads)),
            # Against the mean of the ranks' own gradients: the same keys, and
            # each tensor's largest difference over its largest entry.
            "own_grad_keys": (sorted(grads), sorted(own_grads)),
            "own_grad_err": max(float((grads[k] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                                for k, g in own_grads.items()),
        }
        if rank == 0:  # what the test holds to the JAX step
            records[phase].update(state=_numpy_state(trainer.model), grads={k: g.numpy().copy() for k, g in grads.items()})
    (Path(out_dir) / f"step_rank{rank}.pkl").write_bytes(pickle.dumps(records))
    dist.destroy_process_group()


def curriculum_rank(out_dir, argv):
    """``check_replicated`` on a copy of the weights that rank 1 perturbed,
    then ``dynamo_depth_torch.train.main(argv + --log_dir <out_dir>/rank<r>)``
    with every step's wrapper and every phase's weights before and after
    recorded."""
    from dynamo_depth_torch import train as train_entry
    from dynamo_depth_torch.models.model import DynamoModel
    from dynamo_depth_torch.training import trainer as trainer_mod

    rank, world = _join()
    out = {}
    torch.manual_seed(0)
    model = DynamoModel(drop_path_rate=0.0)
    pdist.check_replicated(model)  # identical: passes
    if rank == 1:
        with torch.no_grad():
            next(model.parameters())[0].view(-1)[0] += 1e-7
    try:
        pdist.check_replicated(model)
    except RuntimeError as e:
        out["replication_error"] = str(e)

    steps, phases = [], {}
    train_step, run_phase = trainer_mod.Trainer.train_step, trainer_mod.Trainer.run_phase

    def recorded_step(self, batch, generator, step):
        losses = train_step(self, batch, generator, step)
        steps.append({"phase": self.phase, "wrapper": id(self.ddp), "type": type(self.ddp).__name__,
                      "module_is_model": self.ddp.module is self.model})
        return losses

    def recorded_phase(self, phase, num_epoch):
        before = {k: v.detach().clone() for k, v in self.model.named_parameters()}
        run_phase(self, phase, num_epoch)
        moved = {k.split(".")[0] for k, v in self.model.named_parameters() if not torch.equal(v, before[k])}
        phases[phase] = {"moved": sorted(moved), "fingerprint": pdist.state_fingerprint(self.model).tolist()}

    trainer_mod.Trainer.train_step, trainer_mod.Trainer.run_phase = recorded_step, recorded_phase
    trainer = train_entry.main(list(argv) + ["--log_dir", str(Path(out_dir) / f"rank{rank}")], device="cpu")
    out.update(steps=steps, phases=phases, history=trainer.history, local_world_size=trainer.cfg.local_world_size,
               global_B=trainer.global_B)
    (Path(out_dir) / f"curriculum_rank{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.destroy_process_group()



def pretrained_rank(work_dir, out_dir):
    """A ``Trainer`` with ``weights_init="pretrained"`` built in ``work_dir``
    (whose ``ckpt/`` holds the backbone files; ``check_replicated`` runs in
    its ``__init__``): what this rank printed, and its state fingerprint.
    Also ``any_rank`` and ``all_gather_rows`` across the ranks."""
    import contextlib
    import io

    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.training.trainer import Trainer

    rank, world = _join()
    assert pdist.any_rank(rank == 1) and not pdist.any_rank(False)
    rows = pdist.all_gather_rows(torch.full((2, 4, 4), float(rank)))
    assert torch.equal(rows, torch.cat([torch.full((2, 4, 4), float(r)) for r in range(world)]))
    os.chdir(work_dir)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        trainer = Trainer(DynamoConfig(dataset="kitti", height=32, width=64, batch_size=1), device="cpu")
    out = Path(out_dir)
    (out / f"pretrained_rank{rank}.txt").write_text(printed.getvalue())
    (out / f"pretrained_rank{rank}.fp").write_text(str(pdist.state_fingerprint(trainer.model).tolist()))
    dist.destroy_process_group()


def init_fingerprints(depth_models):
    """In a process of its own, on torch's default thread pool: the state
    fingerprint of each depth model's ``DynamoModel`` drawn from seed 0."""
    from dynamo_depth_torch.models.model import DynamoModel

    return [pdist.state_fingerprint(DynamoModel(depth_model=d, generator=torch.Generator().manual_seed(0))).tolist()
            for d in depth_models]


class _RecordingWandb:
    """A stand-in for the wandb module: records ``log``'s dicts; ``init``
    raises where this rank's start is to fail."""

    def __init__(self, init_fails):
        self.init_fails, self.logs = init_fails, []

    def init(self, **kwargs):
        if self.init_fails:
            raise RuntimeError("no network")

    def log(self, data, step=None):
        self.logs.append(({k: v.copy() for k, v in data.items()}, step))

    def Image(self, array):  # noqa: N802 - wandb's name
        return array


def monitoring_rank(out_dir):
    """``Trainer.val`` in each phase of ``inputs.pkl`` on this rank's rows of
    its batch (the validation loader replaced by that one batch), then, in
    the last phase, ``setup_logging`` and ``log_vis`` of the same rows with
    each rank's wandb start made to fail as ``inputs["vis_cases"]`` says;
    records the validation scalars and what each stand-in logged."""
    import sys

    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.training.trainer import Trainer

    rank, world = _join()
    inputs = pickle.loads((Path(out_dir) / "inputs.pkl").read_bytes())
    cfg = DynamoConfig(**inputs["cfg"], log_dir=str(Path(out_dir) / f"logs{rank}"))
    local = {k: v[rank * cfg.batch_size:(rank + 1) * cfg.batch_size] for k, v in inputs["batch"].items()}
    trainer = Trainer(cfg, device="cpu", phase=inputs["phases"][0], drop_path_rate=0.0)
    trainer.model.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["state"].items()})
    trainer._make_val_loader = lambda: [local]
    records = {"val": {}, "vis": {}}
    for phase in inputs["phases"]:
        trainer.setup_phase(phase, inputs["steps_per_epoch"])
        trainer.step, trainer._val_iter = inputs["step"], None
        trainer.val()
        records["val"][phase] = trainer.history[-1]["scalars"]
    trainer.g_step = 3
    for case, failing_ranks in inputs["vis_cases"].items():
        stub = sys.modules["wandb"] = _RecordingWandb(rank in failing_ranks)
        trainer.setup_logging()
        trainer.log_vis("train", trainer.to_device(local))
        records["vis"][case] = stub.logs
    (Path(out_dir) / f"monitoring_rank{rank}.pkl").write_bytes(pickle.dumps(records))
    dist.destroy_process_group()
