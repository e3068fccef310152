"""Entry points of the port for a compile check and a dry run (the
counterpart of ``__graft_entry__.py``).

    python -m dynamo_depth_torch.entry [n] [--arm=flagship] [--backend=gloo] [--device=cpu]

(``n`` defaults to the number of cards.)

``entry()``           -> (fn, example_args): the full LiteMono Dynamo-Depth
                         forward at the KITTI training resolution.
``dryrun_multichip``  -> ONE data-parallel ``fine_tune`` training step over
                         ``n`` ranks, in two arms (tiny shapes, then the
                         flagship configuration).

Each arm starts ``n`` rank processes on this machine
(``parallel/dist.py::spawn_ranks``), which join through ``init_distributed``:
NCCL with one card per rank by default; ``backend="gloo"`` lets ranks share
a card, or run on the CPU with ``device="cpu"``. The JAX package's dry run
forces ``n`` virtual CPU devices into one process instead
(``_ensure_devices``); here a NCCL run asking for more ranks than there are
cards is refused, naming both numbers.

Left out: ``_FilteredStderr`` and ``_drop_aot_spam``, which drop the
persistent XLA compile cache's AOT-loader log lines from stderr. Eager
PyTorch prints no such lines.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from dynamo_depth_torch.config import DynamoConfig
from dynamo_depth_torch.models.model import DynamoModel
from dynamo_depth_torch.parallel import dist as pdist
from dynamo_depth_torch.training.synthetic import synthetic_batch
from dynamo_depth_torch.training.trainer import _to_layout, resolve_device
from dynamo_depth_torch.utils import bounded

ROOT = Path(__file__).resolve().parents[1]
ENTRY_OUTPUTS = (("disp", 0, 0), ("cam_T_cam", 0, 1), ("motion_mask", 1, 0))


def entry(device: Optional[str] = None, height: Optional[int] = None, width: Optional[int] = None):
    """The full LiteMono Dynamo-Depth forward (flow and mask) at the config's
    192x640 (or ``height`` x ``width``), batch 1 -> ``(fn, (model, batch))``;
    ``fn(model, batch)`` runs the model in eval mode without a graph and
    returns its ``("disp", 0, 0)``, ``("cam_T_cam", 0, 1)`` and
    ``("motion_mask", 1, 0)``. The weights are the JAX package's random init
    drawn from ``cfg.seed`` on the CPU; the batch is NCHW on ``device`` (the
    card unless ``"cpu"``)."""
    device = resolve_device(device)
    cfg = DynamoConfig(dataset="kitti", no_train_vis=True, height=height, width=width)
    model = DynamoModel(
        depth_model=cfg.depth_model, encoder_num_layers=cfg.encoder_num_layers, scales=tuple(cfg.scales),
        frame_ids=tuple(cfg.frame_ids), generator=torch.Generator().manual_seed(cfg.seed),
    ).to(device).eval()
    host = synthetic_batch(cfg, 1, cfg.height, cfg.width, with_color=False)
    batch = {k: _to_layout(k, torch.from_numpy(v)).to(device) for k, v in host.items()}

    def fn(model, batch):
        model.eval()
        with torch.no_grad():
            out = model(batch, bool_CmpFlow=True, bool_MotMask=True)
        return tuple(out[k] for k in ENTRY_OUTPUTS)

    return fn, (model, batch)


def _on_cpu(device: Optional[str]) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def _check_devices(n_devices: int, backend: Optional[str], device: Optional[str]) -> None:
    """Refuse a dry run this machine cannot hold: no card unless the CPU is
    asked for, and under NCCL (one card per rank) more ranks than cards."""
    if _on_cpu(device):
        return
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the dry run on the CPU")
    cards = torch.cuda.device_count()
    if (backend or "nccl") == "nccl" and n_devices > cards:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) over NCCL needs {n_devices} cards, one per rank, and this machine has "
            f"{cards}: pass backend='gloo' to let ranks share a card")


def _dryrun_step(cfg: DynamoConfig, n_devices: int, tag: str, device: Optional[str]) -> None:
    """One rank of an arm: its rows of the synthetic global batch, one
    ``fine_tune`` step; rank 0 prints the loss."""
    from dynamo_depth_torch.training.trainer import Trainer

    trainer = Trainer(cfg, device=device, phase="fine_tune", steps_per_epoch=10)
    if trainer.world != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}): the launch has {trainer.world} ranks")
    rows = synthetic_batch(cfg, trainer.global_B, cfg.height, cfg.width)
    mine = slice(trainer.rank * trainer.B, (trainer.rank + 1) * trainer.B)
    losses = trainer.train_step(trainer.to_device({k: v[mine] for k, v in rows.items()}), trainer.generator, 0)
    loss = float(losses["loss"])
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip({n_devices}) [{tag}]: loss {loss}")
    if trainer.rank == 0:
        print(f"dryrun_multichip({n_devices}) [{tag}]: fine_tune step OK, loss={loss:.5f}", flush=True)


def _dryrun_rank(cfg_kwargs: dict, n_devices: int, tag: str, backend: Optional[str], device: Optional[str]) -> None:
    """A spawned rank (torchrun's environment is set): join, step, leave.
    Ranks on the card over gloo take the cards in turn."""
    pdist.init_distributed(device, backend)
    if not _on_cpu(device) and backend == "gloo":
        device = f"cuda:{pdist.rank() % torch.cuda.device_count()}"
    try:
        _dryrun_step(DynamoConfig(**cfg_kwargs), n_devices, tag, device)
    finally:
        torch.distributed.destroy_process_group()


def _run_arm(cfg_kwargs: dict, n_devices: int, tag: str, backend, device, timeout: float) -> None:
    pdist.spawn_ranks(_dryrun_rank, (cfg_kwargs, n_devices, tag, backend, device), world=n_devices,
                      timeout=timeout)


def _dryrun_flagship(n_devices: int, backend: Optional[str] = None, device: Optional[str] = None,
                     timeout: float = 3600.0) -> None:
    """The flagship config every bench number quotes (LiteMono, KITTI
    192x640, scales [0, 1, 2]), batch 1 per rank."""
    _check_devices(n_devices, backend, device)
    _run_arm(dict(dataset="kitti", depth_model="litemono", batch_size=1, num_devices=n_devices, no_train_vis=True),
             n_devices, "flagship litemono 192x640", backend, device, timeout)


def _run_flagship_subprocess(n_devices: int, timeout: float, backend: Optional[str] = None,
                             device: Optional[str] = None):
    """Seam for tests: run the flagship arm in a subprocess bounded by
    ``timeout`` seconds (``utils/bounded.py``: at the timeout it and its
    ranks are stopped and ``subprocess.TimeoutExpired`` raised with the
    output)."""
    cmd = [sys.executable, "-m", "dynamo_depth_torch.entry", str(n_devices), "--arm=flagship"]
    cmd += [f"--backend={backend}"] if backend else []
    cmd += [f"--device={device}"] if device else []
    return bounded.run(cmd, timeout, cwd=str(ROOT), env=os.environ.copy(), stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)


def dryrun_multichip(n_devices: int, backend: Optional[str] = None, device: Optional[str] = None) -> None:
    """ONE full ``fine_tune`` train step (all 7 networks, the full loss
    stack, the RANSAC ground plane) data-parallel over ``n_devices`` ranks,
    in two arms (``__graft_entry__.py::dryrun_multichip``):

    1. monodepthv2 32x64, batch 1 per rank: always runs, its ranks started
       from this process.
    2. the flagship LiteMono 192x640 (:func:`_dryrun_flagship`): in a
       subprocess bounded by what is left of ``DYNAMO_DRYRUN_BUDGET``
       seconds (default 480). Over the budget it is SKIPPED with a message
       (a budget skip is not a failure); a real failure (the subprocess
       exits non-zero) raises ``RuntimeError``.

    ``DYNAMO_DRYRUN_QUICK=1`` skips the flagship arm outright. Prints each
    arm's wall seconds."""
    t0 = time.monotonic()
    budget = float(os.environ.get("DYNAMO_DRYRUN_BUDGET", "480"))
    _check_devices(n_devices, backend, device)
    _run_arm(dict(dataset="kitti", height=32, width=64, depth_model="monodepthv2", scales=[0, 1], batch_size=1,
                  num_devices=n_devices, no_train_vis=True),
             n_devices, "monodepthv2 32x64", backend, device, budget)
    print(f"dryrun_multichip: monodepthv2 arm took {time.monotonic() - t0:.1f} s of wall", flush=True)
    if os.environ.get("DYNAMO_DRYRUN_QUICK"):
        print("dryrun_multichip: flagship arm skipped (DYNAMO_DRYRUN_QUICK=1)")
        return
    remaining = budget - (time.monotonic() - t0)
    if remaining < 30:
        print(
            f"dryrun_multichip: flagship arm skipped (only {remaining:.0f}s of "
            f"the {budget:.0f}s budget left after the monodepthv2 arm)"
        )
        return
    t1 = time.monotonic()
    try:
        proc = _run_flagship_subprocess(n_devices, remaining, backend=backend, device=device)
    except subprocess.TimeoutExpired as e:
        sys.stdout.write(e.output or "")
        print(
            f"dryrun_multichip: flagship arm skipped (exceeded the "
            f"{remaining:.0f}s remaining budget; monodepthv2 arm passed)"
        )
        return
    sys.stdout.write(proc.stdout or "")
    if proc.returncode != 0:
        raise RuntimeError(
            f"dryrun_multichip: flagship arm FAILED (rc={proc.returncode}); "
            "monodepthv2 arm passed - see subprocess output above"
        )
    print(f"dryrun_multichip: flagship arm took {time.monotonic() - t1:.1f} s of wall")
    print("dryrun_multichip: both arms completed", flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    bounded.exit_on_sigterm()  # a caller's SIGTERM reaches the flagship arm's process group too
    n = int(argv[0]) if argv and not argv[0].startswith("--") else max(torch.cuda.device_count(), 1)
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    if "--arm=flagship" in argv:
        _dryrun_flagship(n, opts.get("backend"), opts.get("device"))
    else:
        dryrun_multichip(n, opts.get("backend"), opts.get("device"))


if __name__ == "__main__":
    main()
