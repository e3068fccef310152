"""Data parallelism over ``torch.distributed`` (the port's counterpart of
``dynamo_depth_tpu.parallel.mesh``).

One process per card, launched by torchrun (the reference's launcher)::

    torchrun --nproc_per_node N -m dynamo_depth_torch.train [flags]

:func:`init_distributed` joins the process group that torchrun's environment
describes; without that environment the program is one process and every
function here is a no-op. The trainer averages gradients through
``DistributedDataParallel`` and BatchNorm statistics and losses through
:func:`all_reduce_mean`, which is the JAX package's ``pmean`` over its data
axis; validation gathers the ranks' rows (:func:`all_gather_rows`) and
broadcasts rank 0's scores (:func:`broadcast_object`), and the
visualisation takes its maxima over the ranks (:func:`all_reduce_max`).
``all_reduce`` and ``broadcast`` run on the tensors where they lie,
since gloo also runs them on CUDA tensors (it has no ``ReduceOp.AVG``);
:func:`all_gather_rows` gathers on the backend's own device.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# What torchrun exports to each process it starts.
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device: Optional[str] = None, backend: Optional[str] = None) -> bool:
    """Join the process group of a torchrun launch; returns whether one is
    initialised.

    With none of :data:`LAUNCH_ENV` set this is one process and a no-op. A
    partial environment (a stale ``RANK``, say) is refused, naming what is
    missing. ``device`` is where the entry point runs (``None``: the card):
    the backend is ``nccl`` for the card and ``gloo`` for the CPU, unless
    ``backend`` names another (gloo on the card lets two ranks share one
    card, which NCCL refuses). Under NCCL each process takes the card of its
    ``LOCAL_RANK``. A second call is a no-op."""
    env = {name: os.environ.get(name) for name in LAUNCH_ENV}
    given = [name for name, v in env.items() if v]
    if not given:
        return False
    missing = [name for name, v in env.items() if not v]
    if missing:
        raise RuntimeError(
            f"the torchrun launch environment is incomplete: {missing} unset while {given} is set; "
            "launch with torchrun, or export all five or none")
    if dist.is_initialized():
        return True
    on_cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if on_cpu else "nccl")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for NCCL: pass device='cpu' to run on the CPU over gloo")
        torch.cuda.set_device(int(env["LOCAL_RANK"]))
    dist.init_process_group(backend, init_method="env://", rank=int(env["RANK"]),
                            world_size=int(env["WORLD_SIZE"]))
    return True


def _spawned_rank(rank: int, world: int, port: int, fn: Callable, args: Sequence) -> None:
    """A rank of :func:`start_ranks`: torchrun's environment, joining the
    launcher's store on ``port`` as a client (as torchrun's ranks join its
    agent's store), then ``fn(*args)``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), TORCHELASTIC_USE_AGENT_STORE="True")
    fn(*args)


def start_ranks(fn: Callable, args: Sequence = (), world: int = 1):
    """Start ``fn(*args)`` as ranks 0..``world``-1 of one launch, each a
    process spawned on this machine with torchrun's environment (``fn``
    joins the group through :func:`init_distributed`; it must be
    picklable). Returns the spawn context for :func:`join_ranks`; it holds
    the rendezvous store, so the store's port stays bound while it lives."""
    import torch.multiprocessing as mp

    # The rendezvous store is served here on a port the system picks, which
    # stays bound while the store lives: no other process can take it before
    # the ranks join, as it can a port found free, closed and handed on.
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    ctx = mp.start_processes(_spawned_rank, args=(world, store.port, fn, tuple(args)), nprocs=world, join=False,
                             start_method="spawn")
    ctx.store = store
    return ctx


def join_ranks(ctx, timeout: Optional[float] = None) -> None:
    """Wait for the ranks of :func:`start_ranks`. Raises if a rank fails
    (with its traceback) or if they outlast ``timeout`` s, and leaves none
    running."""
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{len(ctx.processes)} ranks still running after {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def spawn_ranks(fn: Callable, args: Sequence = (), world: int = 1, timeout: Optional[float] = None) -> None:
    """:func:`start_ranks`, then :func:`join_ranks`."""
    join_ranks(start_ranks(fn, args, world), timeout)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
    """The index of this process's card on its machine (torchrun's
    ``LOCAL_RANK``); 0 for one process."""
    return int(os.environ.get("LOCAL_RANK", 0)) if is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0, which alone prints, logs and writes checkpoints (the
    reference's ``is_main``, Trainer.py:736-739)."""
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def _comm_device() -> torch.device:
    """Where a collective's own tensors live: NCCL reduces on the card."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _coalesced(tensors: List[torch.Tensor], collective: Callable) -> None:
    """``collective(flat)`` on the flattened tensors of each (dtype,
    device), then the result copied back into the tensors in place."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_sum(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each tensor over the ranks, in place: one ``all_reduce`` per
    (dtype, device) of the flattened tensors. Returns ``tensors``."""
    if world_size() > 1:
        _coalesced(tensors, dist.all_reduce)
    return tensors


def all_reduce_max(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The largest value of each entry over the ranks, in place: one
    ``all_reduce`` with ``MAX`` per (dtype, device) of the flattened
    tensors. Returns ``tensors``."""
    if world_size() > 1:
        _coalesced(tensors, lambda flat: dist.all_reduce(flat, op=dist.ReduceOp.MAX))
    return tensors


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank; ``obj`` itself for one
    process (the other ranks' ``obj`` is not read)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_comm_device())
    return box[0]


def broadcast_state(module: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers to every rank, in place: one
    ``broadcast`` per (dtype, device) of the flattened tensors. A no-op for
    one process."""
    if world_size() > 1:
        _coalesced(list(module.state_dict().values()), lambda flat: dist.broadcast(flat, src=0))


def all_reduce_mean(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean of each floating-point tensor over the ranks, in place:
    their sum (:func:`all_reduce_sum`) over the world size. Returns
    ``tensors``."""
    world = world_size()
    if world == 1:
        return tensors
    all_reduce_sum(tensors)
    for t in tensors:
        t.div_(world)
    return tensors


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` holds on any rank (every rank gets the same
    answer); ``flag`` itself for one process."""
    if world_size() == 1:
        return flag
    count = torch.tensor([int(flag)], dtype=torch.int64, device=_comm_device())
    dist.all_reduce(count)
    return bool(count.item())


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` (each of the same shape) concatenated along the
    first axis in rank order, on every rank, on ``t``'s device; ``t`` itself
    for one process. The gather runs on the backend's device: gloo has no
    ``all_gather`` of CUDA tensors."""
    world = world_size()
    if world == 1:
        return t
    dev = _comm_device()
    mine = t.detach().to(dev).contiguous()
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    return torch.cat(parts).to(t.device)


def state_fingerprint(module: torch.nn.Module) -> torch.Tensor:
    """64-bit content hash of a module's state dict (names, dtypes, shapes and
    bytes of every parameter and buffer) as 4 int64 words, each < 2**16."""
    h = hashlib.sha256()
    for name, t in module.state_dict().items():
        t = t.detach().cpu().contiguous()
        h.update(str((name, str(t.dtype), tuple(t.shape))).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return torch.frombuffer(bytearray(h.digest()[:8]), dtype=torch.int16).to(torch.int64) & 0xFFFF


def check_replicated(module: torch.nn.Module) -> None:
    """Raise unless every rank holds the same state as rank 0: its
    fingerprint is broadcast and compared on every rank, and the count of
    ranks that differ is summed, so all ranks raise together. (The JAX
    package's ``replicate_to_mesh`` check; ``DistributedDataParallel`` would
    instead copy rank 0's weights over a diverged rank without a word.)"""
    world = world_size()
    if world == 1:
        return
    dev = _comm_device()
    mine = state_fingerprint(module).to(dev)
    ref = mine.clone()
    dist.broadcast(ref, src=0)
    differ = (mine != ref).any().to(torch.int64).reshape(1)
    dist.all_reduce(differ)
    if int(differ.item()):
        raise RuntimeError(
            f"check_replicated: the weights of {int(differ.item())} of {world} ranks differ from rank 0's "
            "(state fingerprints disagree); every rank must hold identical state (same seed, same checkpoint, "
            "same pretrained weights). A common cause: a load that failed on some ranks, leaving their random "
            "init there.")
