"""Drive the program, ``dynamo_depth_torch``, through its public objects
``DynamoConfig`` and ``Trainer``: build the step, run its first steps with a
snapshot for the output check, the timed window, and the profiled steps.
The only module of the benchmark that imports the program.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from benchmark import inputs

CHECKED_STEPS = 3


def build(cell, seed: int, device, weights: dict, options: dict = None):
    """A ``Trainer`` of the cell's phase holding ``weights``."""
    from dynamo_depth_torch.config import DynamoConfig
    from dynamo_depth_torch.training.trainer import Trainer

    options = options or cell.options
    cfg = DynamoConfig(**options, seed=inputs.sub_seed(seed, "program") >> 32)
    trainer = Trainer(cfg, device=str(device), phase=cell.traffic["phase"], steps_per_epoch=options["epoch_size"],
                      drop_path_rate=cell.config["drop_path_rate"])
    trainer.model.load_state_dict(weights)
    return trainer


@dataclass
class Snapshot:
    """What the first ``CHECKED_STEPS`` steps left, for the check: the losses
    of each, the first gradient by parameter name, every parameter and
    buffer after the last of them, and the generator's state before each."""
    losses: list = field(default_factory=list)  # per step {name: float}: the total "loss" and every term
    grads: dict = field(default_factory=dict)
    after: dict = field(default_factory=dict)
    gen_states: list = field(default_factory=list)  # the generator's state before each checked step
    stats0: dict = field(default_factory=dict)  # the BatchNorm running statistics after the first step


def first_gradient(trainer) -> dict:
    """{name: the gradient Adam took in its first step}, from its state:
    after one step ``exp_avg = (1 - beta1) * grad``; None where Adam holds
    no state for the parameter."""
    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
    out = {}
    for name, p in trainer.model.named_parameters():
        state = trainer.optimizer.state.get(p, {})
        out[name] = state["exp_avg"].detach() / (1 - beta1) if "exp_avg" in state else None
    return out


def as_floats(losses: dict) -> dict:
    """{name: float} of a step's detached losses, in one copy to the host."""
    names = list(losses)
    values = torch.stack([losses[k].float().reshape(()) for k in names]).tolist()
    return dict(zip(names, values))


def running_stats(model) -> dict:
    """{name: a copy} of every BatchNorm running mean and variance."""
    return {k: v.detach().clone() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def first_steps(trainer, batches: list, gen: torch.Generator, steps: int) -> Snapshot:
    """Set-up's steps, through the window's own call and feed (step ``i``
    on ``batches[i % len(batches)]``), with a snapshot of the first
    ``CHECKED_STEPS``. The check holds only these steps against the
    reference, so the window has to run the path they run: the same call on
    the same object, with nothing that the step count or a warm-up switches
    on."""
    snap = Snapshot()
    for i in range(steps):
        if i < CHECKED_STEPS:
            snap.gen_states.append(gen.get_state())
        out = trainer.train_step(batches[i % len(batches)], gen, i)
        if i < CHECKED_STEPS:
            snap.losses.append(out)
        if i == 0:
            snap.grads = {k: None if g is None else g.clone() for k, g in first_gradient(trainer).items()}
            snap.stats0 = running_stats(trainer.model)
        if i == CHECKED_STEPS - 1:
            snap.after = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    snap.losses = [as_floats(out) for out in snap.losses]  # waits for the steps
    return snap


@dataclass
class Window:
    steps: int
    seconds: float  # window start to the final synchronize, host clock
    periods_ms: list  # step k's period, CUDA events
    host_spans_ms: list  # host time of each train_step call
    failed: int  # steps whose loss was not finite


def timed_window(trainer, batches: list, gen: torch.Generator, first: int, seconds: float) -> Window:
    """Steps back to back until ``seconds`` have passed on the host clock,
    then one synchronize. A CUDA event after each step marks its end; the
    losses are copied into one buffer on the card and read after the close."""
    dev = trainer.device
    cap = int(seconds * 200) + 16
    events = [torch.cuda.Event(enable_timing=True) for _ in range(cap + 1)]
    losses = torch.zeros(cap, device=dev)
    spans = []
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    events[0].record()
    n = 0
    while n < cap:
        a = time.perf_counter()
        out = trainer.train_step(batches[(first + n) % len(batches)], gen, first + n)
        b = time.perf_counter()
        events[n + 1].record()
        losses[n].copy_(out["loss"])
        spans.append(1e3 * (b - a))
        n += 1
        if b - t0 >= seconds:
            break
    torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    periods = [events[k].elapsed_time(events[k + 1]) for k in range(n)]
    failed = int((~torch.isfinite(losses[:n])).sum())
    return Window(steps=n, seconds=elapsed, periods_ms=periods, host_spans_ms=spans, failed=failed)


def profiled_steps(trainer, batches: list, gen: torch.Generator, first: int, count: int) -> dict:
    """``count`` steps under ``torch.profiler`` (CPU and CUDA), after one
    profiled warm-up step that is thrown away; -> the Chrome trace as a dict.
    The trace file lives in the temporary directory until it is read."""
    import json

    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    fd, path = tempfile.mkstemp(prefix="benchmark-trace-", suffix=".json")
    os.close(fd)
    try:
        torch.cuda.synchronize(trainer.device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=count),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            for k in range(count + 1):
                with record_function("benchmark.train_step"):
                    trainer.train_step(batches[(first + k) % len(batches)], gen, first + k)
                if k in (0, count):  # the profiled steps start and end on an idle card
                    torch.cuda.synchronize(trainer.device)
                prof.step()
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)
