"""Helpers of the benchmark's CPU tests: cells cut to a CPU's size, and a
host-clock stand-in for the CUDA events and synchronize the window uses."""

import dataclasses
import time

import pytest
import torch

from benchmark import spec

TINY = {"height": 64, "width": 96}


def tiny_cell(name: str, batch: int = 2) -> spec.Cell:
    """The cell ``name`` at 64x96 and ``batch`` rows, three warm-up steps
    and one profiled step; every other setting and its limits as committed."""
    cell = spec.load_cell(name)
    config = dict(cell.config, options=dict(cell.config["options"], **TINY))
    traffic = dict(cell.traffic, batch_size=batch, warmup_steps=3, profiled_steps=1)
    return dataclasses.replace(cell, config=config, traffic=traffic)


class HostEvent:
    """``torch.cuda.Event`` on the host clock."""

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


@pytest.fixture
def host_timing(monkeypatch):
    """Run the window on the CPU: events on the host clock, no synchronize."""
    monkeypatch.setattr(torch.cuda, "Event", HostEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
