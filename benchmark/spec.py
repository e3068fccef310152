"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix:

    configs/<config>.json     the model and the recipe, as run
    traffic/<traffic>.json    what one run feeds the step: phase, batch, ring
    workloads/<cell>.json     the limits of the cell's output check
    metrics/<metric>.py       one reader per metric; a metric split by the
                              end-to-end metric it moves, <metric>.<part>,
                              reads as <metric> does unless it has a file

A later cell, configuration or metric is a new file and a new entry here;
no file that is there needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK_JSON = ROOT / "BENCHMARK.json"


def load_benchmark(path: Path = BENCHMARK_JSON) -> dict:
    with open(path) as f:
        return json.load(f)


def _read(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # workloads/<cell>.json["limits"]: number -> limit
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def options(self) -> dict:
        """The recipe's options (``DynamoConfig`` field names) with the
        traffic's batch."""
        return dict(self.config["options"], batch_size=self.traffic["batch_size"])


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None) -> Cell:
    bench = bench or load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {known})")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(ROOT / config["file"]) as f:
        config_file = json.load(f)
    return Cell(
        name=name,
        chips=entry["chips"],
        config=config_file,
        traffic=_read("traffic", entry["traffic"]),
        limits=_read("workloads", name)["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str):
    """``read(record) -> float or None`` of ``metrics/<name>.py``, or, where
    there is none, of the name without its last dotted part
    (``examples_per_s.device_bound`` reads as ``examples_per_s``)."""
    path = HERE / "metrics" / f"{name}.py"
    base = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    if not path.exists() and "." in name and base.exists():
        path = base
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
