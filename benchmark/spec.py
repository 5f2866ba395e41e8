"""Finding a cell's pieces by name.

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own, which is found from the names in
``BENCHMARK.json``:

- a configuration: the JSON file that its entry's ``file`` names;
- a traffic mix: ``benchmark/traffic/<traffic>.json``, parameters that the
  one general generator (``loadgen``) reads;
- a metric: ``benchmark/metrics/<name>.py``, a reader ``read(run)``, or,
  where no such file is there, the reader of the name without its last
  dotted part, so that one quantity split by the cells that report it
  (``kernels.hand_ms.eager`` beside ``kernels.hand_ms``) has one reader.
  Unit, direction, layer and what it moves are declared in
  ``BENCHMARK.json`` alone;
- a mask generator that is not one of the frozen ones of
  ``data/generators.py``: ``benchmark/data/masks/<generator>.py``, a
  ``make(**kwargs)`` that returns a ``generators.Mask``, with a small
  ``EXAMPLE`` (its keyword arguments) and ``EXAMPLE_SHA256``, the
  ``generators.digest`` of that example's mask, which holds it frozen.

So a cell, a configuration, a mix or a metric is added by adding files and
entries, with no edit to a file that is there. Nothing here imports torch.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import List

#: the checkout: the directory above ``benchmark/``
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _entry(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    """The configuration file of the configuration ``name``."""
    entry = _entry(bench["configs"], name, "config")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(name: str, root: str = ROOT) -> dict:
    path = os.path.join(root, HERE, "traffic", f"{_check_name(name)}.json")
    with open(path) as f:
        return json.load(f)


def _load(path: str, prefix: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric(name: str, root: str = ROOT) -> ModuleType:
    """The reader module of the metric ``name``."""
    metrics = os.path.join(root, HERE, "metrics")
    path = os.path.join(metrics, f"{_check_name(name)}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(metrics, f"{name.rsplit('.', 1)[0]}.py")
    return _load(path, "benchmark_metric_", name)


def mask_generator(name: str, root: str = ROOT) -> ModuleType:
    """The module of the generator file ``data/masks/<name>.py``; a
    ``ValueError`` where there is none."""
    path = os.path.join(root, HERE, "data", "masks",
                        f"{_check_name(name)}.py")
    if not os.path.isfile(path):
        raise ValueError(f"unknown mask generator {name!r}")
    return _load(path, "benchmark_mask_", name)


def metrics_of(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metric entries a run of the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced. An entry without
    ``workloads`` belongs to every cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if cell_name in m.get("workloads", [cell_name])]
