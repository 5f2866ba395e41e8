"""A configuration that is not a SuiteSparse replica lands as new files and
new entries alone. In a copy of the benchmark this adds a generator file
with its example, a configuration that uses it with a cut in ``reduced``,
a traffic mix, a cell, and the cell's split per-layer entries. Then every
invariant of the spec, data and span tests holds over the copy, a CPU run
of the new cell is correct and reports its split metrics, and every file
that was there before is byte for byte as it was."""

import json
import os
import time

import pytest

from benchmark import harness, spec
from benchmark.tests import tiny
from benchmark.tests.test_bench_data import (check_config_mask,
                                             check_generator_file,
                                             generator_files)
from benchmark.tests.test_bench_spans import check_declared_for_every_cell
from benchmark.tests.test_bench_spec import (check_cell, check_config_entry,
                                             check_metric_entry,
                                             check_names_unique,
                                             check_top_level)

SEED = 2**31 + 777
CONFIG = "causal_band_512"
CELL = "causal_band_512.k32.eager"

GENERATOR = '''"""A causal sliding window: row i holds columns
max(0, i - window + 1) to i."""

import numpy as np

from benchmark.data.generators import Mask

EXAMPLE = {"n": 40, "window": 6}
EXAMPLE_SHA256 = ("9003eb1e4bfe8e90537d9f0af70a2dcd"
                  "d57eeff2c8057581de1cb3db727e75a4")


def make(n, window):
    q = np.arange(n, dtype=np.int64)
    lo = np.maximum(q - window + 1, 0)
    row_offsets = np.zeros(n + 1, np.int64)
    row_offsets[1:] = np.cumsum(q - lo + 1)
    cols = np.concatenate([np.arange(a, b + 1) for a, b in zip(lo, q)])
    return Mask(n, n, row_offsets, cols.astype(np.int32))
'''


def add_route(root):
    """Add the new configuration, its mix, cell and split per-layer
    entries to the benchmark at ``root``; returns the split entries."""
    with open(os.path.join(root, "benchmark/data/masks/causal_band.py"),
              "w") as f:
        f.write(GENERATOR)
    bench = spec.load_benchmark(root)
    base = spec.config(bench, bench["configs"][0]["name"], root)
    tiny.dump(root, f"benchmark/configs/{CONFIG}.json", {
        "deployment": "the Sparse Transformer's causal local band alone, "
                      "at a cut sequence length: a test configuration",
        "mask": {"generator": "causal_band", "n": 512, "window": 128},
        "reduced": {"n": "512 positions from the source's 12288 (enwik8), "
                         "so that a CPU test stays short"},
        "expected_nnz": 57408,
        "arms": {"32": {"alpha": 0.3, "delta": 0.002,
                        "subpack_min_nnz": 12}},
        "settings": base["settings"],
        "precision": base["precision"],
        "guarantees": base["guarantees"],
        "check": base["check"],
        "assumed": {"mask": "every position attends to itself and the 127 "
                            "before it; the strided summaries are left out",
                    "operands": base["assumed"]["operands"]},
    })
    tiny.dump(root, "benchmark/traffic/k32_eager_short.json",
              {"k": 32, "mode": "eager", "ring_min_bytes": 300000,
               "warmup_calls": 2, "trace_calls": 3})
    bench["configs"].append({
        "name": CONFIG, "file": f"benchmark/configs/{CONFIG}.json",
        "source": "https://arxiv.org/abs/1904.10509 (Sparse Transformer, "
                  "local band of 128 on enwik8)",
        "reduced": ["n"], "why": "test: a mask that is not a replica"})
    bench["workloads"].append({"name": CELL, "config": CONFIG,
                               "traffic": "k32_eager_short", "chips": 1,
                               "why": "test: the new configuration, eager"})
    splits = [dict(m, name=f"{m['name']}.{CONFIG}", workloads=[CELL])
              for m in bench["per_layer"]]
    bench["per_layer"] += splits
    tiny.dump(root, "BENCHMARK.json", bench)
    return splits


def _files(root):
    out = {}
    for top, _, names in os.walk(root):
        for name in names:
            path = os.path.join(top, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def route(tmp_path_factory):
    root = tiny.copy_root(tmp_path_factory.mktemp("bench"))
    before = _files(root)
    splits = add_route(root)
    return root, before, _files(root), splits


def test_every_invariant_holds_over_the_new_entries(route):
    root = route[0]
    bench = spec.load_benchmark(root)
    assert CELL in [c["name"] for c in bench["workloads"]]
    check_top_level(bench, root)
    check_names_unique(bench)
    for entry in bench["configs"]:
        check_config_entry(bench, entry, root)
        check_config_mask(bench, entry, root)
    for cell in bench["workloads"]:
        check_cell(bench, cell, root)
    for entry in bench["end_to_end"] + bench["per_layer"]:
        check_metric_entry(bench, entry, root)
    check_declared_for_every_cell(bench)
    assert "causal_band" in generator_files(root)
    for name in generator_files(root):
        check_generator_file(name, root)


@pytest.mark.parametrize("trace", [False, True])
def test_the_new_cell_runs_correct_and_reports_its_metrics(route, trace):
    root, _, _, splits = route
    run, bench, cell, config = harness.execute(
        CELL, SEED, 0.2, trace, "cpu", time.perf_counter(), root=root)
    out = harness.result(run, bench, cell, config, trace, 1, root=root)
    assert out["correct"] is True and run.nnz == 57408
    if trace:
        # every split entry whose reader needs no device trace reports
        want = {m["name"] for m in splits if m["source"] != "device_trace"}
    else:
        want = {m["name"] for m in bench["end_to_end"]}
    assert want and set(out["metrics"]) == want
    assert all(m["value"] > 0 for m in out["metrics"].values())


def test_no_file_that_was_there_changed(route):
    _, before, after, _ = route
    assert sorted(set(after) - set(before)) == [
        "benchmark/configs/causal_band_512.json",
        "benchmark/data/masks/causal_band.py",
        "benchmark/traffic/k32_eager_short.json"]
    changed = [rel for rel, data in before.items() if after[rel] != data]
    assert changed == ["BENCHMARK.json"]
    old, new = (json.loads(d["BENCHMARK.json"]) for d in (before, after))
    assert set(new) == set(old)
    for key, value in old.items():    # entries only appended
        assert (new[key][:len(value)] if isinstance(value, list)
                else new[key]) == value, key
