"""A benchmark root with one tiny cell beside the real files, for runs of
the harness on the CPU (the plain versions of the port's kernels)."""

import json
import os
import shutil

from benchmark import spec


def cell(mode="eager"):
    return f"tiny.k32.{mode}"


CELL = cell()


def copy_root(tmp):
    """Copy ``BENCHMARK.json`` and ``benchmark/`` into ``tmp``."""
    root = str(tmp)
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copyfile(os.path.join(spec.ROOT, "BENCHMARK.json"),
                    os.path.join(root, "BENCHMARK.json"))
    return root


def make_root(tmp, mode="eager"):
    """Copy ``BENCHMARK.json`` and ``benchmark/`` into ``tmp`` and add the
    tiny configuration, a traffic mix of ``mode`` and a cell of them."""
    root = copy_root(tmp)
    bench = spec.load_benchmark(root)
    config = spec.config(bench, bench["configs"][0]["name"], root)
    config.update(mask={"generator": "banded", "n": 512, "nnz": 20000,
                        "bandwidth": 32, "seed": 1},
                  expected_nnz=None,
                  arms={"32": {"alpha": 0.3, "delta": 0.002,
                               "subpack_min_nnz": 12}})
    dump(root, "benchmark/configs/tiny.json", config)
    dump(root, f"benchmark/traffic/tiny_{mode}.json",
          {"k": 32, "mode": mode, "ring_min_bytes": 300000,
           "warmup_calls": 2, "trace_calls": 3})
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "benchmark/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell(mode), "config": "tiny",
                               "traffic": f"tiny_{mode}", "chips": 1,
                               "why": "test"})
    for entry in bench["end_to_end"] + bench["per_layer"]:
        # the tiny cell reports what the real cells report
        if "workloads" in entry:
            entry["workloads"].append(cell(mode))
    dump(root, "BENCHMARK.json", bench)
    return root


def dump(root, rel, obj):
    """Write ``obj`` as JSON to ``rel`` under ``root``."""
    with open(os.path.join(root, rel), "w") as f:
        json.dump(obj, f, indent=1)
