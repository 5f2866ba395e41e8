"""Every piece of BENCHMARK.json is found by name, a new one is found by
adding files alone, and the file keeps to the benchmark's schema."""

import json
import os
import re

import pytest

from benchmark import spec
from benchmark.tests import tiny

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def check_top_level(bench, root):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(root, "BENCHMARK.json")) \
        <= 64 * 1024


def check_reduced(entry, config):
    """``reduced`` names the keys cut from the source, at most 16; the
    configuration file's own ``reduced`` says, in one line a key, what
    each was cut from."""
    keys = entry["reduced"]
    assert isinstance(keys, list) and len(keys) <= 16
    assert len(set(keys)) == len(keys) and all(NAME.match(k) for k in keys)
    cuts = config.get("reduced", {})
    assert sorted(cuts) == sorted(keys)
    for key, cut in cuts.items():
        assert key in config["mask"] or key in config
        assert _one_line(cut)


def check_config_entry(bench, entry, root):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert _one_line(entry["source"]) and _one_line(entry["why"])
    assert entry["file"].startswith("benchmark/")
    config = spec.config(bench, entry["name"], root)
    assert {"mask", "arms", "settings", "check", "assumed"} <= set(config)
    check_reduced(entry, config)
    assert any(c["config"] == entry["name"] for c in bench["workloads"])


def check_cell(bench, cell, root):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and _one_line(cell["why"])
    traffic = spec.traffic(cell["traffic"], root)
    assert traffic["mode"] in ("replay", "eager")
    config = spec.config(bench, cell["config"], root)
    assert str(traffic["k"]) in config["arms"]
    reported = spec.metrics_of(bench, cell["name"], False)
    assert "setup_s" in [m["name"] for m in reported] and len(reported) > 1
    assert spec.metrics_of(bench, cell["name"], True)


def check_names_unique(bench):
    for group in ("configs", "workloads"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(c["config"], c["traffic"]) for c in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def check_metric_entry(bench, entry, root):
    e2e = entry in bench["end_to_end"]
    keys = set(entry) - {"workloads"}
    assert keys == (E2E_KEYS if e2e else LAYER_KEYS)
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    assert callable(spec.metric(entry["name"], root).read)
    if not os.path.exists(os.path.join(root, spec.HERE, "metrics",
                                       entry["name"] + ".py")):
        # a split of a declared quantity: the same quantity, by cells
        base = entry["name"].rsplit(".", 1)[0]
        same = [m for m in bench["end_to_end"] + bench["per_layer"]
                if m["name"] == base]
        assert same
        for key in ("unit", "better", "source", "layer"):
            assert entry.get(key) == same[0].get(key)
    if e2e:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    else:
        assert _one_line(entry["layer"])
        assert entry["moves"] in [m["name"] for m in bench["end_to_end"]]
        cells = entry.get("workloads", [c["name"]
                                        for c in bench["workloads"]])
        for cell in cells:      # each cell it lists reports what it moves
            spec.cell(bench, cell)
            assert entry["moves"] in [
                m["name"] for m in spec.metrics_of(bench, cell, False)]


def test_top_level_keys():
    check_top_level(BENCH, spec.ROOT)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    check_config_entry(BENCH, entry, spec.ROOT)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_entry_and_its_files(cell):
    check_cell(BENCH, cell, spec.ROOT)


def test_names_are_unique():
    check_names_unique(BENCH)


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_metric_entry_and_its_reader(entry):
    check_metric_entry(BENCH, entry, spec.ROOT)


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "nope")
    with pytest.raises(ValueError):
        spec.traffic("../configs/pdb1HYS")
    with pytest.raises(FileNotFoundError):
        spec.metric("nope.at_all")
    for name in ("nope", "../generators", "local_strided/../x"):
        with pytest.raises(ValueError):
            spec.mask_generator(name)


def test_a_new_config_mix_and_metric_are_found_by_adding_files(tmp_path):
    root = tiny.make_root(tmp_path)
    with open(os.path.join(root, "benchmark/metrics/dummy.calls.py"),
              "w") as f:
        f.write('def read(run):\n    return run.calls\n')
    bench = spec.load_benchmark(root)
    bench["per_layer"].append({"name": "dummy.calls", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "sddmm_gflops",
                               "workloads": [tiny.CELL]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    bench = spec.load_benchmark(root)
    assert spec.config(bench, "tiny", root)["mask"]["n"] == 512
    assert spec.traffic("tiny_eager", root)["k"] == 32
    names = [m["name"] for m in spec.metrics_of(bench, tiny.CELL, True)]
    assert "dummy.calls" in names
    assert "dummy.calls" not in [
        m["name"] for m in spec.metrics_of(bench, BENCH["workloads"][0]
                                           ["name"], True)]

    class Run:
        calls = 7
    assert spec.metric("dummy.calls", root).read(Run()) == 7
    # a quantity split by cells has one reader
    assert spec.metric("dummy.calls.eager", root).read(Run()) == 7
