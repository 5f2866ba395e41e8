"""The Sparse Transformer's enwik8 configuration: its frozen mask generator
against the port's ``fixed_mask``, the yardstick of the dense tier's
launch (``kernel_work``) against the port's ``dense_kernels.tile_work``,
the reader ``dense.roofline_pct`` on runs with and without what it reads,
the split per-layer entries of its cell, and a CPU run of the
configuration cut to 1 024 positions."""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from benchmark import harness, kernel_work, spec
from benchmark.data import generators
from benchmark.tests import tiny

from bsmr_sddmm_tpu_torch import BsmrSddmm, SddmmConfig
from bsmr_sddmm_tpu_torch.models.sparse_transformer import fixed_mask
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops.sddmm import make_sddmm_body
from bsmr_sddmm_tpu_torch.utils import profiling

BENCH = spec.load_benchmark()
CONFIG = "st_enwik8"
CELL = "st_enwik8.k64.replay"
ROOFLINE = "dense.roofline_pct"
SEED = 2**31 + 1904


@pytest.mark.parametrize("args", [(300, 16, 4), (2048, 128, 32),
                                  (12288, 128, 32)])
def test_generator_is_the_ports_fixed_mask(args):
    seq_len, stride, c = args
    mask = generators.make_mask({"generator": "fixed_attention",
                                 "seq_len": seq_len, "stride": stride,
                                 "c": c})
    csr = fixed_mask(seq_len, stride, c)
    assert (mask.rows, mask.cols) == (csr.rows, csr.cols)
    assert mask.row_offsets.dtype == csr.row_offsets.dtype
    assert mask.col_indices.dtype == csr.col_indices.dtype
    np.testing.assert_array_equal(mask.row_offsets, csr.row_offsets)
    np.testing.assert_array_equal(mask.col_indices, csr.col_indices)


def test_config_is_the_published_model():
    config = spec.config(BENCH, CONFIG)
    assert config["mask"] == {"generator": "fixed_attention",
                              "seq_len": 12288, "stride": 128, "c": 32}
    assert config["expected_nnz"] == 19_470_336
    model = config["model"]
    assert (model["num_layers"], model["num_heads"], model["model_dim"],
            model["head_dim"], model["seq_len"], model["vocab_size"]) == (
        30, 8, 512, 64, 12288, 256)
    assert config["settings"]["col_mode"] == "reorder"
    entry = [c for c in BENCH["configs"] if c["name"] == CONFIG][0]
    assert "arXiv:1904.10509" in entry["source"] and entry["reduced"] == []


def _tiny_plan(col_mode="reorder"):
    mask = fixed_mask(512, 64, 8)
    cfg = SddmmConfig(k=32, alpha=0.3, delta=0.3, col_mode=col_mode)
    plan = BsmrSddmm(mask, cfg, device="cpu").plan(cfg.alpha, cfg.delta, 32)
    make_sddmm_body(plan, cfg)
    return plan, profiling.counters()


@pytest.mark.parametrize("col_mode", ["reorder", "bsr"])
def test_kernel_work_is_the_ports_tile_work(col_mode):
    plan, got = _tiny_plan(col_mode)
    args = (got["body.dense.tiles"], got["body.tile.rows"],
            got["body.tile.cols"], plan.k)
    rows = dict(a_rows=got["body.dense.a_rows"],
                b_rows=got["body.dense.b_rows"],
                index_bytes=got["body.dense.index_bytes"])
    for passes in (1, 3):
        want = dk.tile_work(*args, torch.float32, passes=passes, **rows)
        assert kernel_work.tile_flops(*args) == want["flops"]
        assert kernel_work.tile_bytes(*args, **rows) == want["bytes"]
        bound = kernel_work.tile_bound_s(*args, passes=passes,
                                         device_name="NVIDIA H100 80GB HBM3",
                                         **rows)
        assert bound == pytest.approx(want["bound_ms"] / 1e3, rel=1e-12)
    assert kernel_work.tile_bound_s(*args, passes=3, device_name="cpu",
                                    **rows) is None


def _run(kernels, calls=10, fused=0, device="NVIDIA H100 80GB HBM3"):
    return types.SimpleNamespace(
        k=32, device_name=device,
        counters={"fused_gathered.launches": fused},
        traced={"calls": calls, "kernels": kernels})


def _read(run, root=spec.ROOT):
    return spec.metric(ROOFLINE, root).read(run)


def test_roofline_reads_the_kernels_time_per_call():
    _, got = _tiny_plan()
    kernels = [("void gathered_tile_kernel<32, 128, 3>(float const*)",
                0.0, 40.0),
               ("void gathered_tile_kernel<32, 128, 3>(float const*)",
                100.0, 140.0),
               ("vectorized_gather_kernel", 40.0, 90.0)]
    bound = kernel_work.tile_bound_s(
        got["body.dense.tiles"], got["body.tile.rows"],
        got["body.tile.cols"], 32, got["body.dense.a_rows"],
        got["body.dense.b_rows"], got["body.dense.index_bytes"], 3,
        "NVIDIA H100 80GB HBM3")
    assert _read(_run(kernels, calls=2)) == pytest.approx(
        100.0 * bound / 40e-6)
    assert _read(_run(kernels[2:])) is None            # kernel not run
    assert _read(_run(kernels, fused=1)) is None       # not the dense tier's
    assert _read(_run(kernels, device="cpu")) is None  # no peaks


def test_roofline_is_none_without_the_counters(monkeypatch):
    """A program without ``body.dense.*`` (the parent's) reads nothing."""
    kernels = [("void gathered_tile_kernel<32, 128, 3>()", 0.0, 40.0)]
    monkeypatch.setattr(profiling, "_counts", type(profiling._counts)())
    assert _read(_run(kernels)) is None
    profiling.count("body.nnz", 10)
    assert _read(_run(kernels)) is None
    monkeypatch.delattr(profiling, "counters")
    assert _read(_run(kernels)) is None


#: the per-layer metrics of the replica cells when this cell was added;
#: each has a split ``<metric>.st_enwik8``
SPLIT_BASES = ("prep_s", "prep.reorder_s", "prep.pack_s", "kernels.hand_ms",
               "torch_ops.ms", "device.idle_pct", "call.roofline_pct",
               "prep.cluster_s", "prep.split_s", "prep.upload_s",
               "plan.device_mb", "body.useful_pct")


def test_cell_reports_split_entries_of_every_per_layer_metric():
    """Each entry ``<metric>.st_enwik8`` is its base metric's quantity and
    lists the new cell alone; every metric of ``SPLIT_BASES`` has one;
    ``dense.roofline_pct`` lists the new cell alone. Entries of later cells
    and metrics are not looked at."""
    suffix = "." + CONFIG
    by_name = {m["name"]: m for m in BENCH["per_layer"]}
    splits = [m for m in BENCH["per_layer"] if m["name"].endswith(suffix)]
    assert {m["name"] for m in splits} >= {b + suffix for b in SPLIT_BASES}
    for split in splits:
        base = by_name[split["name"][:-len(suffix)]]
        assert CELL not in base.get("workloads", [CELL])
        assert split["workloads"] == [CELL]
        for key in ("unit", "better", "source", "layer", "moves"):
            assert split[key] == base[key]
        assert spec.metric(split["name"]).read is not None
    assert by_name[ROOFLINE]["workloads"] == [CELL]
    assert [c["chips"] for c in BENCH["workloads"]
            if c["name"] == CELL] == [1]


def _cut_root(tmp):
    """The benchmark with the configuration cut to 1 024 positions and an
    eager mix of a few calls, beside the real files."""
    root = tiny.copy_root(tmp)
    bench = spec.load_benchmark(root)
    config = spec.config(bench, CONFIG, root)
    config["mask"]["seq_len"] = 1024
    config["expected_nnz"] = int(fixed_mask(1024, 128, 32).nnz)
    tiny.dump(root, "benchmark/configs/st_cut.json", config)
    tiny.dump(root, "benchmark/traffic/k64_eager_short.json",
              {"k": 64, "mode": "eager", "ring_min_bytes": 1000000,
               "warmup_calls": 2, "trace_calls": 3})
    bench["configs"].append(dict(
        [c for c in bench["configs"] if c["name"] == CONFIG][0],
        name="st_cut", file="benchmark/configs/st_cut.json"))
    bench["workloads"].append({"name": "st_cut.k64.eager",
                               "config": "st_cut",
                               "traffic": "k64_eager_short", "chips": 1,
                               "why": "test"})
    for entry in bench["per_layer"]:
        if entry.get("workloads") == [CELL]:
            entry["workloads"].append("st_cut.k64.eager")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_cut_configuration_runs_correct_on_the_cpu(tmp_path, trace):
    root = _cut_root(tmp_path)
    run, bench, cell, config = harness.execute(
        "st_cut.k64.eager", SEED, 0.2, trace, "cpu", time.perf_counter(),
        root=root)
    out = harness.result(run, bench, cell, config, trace, 1, root=root)
    assert out["correct"] is True and run.nnz == config["expected_nnz"]
    got = out["metrics"]
    if trace:
        # the program's counters and spans read; the device trace does not
        assert 0 < got[f"body.useful_pct.{CONFIG}"]["value"] <= 100
        assert f"prep.cluster_s.{CONFIG}" in got
        assert ROOFLINE not in got
    else:
        assert set(got) == {"sddmm_gflops", "call_ms_p95", "setup_s"}
