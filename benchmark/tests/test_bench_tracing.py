"""The trace reductions on hand-made intervals."""

import os

from benchmark import spec, tracing

import bsmr_sddmm_tpu_torch


def test_union_counts_overlap_once():
    ivs = [("a", 0, 10), ("b", 5, 12), ("c", 20, 25), ("d", 21, 22)]
    assert tracing.busy_segments(ivs) == [(0, 12), (20, 25)]
    assert tracing.union_us(ivs) == 17


def test_idle_gaps_by_host_op():
    ivs = [("k", 0, 10), ("k", 30, 40), ("k", 40.5, 50), ("k", 90, 100)]
    ops = [("aten::cat", 12, 28), ("aten::index_select", 55, 95)]
    assert tracing.idle_gaps(ivs, ops) == {"aten::cat": 20.0,
                                           "aten::index_select": 40.0}
    assert tracing.idle_gaps(ivs, []) == {"host between ops": 60.0}


def test_time_by_name_and_top():
    ivs = [("x", 0, 2e6), ("y", 0, 1e6), ("x", 0, 1e6)]
    assert tracing.top(tracing.time_by_name(ivs), 1) == [["x", 3.0]]


def test_hand_kernels_are_the_ports_global_functions():
    hand = tracing.hand_kernel_names(
        os.path.dirname(bsmr_sddmm_tpu_torch.__file__))
    assert set(hand) == {"bsr_resident_kernel", "bsr_stream_kernel",
                         "subpack_kernel", "gathered_tile_kernel",
                         "csr_emit_kernel"}
    assert tracing.is_hand("void bsr_resident_kernel<32, 128, 3>(float "
                           "const*, float const*)", hand)
    assert not tracing.is_hand("void at::native::index_elementwise_kernel"
                               "<128, 4>(int)", hand)
    assert not tracing.is_hand("anything", ())
    assert os.path.isdir(os.path.join(spec.ROOT, "benchmark", "metrics"))
