"""The call's operations, bytes and bound against hand counts."""

import pytest

from benchmark import roofline

# (config, K): (M, N, nnz, operations, bytes) counted by hand
CASES = {
    ("pdb1HYS", 128): (36417, 36417, 2_119_946, 542_706_176,
                       18_645_504 + 18_645_504 + 8_479_784 + 145_672
                       + 8_479_784),
    ("pdb1HYS", 256): (36417, 36417, 2_119_946, 1_085_412_352,
                       37_291_008 + 37_291_008 + 8_479_784 + 145_672
                       + 8_479_784),
    ("Goodwin_054", 128): (32510, 32510, 1_242_374, 318_047_744,
                           16_645_120 + 16_645_120 + 4_969_496 + 130_044
                           + 4_969_496),
}


@pytest.mark.parametrize("case", sorted(CASES), ids=str)
def test_counts(case):
    m, n, nnz, ops, nbytes = CASES[case]
    k = case[1]
    assert roofline.call_flops(nnz, k) == ops
    assert roofline.call_bytes(m, n, nnz, k) == nbytes


@pytest.mark.parametrize("case", sorted(CASES), ids=str)
def test_bound_is_the_bytes_side_on_the_h100(case):
    m, n, nnz, ops, nbytes = CASES[case]
    bound = roofline.call_bound_s(m, n, nnz, case[1],
                                  "NVIDIA H100 80GB HBM3")
    assert bound == pytest.approx(nbytes / 3.35e12)
    assert bound > ops / 495e12


def test_bounds_by_hand():
    # 16.24 us, 12.94 us and 27.37 us, worked out by hand from the counts
    # above (54.40 MB, 43.36 MB and 91.69 MB at 3.35 TB/s)
    assert roofline.call_bound_s(36417, 36417, 2_119_946, 128, "H100") \
        == pytest.approx(16.24e-6, rel=1e-3)
    assert roofline.call_bound_s(32510, 32510, 1_242_374, 128, "H100") \
        == pytest.approx(12.94e-6, rel=1e-3)
    assert roofline.call_bound_s(36417, 36417, 2_119_946, 256, "H100") \
        == pytest.approx(27.37e-6, rel=1e-3)


def test_no_bound_for_an_unknown_card():
    assert roofline.call_bound_s(8, 8, 8, 8, "cpu") is None
