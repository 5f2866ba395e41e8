"""The frozen generators give the port's SUITE masks and replicas bit for
bit, and each configuration's mask is the port's replica of the matrix its
file names, with the nonzeros the file states."""

import numpy as np
import pytest

from benchmark import spec
from benchmark.data import generators

from bsmr_sddmm_tpu_torch import datasets, replicas

SUITE = dict(datasets.SUITE)
MANIFEST = {s.name: s for s in replicas.load_manifest()}
FROZEN = {
    "banded_mesh_32k": lambda: generators.banded(32768, 2_000_000, 256,
                                                 seed=44),
    "banded_mesh_64k": lambda: generators.banded(65536, 3_500_000, 384,
                                                 seed=49),
    "banded_mesh_20k": lambda: generators.banded(20000, 1_200_000, 128,
                                                 seed=50),
    "banded_mesh_12k": lambda: generators.banded(12000, 600_000, 96,
                                                 seed=45),
    "community_16k": lambda: generators.community(16384, 1_200_000, 24,
                                                  seed=46),
    "community_20k": lambda: generators.community(20000, 900_000, 48,
                                                  seed=47),
    "community_32k": lambda: generators.community(32768, 1_800_000, 64,
                                                  seed=51),
    "rmat_16": lambda: generators.rmat(1 << 16, 1_000_000, seed=42),
}


def _same(mask, csr):
    assert (mask.rows, mask.cols) == (csr.rows, csr.cols)
    assert mask.row_offsets.dtype == csr.row_offsets.dtype
    assert mask.col_indices.dtype == csr.col_indices.dtype
    np.testing.assert_array_equal(mask.row_offsets, csr.row_offsets)
    np.testing.assert_array_equal(mask.col_indices, csr.col_indices)


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_frozen_generator_is_the_ports_suite_mask(name):
    _same(FROZEN[name](), SUITE[name]())


def test_uniform_is_the_ports():
    _same(generators.uniform(2000, 30_000, seed=48),
          datasets.uniform(2000, 30_000, seed=48))


def _replica_args(row):
    return dict(name=row.name, group=row.group, regime=row.regime, m=row.m,
                n=row.n, nnz=row.nnz)


# the smallest matrix of each of the replica generator's branches
@pytest.mark.parametrize("name", ["psse0", "vsp_barth5_1Ksep_50in_5Kout",
                                  "TSOPF_RS_b39_c7", "skirt"])
def test_frozen_replica_is_the_ports(name):
    row = MANIFEST[name]
    _same(generators.replica(**_replica_args(row)),
          replicas.make_replica(row))


@pytest.mark.parametrize("entry", spec.load_benchmark()["configs"],
                         ids=lambda e: e["name"])
def test_config_mask_is_the_ports_replica_of_its_matrix(entry):
    config = spec.config(spec.load_benchmark(), entry["name"])
    row = MANIFEST[entry["name"]]
    assert config["mask"] == dict(generator="replica", **_replica_args(row))
    matrix = config["matrix"]
    assert (matrix["name"], matrix["group"], matrix["regime"], matrix["M"],
            matrix["N"], matrix["NNZ"]) == (row.name, row.group, row.regime,
                                            row.m, row.n, row.nnz)
    assert matrix["ref_dense_coverage"] == row.ref_dense_coverage
    assert f"/{row.group}/{row.name}" in entry["source"]
    mask = generators.make_mask(config["mask"])
    assert mask.nnz == config["expected_nnz"]
    _same(mask, replicas.make_replica(row))


def test_make_mask_refuses_an_unknown_generator():
    with pytest.raises(ValueError):
        generators.make_mask({"generator": "nope", "n": 4})


def test_cached_mask_is_the_generated_mask(tmp_path):
    spec = {"generator": "banded", "n": 3000, "nnz": 40_000,
            "bandwidth": 64, "seed": 9}
    made = generators.cached_mask(spec, str(tmp_path))
    assert len(list(tmp_path.iterdir())) == 1
    read = generators.cached_mask(spec, str(tmp_path))
    fresh = generators.make_mask(spec)
    for mask in (made, read):
        _same(mask, fresh)
    other = generators.cached_mask(dict(spec, seed=10), str(tmp_path))
    assert len(list(tmp_path.iterdir())) == 2 and other.nnz != fresh.nnz
