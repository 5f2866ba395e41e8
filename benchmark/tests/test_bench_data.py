"""The frozen generators give the port's SUITE masks and replicas bit for
bit, each generator file gives its example's mask bit for bit, and each
configuration's mask is held by its kind: a replica is the port's replica
of the matrix its file names, and any other mask is its generator's, with
the nonzeros the file states and a source and an account of its
structure."""

import os
import re

import numpy as np
import pytest

from benchmark import spec
from benchmark.data import generators
from benchmark.tests.test_bench_spec import _one_line

from bsmr_sddmm_tpu_torch import datasets, replicas
from bsmr_sddmm_tpu_torch.models.sparse_transformer import local_strided_mask

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


def _is_replica(bench, entry, root=spec.ROOT):
    return spec.config(bench, entry["name"], root)["mask"]["generator"] \
        == "replica"


def check_csr(mask):
    """A mask in the form the harness hands the program: int64 row
    offsets from 0 to nnz, int32 columns in range, ascending and distinct
    within each row."""
    ro, ci = mask.row_offsets, mask.col_indices
    assert ro.dtype == np.int64 and ci.dtype == np.int32
    assert ro.shape == (mask.rows + 1,) and ro[0] == 0 and ro[-1] == mask.nnz
    assert mask.nnz > 0 and (np.diff(ro) >= 0).all()
    assert 0 <= ci.min() and ci.max() < mask.cols
    keys = mask.coo_rows() * mask.cols + ci
    assert (np.diff(keys) > 0).all()


def check_replica_config(bench, entry, root):
    """The mask is the port's replica of the matrix the file names, at its
    published size."""
    config = spec.config(bench, entry["name"], root)
    row = MANIFEST[entry["name"]]
    assert config["mask"] == dict(generator="replica", **_replica_args(row))
    matrix = config["matrix"]
    assert (matrix["name"], matrix["group"], matrix["regime"], matrix["M"],
            matrix["N"], matrix["NNZ"]) == (row.name, row.group, row.regime,
                                            row.m, row.n, row.nnz)
    assert matrix["ref_dense_coverage"] == row.ref_dense_coverage
    assert f"/{row.group}/{row.name}" in entry["source"]
    assert entry["reduced"] == []
    mask = generators.make_mask(config["mask"], root)
    assert mask.nnz == config["expected_nnz"]
    _same(mask, replicas.make_replica(row))


def check_generated_config(bench, entry, root):
    """The mask is its generator's, frozen or of a file, with the nonzeros
    the file states; the entry names a public source and the file says how
    the structure was made."""
    config = spec.config(bench, entry["name"], root)
    assert config["mask"]["generator"] != "replica"
    assert re.search(r"https://|arXiv:\d", entry["source"])
    assert _one_line(config["assumed"]["mask"])
    assert type(config["expected_nnz"]) is int
    mask = generators.make_mask(config["mask"], root)
    check_csr(mask)
    assert mask.nnz == config["expected_nnz"]


def generator_files(root):
    """The names of the generator files under ``data/masks/``."""
    masks = os.path.join(root, spec.HERE, "data", "masks")
    return sorted(f[:-3] for f in os.listdir(masks) if f.endswith(".py"))


def check_generator_file(name, root):
    """A generator file's small example gives the mask its digest
    records, through ``make_mask`` as a configuration names it."""
    module = spec.mask_generator(name, root)
    assert name not in generators.GENERATORS    # else it is never read
    mask = generators.make_mask(dict(module.EXAMPLE, generator=name), root)
    check_csr(mask)
    assert mask.nnz <= 100_000                  # small: a test runs it
    assert generators.digest(mask) == module.EXAMPLE_SHA256


def check_config_mask(bench, entry, root):
    if _is_replica(bench, entry, root):
        check_replica_config(bench, entry, root)
    else:
        check_generated_config(bench, entry, root)


BENCH = spec.load_benchmark()


@pytest.mark.parametrize("entry", [e for e in BENCH["configs"]
                                   if _is_replica(BENCH, e)],
                         ids=lambda e: e["name"])
def test_config_mask_is_the_ports_replica_of_its_matrix(entry):
    check_replica_config(BENCH, entry, spec.ROOT)


@pytest.mark.parametrize("entry", [e for e in BENCH["configs"]
                                   if not _is_replica(BENCH, e)],
                         ids=lambda e: e["name"])
def test_config_mask_is_its_generators(entry):
    check_generated_config(BENCH, entry, spec.ROOT)


@pytest.mark.parametrize("name", generator_files(spec.ROOT))
def test_generator_file_is_frozen(name):
    check_generator_file(name, spec.ROOT)


@pytest.mark.parametrize("args", [(300, 16, 8), (4096, 128, 64),
                                  (64, 128, 64)])
def test_local_strided_is_the_ports(args):
    seq_len, window, stride = args
    _same(generators.make_mask({"generator": "local_strided",
                                "seq_len": seq_len, "window": window,
                                "stride": stride}),
          local_strided_mask(seq_len, window, stride))


def test_make_mask_refuses_an_unknown_generator():
    for name in ("nope", "../generators", "masks/x"):
        with pytest.raises(ValueError):
            generators.make_mask({"generator": name, "n": 4})


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
