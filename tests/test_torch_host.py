"""The port's host layer against the JAX package's: formats, datasets,
reorder (both column modes), native clustering, pack_tiles, the reorder
cache and the reordering evaluation give identical arrays for identical
inputs (bit-identical TilePlans), and the port never imports jax.

Inputs are made with NumPy from fixed seeds and handed to both packages."""

import dataclasses
import filecmp
import gzip
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

import bsmr_sddmm_tpu.cache as jcache
import bsmr_sddmm_tpu.datasets as jds
import bsmr_sddmm_tpu.evaluate as jev
import bsmr_sddmm_tpu.formats as jfm
import bsmr_sddmm_tpu.native as jnative
import bsmr_sddmm_tpu.pack as jpack
import bsmr_sddmm_tpu.reorder as jre
from bsmr_sddmm_tpu.config import SddmmConfig as JConfig

import bsmr_sddmm_tpu_torch.cache as tcache
import bsmr_sddmm_tpu_torch.datasets as tds
import bsmr_sddmm_tpu_torch.evaluate as tev
import bsmr_sddmm_tpu_torch.formats as tfm
import bsmr_sddmm_tpu_torch.native as tnative
import bsmr_sddmm_tpu_torch.pack as tpack
import bsmr_sddmm_tpu_torch.reorder as tre
from bsmr_sddmm_tpu_torch.config import SddmmConfig as TConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the conftest geometry (small_mask / cfg fixtures), built in both packages
SMALL = dict(rows=512, cols=768, nnz=20000, seed=7, block_rows=24,
             block_cols=96)
TINY = dict(rows=96, cols=160, nnz=900, seed=3, block_rows=12,
            block_cols=40)
BASE_CFG = dict(k=32, panel_height=16, block_width=128, dense_chunk=64,
                residual_chunk=4096)
# the windowed plan of tests/test_sddmm.py:138-147
WIDE = dict(rows=1024, cols=40960, nnz=80000, seed=31, block_rows=16,
            block_cols=64)
WIDE_CFG = dict(k=32, panel_height=16, dense_chunk=16, residual_chunk=2048,
                delta=0.9, gather_window_mb=1, gather_window_threshold_mb=2)


def assert_same(ref, port, skip=()):
    """Every dataclass field of ``port`` equals ``ref``'s: arrays with
    np.array_equal and the same dtype, everything else with ==."""
    for f in dataclasses.fields(port):
        if f.name in skip:
            continue
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), f.name
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            assert np.array_equal(a, b), f.name
        elif isinstance(b, float) and np.isnan(b):
            assert np.isnan(a), f.name
        else:
            assert a == b, (f.name, a, b)


def both_masks(spec):
    return jfm.random_mask(**spec), tfm.random_mask(**spec)


def both_plans(spec, cfg_kw):
    jcsr, tcsr = both_masks(spec)
    jcfg, tcfg = JConfig(**cfg_kw), TConfig(**cfg_kw)
    jplan = jpack.pack_tiles(jcsr, jre.bsmr(jcsr, jcfg), jcfg)
    tplan = tpack.pack_tiles(tcsr, tre.bsmr(tcsr, tcfg), tcfg)
    return jplan, tplan


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [SMALL, TINY, WIDE],
                         ids=["small", "tiny", "wide"])
def test_random_mask_identical(spec):
    jcsr, tcsr = both_masks(spec)
    assert_same(jcsr, tcsr)


def test_make_dense_identical():
    for rows, cols, seed in [(512, 32, 1337), (32, 768, 1338), (7, 5, 0)]:
        np.testing.assert_array_equal(jfm.make_dense(rows, cols, seed),
                                      tfm.make_dense(rows, cols, seed))


MTX_FILES = {
    "general.mtx": ("%%MatrixMarket matrix coordinate real general\n"
                    "% comment\n4 5 5\n1 1 0.5\n1 4 2\n2 2 -1\n3 5 3.25\n"
                    "4 3 1\n"),
    "pattern.mtx": ("%%MatrixMarket matrix coordinate pattern general\n"
                    "3 3 4\n1 1\n2 3\n3 1\n3 2\n"),
    "symmetric.mtx": ("%%MatrixMarket matrix coordinate real symmetric\n"
                      "3 3 3\n1 1 1\n2 1 2\n3 2 4\n"),
    "graph.smtx": "4, 4, 5\n0 2 3 4 5\n0 3 1 2 0\n",
    "edges.txt": "# snap\n0 1\n1 2\n2 0\n0 1\n3 3\n",
}


@pytest.mark.parametrize("name", sorted(MTX_FILES) + ["general.mtx.gz"])
def test_load_matrix_identical(tmp_path, name):
    base = name[:-3] if name.endswith(".gz") else name
    path = tmp_path / name
    if name.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(MTX_FILES[base])
    else:
        path.write_text(MTX_FILES[base])
    assert_same(jfm.load_matrix(str(path)), tfm.load_matrix(str(path)))


def test_save_mtx_identical(tmp_path):
    jcsr, tcsr = both_masks(TINY)
    jfm.save_mtx(str(tmp_path / "j.mtx"), jcsr)
    tfm.save_mtx(str(tmp_path / "t.mtx"), tcsr)
    assert filecmp.cmp(tmp_path / "j.mtx", tmp_path / "t.mtx",
                       shallow=False)
    assert_same(jcsr, tfm.load_matrix(str(tmp_path / "t.mtx")))


@pytest.mark.parametrize("body", [
    "3 3 2\n1 1 1\n4 1 1\n",           # row out of range
    "3 3 2\n1 1 1\n1 1 2\n",           # duplicate entry
    "3 3 3\n1 1 1\n2 2 2\n",           # wrong count
], ids=["range", "duplicate", "count"])
def test_malformed_mtx_raises(tmp_path, body):
    path = tmp_path / "bad.mtx"
    path.write_text("%%MatrixMarket matrix coordinate real general\n" + body)
    with pytest.raises(tfm.MatrixFormatError):
        tfm.load_matrix(str(path))
    with pytest.raises(jfm.MatrixFormatError):
        jfm.load_matrix(str(path))


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def test_suite_names_identical():
    assert [n for n, _ in tds.SUITE] == [n for n, _ in jds.SUITE]
    assert [n for n, _ in tds.EXTRA] == [n for n, _ in jds.EXTRA]


@pytest.mark.parametrize("gen,args", [
    ("banded", (3000, 40000, 64)), ("community", (3000, 40000, 12)),
    ("rmat", (4096, 40000)), ("uniform", (3000, 20000))])
@pytest.mark.parametrize("seed", [0, 44])
def test_generators_identical(gen, args, seed):
    assert_same(getattr(jds, gen)(*args, seed=seed),
                getattr(tds, gen)(*args, seed=seed))


def test_suite_entry_identical():
    """One full-size SUITE generator (the smallest) end to end."""
    name = "banded_mesh_12k"
    jcsr = dict(jds.SUITE)[name]()
    tcsr = dict(tds.SUITE)[name]()
    assert_same(jcsr, tcsr)
    assert tcsr.rows >= 10000 and tcsr.nnz >= 100000


# ---------------------------------------------------------------------------
# native clustering
# ---------------------------------------------------------------------------

def test_cluster_cpp_byte_identical():
    assert filecmp.cmp(
        os.path.join(REPO, "bsmr_sddmm_tpu", "native", "cluster.cpp"),
        os.path.join(REPO, "bsmr_sddmm_tpu_torch", "native", "cluster.cpp"),
        shallow=False)


@pytest.mark.parametrize("exact", [False, True])
def test_native_cluster_identical(exact):
    jcsr, tcsr = both_masks(SMALL)
    if not (jnative.available() and tnative.available()):
        pytest.skip("no g++ to build the native clustering")
    cfg = TConfig(**BASE_CFG)
    enc = tre.row_encodings(tcsr, cfg.encoding_block)
    order = np.argsort(tre.dispersion_scores(tcsr, enc, cfg.encoding_block),
                       kind="stable")
    order = order[tcsr.row_nnz()[order] > 0]
    np.testing.assert_array_equal(
        jre._cluster_native(enc, order, 0.3, exact),
        tre._cluster_native(enc, order, 0.3, exact))


def test_native_fallback_notice(monkeypatch, capsys):
    """Without the native library the port prints the same stderr notice
    as the reference and clusters with NumPy, to the same result."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_failed", False)

    def no_compiler():
        raise OSError("no g++")
    monkeypatch.setattr(tnative, "_compile", no_compiler)
    jcsr, tcsr = both_masks(TINY)
    cfg_kw = dict(BASE_CFG, use_native=True)
    port = tre.row_reordering(tcsr, 0.3, TConfig(**cfg_kw))
    assert "native clustering unavailable" in capsys.readouterr().err
    ref = jre.row_reordering(jcsr, 0.3, JConfig(**dict(cfg_kw,
                                                       use_native=False)))
    np.testing.assert_array_equal(ref.row_perm, port.row_perm)


# ---------------------------------------------------------------------------
# reorder
# ---------------------------------------------------------------------------

def test_encodings_and_ranges_identical():
    jcsr, tcsr = both_masks(SMALL)
    je, te = jre.row_encodings(jcsr, 32), tre.row_encodings(tcsr, 32)
    assert (je != te).nnz == 0
    np.testing.assert_array_equal(jre.dispersion_scores(jcsr, je, 32),
                                  tre.dispersion_scores(tcsr, te, 32))
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 1000, 50)
    lengths = rng.integers(0, 20, 50)
    np.testing.assert_array_equal(jre._concat_ranges(starts, lengths),
                                  tre._concat_ranges(starts, lengths))


@pytest.mark.parametrize("strategy", ["fast", "exact", "none"])
@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("delta", [0.0, 0.3, 1.1])
def test_reordering_identical(strategy, use_native, delta):
    jcsr, tcsr = both_masks(SMALL)
    kw = dict(BASE_CFG, row_strategy=strategy, use_native=use_native,
              delta=delta)
    ref = jre.bsmr(jcsr, JConfig(**kw))
    port = tre.bsmr(tcsr, TConfig(**kw))
    assert_same(ref, port, skip=("row_time_ms", "col_time_ms"))


@pytest.mark.parametrize("strategy", ["fast", "exact", "none"])
@pytest.mark.parametrize("delta", [0.0, 0.3, 1.1])
def test_col_reordering_identical(strategy, delta):
    """col_mode="reorder": the per-panel column reordering of both
    packages gives the same dense/sparse column arrays."""
    jcsr, tcsr = both_masks(SMALL)
    kw = dict(BASE_CFG, row_strategy=strategy, delta=delta,
              col_mode="reorder")
    ref = jre.bsmr(jcsr, JConfig(**kw))
    port = tre.bsmr(tcsr, TConfig(**kw))
    assert_same(ref, port, skip=("row_time_ms", "col_time_ms"))
    if delta == 0.0:
        assert port.dense_cols.size and not port.sparse_cols.size
    if delta == 1.1:
        assert not port.dense_cols.size


# ---------------------------------------------------------------------------
# pack_tiles: bit-identical TilePlans
# ---------------------------------------------------------------------------

PLAN_CASES = {
    "fat": {},
    "fat_group_1": dict(dense_fat_group=1),
    "subpack_0": dict(subpack_min_nnz=0),
    "delta_0": dict(delta=0.0),
    "delta_1.1": dict(delta=1.1),
    "numpy_clustering": dict(use_native=False),
    "exact": dict(row_strategy="exact"),
    "pernnz": dict(residual_mode="pernnz"),
    "ph32_k64": dict(panel_height=32, k=64),
    "unbucketed": dict(bucket_shapes=False),
    "reorder": dict(col_mode="reorder"),
    "reorder_delta_0": dict(col_mode="reorder", delta=0.0),
    "reorder_delta_0.05": dict(col_mode="reorder", delta=0.05),
    "reorder_delta_1.1": dict(col_mode="reorder", delta=1.1),
    "reorder_pernnz": dict(col_mode="reorder", residual_mode="pernnz"),
    "reorder_ph32_k64": dict(col_mode="reorder", panel_height=32, k=64),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_bit_identical(case):
    jplan, tplan = both_plans(SMALL, dict(BASE_CFG, **PLAN_CASES[case]))
    assert_same(jplan, tplan, skip=("pack_time_ms",))
    if case == "fat":
        assert tplan.fat_group > 1 and tplan.num_packed > 0
        assert tplan.num_gathered > 0 and tplan.num_residual > 0
    if case == "fat_group_1":
        assert tplan.fat_group == 1
    if case == "subpack_0":
        assert tplan.num_packed == 0
    if case.startswith("reorder"):
        assert tplan.mode == "reorder" and tplan.fat_group == 1
        assert tplan.tile_cblock is None and tplan.step_cblock is None
        assert (tplan.tile_cols < tplan.cols).all()
    if case == "reorder_delta_0.05":
        assert tplan.num_tiles > 0 and tplan.num_packed > 0


def test_plan_bit_identical_tiny():
    jplan, tplan = both_plans(TINY, BASE_CFG)
    assert_same(jplan, tplan, skip=("pack_time_ms",))


def test_windowed_plan_bit_identical():
    jplan, tplan = both_plans(WIDE, WIDE_CFG)
    assert tplan.window_rows == 8192
    assert tplan.g_groups or tplan.res_groups
    assert_same(jplan, tplan, skip=("pack_time_ms",))


@pytest.mark.parametrize("spec,cfg_kw", [(TINY, BASE_CFG), (WIDE, WIDE_CFG)],
                         ids=["tiny", "wide"])
def test_reorder_plan_bit_identical(spec, cfg_kw):
    jplan, tplan = both_plans(spec, dict(cfg_kw, col_mode="reorder"))
    assert tplan.mode == "reorder"
    assert_same(jplan, tplan, skip=("pack_time_ms",))


def test_plan_statistics_identical():
    jplan, tplan = both_plans(SMALL, BASE_CFG)
    for name in ("dense_nnz", "packed_nnz", "gathered_nnz", "residual_nnz",
                 "average_tile_density"):
        assert getattr(jplan, name) == getattr(tplan, name), name
    assert jplan.flops() == tplan.flops()


def test_bucket_sizes_identical():
    for n in [0, 1, 7, 8, 9, 100, 1000, 4097, 123457]:
        for enabled in (True, False):
            assert jpack.bucket_size(n, enabled) == \
                tpack.bucket_size(n, enabled)
            assert jpack.exec_size(n, enabled, 64) == \
                tpack.exec_size(n, enabled, 64)


# ---------------------------------------------------------------------------
# reordering evaluation and the reorder cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("col_mode", ["bsr", "reorder"])
def test_evaluate_reordering_identical(col_mode):
    jcsr, tcsr = both_masks(SMALL)
    kw = dict(BASE_CFG, col_mode=col_mode, delta=0.1)
    ref = jev.evaluate_reordering(jcsr, JConfig(**kw))
    port = tev.evaluate_reordering(tcsr, TConfig(**kw))
    assert_same(ref, port)
    assert port.as_extras() == ref.as_extras()
    assert port.dense_block_gain == ref.dense_block_gain
    assert port.dense_coverage == ref.dense_coverage


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reorder_cache_shared(monkeypatch, tmp_path, writer):
    """An entry that one package writes under BSMR_CACHE_DIR loads in the
    other, with an identical row permutation."""
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path))
    jcsr, tcsr = both_masks(SMALL)
    jcfg, tcfg = JConfig(**BASE_CFG), TConfig(**BASE_CFG)
    assert jcache._key(jcsr, 0.3, jcfg) == tcache._key(tcsr, 0.3, tcfg)
    if writer == "jax":
        stored = jcache.cached_row_reordering(jcsr, 0.3, jcfg)
        loaded = tcache.load_reordering(tcsr, 0.3, tcfg)
    else:
        stored = tcache.cached_row_reordering(tcsr, 0.3, tcfg)
        loaded = jcache.load_reordering(jcsr, 0.3, jcfg)
    assert loaded is not None
    assert len(list(tmp_path.glob("*.npz"))) == 1
    np.testing.assert_array_equal(loaded.row_perm, stored.row_perm)
    np.testing.assert_array_equal(loaded.cluster_ids, stored.cluster_ids)
    assert loaded.num_clusters == stored.num_clusters


def test_pipeline_reads_reorder_cache(monkeypatch, tmp_path):
    """BsmrSddmm with reorder_cache loads a cached entry instead of
    clustering again."""
    tsddmm = importlib.import_module("bsmr_sddmm_tpu_torch.sddmm")
    monkeypatch.setenv("BSMR_CACHE_DIR", str(tmp_path))
    jcsr, tcsr = both_masks(TINY)
    jcfg = JConfig(**dict(BASE_CFG, reorder_cache=True))
    ref = jcache.cached_row_reordering(jcsr, jcfg.alpha, jcfg)

    def no_clustering(*args, **kw):
        raise AssertionError("clustered although the cache has the entry")
    monkeypatch.setattr(tcache, "row_reordering", no_clustering)
    monkeypatch.setattr(tsddmm, "row_reordering", no_clustering)
    tcfg = TConfig(**dict(BASE_CFG, reorder_cache=True))
    port = tsddmm.BsmrSddmm(tcsr, tcfg, device="cpu").reorder()
    np.testing.assert_array_equal(port.row_perm, ref.row_perm)


# ---------------------------------------------------------------------------
# no jax in the port
# ---------------------------------------------------------------------------

def test_port_never_imports_jax():
    """In a fresh interpreter (conftest has already imported jax here),
    importing every module of the port leaves jax out of sys.modules."""
    code = (
        "import sys\n"
        "import bsmr_sddmm_tpu_torch, bsmr_sddmm_tpu_torch.cli, "
        "bsmr_sddmm_tpu_torch.interop, bsmr_sddmm_tpu_torch.datasets, "
        "bsmr_sddmm_tpu_torch.ops.dense_kernels, "
        "bsmr_sddmm_tpu_torch.ops._build, bsmr_sddmm_tpu_torch.utils, "
        "bsmr_sddmm_tpu_torch.cache, bsmr_sddmm_tpu_torch.evaluate, "
        "bsmr_sddmm_tpu_torch.autotune, bsmr_sddmm_tpu_torch.baselines, "
        "bsmr_sddmm_tpu_torch.datatools, bsmr_sddmm_tpu_torch.replicas, "
        "bsmr_sddmm_tpu_torch.utils.hostmem, "
        "bsmr_sddmm_tpu_torch.utils.profiling, "
        "bsmr_sddmm_tpu_torch.bench.analyze, "
        "bsmr_sddmm_tpu_torch.bench.plot, bsmr_sddmm_tpu_torch.bench.runner, "
        "bsmr_sddmm_tpu_torch.bench.suite, "
        "bsmr_sddmm_tpu_torch.bench.replica_suite, "
        "bsmr_sddmm_tpu_torch.parallel, "
        "bsmr_sddmm_tpu_torch.parallel.sharding, "
        "bsmr_sddmm_tpu_torch.parallel.ring, "
        "bsmr_sddmm_tpu_torch.parallel.distributed, "
        "bsmr_sddmm_tpu_torch.parallel.scaling_model, "
        "bsmr_sddmm_tpu_torch.parallel.collectives, "
        "bsmr_sddmm_tpu_torch.parallel.worker, "
        "bsmr_sddmm_tpu_torch.models, "
        "bsmr_sddmm_tpu_torch.models.sparse_transformer, "
        "bsmr_sddmm_tpu_torch.graft_entry, "
        "bsmr_sddmm_tpu_torch.utils.compilecache\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'bsmr_sddmm_tpu.')) "
        "or m == 'bsmr_sddmm_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
