"""The port's graft entry points (``bsmr_sddmm_tpu_torch.graft_entry``)
against the JAX package's ``__graft_entry__.py`` on the CPU.

Both sides get the same inputs: ``_tiny_problem``'s mask and config (equal
here), the JAX ``init_params`` carried across with
``interop.params_from_reference``, and NumPy features, labels and operands
from fixed seeds. The JAX side runs as ``__graft_entry__`` does: the
forward under ``jax.jit``, the train step jitted on ``shard_device_plan``'s
plan over an n-device mesh of tests/conftest.py's 8 virtual CPU devices,
and ``make_sharded_sddmm`` / ``make_ring_sddmm`` over that mesh. The port
runs on CPU meshes (``devices=["cpu"] * n``). Tolerances: logits rtol 1e-5
with atol 1e-5 x the largest |logit| (a logit that cancels to ~1e-3 carries
the rounding of its O(1) terms); the loss rtol 1e-5
(tests/test_torch_train_sharded.py's for the same step); every SDDMM output
rtol 1e-5 + atol 1e-4, with equal check_data error rates.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import bsmr_sddmm_tpu.parallel as jpar
from bsmr_sddmm_tpu.formats import make_dense as j_make_dense
from bsmr_sddmm_tpu.models import graph_transformer as j_gt
from bsmr_sddmm_tpu.ops.sddmm import sddmm_ref as j_sddmm_ref
from bsmr_sddmm_tpu.parallel.ring import (make_ring_sddmm as j_ring,
                                          ring_operands as j_ring_operands)
from bsmr_sddmm_tpu.reorder import bsmr as j_bsmr
from bsmr_sddmm_tpu.utils.checkdata import check_data as j_check_data

from bsmr_sddmm_tpu_torch import graft_entry
from bsmr_sddmm_tpu_torch.interop import (config_from_reference,
                                          params_from_reference)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SDDMM_TOL = dict(rtol=1e-5, atol=1e-4)
CSR_OUTPUTS = ("allgather_b0", "allgather_b1", "ring")


def _jax_entry_module():
    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jge():
    return _jax_entry_module()


def test_tiny_problem_equal(jge):
    jcsr, jcfg = jge._tiny_problem()
    csr, cfg = graft_entry._tiny_problem()
    assert (csr.rows, csr.cols) == (jcsr.rows, jcsr.cols)
    for name in ("row_offsets", "col_indices", "values"):
        np.testing.assert_array_equal(getattr(csr, name),
                                      getattr(jcsr, name), err_msg=name)
    assert cfg == config_from_reference(jcfg)


def test_entry_logits_match_jax(jge):
    """entry(device="cpu")'s forward on the JAX params against
    jax.jit(fn)(*args) of the JAX entry()."""
    jfn, jargs = jge.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, (params, X, dplan) = graft_entry.entry(device="cpu")
    with torch.no_grad():
        got = fn(params_from_reference(jargs[0]), X, dplan).numpy()
        own = fn(params, X, dplan).numpy()
    assert got.shape == want.shape == (256, graft_entry.NUM_CLASSES)
    # rtol 1e-5 elementwise, and 1e-5 of the largest logit for the
    # entries that cancel to ~1e-3 (fp32 sums in another order)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    # the port's own init_params draws the JAX package's weights
    np.testing.assert_array_equal(own, got)


@pytest.fixture(scope="module")
def jax_dryrun(jge):
    """The JAX dry run's numbers per mesh size, computed as
    ``__graft_entry__.dryrun_multichip`` computes them: (loss, {output:
    values}, {output: error rate}, params)."""
    built = {}

    def get(n):
        if n in built:
            return built[n]
        csr, cfg = jge._tiny_problem()
        mesh = jpar.make_mesh(devices=jax.devices()[:n])
        model = j_gt.GraphTransformer(num_nodes=csr.rows, feature_dim=16,
                                      head_dim=cfg.k, num_heads=2,
                                      num_layers=1, num_classes=4)
        forward, _, plan = j_gt.make_forward(model, csr, cfg)
        params = j_gt.init_params(model)
        opt_init, train_step = j_gt.make_train_step(model, forward)
        repl = NamedSharding(mesh, PartitionSpec())
        X = jax.device_put(jnp.asarray(np.random.default_rng(0).normal(
            0, 1, (csr.rows, 16)), jnp.float32), repl)
        labels = jax.device_put(jnp.asarray(np.random.default_rng(
            1).integers(0, 4, csr.rows)), repl)
        _, _, loss = jax.jit(train_step)(
            jax.device_put(params, repl),
            jax.device_put(opt_init(params), repl), X, labels,
            jpar.shard_device_plan(plan, mesh))
        reord = j_bsmr(csr, cfg)
        A = j_make_dense(csr.rows, cfg.k)
        Bt = j_make_dense(csr.cols, cfg.k, seed=99)
        oracle = j_sddmm_ref(A, Bt.T, csr)
        outs = {}
        for b in (False, True):
            fn, dplan, _ = jpar.make_sharded_sddmm(
                csr, reord, cfg, mesh, b_sharded=b, emit="csr")
            outs[f"allgather_b{int(b)}"] = np.asarray(fn(
                *jpar.shard_operands(A, Bt, mesh, b_sharded=b), dplan))
        fn, rplan = j_ring(csr, reord, cfg, mesh, emit="csr")
        outs["ring"] = np.asarray(fn(*j_ring_operands(A, Bt, rplan, mesh)))
        rates = {k: j_check_data(oracle, v).error_rate
                 for k, v in outs.items()}
        built[n] = (float(loss), outs, rates, params)
        return built[n]
    return get


@pytest.fixture(scope="module")
def port_dryrun(jax_dryrun):
    """The port's dry run per mesh size, on the JAX params."""
    built = {}

    def get(n):
        if n not in built:
            params = params_from_reference(jax_dryrun(n)[3])
            built[n] = graft_entry.dryrun_multichip(
                n, devices=["cpu"] * n, params=params)
        return built[n]
    return get


@pytest.mark.parametrize("n", (2, 8))
def test_dryrun_loss_matches_jax(jax_dryrun, port_dryrun, n):
    """The port's n-shard Adam step (per-shard packed plans) against the
    JAX step on shard_device_plan over an n-device mesh."""
    jloss = jax_dryrun(n)[0]
    got = port_dryrun(n)
    assert np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
    assert got["devices"] == ["cpu"] * n
    assert set(got["ms"]) == {"train_step", "allgather_b0", "rphm_b0",
                              "allgather_b1", "rphm_b1", "ring"}


@pytest.mark.parametrize("key", CSR_OUTPUTS)
@pytest.mark.parametrize("n", (2, 8))
def test_dryrun_sddmm_matches_jax(jax_dryrun, port_dryrun, n, key):
    """Both emit="csr" outputs and the ring's against the JAX
    make_sharded_sddmm / make_ring_sddmm outputs, with the same check_data
    error rate; the rphm tiers read back through sharded_rphm_to_csr equal
    the csr emission of the same layout."""
    _, jouts, jrates, _ = jax_dryrun(n)
    got = port_dryrun(n)
    np.testing.assert_allclose(got["outputs"][key], jouts[key], **SDDMM_TOL)
    assert got["error_rates"][key] == jrates[key] == 0.0
    if key != "ring":
        rphm = key.replace("allgather", "rphm")
        np.testing.assert_allclose(got["outputs"][rphm], got["outputs"][key],
                                   **SDDMM_TOL)
        assert got["error_rates"][rphm] == 0.0


def test_dryrun_prints_the_jax_summary(capsys):
    graft_entry.dryrun_multichip(2, devices=["cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(
        "dryrun_multichip(2): train loss ")
    assert ("sddmm oracle-validated (5782 nnz, per-shard-packed, replicated "
            "+ all-gathered + ring-rotated B; error_rate allgather_b0=0.0, "
            "allgather_b1=0.0, ring=0.0)") in line
    assert "2 shards on 1 device(s) (cpu)" in line


def test_entry_points_need_a_card_or_a_named_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)


def test_plain_build_equals_the_kernel_build():
    """problem=(csr, cfg with backend="torch") builds the same path on the
    plain versions; on CPU tensors both builds run those, so they agree
    exactly (chip_smoke.py [graft] compares them on the card)."""
    csr, cfg = graft_entry._tiny_problem()
    a = graft_entry.dryrun_multichip(2, devices=["cpu"])
    b = graft_entry.dryrun_multichip(
        2, devices=["cpu"], problem=(csr, cfg.replace(backend="torch")))
    assert a["loss"] == b["loss"]
    for key, vals in a["outputs"].items():
        np.testing.assert_array_equal(vals, b["outputs"][key], err_msg=key)
