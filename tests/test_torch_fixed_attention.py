"""The Sparse Transformer's "fixed" attention pattern in the port: the mask
against the paper's two sets, the SDDMM body on it in the three arms
against the fp64 oracle, the counters of the dense tier's launch, and the
``pattern="fixed"`` net against the plain reference
(``reference.sparse_transformer``) on seeded weights, logits and gradients
of the loss.

The test marked ``cuda`` imports nothing of JAX: ``python -m pytest
--noconftest -m cuda tests/test_torch_fixed_attention.py`` on the card."""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (this worker's thread budget)

from bsmr_sddmm_tpu_torch import BsmrSddmm, SddmmConfig
from bsmr_sddmm_tpu_torch.formats import make_dense
from bsmr_sddmm_tpu_torch.models import sparse_transformer as st
from bsmr_sddmm_tpu_torch.ops import dense_kernels as dk
from bsmr_sddmm_tpu_torch.ops.sddmm import (device_plan, make_sddmm_body,
                                            sddmm_ref)
from bsmr_sddmm_tpu_torch.reference import sparse_transformer as ref
from bsmr_sddmm_tpu_torch.utils import profiling

#: the three arms of the enwik8 mask: the column-reordered dense tier, the
#: natural column blocks at the same delta, and the benchmark's replica arm
ARMS = {
    "reorder": dict(col_mode="reorder", alpha=0.3, delta=0.3),
    "bsr": dict(alpha=0.3, delta=0.3),
    "bsr_low_delta": dict(alpha=0.3, delta=0.002),
}
# a small model of the fixed pattern: 512 positions, stride 64, c 8
SMALL = dict(seq_len=512, vocab_size=32, head_dim=16, num_heads=2,
             num_layers=2, pattern="fixed", stride=64, c=8)


def closed_form_nnz(seq_len, stride, c):
    """Row i holds (i // stride) * c + i % stride + 1 nonzeros: the
    summaries of the blocks before its own, then its block up to i."""
    i = np.arange(seq_len, dtype=np.int64)
    return int(((i // stride) * c + i % stride + 1).sum())


@pytest.mark.parametrize("seq_len, stride, c", [
    (512, 64, 8), (300, 16, 4), (100, 7, 1), (64, 8, 8), (130, 128, 32),
    (5, 8, 3), (1, 1, 1)])
def test_fixed_mask_is_the_two_sets(seq_len, stride, c):
    mask = st.fixed_mask(seq_len, stride, c)
    mask.validate()
    got = np.zeros((seq_len, seq_len), bool)
    got[mask.coo_rows(), mask.col_indices] = True
    want = ref.fixed_mask_dense(seq_len, stride, c).numpy()
    np.testing.assert_array_equal(got, want)
    assert mask.nnz == int(want.sum()) == closed_form_nnz(seq_len, stride, c)
    assert mask.row_offsets.dtype == np.int64
    assert mask.col_indices.dtype == np.int32
    assert (mask.values == 1).all()


def test_fixed_mask_refuses_c_outside_the_block():
    for c in (0, 9):
        with pytest.raises(ValueError):
            st.fixed_mask(64, 8, c)


def test_enwik8_mask_nonzeros():
    """96 blocks of 128: 8 256 local nonzeros each, and 32 summaries of
    each earlier block in every row."""
    want = 96 * 8256 + 128 * 32 * sum(range(96))
    assert want == 19_470_336
    assert closed_form_nnz(12288, 128, 32) == want
    assert st.fixed_mask(12288, 128, 32).nnz == want


def test_enwik8_preset_is_the_published_model():
    m = st.ENWIK8
    assert (m.seq_len, m.vocab_size, m.head_dim, m.num_heads,
            m.num_layers) == (12288, 256, 64, 8, 30)
    assert (m.pattern, m.stride, m.c) == ("fixed", 128, 32)
    assert m.model_dim == 512


def test_unknown_pattern_is_refused():
    with pytest.raises(ValueError):
        st.SparseTransformer(seq_len=8, vocab_size=4, head_dim=4,
                             pattern="strided")


def test_make_forward_packs_the_models_own_pattern():
    cfg = SddmmConfig(k=16, delta=0.05)
    _, _, plan = st.make_forward(st.SparseTransformer(**SMALL), config=cfg,
                                 device="cpu")
    assert plan.nnz == st.fixed_mask(512, 64, 8).nnz
    local = st.SparseTransformer(seq_len=256, vocab_size=8, head_dim=16)
    _, _, plan = st.make_forward(local, config=cfg, window=32, stride=64,
                                 device="cpu")
    assert plan.nnz == st.local_strided_mask(256, window=32, stride=64).nnz
    _, _, plan = st.make_forward(local, config=cfg, device="cpu")
    assert plan.nnz == st.local_strided_mask(256).nnz


@pytest.mark.parametrize("fields", [dict(pattern="fixed"),
                                    dict(pattern="fixed", stride=64),
                                    dict(pattern="fixed", c=8),
                                    dict(stride=32), dict(c=8),
                                    dict(stride=64, c=8)])
def test_pattern_parameters_have_one_owner(fields):
    """A fixed-pattern model needs its stride and c; a local_strided one
    takes its window and stride from ``make_forward`` and refuses them as
    fields."""
    with pytest.raises(ValueError):
        st.SparseTransformer(seq_len=256, vocab_size=8, head_dim=16,
                             **fields)


@pytest.mark.parametrize("kw", [dict(window=32), dict(stride=64)])
def test_make_forward_refuses_window_or_stride_for_a_fixed_model(kw):
    with pytest.raises(ValueError):
        st.make_forward(st.SparseTransformer(**SMALL),
                        config=SddmmConfig(k=16, delta=0.05), device="cpu",
                        **kw)


@pytest.fixture(scope="module")
def enwik8_2048():
    """The fixed pattern at 2 048 positions, stride 128, c 32, and K=64
    operands."""
    mask = st.fixed_mask(2048, 128, 32)
    A = make_dense(mask.rows, 64, seed=11)
    B = make_dense(64, mask.cols, seed=12)
    return mask, A, B, sddmm_ref(A, B, mask)


def _plan(mask, arm):
    cfg = SddmmConfig(k=64, subpack_min_nnz=12, **ARMS[arm])
    return cfg, BsmrSddmm(mask, cfg, device="cpu").plan(cfg.alpha,
                                                        cfg.delta, 64)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_body_equals_the_oracle_in_each_arm(enwik8_2048, arm):
    mask, A, B, want = enwik8_2048
    cfg, plan = _plan(mask, arm)
    assert plan.mode == ("reorder" if arm == "reorder" else "bsr")
    fn = make_sddmm_body(plan, cfg)
    got = fn(torch.from_numpy(A), torch.from_numpy(np.ascontiguousarray(
        B.T)), device_plan(plan, "cpu")).numpy()
    assert got.shape == (mask.nnz,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_dense_launch_counters(enwik8_2048, arm):
    """The counters of the dense tier's launch, counted from the plan's
    own arrays, and the work ``dense_kernels.tile_work`` makes of them."""
    mask = enwik8_2048[0]
    cfg, plan = _plan(mask, arm)
    make_sddmm_body(plan, cfg)
    got = profiling.counters()
    ph, bw = plan.panel_height, plan.block_width
    T = plan.tile_panel.shape[0]
    # every (row of B) a tile's columns name, as the kernel reads them
    if plan.mode == "bsr":
        cols = (plan.tile_cblock.astype(np.int64)[:, None] * bw
                + np.arange(bw))
        src = plan.step_cblock if plan.fat_group > 1 else plan.tile_cblock
    else:
        cols = plan.tile_cols
        src = plan.tile_cols
    b_rows = np.unique(cols[cols < mask.cols]).shape[0]
    assert got["body.dense.tiles"] == T > 0
    assert got["body.dense.a_rows"] == ph * np.unique(plan.tile_panel).size
    assert got["body.dense.b_rows"] == b_rows
    assert got["body.dense.index_bytes"] == 4 * (T + src.size)
    assert (got["body.tile.rows"], got["body.tile.cols"]) == (ph, bw)
    assert got["body.passes"] == 3
    work = dk.tile_work(T, ph, bw, 64, torch.float32,
                        a_rows=got["body.dense.a_rows"], b_rows=b_rows,
                        index_bytes=got["body.dense.index_bytes"])
    assert work["flops"] == 2 * T * ph * bw * 64
    if arm == "reorder":        # the mask's own work is most of the tier's
        assert 0.6 < mask.nnz / (T * ph * bw) < 1


def test_passes_counter_follows_the_precision(enwik8_2048):
    mask = enwik8_2048[0]
    cfg, plan = _plan(mask, "reorder")
    make_sddmm_body(plan, cfg.replace(matmul_precision="default"))
    assert profiling.counters()["body.passes"] == 1


def _small_net(col_mode):
    model = st.SparseTransformer(**SMALL)
    params = st.init_params(model, seed=5)
    cfg = SddmmConfig(k=16, delta=0.05, col_mode=col_mode)
    net, dplan, _ = st.make_forward(model, config=cfg, params=params,
                                    device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.vocab_size, model.seq_len))
    mask = ref.fixed_mask_dense(model.seq_len, model.stride, model.c)
    return model, params, net, dplan, tokens, mask


@pytest.mark.parametrize("col_mode", ["bsr", "reorder"])
def test_fixed_net_logits_match_the_reference(col_mode):
    """Logits at rtol/atol 2e-4, the tolerance of the JAX package's test of
    its sparse model against dense attention."""
    model, params, net, dplan, tokens, mask = _small_net(col_mode)
    with torch.no_grad():
        got = net(tokens, dplan)
    want = ref.forward(params, tokens, model.num_heads, model.head_dim, mask)
    assert got.shape == (model.seq_len, model.vocab_size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_fixed_net_loss_and_gradients_match_the_reference():
    """The loss at rtol 1e-5 and every parameter's gradient at rtol 1e-3
    and atol 1e-4 x that tensor's largest |g|, the tolerances of the
    port's model tests against the JAX package."""
    model, params, net, dplan, tokens, mask = _small_net("reorder")
    loss = st.loss_fn(net, tokens, dplan)
    loss.backward()
    leaves = {key: ({k: v.clone().requires_grad_() for k, v in val.items()}
                    if isinstance(val, dict) else val.clone()
                    .requires_grad_()) for key, val in params.items()}
    want = ref.loss(leaves, tokens, model.num_heads, model.head_dim, mask)
    want.backward()
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-5)
    grads = dict(net.named_parameters())
    flat = {}
    for key, val in leaves.items():
        for sub, leaf in (val.items() if isinstance(val, dict)
                          else [(None, val)]):
            flat[key if sub is None else f"{key}.{sub}"] = leaf.grad
    assert sorted(flat) == sorted(grads)
    for name, g in flat.items():
        got = grads[name].grad.numpy()
        scale = float(np.abs(g.numpy()).max())
        np.testing.assert_allclose(got, g.numpy(), rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=name)


def test_reference_scores_are_the_masked_product():
    mask = st.fixed_mask(300, 16, 4)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(300, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(300, 8)).astype(np.float32))
    got = ref.scores(q, k, mask.coo_rows(), mask.col_indices, block_rows=64)
    want = sddmm_ref(q.numpy(), k.numpy().T.copy(), mask)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got = ref.scores(q.double(), k.double(), mask.coo_rows(),
                     mask.col_indices, block_rows=64)
    want = (q.double()[mask.coo_rows()]
            * k.double()[mask.col_indices]).sum(1)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest -m "
                    "cuda tests/test_torch_fixed_attention.py")
    return torch.device("cuda")


@pytest.mark.cuda
def test_reorder_body_on_the_card_against_fp64(cuda, enwik8_2048):
    """The reorder arm's body through the hand kernels (``dense_tile`` for
    the dense tier) at K=64, against the fp64 product, within 3e-5 of the
    sum of the terms' magnitudes at each nonzero."""
    mask, A, B, _ = enwik8_2048
    cfg, plan = _plan(mask, "reorder")
    fn = make_sddmm_body(plan, cfg)
    launches = dk.dense_tile.launches
    A_t = torch.from_numpy(A).to(cuda)
    Bt_t = torch.from_numpy(np.ascontiguousarray(B.T)).to(cuda)
    got = fn(A_t, Bt_t, device_plan(plan, cuda)).double()
    assert dk.dense_tile.launches == launches + 1
    rows = torch.from_numpy(mask.coo_rows()).to(cuda).long()
    cols = torch.from_numpy(mask.col_indices).to(cuda).long()
    a, b = A_t.double()[rows], Bt_t.double()[cols]
    want = (a * b).sum(1)
    err = ((got - want).abs() / (a.abs() * b.abs()).sum(1)).max().item()
    assert err < 3e-5


@pytest.mark.cuda
def test_reorder_body_at_12288_positions_against_reference_scores(cuda):
    """The cell's configuration: the reorder arm's body on the enwik8 mask
    at its 12 288 positions, K=64, against the plain reference's blocked
    scores in float64, within 3e-5 of the sum of the terms' magnitudes at
    each nonzero (the same scores of |A| and |B|)."""
    mask = st.fixed_mask(12288, 128, 32)
    cfg, plan = _plan(mask, "reorder")
    fn = make_sddmm_body(plan, cfg)
    A_t = torch.from_numpy(make_dense(mask.rows, 64, seed=11)).to(cuda)
    Bt_t = torch.from_numpy(np.ascontiguousarray(
        make_dense(64, mask.cols, seed=12).T)).to(cuda)
    got = fn(A_t, Bt_t, device_plan(plan, cuda)).double()
    rows, cols = mask.coo_rows(), mask.col_indices
    want = ref.scores(A_t.double(), Bt_t.double(), rows, cols)
    size = ref.scores(A_t.double().abs(), Bt_t.double().abs(), rows, cols)
    assert ((got - want).abs() / size).max().item() < 3e-5


def enwik8_logit_errors(device, matmul_precision="bf16x3", num_layers=4,
                        seed=0):
    """The ``ENWIK8`` preset at every published width and 12 288
    positions, cut to ``num_layers`` of its 30 identical layers, through
    ``make_forward`` on the cell's arm (the column-reordered dense tier)
    at ``matmul_precision``, against the plain reference on the same
    weights and tokens: ``(max |logit - ref|, max |ref|)``."""
    import dataclasses
    model = dataclasses.replace(st.ENWIK8, num_layers=num_layers)
    params = st.init_params(model, seed=seed)
    cfg = SddmmConfig(k=64, alpha=0.3, delta=0.3, subpack_min_nnz=12,
                      col_mode="reorder", matmul_precision=matmul_precision)
    net, dplan, _ = st.make_forward(model, config=cfg, params=params,
                                    device=device)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, model.vocab_size, model.seq_len)).to(device)
    with torch.no_grad():
        got = net(tokens, dplan).double()
        del net, dplan
        want = ref.forward(
            {key: ({k: v.to(device) for k, v in val.items()}
                   if isinstance(val, dict) else val.to(device))
             for key, val in params.items()}, tokens, model.num_heads,
            model.head_dim, ref.fixed_mask_dense(model.seq_len, model.stride,
                                                 model.c, device)).double()
    return (got - want).abs().max().item(), want.abs().max().item()


#: the ENWIK8 forward's tolerance on the card: max |logit - ref| over the
#: logits' scale max |ref|. Three TF32 passes read 1.3-1.5e-6 (fp32 sums
#: of up to 4 096 attention terms a row, in another order than the
#: reference's); one pass (``matmul_precision="default"``) reads 1.8-1.9e-4,
#: its operands rounded to 10 mantissa bits (NVIDIA H100, 4 layers, seeds 0
#: and 1). 2e-5 leaves 13x above the first and 9x below the second.
ENWIK8_REL_TOL = 2e-5


@pytest.mark.cuda
def test_enwik8_forward_on_the_card_matches_the_reference(cuda):
    """The preset at its published widths and 12 288 positions, 4 of its 30
    layers, through the hand kernels, within ``ENWIK8_REL_TOL`` of the
    plain reference, and one TF32 pass outside it."""
    err, scale = enwik8_logit_errors(cuda, "bf16x3")
    assert err <= ENWIK8_REL_TOL * scale
    err, scale = enwik8_logit_errors(cuda, "default")
    assert err > ENWIK8_REL_TOL * scale
