"""The Sparse Transformer's "fixed" attention pattern (Child et al., 2019,
arXiv:1904.10509), its two heads merged into one head over their union: a
frozen copy of ``bsmr_sddmm_tpu_torch.models.sparse_transformer.
fixed_mask``.

Query ``i`` attends to the causal ``j <= i`` in its own block of
``stride`` positions, A(1) = {j : floor(j / stride) = floor(i / stride)},
and to the last ``c`` "summary" positions of every block, A(2) = {j : j
mod stride >= stride - c}. A row holds the summaries of the blocks before
its own, then its own block up to itself, so the mask is built in CSR
order a block of rows at a time, with no sort.
"""

import numpy as np

from benchmark.data.generators import Mask

EXAMPLE = {"seq_len": 300, "stride": 16, "c": 4}
EXAMPLE_SHA256 = ("205ea4eebf0d5deccd4b95aa494ff1d7"
                  "4edeb341f3f89faf858a91fe61d255de")


def make(seq_len: int, stride: int, c: int) -> Mask:
    if not 1 <= c <= stride:
        raise ValueError(f"need 1 <= c <= stride, got c={c}, "
                         f"stride={stride}")
    summaries = (np.arange(stride - c, stride, dtype=np.int64)[None, :]
                 + stride * np.arange(-(-seq_len // stride),
                                      dtype=np.int64)[:, None]).reshape(-1)
    row_nnz = np.empty(seq_len, np.int64)
    cols = []
    for b, start in enumerate(range(0, seq_len, stride)):
        n = min(stride, seq_len - start)
        pos = np.arange(n, dtype=np.int64)
        row_nnz[start:start + n] = b * c + pos + 1
        # each row's summaries, then the block's columns up to the row
        full = np.concatenate([np.broadcast_to(summaries[:b * c], (n, b * c)),
                               np.broadcast_to(start + pos, (n, n))], axis=1)
        keep = np.concatenate([np.ones((n, b * c), bool),
                               pos[None, :] <= pos[:, None]], axis=1)
        cols.append(full[keep])
    row_offsets = np.zeros(seq_len + 1, np.int64)
    np.cumsum(row_nnz, out=row_offsets[1:])
    return Mask(seq_len, seq_len, row_offsets,
                np.concatenate(cols).astype(np.int32))
