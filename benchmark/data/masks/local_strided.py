"""The fixed causal local + strided attention mask of the Sparse
Transformer (Child et al., 2019, arXiv:1904.10509), as the port builds it
for its sparse-attention model: a frozen copy of
``bsmr_sddmm_tpu_torch.models.sparse_transformer.local_strided_mask``.

Query ``q`` attends to the previous ``window`` positions (itself included)
and, beyond them, to every summary position ``stride * j - 1`` before it.
"""

import numpy as np

from benchmark.data.generators import Mask, _dedup_to_csr

EXAMPLE = {"seq_len": 300, "window": 16, "stride": 8}
EXAMPLE_SHA256 = ("4c233ec6f4ccfb80a863d0e1d6f31689"
                  "4b51dae6f923ffa7958164f94ce2d635")


def make(seq_len: int, window: int, stride: int) -> Mask:
    q = np.arange(seq_len, dtype=np.int64)
    rows, cols = [], []
    for off in range(window):               # the causal local band
        keep = q - off >= 0
        rows.append(q[keep])
        cols.append(q[keep] - off)
    for g in (np.arange(seq_len // stride, dtype=np.int64) + 1) * stride - 1:
        keep = q > g + window - 1           # summaries beyond the band
        rows.append(q[keep])
        cols.append(np.full(int(keep.sum()), g, np.int64))
    return _dedup_to_csr(np.concatenate(rows), np.concatenate(cols),
                         seq_len, seq_len)
