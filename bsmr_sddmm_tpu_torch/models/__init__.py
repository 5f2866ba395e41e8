"""Model families over the SDDMM pipeline, trained through the hand
kernels.

* :mod:`graph_transformer` — sparse-attention GNN over a graph mask.
* :mod:`sparse_transformer` — decoder transformer with a fixed causal
  attention mask: the JAX package's local + summary-column mask, or the
  Sparse Transformer's "fixed" pattern (``ENWIK8``).
"""

from bsmr_sddmm_tpu_torch.models import sparse_transformer
from bsmr_sddmm_tpu_torch.models.graph_transformer import (GraphTransformer,
                                                           init_params,
                                                           make_forward,
                                                           make_train_step)
from bsmr_sddmm_tpu_torch.models.sparse_transformer import (
    SparseTransformer, local_strided_mask)

__all__ = ["GraphTransformer", "init_params", "make_forward",
           "make_train_step", "SparseTransformer", "local_strided_mask",
           "sparse_transformer"]
