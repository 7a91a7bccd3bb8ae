"""Counting, compaction, curve and top-k functions, with the CUDA kernels
behind them. JAX counterpart: ``torcheval_tpu/ops/``.

The package exports the JAX package's ``ops.__all__`` under the port's
names. Two tables, in the style of ``obs/inventory.py``, account for every
JAX name; ``tests/test_torch_ops_exports.py`` holds them to both
``__all__`` lists:

* :data:`JAX_NAMES`: JAX name -> the port's name for the same function
  (the kernel entries drop the JAX package's ``pallas_`` prefix);
* :data:`NO_COUNTERPART`: JAX name -> why the port has none.
"""

from typing import Dict

from torcheval_tpu_torch.ops.confusion import class_counts, confusion_matrix_counts
from torcheval_tpu_torch.ops.curves import (
    binary_auprc_kernel,
    binary_auroc_kernel,
    multiclass_prc_points_kernel,
    prc_points_kernel,
)
from torcheval_tpu_torch.ops.scatter import segment_scatter, segment_sum, sharded_segment_sum
from torcheval_tpu_torch.ops.topk import (
    prune_topk,
    sharded_label_topk,
    topk,
    topk_indices,
    topk_kernel,
    topk_values,
)

JAX_NAMES: Dict[str, str] = {
    "binary_auprc_kernel": "binary_auprc_kernel",
    "binary_auroc_kernel": "binary_auroc_kernel",
    "class_counts": "class_counts",
    "confusion_matrix_counts": "confusion_matrix_counts",
    "multiclass_prc_points_kernel": "multiclass_prc_points_kernel",
    "pallas_segment_sum": "segment_sum",
    "pallas_topk": "topk_kernel",
    "prc_points_kernel": "prc_points_kernel",
    "prune_topk": "prune_topk",
    "segment_scatter": "segment_scatter",
    "sharded_label_topk": "sharded_label_topk",
    "sharded_pallas_segment_sum": "sharded_segment_sum",
    "topk": "topk",
    "topk_indices": "topk_indices",
    "topk_values": "topk_values",
}

NO_COUNTERPART: Dict[str, str] = {
    "topk_onehot": "no caller in the port",
    "label_sharding_of": (
        "the JAX auto-pick of the label-sharded engine from an operand's "
        "sharding; the port takes label_mesh= (ROADMAP: DTensor detection)"
    ),
}

__all__ = sorted(JAX_NAMES.values())
