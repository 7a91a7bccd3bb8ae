"""Data-parallel streaming evaluation: one process per card, one global
result.

JAX counterpart: ``torcheval_tpu/parallel/evaluator.py``
(``ShardedEvaluator``). There one process feeds global batches sharded over
a device mesh, and XLA adds the collectives inside the update programs.
Here each rank of a ``torch.distributed`` world feeds its own local batches
(for example its block of each global batch, ``mesh.shard_batch``) to an
eager ``MetricCollection`` on its card, and :meth:`ShardedEvaluator.compute`
gives the global result on every rank, as in the JAX package:

* the exact curve members (``BinaryAUROC``, ``BinaryAUPRC``,
  ``MulticlassAUROC``, ``MulticlassAUPRC``) compute through the
  distributed curves (``ops/dist_curves.py``): each row crosses the wire
  once, in one bucket all-to-all, where a gather would bring every rank's
  cache to every rank (the JAX package's ``_sharded_value``); their
  ``approx=`` forms add every rank's sketch in one all-reduce;
* every other member, and a curve member whose route stood down (a
  summary, a NaN score or a bucket overflow on some rank: every rank sees
  it in the same collective), syncs in one two-round exchange
  (``toolkit.sync_and_compute_collection(..., recipient_rank="all")``).

A group of one rank syncs nothing and warns, as before.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

from torcheval_tpu_torch.metrics.collection import MetricCollection
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.metrics.toolkit import _torch_group, sync_and_compute_collection
from torcheval_tpu_torch.parallel.mesh import DataParallelMesh, data_parallel_mesh


class ShardedEvaluator:
    """Drive one metric (or a named collection) on this rank's batches and
    compute the result over every rank of the mesh.

    Example (one process per card, launched with ``torchrun``)::

        init_from_env()
        mesh = data_parallel_mesh()
        ev = ShardedEvaluator({"acc": MulticlassAccuracy(num_classes=10)}, mesh=mesh)
        for scores, labels in loader:                 # global batches
            ev.update(*shard_batch(mesh, scores, labels))
        results = ev.compute()                        # global, on every rank

    ``metrics`` move to the mesh's device. Every rank must call
    :meth:`compute` (it is a collective), with members built in the same
    order.
    """

    def __init__(
        self,
        metrics: Union[Metric, Dict[str, Metric]],
        *,
        mesh: Optional[DataParallelMesh] = None,
    ) -> None:
        self.mesh = mesh if mesh is not None else data_parallel_mesh()
        self._collection = MetricCollection(metrics)
        self.metrics: Dict[str, Metric] = self._collection.metrics
        for m in self.metrics.values():
            m.to(self.mesh.device)
        self._single = isinstance(metrics, Metric)

    def update(self, *args: Any, **kwargs: Any) -> "ShardedEvaluator":
        """Fold this rank's local batch (which may be empty) into every
        member."""
        self._collection.update(*args, **kwargs)
        return self

    def compute(self) -> Any:
        """Every member's result over all ranks of the mesh, on every rank:
        the curve members by their distributed routes, in member order, then
        the rest in one sync (module doc). The states are not changed."""
        out: Dict[str, Any] = {}
        if self.mesh.size > 1:
            group = _torch_group(self.mesh.processes)
            for name, m in self.metrics.items():
                route = getattr(m, "_distributed_compute", None)
                value = route(group) if route is not None else None
                if value is not None:
                    out[name] = value
        rest = {n: m for n, m in self.metrics.items() if n not in out}
        if rest:
            out.update(sync_and_compute_collection(
                rest, recipient_rank="all", processes=self.mesh.processes
            ))
        out = {n: out[n] for n in self.metrics}
        return out["metric"] if self._single else out

    def reset(self) -> "ShardedEvaluator":
        self._collection.reset()
        return self

    # ------------------------------------------------------- checkpointing
    def state_dicts(self) -> Dict[str, Dict[str, Any]]:
        """This rank's local state, member by member."""
        return self._collection.state_dicts()

    def load_state_dicts(
        self, state_dicts: Dict[str, Dict[str, Any]], strict: bool = True
    ) -> "ShardedEvaluator":
        self._collection.load_state_dicts(state_dicts, strict)
        return self
