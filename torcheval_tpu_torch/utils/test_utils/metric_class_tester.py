"""Protocol-conformance harness for class metrics.

JAX counterpart: ``torcheval_tpu/utils/test_utils/metric_class_tester.py``
(``MetricClassTester``, ``assert_result_close``). Every update argument
carries a leading ``num_total_updates`` axis; update ``i`` takes slice
``i``. For one spec the harness checks:

1. init invariants: state names, deepcopy and pickle, the state_dict round
   trip and a strict load's refusal of unknown keys;
2. streaming ``update`` and ``compute``: chaining, idempotence, the
   expected value;
3. that merging replicas equals one stream: the updates split across
   ``num_processes`` replicas and merged with ``merge_state`` give the
   single-stream result, leave the sources unchanged, and merging into a
   fresh metric or merging an empty one mid-stream works;
4. with a CUDA device present, replicas on the CPU and the card merge, and
   the merged state lands on the destination's device.

Real multi-process sync is tested apart, in worlds of processes
(``utils/test_utils/sync_worker.py``).
"""

from __future__ import annotations

import copy
import pickle
import unittest
from collections import deque
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.metric import Metric

NUM_TOTAL_UPDATES = 8
NUM_PROCESSES = 4
BATCH_SIZE = 16


def _numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64 if x.is_floating_point() else x.dtype).numpy()
    return np.asarray(x)


def assert_result_close(
    result: Any, expected: Any, atol: float = 1e-5, rtol: float = 1e-4
) -> None:
    """Compare metric results (tensors, arrays, sequences, dicts) with NaN
    equal to NaN, at float32 tolerances."""
    if isinstance(expected, dict):
        assert isinstance(result, dict), f"expected dict, got {type(result)}"
        assert set(result) == set(expected)
        for k in expected:
            assert_result_close(result[k], expected[k], atol=atol, rtol=rtol)
    elif isinstance(expected, (list, tuple)):
        assert isinstance(result, (list, tuple)), f"expected sequence, got {type(result)}"
        assert len(result) == len(expected), f"{len(result)} != {len(expected)}"
        for r, e in zip(result, expected):
            assert_result_close(r, e, atol=atol, rtol=rtol)
    else:
        np.testing.assert_allclose(
            _numpy(result).astype(np.float64),
            _numpy(expected).astype(np.float64),
            atol=atol,
            rtol=rtol,
            equal_nan=True,
        )


def _slice_kwargs(update_kwargs: Dict[str, Any], idx: int) -> Dict[str, Any]:
    return {name: value[idx] for name, value in update_kwargs.items()}


def _leaves(value) -> list:
    if isinstance(value, dict):
        return list(value.values())
    if isinstance(value, (list, tuple, deque)):
        return list(value)
    return [value]


class MetricClassTester(unittest.TestCase):
    """Inherit in class-metric tests and call
    :meth:`run_class_implementation_tests`."""

    def run_class_implementation_tests(
        self,
        metric: Metric,
        state_names: Union[set, frozenset],
        update_kwargs: Dict[str, Any],
        compute_result: Any,
        num_total_updates: int = NUM_TOTAL_UPDATES,
        num_processes: int = NUM_PROCESSES,
        merge_and_compute_result: Optional[Any] = None,
        test_merge_with_one_update: bool = True,
        atol: float = 1e-5,
        rtol: float = 1e-4,
    ) -> None:
        assert num_total_updates % num_processes == 0, (
            "num_total_updates must divide evenly among num_processes"
        )
        self._test_init(metric, state_names)
        self._test_update_and_compute(
            metric, update_kwargs, compute_result, num_total_updates, atol, rtol
        )
        expected_merge = (
            merge_and_compute_result if merge_and_compute_result is not None else compute_result
        )
        self._test_merge_state(
            metric,
            update_kwargs,
            expected_merge,
            num_total_updates,
            num_processes,
            test_merge_with_one_update,
            atol,
            rtol,
            stream_result=compute_result,
        )
        self._test_cross_device_merge(
            metric, update_kwargs, expected_merge, num_total_updates, num_processes, atol, rtol
        )

    def _replicas(self, metric, update_kwargs, n, num_processes, devices=None) -> List[Metric]:
        per_rank = n // num_processes
        replicas = [copy.deepcopy(metric) for _ in range(num_processes)]
        for rank, rep in enumerate(replicas):
            if devices is not None:
                rep.to(devices[rank % len(devices)])
            for i in range(rank * per_rank, (rank + 1) * per_rank):
                rep.update(**_slice_kwargs(update_kwargs, i))
        return replicas

    def _test_cross_device_merge(
        self, metric, update_kwargs, compute_result, n, num_processes, atol, rtol
    ) -> None:
        """Replicas on the CPU and the card merge into the first one's
        device (the reference torcheval's CPU/CUDA merge check)."""
        if not torch.cuda.is_available():
            return
        dest = torch.device("cpu") if metric.device.type == "cuda" else torch.device("cuda", 0)
        devices = [dest, metric.device]
        replicas = self._replicas(metric, update_kwargs, n, num_processes, devices)
        merged = replicas[0].merge_state(replicas[1:])
        assert_result_close(merged.compute(), compute_result, atol=atol, rtol=rtol)
        for name, value in merged._states().items():
            for leaf in _leaves(value):
                self.assertEqual(
                    leaf.device.type,
                    dest.type,
                    f"state {name!r} not on the destination device after a cross-device merge",
                )

    def _test_init(self, metric: Metric, state_names) -> None:
        self.assertEqual(set(metric.state_names), set(state_names))
        cloned = copy.deepcopy(metric)
        self.assertEqual(set(cloned.state_names), set(state_names))
        restored = pickle.loads(pickle.dumps(metric))
        self.assertEqual(set(restored.state_names), set(state_names))
        sd = metric.state_dict()
        self.assertEqual(set(sd.keys()), set(state_names))
        fresh = copy.deepcopy(metric)
        fresh.load_state_dict(sd)
        with self.assertRaises(RuntimeError):
            fresh.load_state_dict({"__not_a_state__": torch.zeros(())}, strict=True)

    def _test_update_and_compute(
        self, metric: Metric, update_kwargs, compute_result, n, atol, rtol
    ) -> None:
        m = copy.deepcopy(metric)
        for i in range(n):
            ret = m.update(**_slice_kwargs(update_kwargs, i))
            self.assertIs(ret, m)  # update chains
        r1 = m.compute()
        r2 = m.compute()  # idempotent
        assert_result_close(r1, compute_result, atol=atol, rtol=rtol)
        assert_result_close(r2, compute_result, atol=atol, rtol=rtol)

    def _test_merge_state(
        self,
        metric: Metric,
        update_kwargs,
        compute_result,
        n,
        num_processes,
        test_merge_with_one_update,
        atol,
        rtol,
        stream_result=None,
    ) -> None:
        if stream_result is None:
            stream_result = compute_result
        replicas = self._replicas(metric, update_kwargs, n, num_processes)
        source_dicts = [copy.deepcopy(rep.state_dict()) for rep in replicas[1:]]
        merged = replicas[0].merge_state(replicas[1:])
        self.assertIs(merged, replicas[0])
        assert_result_close(merged.compute(), compute_result, atol=atol, rtol=rtol)
        # sources unchanged by the merge
        for rep, before in zip(replicas[1:], source_dicts):
            after = rep.state_dict()
            self.assertEqual(set(after), set(before))
            for k in before:
                self._assert_state_equal(before[k], after[k])
        # merge into a metric that has never been updated
        fresh = copy.deepcopy(metric)
        fresh.merge_state(self._replicas(metric, update_kwargs, n, num_processes))
        assert_result_close(fresh.compute(), compute_result, atol=atol, rtol=rtol)
        # merge an empty metric mid-stream, then keep updating: merging an
        # empty metric is a no-op, so this is the single-stream result
        if test_merge_with_one_update:
            a = copy.deepcopy(metric)
            b = copy.deepcopy(metric)
            for i in range(n // 2):
                a.update(**_slice_kwargs(update_kwargs, i))
            a.merge_state([b])
            for i in range(n // 2, n):
                a.update(**_slice_kwargs(update_kwargs, i))
            assert_result_close(a.compute(), stream_result, atol=atol, rtol=rtol)

    def _assert_state_equal(self, before, after) -> None:
        if isinstance(before, dict):
            self.assertEqual(set(before), set(after))
            pairs = [(before[k], after[k]) for k in before]
        else:
            b, a = _leaves(before), _leaves(after)
            self.assertEqual(len(b), len(a))
            pairs = list(zip(b, a))
        for b, a in pairs:
            torch.testing.assert_close(a.cpu(), b.cpu(), rtol=0, atol=0, equal_nan=True)
