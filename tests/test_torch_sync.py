"""The port's cross-process sync in a real 4-process world, on gloo and the
CPU, against the JAX package.

One world is launched for the whole module (``setUpClass``): four
processes of ``python -m torcheval_tpu_torch.utils.test_utils.sync_worker``,
each joining through ``parallel.init_from_env`` and writing its results to
a JSON file. The launch has its own timeout (90 s), after which every
worker is killed, so a hung collective cannot hang the suite; a second
launch, on another port, follows only when the first port was taken. The
references are the JAX package's metrics fed the single stream of all four
ranks' shards, its ``sharded_pallas_class_counts(interpret=True)`` and its
``ShardedEvaluator`` on a 4-device CPU mesh fed the same global batches.
Counts are compared exactly; float results within rtol 1e-5 and atol 1e-8.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import unittest

import jax
import jax.numpy as jnp
import numpy as np

import torcheval_tpu.metrics as J
from torcheval_tpu_torch.utils.test_utils import sync_worker as W

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_parallel import jax_example_numbers  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
LAUNCH_TIMEOUT_S = 90
RTOL, ATOL = 1e-5, 1e-8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_world(outdir: str) -> list:
    """Run the four workers and read their results. A second port is tried
    only when the first was taken between choosing and binding it."""
    try:
        return _launch_world_once(outdir)
    except AssertionError as err:
        if "address already in use" not in str(err).lower():
            raise
        return _launch_world_once(outdir)


def _launch_world_once(outdir: str) -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "torcheval_tpu_torch.utils.test_utils.sync_worker",
             str(r), str(WORLD), port, outdir],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r in range(WORLD)
    ]
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    outs, timed_out = [], False
    for p in procs:
        try:
            out = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))[0]
        except subprocess.TimeoutExpired:
            timed_out = True
            for q in procs:
                q.kill()
            out = p.communicate()[0]
        outs.append(out.decode(errors="replace"))
    for r, (p, out) in enumerate(zip(procs, outs)):
        if timed_out or p.returncode != 0:
            logs = "\n".join(f"--- rank {i}:\n{o[-3000:]}" for i, o in enumerate(outs))
            raise AssertionError(
                f"the world failed (rank {r} exit {p.returncode}, timed out: {timed_out}):\n{logs}"
            )
    results = []
    for r in range(WORLD):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _close(got, want):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, atol=ATOL
    )


def _stream(make, ranks=range(WORLD)):
    parts = [make(r) for r in ranks]
    return [np.concatenate([p[i] for p in parts]) for i in range(len(parts[0]))]


class TestFourProcessSync(unittest.TestCase):
    @classmethod
    def setUpClass(cls):
        cls._tmp = tempfile.TemporaryDirectory(prefix="torch_sync_")
        cls.results = _launch_world(cls._tmp.name)

    @classmethod
    def tearDownClass(cls):
        cls._tmp.cleanup()

    def test_sum_under_every_recipient_rank(self):
        # local sums are 3 * (rank + 1); the global sum is 30
        for r, res in enumerate(self.results):
            self.assertEqual(res["sum_r0"], 30.0 if r == 0 else None)
            self.assertEqual(res["sum_r1"], 30.0 if r == 1 else None)
            self.assertEqual(res["sum_rall"], 30.0)
            self.assertEqual(res["sum_source_after"], 3.0 * (r + 1))  # source unchanged

    def test_accuracy_equals_the_single_stream(self):
        scores, labels = _stream(W.make_acc_shard)
        micro = J.MulticlassAccuracy(num_classes=W.NUM_CLASSES).update(scores, labels).compute()
        macro = J.MulticlassAccuracy(average="macro", num_classes=W.NUM_CLASSES)
        macro = macro.update(scores, labels).compute()
        for res in self.results:
            _close(res["acc_all"], micro)
            _close(res["macro_acc_all"], macro)

    def test_f1_every_average_equals_the_single_stream(self):
        scores, labels = _stream(W.make_acc_shard)
        for avg in ("micro", "macro", "weighted", None):
            ref = J.MulticlassF1Score(num_classes=W.NUM_CLASSES, average=avg).update(scores, labels)
            sd = ref.state_dict()
            counts = [np.asarray(sd[n]).tolist() for n in ("num_tp", "num_label", "num_prediction")]
            for res in self.results:
                self.assertEqual(res[f"f1_{avg or 'none'}_counts"], counts)
                _close(res[f"f1_{avg or 'none'}"], ref.compute())

    def test_synced_metric_and_state_dict_on_rank_1(self):
        for r, res in enumerate(self.results):
            if r == 1:
                self.assertIsNotNone(res["synced_metric_r1"])
                self.assertEqual(res["synced_sd_r1_keys"], ["num_correct", "num_total"])
                self.assertEqual(res["synced_sd_r1_num_total"], float(WORLD * W.ACC_BATCH))
            else:
                self.assertIsNone(res["synced_metric_r1"])
                self.assertEqual(res["synced_sd_r1_keys"], [])

    def test_auroc_uneven_caches_and_an_empty_rank(self):
        self.assertEqual(W.AUROC_SIZES[2], 0)
        scores, targets = _stream(W.make_auroc_shard)
        want = J.BinaryAUROC().update(scores, targets).compute()
        for r, res in enumerate(self.results):
            _close(res["auroc_all"], want)
            _close(res["auroc_compacting_all"], want)
            if r == 0:
                _close(res["auroc_r0"], want)
            else:
                self.assertIsNone(res["auroc_r0"])

    def test_dict_state_through_the_object_gather(self):
        want = sum(v for r in range(WORLD) for _, v in W.make_dict_updates(r))
        keys = sorted({k for r in range(WORLD) for k, _ in W.make_dict_updates(r)})
        for r, res in enumerate(self.results):
            _close(res["dict_all"], want)
            self.assertEqual(res["dict_keys_r0"], keys if r == 0 else None)

    def test_window_keeps_the_newest_rows_and_ships_only_them(self):
        rows = [row for r in range(WORLD) for row in W.make_window_rows(r)]
        want = np.stack(rows[-W.WINDOW_MAXLEN:])
        # descriptor round: 2 rows of 9 int32; payload round: the longest
        # rank's kept rows, 2 of (2,) float32 (rank 0 keeps none)
        wire = 2 * 9 * 4 + 2 * 2 * 4
        for res in self.results:
            np.testing.assert_array_equal(np.asarray(res["window_rows"]), want)
            self.assertEqual(res["window_rounds"], 2)
            self.assertEqual(res["window_payload_bytes"], wire)

    def test_collection_values_equal_the_single_metric_syncs(self):
        for r, res in enumerate(self.results):
            col = res["collection_all"]
            self.assertEqual(sorted(col), ["acc", "auroc", "f1", "sum"])
            _close(col["acc"], res["acc_all"])
            _close(col["auroc"], res["auroc_all"])
            _close(col["sum"], 30.0)
            _close(col["f1"], res["f1_macro"])
            self.assertEqual(res["collection_r1"], ["acc", "auroc", "f1", "sum"] if r == 1 else None)

    def test_every_collection_sync_is_two_rounds(self):
        for res in self.results:
            for key in ("rounds_acc", "rounds_auroc", "rounds_collection", "rounds_sliced"):
                self.assertEqual(res[key], 2, key)
            # the dict member's object lane adds its own two
            self.assertEqual(res["rounds_window_plus_dict"], 4)

    def test_ragged_sliced_collection_equals_jax(self):
        ref = J.SlicedMetricCollection({"acc": J.BinaryAccuracy(), "sum": J.Sum()}, capacity=4)
        for r in range(WORLD):
            for ids, s, t in W.make_sliced_shard(r):
                ref.update(ids, s, t)
        want = ref.compute()
        for member, key in (("acc", "sliced_acc"), ("sum", "sliced_sum")):
            ids = np.asarray(want[member]["slice_ids"])
            order = np.argsort(ids)
            vals = np.asarray(want[member]["values"])[order]
            for res in self.results:
                ids_key = "sliced_ids" if member == "acc" else "sliced_sum_ids"
                self.assertEqual(res[ids_key], ids[order].tolist())
                if member == "acc":
                    np.testing.assert_array_equal(np.asarray(res[key], np.float32), vals)
                else:
                    _close(res[key], vals)

    def test_subgroup_sync(self):
        want_auroc = J.BinaryAUROC().update(*_stream(W.make_auroc_shard, W.SUBGROUP)).compute()
        want_dict = sum(v for r in W.SUBGROUP for _, v in W.make_dict_updates(r))
        want_eval = J.MulticlassAccuracy(num_classes=W.NUM_CLASSES)
        for s, l in W.make_eval_batches():
            want_eval.update(s, l)
        want_eval = want_eval.compute()
        for r, res in enumerate(self.results):
            if r in W.SUBGROUP:
                # 10 * (1 + 1) + 10 * (3 + 1)
                self.assertEqual(res["subgroup_sum_all"], 60.0)
                self.assertEqual(res["subgroup_sum_r3"], 60.0 if r == 3 else None)
                self.assertTrue(res["subgroup_bad_recipient"])
                col = res["subgroup_collection"]
                self.assertEqual(col["s"], 60.0)
                _close(col["auroc"], want_auroc)
                _close(col["d"], want_dict)
                self.assertEqual(res["subgroup_sd_r1"], 60.0 if r == 1 else None)
                self.assertEqual(res["subgroup_mesh"], [2, W.SUBGROUP.index(r)])
                _close(res["subgroup_evaluator"], want_eval)
            else:
                self.assertTrue(res["subgroup_nonmember_error"])

    def test_sharded_class_counts_equal_jax_on_a_four_device_mesh(self):
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        from torcheval_tpu.ops.pallas_hist import sharded_pallas_class_counts

        mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
        labels = np.concatenate([W.make_hist_labels(r) for r in range(WORLD)]).astype(np.int32)
        sharding = NamedSharding(mesh, P("data"))
        fn = jax.jit(lambda ls: sharded_pallas_class_counts(ls, W.HIST_CLASSES, True), in_shardings=sharding)
        want = np.asarray(fn(jax.device_put(jnp.asarray(labels), sharding))).tolist()
        for res in self.results:
            self.assertEqual(res["sharded_counts"], want)
            self.assertEqual(res["sharded_counts_dtype"], "torch.int32")

    def test_sharded_evaluator_equals_jax_on_a_four_device_mesh(self):
        from torcheval_tpu.parallel import ShardedEvaluator, data_parallel_mesh

        mesh = data_parallel_mesh(jax.devices()[:WORLD])
        ev = ShardedEvaluator(
            {
                "acc": J.MulticlassAccuracy(num_classes=W.NUM_CLASSES),
                "f1": J.MulticlassF1Score(num_classes=W.NUM_CLASSES, average="macro"),
            },
            mesh=mesh,
        )
        ev_auroc = ShardedEvaluator(J.BinaryAUROC(), mesh=mesh)
        batches = W.make_eval_batches()
        for s, l in batches:
            ev.update(s, l)
            ev_auroc.update(s[:, 0], (l == 0).astype(np.float32))
        want = ev.compute()
        want_auroc = ev_auroc.compute()
        total = sum(s.shape[0] for s, _ in batches)
        self.assertEqual(sum(res["evaluator_rows"] for res in self.results), total)
        for r, res in enumerate(self.results):
            self.assertEqual(res["evaluator_mesh"], [WORLD, r])
            _close(res["evaluator"]["acc"], want["acc"])
            _close(res["evaluator"]["f1"], want["f1"])
            _close(res["evaluator_auroc"], want_auroc)

    def test_init_from_env_again_keeps_the_world(self):
        for r, res in enumerate(self.results):
            self.assertEqual(res["init_again"], [r, WORLD])

    def test_distributed_example_at_four_ranks_prints_the_jax_numbers(self):
        want = jax_example_numbers()
        for res in self.results:
            for key in ("accuracy", "f1_macro", "auroc"):
                _close(res["example"][key], want[key])


if __name__ == "__main__":
    unittest.main()
