"""Sketch state on the port's two-round sync, in a real 2-process world on
gloo and the CPU, against the JAX package's single-stream results.

Mirrors ``tests/sketch/test_sketch_sync.py`` without its codec cases (the
port ships raw bytes). Two processes of
``python -m torcheval_tpu_torch.utils.test_utils.sketch_sync_worker`` each
stream one rank's shard, sync through ``metrics/toolkit.py`` and write
their results; the launch is killed after 90 s. The sketch lanes are int32
SUM states, so the synced counts must equal the JAX package's over the
whole stream exactly; values within atol 1e-8, rtol 1e-5. A NaN seen by
one rank raises on every rank after the sync.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import unittest

import jax.numpy as jnp
import numpy as np

import torcheval_tpu.metrics as J
from torcheval_tpu import sketch as JS
from torcheval_tpu_torch.utils.test_utils import sketch_sync_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LAUNCH_TIMEOUT_S = 90
RTOL, ATOL = 1e-5, 1e-8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(outdir: str) -> list:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "torcheval_tpu_torch.utils.test_utils.sketch_sync_worker",
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
    for r, p in enumerate(procs):
        if timed_out or p.returncode != 0:
            logs = "\n".join(f"--- rank {i}:\n{o[-3000:]}" for i, o in enumerate(outs))
            raise AssertionError(f"the world failed (rank {r} exit {p.returncode}):\n{logs}")
    results = []
    for r in range(WORLD):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _stream(make):
    parts = [make(r) for r in range(WORLD)]
    return [np.concatenate([p[i] for p in parts]) for i in range(len(parts[0]))]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL)


class TestTwoProcessSketchSync(unittest.TestCase):
    @classmethod
    def setUpClass(cls):
        cls._tmp = tempfile.TemporaryDirectory(prefix="torch_sketch_sync_")
        try:
            cls.results = _launch(cls._tmp.name)
        except AssertionError as err:
            if "address already in use" not in str(err).lower():
                raise
            cls.results = _launch(cls._tmp.name)

    @classmethod
    def tearDownClass(cls):
        cls._tmp.cleanup()

    def test_binary_curves_equal_the_single_stream(self):
        s, t = _stream(W.make_binary_shard)
        tp, fp, _ = JS.score_hist_fold(jnp.asarray(s), jnp.asarray(t), 16)
        auroc = J.BinaryAUROC(approx=True).update(s, t).compute()
        auprc = J.BinaryAUPRC(approx=True).update(s, t).compute()
        for res in self.results:
            np.testing.assert_array_equal(res["auroc_sketch_tp"], np.asarray(tp))
            np.testing.assert_array_equal(res["auroc_sketch_fp"], np.asarray(fp))
            self.assertEqual(res["auroc_staged_after_sync"], 0)  # the sync ships the sketch
            _close(res["auroc"], auroc)
            _close(res["auprc"], auprc)

    def test_multiclass_quantile_cat_hit_rate(self):
        x, lbl = _stream(W.make_mc_shard)
        mc = J.MulticlassAUPRC(num_classes=W.NUM_CLASSES, average=None, approx=True).update(x, lbl)
        s, _ = _stream(W.make_binary_shard)
        q = J.Quantile((0.1, 0.5, 0.9)).update(s)
        cat_v, cat_n = J.Cat(approx=1024).update(s).compute()
        rx, rt = _stream(W.make_rank_shard)
        hr = J.HitRate(k=3, approx=True).update(rx, rt).compute()
        for res in self.results:
            _close(res["mc_auprc"], mc.compute())
            _close(res["quantile"], q.compute())
            np.testing.assert_array_equal(res["quantile_counts"], np.asarray(q.bucket_counts))
            np.testing.assert_array_equal(np.asarray(res["cat_values"], np.float32), np.asarray(cat_v))
            np.testing.assert_array_equal(res["cat_counts"], np.asarray(cat_n))
            _close(res["hit_rate"], hr)

    def test_collection_is_two_rounds_and_nan_raises_everywhere(self):
        s, t = _stream(W.make_binary_shard)
        auroc = J.BinaryAUROC(approx=True).update(s, t).compute()
        q = J.Quantile(0.5).update(s).compute()
        for res in self.results:
            self.assertEqual(res["collection_rounds"], 2)
            _close(res["collection_auroc"], auroc)
            _close(res["collection_q"], q)
            self.assertTrue(res["nan_raised"])

    def test_sliced_sketch_member_equals_jax(self):
        ref = J.SlicedMetricCollection(
            {"acc": J.BinaryAccuracy(), "auroc": J.BinaryAUROC(approx=1024)},
            capacity=4, curve_bucket_bits=6)
        for r in range(WORLD):
            ref.update(*W.make_sliced_shard(r))
        want = ref.compute()["auroc"]
        ids = np.asarray(want["slice_ids"])
        order = np.argsort(ids)
        for res in self.results:
            self.assertEqual(res["sliced_ids"], ids[order].tolist())
            _close(res["sliced_auroc"], np.asarray(want["values"])[order])


if __name__ == "__main__":
    unittest.main()
