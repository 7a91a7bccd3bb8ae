"""The port's checkpoint/restore (``torcheval_tpu_torch/resilience/snapshot.py``):
every class of ``tests/resilience/test_snapshot.py`` on the port's metrics
(round trips bit-identical, the tricky containers, validation, atomicity
and rotation, the stale-tmp GC, obs counters, lineage fallback, discovery,
the quarantine/rotation interplay), then what is the port's own:

* checkpoints cross the packages both ways: a JAX-written checkpoint
  restores into the port and a port-written one into the JAX package, with
  the states equal as bytes and ``compute()`` equal (counts exactly, floats
  within atol 1e-8 / rtol 1e-5);
* a grown ``SlicedMetricCollection`` restores into a fresh one (the leading
  capacity dim may differ), in the port as in the JAX package;
* bfloat16 leaves: the port round-trips them bit for bit, and refuses the
  JAX package's (``'<V2'`` with no dtype named) with ``"unsupported"``;
* the rotation churn test reads its flag before it lists the directory, so
  it cannot race (the JAX test reads it after, and fails when the first
  save publishes in between).
"""

import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zipfile
from collections import deque
from unittest import mock

import numpy as np
import pytest
import torch

from torcheval_tpu_torch import obs
from torcheval_tpu_torch.metrics import (
    BinaryAUROC,
    MetricCollection,
    MulticlassAccuracy,
    Sum,
    Throughput,
    WindowedClickThroughRate,
)
from torcheval_tpu_torch.metrics.sample_cache import SampleCacheMetric
from torcheval_tpu_torch.resilience import (
    CheckpointError,
    latest_checkpoint,
    list_checkpoints,
    restore,
    save,
)
from torcheval_tpu_torch.resilience import snapshot as snapshot_mod
from torcheval_tpu_torch.utils.test_utils import DummySumDictStateMetric

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}
RNG = np.random.default_rng(7)
RTOL, ATOL = 1e-5, 1e-8


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _acc_batch(n=64, c=5, seed=None):
    rng = np.random.default_rng(seed) if seed is not None else RNG
    return rng.random((n, c)).astype(np.float32), rng.integers(0, c, n)


def _sum(*values):
    m = Sum(**CPU)
    for v in values:
        m.update(torch.tensor([float(v)]))
    return m


class _IntCache(SampleCacheMetric[torch.Tensor]):
    """Integer-cache fixture (the JAX test's)."""

    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_cache_state("ids")

    def update(self, ids):
        self.ids.append(self._input(ids))
        return self

    def compute(self) -> torch.Tensor:
        return self._concat_cache("ids", dtype=torch.int32)


@pytest.fixture
def ckdir():
    d = tempfile.mkdtemp(prefix="torch_ckpt_")
    yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def obs_on():
    obs.reset()
    obs.enable()
    yield obs
    obs.disable()
    obs.reset()


# ----------------------------------------------------------------- round trip
class TestRoundTrip:
    def test_bare_metric_mid_stream_bit_identical(self, ckdir):
        m = MulticlassAccuracy(num_classes=5, **CPU)
        x, t = _acc_batch()
        m.update(_t(x), _t(t))
        assert m._pending  # mid-window: save must fold first
        path = save(m, ckdir)
        assert m._pending == []  # folded, not dropped
        want = m.compute()
        fresh = restore(MulticlassAccuracy(num_classes=5, **CPU), path)
        assert torch.equal(fresh.compute(), want)
        x2, t2 = _acc_batch(16)
        fresh.update(_t(x2), _t(t2))
        ref = MulticlassAccuracy(num_classes=5, **CPU)
        ref.update(_t(np.concatenate([x, x2])), _t(np.concatenate([t, t2])))
        assert float(fresh.compute()) == pytest.approx(float(ref.compute()), abs=1e-6)

    def test_restore_from_parent_dir_takes_latest(self, ckdir):
        m = _sum(1.0)
        save(m, ckdir)
        m.update(torch.tensor([2.0]))
        save(m, ckdir)
        assert float(restore(Sum(**CPU), ckdir).compute()) == 3.0

    def test_mixed_metric_dict_round_trip_including_cache_and_dict(self, ckdir):
        acc, auroc, d = MulticlassAccuracy(num_classes=5, **CPU), BinaryAUROC(**CPU), DummySumDictStateMetric(**CPU)
        x, t = _acc_batch()
        acc.update(_t(x), _t(t))
        auroc.update(_t(RNG.random(33).astype(np.float32)), _t((RNG.random(33) > 0.4).astype(np.float32)))
        d.update("a", 2.0)
        d.update("b", 3.0)
        want_acc, want_auroc = acc.compute(), auroc.compute()
        save({"acc": acc, "auroc": auroc, "d": d}, ckdir)
        fresh = {"acc": MulticlassAccuracy(num_classes=5, **CPU), "auroc": BinaryAUROC(**CPU),
                 "d": DummySumDictStateMetric(**CPU)}
        restore(fresh, ckdir)
        assert torch.equal(fresh["acc"].compute(), want_acc)
        assert torch.equal(fresh["auroc"].compute(), want_auroc)
        assert float(fresh["d"].compute()) == 5.0
        # dict state keeps missing-key-is-zero semantics after restore
        fresh["d"].update("c", 1.0)
        assert float(fresh["d"].compute()) == 6.0

    def test_metric_collection_object_round_trip(self, ckdir):
        col = MetricCollection({"acc": MulticlassAccuracy(num_classes=5, **CPU)})
        x, t = _acc_batch()
        col.update(_t(x), _t(t))
        want = float(col.compute()["acc"])
        save(col, ckdir)
        fresh = restore(MetricCollection({"acc": MulticlassAccuracy(num_classes=5, **CPU)}), ckdir)
        assert float(fresh.compute()["acc"]) == want

    def test_sharded_evaluator_round_trip(self, ckdir):
        from torcheval_tpu_torch.parallel import ShardedEvaluator, data_parallel_mesh

        mesh = data_parallel_mesh(device="cpu")
        ev = ShardedEvaluator({"acc": MulticlassAccuracy(num_classes=5, **CPU)}, mesh=mesh)
        x, t = _acc_batch(64)
        ev.update(_t(x), _t(t))
        want = float(ev.compute()["acc"])  # a world of one: the local value
        save(ev, ckdir)
        fresh = ShardedEvaluator({"acc": MulticlassAccuracy(num_classes=5, **CPU)}, mesh=mesh)
        restore(fresh, ckdir)
        assert float(fresh.compute()["acc"]) == want
        fresh.update(_t(x), _t(t))
        assert float(fresh.compute()["acc"]) == pytest.approx(want, abs=1e-6)


class TestTrickyContainers:
    def test_window_deque_order_and_maxlen_preserved(self, ckdir):
        m = WindowedClickThroughRate(window_size=3, **CPU)
        for i in range(5):  # 5 updates > window 3: only the newest 3 survive
            m.update(torch.tensor([float(i % 2)] * 4))
        want_rows = [r.clone() for r in m.state_dict()["window"]]
        lifetime, windowed = m.compute()
        save(m, ckdir)
        fresh = restore(WindowedClickThroughRate(window_size=3, **CPU), ckdir)
        window = fresh.state_dict()["window"]
        assert window.maxlen == 3 and len(window) == 3
        for got, want in zip(window, want_rows):
            assert torch.equal(got, want)
        got_lifetime, got_windowed = fresh.compute()
        assert torch.equal(got_lifetime, lifetime) and torch.equal(got_windowed, windowed)
        # the bound still enforces after restore
        fresh.update(torch.tensor([1.0] * 4))
        window = fresh.state_dict()["window"]
        assert len(window) == 3 and torch.equal(window[0], want_rows[1])

    def test_sample_cache_empty_dtype_honored_on_restore(self, ckdir):
        save(_IntCache(**CPU), ckdir)
        out = restore(_IntCache(**CPU), ckdir).compute()
        assert out.shape == (0,) and out.dtype == torch.int32

    def test_sample_cache_chunks_round_trip(self, ckdir):
        m = _IntCache(**CPU)
        m.update(torch.tensor([3, 1, 2], dtype=torch.int32))
        m.update(torch.tensor([9, 8], dtype=torch.int32))
        save(m, ckdir)
        out = restore(_IntCache(**CPU), ckdir).compute()
        assert out.tolist() == [3, 1, 2, 9, 8] and out.dtype == torch.int32

    def test_throughput_max_elapsed_merge_unaffected_by_restore(self, ckdir):
        m = Throughput(**CPU)
        m.update(num_processed=100, elapsed_time_sec=4.0)
        save(m, ckdir)
        fresh = restore(Throughput(**CPU), ckdir)
        peer = Throughput(**CPU)
        peer.update(num_processed=200, elapsed_time_sec=2.0)
        fresh.merge_state([peer])
        assert float(fresh.num_total) == 300.0
        assert float(fresh.elapsed_time_sec) == 4.0
        assert float(fresh.compute()) == 75.0


class TestValidation:
    def _saved_sum(self, ckdir):
        return save(_sum(5.0), ckdir)

    def test_missing_checkpoint_not_found(self, ckdir):
        with pytest.raises(CheckpointError) as ctx:
            restore(Sum(**CPU), os.path.join(ckdir, "nope"))
        assert ctx.value.reason == "not_found"

    def test_corrupted_payload_rejected(self, ckdir):
        path = self._saved_sum(ckdir)
        with open(os.path.join(path, "state.npz"), "r+b") as f:
            f.seek(12)
            f.write(b"\xde\xad\xbe\xef")
        with pytest.raises(CheckpointError) as ctx:
            restore(Sum(**CPU), path)
        assert ctx.value.reason == "checksum_mismatch"

    def test_corrupted_manifest_rejected(self, ckdir):
        path = self._saved_sum(ckdir)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            f.write("{not json")
        with pytest.raises(CheckpointError) as ctx:
            restore(Sum(**CPU), path)
        assert ctx.value.reason == "corrupt_manifest"

    @pytest.mark.parametrize("field", ["format_version", "schema_digest", "payload_sha256", "entries"])
    def test_manifest_missing_field_rejected(self, ckdir, field):
        path = self._saved_sum(ckdir)
        mpath = os.path.join(path, "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        del manifest[field]
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        with pytest.raises(CheckpointError) as ctx:
            restore(Sum(**CPU), path)
        assert ctx.value.reason == "corrupt_manifest"

    def test_unknown_format_version_rejected(self, ckdir):
        path = self._saved_sum(ckdir)
        mpath = os.path.join(path, "manifest.json")
        with open(mpath) as f:
            manifest = json.load(f)
        manifest["format_version"] = 2
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        with pytest.raises(CheckpointError) as ctx:
            restore(Sum(**CPU), path)
        assert ctx.value.reason == "corrupt_manifest"

    def test_schema_mismatch_different_metric_set(self, ckdir):
        self._saved_sum(ckdir)
        with pytest.raises(CheckpointError) as ctx:
            restore(MulticlassAccuracy(num_classes=5, **CPU), ckdir)
        assert ctx.value.reason == "schema_mismatch"

    def test_schema_mismatch_window_config_drift(self, ckdir):
        m = WindowedClickThroughRate(window_size=4, **CPU)
        m.update(torch.tensor([1.0]))
        save(m, ckdir)
        with pytest.raises(CheckpointError) as ctx:
            restore(WindowedClickThroughRate(window_size=5, **CPU), ckdir)
        assert ctx.value.reason == "schema_mismatch"

    def test_shape_drift_within_same_schema_rejected(self, ckdir):
        m = MulticlassAccuracy(num_classes=5, average="macro", **CPU)
        x, t = _acc_batch()
        m.update(_t(x), _t(t))
        save(m, ckdir)
        target = MulticlassAccuracy(num_classes=4, average="macro", **CPU)
        before = {k: v.clone() for k, v in target.state_dict().items()}
        with pytest.raises(CheckpointError) as ctx:
            restore(target, ckdir)
        assert ctx.value.reason == "schema_mismatch"
        for k, v in target.state_dict().items():
            assert torch.equal(v, before[k]), k

    def test_failed_validation_precedes_any_state_write(self, ckdir):
        path = self._saved_sum(ckdir)
        with open(os.path.join(path, "state.npz"), "r+b") as f:
            f.seek(12)
            f.write(b"\xde\xad\xbe\xef")
        target = _sum(42.0)
        with pytest.raises(CheckpointError):
            restore(target, path)
        assert float(target.compute()) == 42.0

    def test_unsupported_holder_and_dict_keys(self, ckdir):
        with pytest.raises(TypeError):
            save(object(), ckdir)
        d = DummySumDictStateMetric(**CPU)
        d.update(("tuple", "key"), 1.0)
        with pytest.raises(CheckpointError) as ctx:
            save(d, ckdir)
        assert ctx.value.reason == "unsupported"
        assert list_checkpoints(ckdir) == []

    def test_read_extra(self, ckdir):
        path = save(_sum(1.0), ckdir, extra={"watermark": 7})
        assert snapshot_mod.read_extra(path) == {"watermark": 7}
        assert snapshot_mod.read_extra(ckdir) == {"watermark": 7}
        save(_sum(1.0), ckdir)
        assert snapshot_mod.read_extra(ckdir) == {}


class TestAtomicityAndRotation:
    def test_crash_between_temp_write_and_rename_publishes_nothing(self, ckdir):
        m = _sum(1.0)
        real_replace = os.replace

        def crash(src, dst):
            raise OSError("simulated crash before rename")

        with mock.patch.object(snapshot_mod.os, "replace", crash):
            with pytest.raises(OSError):
                save(m, ckdir)
        assert list_checkpoints(ckdir) == [] and latest_checkpoint(ckdir) is None
        with pytest.raises(CheckpointError) as ctx:
            restore(Sum(**CPU), ckdir)
        assert ctx.value.reason == "not_found"
        with mock.patch.object(snapshot_mod.os, "replace", real_replace):
            path = save(m, ckdir)
        assert float(restore(Sum(**CPU), path).compute()) == 1.0

    def test_stray_tmp_dirs_are_invisible_to_readers(self, ckdir):
        os.makedirs(os.path.join(ckdir, ".tmp-ckpt-00000007-123"))
        assert list_checkpoints(ckdir) == []
        save(_sum(2.0), ckdir)
        assert len(list_checkpoints(ckdir)) == 1

    def test_keep_last_rotation(self, ckdir):
        m = Sum(**CPU)
        for _ in range(4):
            m.update(torch.tensor([1.0]))
            save(m, ckdir, keep_last=2)
        ckpts = list_checkpoints(ckdir)
        assert len(ckpts) == 2 and ckpts[-1].endswith("ckpt-00000003")
        assert float(restore(Sum(**CPU), ckdir).compute()) == 4.0

    def test_step_numbering_monotonic_after_rotation(self, ckdir):
        m = _sum(1.0)
        for _ in range(3):
            save(m, ckdir, keep_last=1)
        assert latest_checkpoint(ckdir).endswith("ckpt-00000002")

    def test_invalid_keep_last_rejected_before_any_write(self, ckdir):
        with pytest.raises(ValueError, match="keep_last"):
            save(Sum(**CPU), ckdir, keep_last=0)
        assert list_checkpoints(ckdir) == []

    def test_explicit_step_collision_rejected(self, ckdir):
        m = Sum(**CPU)
        save(m, ckdir, step=3)
        with pytest.raises(CheckpointError):
            save(m, ckdir, step=3)


class TestStaleTmpGC:
    def _crashed_writer_tmp(self, ckdir) -> str:
        """A LITERAL crash between temp write and rename in a child process
        (``os.replace`` swapped for ``os._exit``): the orphaned tmp path,
        whose writer pid is provably dead."""
        script = (
            "import os, sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import torch\n"
            "from torcheval_tpu_torch.metrics import Sum\n"
            "from torcheval_tpu_torch.resilience import snapshot as snap\n"
            "m = Sum(device='cpu'); m.update(torch.tensor([1.0]))\n"
            "snap.os.replace = lambda s, d: os._exit(7)\n"
            "snap.save(m, sys.argv[1])\n"
        )
        proc = subprocess.run([sys.executable, "-c", script, ckdir], capture_output=True, timeout=120)
        assert proc.returncode == 7, proc.stderr.decode()[-2000:]
        tmps = [n for n in os.listdir(ckdir) if n.startswith(".tmp-")]
        assert len(tmps) == 1
        pid = snapshot_mod._tmp_writer_pid(tmps[0])
        assert pid is not None
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
        return os.path.join(ckdir, tmps[0])

    def test_next_save_reclaims_crash_orphaned_tmp(self, ckdir, obs_on):
        orphan = self._crashed_writer_tmp(ckdir)
        save(_sum(2.0), ckdir)
        assert not os.path.exists(orphan)
        assert obs.snapshot()["counters"]["resilience.checkpoint.tmp_gc"] == 1.0
        assert float(restore(Sum(**CPU), ckdir).compute()) == 2.0

    def test_live_writers_tmp_dirs_left_alone(self, ckdir):
        sleeper = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
        try:
            live_tmp = os.path.join(ckdir, f".tmp-ckpt-00000009-{sleeper.pid}")
            own_tmp = os.path.join(ckdir, f".tmp-ckpt-00000010-{os.getpid()}")
            os.makedirs(live_tmp)
            os.makedirs(own_tmp)
            save(_sum(1.0), ckdir)
            assert os.path.exists(live_tmp) and os.path.exists(own_tmp)
        finally:
            sleeper.kill()
            sleeper.wait()

    def test_unparseable_pid_falls_back_to_mtime_age(self, ckdir):
        fresh_tmp = os.path.join(ckdir, ".tmp-upload-123")
        old_tmp = os.path.join(ckdir, ".tmp-ckpt-older-garbage")
        assert snapshot_mod._tmp_writer_pid(".tmp-upload-123") is None
        assert snapshot_mod._tmp_writer_pid(".tmp-ckpt-00000010") is None
        os.makedirs(fresh_tmp)
        os.makedirs(old_tmp)
        stale = time.time() - 2 * snapshot_mod._TMP_GC_MIN_AGE_S
        os.utime(old_tmp, (stale, stale))
        save(_sum(1.0), ckdir)
        assert os.path.exists(fresh_tmp) and not os.path.exists(old_tmp)


class TestRotationUnderChurn:
    def test_concurrent_reader_never_observes_zero_checkpoints(self, ckdir):
        errors = []
        stop = threading.Event()
        first_saved = threading.Event()

        def reader():
            while not stop.is_set():
                # the flag is read BEFORE the listing: a save that publishes
                # between the two can then only make the listing newer
                saved = first_saved.is_set()
                path = latest_checkpoint(ckdir)
                if path is None:
                    if saved:
                        errors.append("latest_checkpoint returned None")
                    continue
                try:
                    with open(os.path.join(path, "manifest.json")) as f:
                        json.load(f)
                except (FileNotFoundError, json.JSONDecodeError):
                    # rotated away between list and open: a NEWER latest exists
                    newer = latest_checkpoint(ckdir)
                    if newer is None or newer <= path:
                        errors.append(f"latest regressed: {path} -> {newer}")

        t = threading.Thread(target=reader)
        t.start()
        try:
            m = Sum(**CPU)
            for _ in range(30):
                m.update(torch.tensor([1.0]))
                path = save(m, ckdir, keep_last=2)
                first_saved.set()
                assert os.path.isdir(path)
                ckpts = list_checkpoints(ckdir)
                assert len(ckpts) <= 2 and ckpts[-1] == path
        finally:
            stop.set()
            t.join(30)
        assert errors == []
        assert float(restore(Sum(**CPU), ckdir).compute()) == 30.0

    def test_flag_after_listing_is_the_race(self, ckdir):
        # the JAX test's order, made deterministic: the listing is taken
        # before the first publish and the flag read after it
        path = latest_checkpoint(ckdir)
        save(_sum(1.0), ckdir, keep_last=2)
        assert path is None and latest_checkpoint(ckdir) is not None

    def test_rapid_resume_cycles_rotate_and_resume(self, ckdir):
        # every cycle restores the newest generation into a fresh metric,
        # streams one batch and saves again with keep_last=2
        rng = np.random.default_rng(21)
        batches = [(rng.random((16, 5)).astype(np.float32), rng.integers(0, 5, 16)) for _ in range(6)]
        oracle = MulticlassAccuracy(num_classes=5, **CPU)
        save(MulticlassAccuracy(num_classes=5, **CPU), ckdir, keep_last=2)
        for s, l in batches:
            m = restore(MulticlassAccuracy(num_classes=5, **CPU), ckdir)
            m.update(_t(s), _t(l))
            oracle.update(_t(s), _t(l))
            save(m, ckdir, keep_last=2)
            assert len(list_checkpoints(ckdir)) <= 2
        got = restore(MulticlassAccuracy(num_classes=5, **CPU), ckdir)
        assert torch.equal(got.compute(), oracle.compute())


class TestObsCounters:
    def test_save_restore_counters_spans_and_timeline(self, ckdir, obs_on):
        path = save(_sum(1.0), ckdir)
        restore(Sum(**CPU), path)
        snap = obs.snapshot()
        assert snap["counters"]["resilience.checkpoint.saves"] == 1.0
        assert snap["counters"]["resilience.checkpoint.restores"] == 1.0
        assert snap["counters"]["resilience.checkpoint.bytes"] > 0.0
        assert snap["spans"]["resilience.checkpoint.save"]["count"] == 1
        assert snap["spans"]["resilience.checkpoint.restore"]["count"] == 1
        # the metrics' own spans and the watchdog's instants ride the same
        # timeline; the checkpoint's events come in this order
        names = [e["name"] for e in obs.timeline_events() if e["name"].startswith("resilience.")]
        assert names == ["resilience.checkpoint.save", "resilience.checkpoint.published",
                         "resilience.checkpoint.restore", "resilience.checkpoint.restored"]

    def test_disabled_records_nothing(self, ckdir):
        obs.reset()
        restore(Sum(**CPU), save(_sum(1.0), ckdir))
        assert obs.snapshot()["counters"] == {} and obs.timeline_events() == []


def _corrupt_manifest(ckpt):
    with open(os.path.join(ckpt, "manifest.json"), "w") as f:
        f.write('{"truncated mid-wr')


def _flip_payload_byte(ckpt):
    path = os.path.join(ckpt, "state.npz")
    with open(path, "r+b") as f:
        f.seek(12)
        byte = f.read(1)
        f.seek(12)
        f.write(bytes([byte[0] ^ 0xFF]))


class TestLineageFallback:
    def _saved_sums(self, ckdir, *values):
        m = Sum(**CPU)
        for v in values:
            m.update(torch.tensor([float(v)]))
            save(m, ckdir)
        return m

    def test_falls_back_past_corrupt_newest_and_quarantines(self, ckdir, obs_on):
        self._saved_sums(ckdir, 1.0, 2.0)  # gen1 holds 1.0, gen2 holds 3.0
        ckpts = list_checkpoints(ckdir)
        _flip_payload_byte(ckpts[-1])
        target = Sum(**CPU)
        assert snapshot_mod.restore_latest_valid(target, ckdir) == ckpts[0]
        assert float(target.compute()) == 1.0
        assert list_checkpoints(ckdir) == [ckpts[0]]
        corrupt = [n for n in os.listdir(ckdir) if n.startswith("corrupt-")]
        assert len(corrupt) == 1 and os.path.exists(os.path.join(ckdir, corrupt[0], "state.npz"))
        counters = obs.snapshot()["counters"]
        assert counters["resilience.checkpoint.corrupt_quarantined"] == 1.0
        assert counters["resilience.checkpoint.fallback_restores"] == 1.0

    def test_chaos_ckpt_corrupt_drives_the_fallback(self, ckdir, obs_on):
        from torcheval_tpu_torch.resilience import chaos

        env = {"TORCHEVAL_TPU_CHAOS": "1", "TORCHEVAL_TPU_CHAOS_ACTION": "ckpt_corrupt",
               "TORCHEVAL_TPU_CHAOS_TENANT": os.path.basename(ckdir), "TORCHEVAL_TPU_CHAOS_STEP": "2"}
        with mock.patch.dict(os.environ, env):
            chaos.reset_for_tests()
            try:
                self._saved_sums(ckdir, 1.0, 2.0)
            finally:
                chaos.reset_for_tests()
        first, second = list_checkpoints(ckdir)
        with pytest.raises(CheckpointError) as ctx:
            restore(Sum(**CPU), second)
        assert ctx.value.reason in ("checksum_mismatch", "corrupt_payload")
        target = Sum(**CPU)
        assert snapshot_mod.restore_latest_valid(target, ckdir) == first
        assert float(target.compute()) == 1.0
        assert obs.snapshot()["counters"]["resilience.checkpoint.fallback_restores"] == 1.0

    def test_every_generation_corrupt_raises_not_found(self, ckdir):
        self._saved_sums(ckdir, 1.0, 2.0)
        for ckpt in list_checkpoints(ckdir):
            _corrupt_manifest(ckpt)
        with pytest.raises(CheckpointError) as ctx:
            snapshot_mod.restore_latest_valid(Sum(**CPU), ckdir)
        assert ctx.value.reason == "not_found"
        assert len([n for n in os.listdir(ckdir) if n.startswith("corrupt-")]) == 2

    def test_schema_mismatch_raises_without_quarantining(self, ckdir):
        self._saved_sums(ckdir, 1.0)
        with pytest.raises(CheckpointError) as ctx:
            snapshot_mod.restore_latest_valid(MulticlassAccuracy(num_classes=5, **CPU), ckdir)
        assert ctx.value.reason == "schema_mismatch"
        assert len(list_checkpoints(ckdir)) == 1
        assert [n for n in os.listdir(ckdir) if n.startswith("corrupt-")] == []


class TestDiscoveryHardening:
    def _tenant(self, ckdir, name, gens=1):
        sub = os.path.join(ckdir, name)
        m = Sum(**CPU)
        for _ in range(gens):
            m.update(torch.tensor([1.0]))
            save(m, sub)
        return sub

    def test_corrupt_manifest_skipped_and_counted(self, ckdir, obs_on):
        good = self._tenant(ckdir, "good")
        bad = self._tenant(ckdir, "bad", gens=2)
        ckpts = list_checkpoints(bad)
        _corrupt_manifest(ckpts[-1])
        found = snapshot_mod.discover_checkpoints(ckdir)
        assert found["bad"] == ckpts[0]
        assert found["good"] == list_checkpoints(good)[-1]
        key = "resilience.checkpoint.corrupt_skipped{reason=corrupt_manifest}"
        assert obs.snapshot()["counters"][key] == 1.0

    def test_tenant_with_no_readable_generation_is_omitted(self, ckdir):
        self._tenant(ckdir, "good")
        bad = self._tenant(ckdir, "bad")
        _corrupt_manifest(list_checkpoints(bad)[-1])
        assert sorted(snapshot_mod.discover_checkpoints(ckdir)) == ["good"]
        assert snapshot_mod.discover_checkpoints(os.path.join(ckdir, "missing")) == {}


class TestQuarantineRotationInterplay:
    def test_rotation_spares_the_last_valid_generation(self, ckdir):
        m = Sum(**CPU)
        for _ in range(3):
            m.update(torch.tensor([1.0]))
            save(m, ckdir)
        gen1, gen2, gen3 = list_checkpoints(ckdir)
        _corrupt_manifest(gen2)
        _corrupt_manifest(gen3)
        snapshot_mod.rotate_checkpoints(ckdir, keep_last=2)
        assert os.path.exists(gen1)
        assert snapshot_mod.restore_latest_valid(Sum(**CPU), ckdir) == gen1

    def test_quarantine_survives_rapid_save_churn(self, ckdir):
        m = _sum(1.0)
        save(m, ckdir)
        quarantined = snapshot_mod.quarantine_checkpoint(list_checkpoints(ckdir)[-1])
        dead_tmp = os.path.join(ckdir, ".tmp-ckpt-00000099-999999999")
        os.makedirs(dead_tmp)
        for _ in range(30):
            m.update(torch.tensor([1.0]))
            save(m, ckdir, keep_last=2)
        assert os.path.exists(quarantined) and not os.path.exists(dead_tmp)
        assert len(list_checkpoints(ckdir)) <= 2
        snapshot_mod.restore_latest_valid(Sum(**CPU), ckdir)

    def test_quarantine_collision_names_are_unique(self, ckdir):
        m = Sum(**CPU)
        for _ in range(2):
            m.update(torch.tensor([1.0]))
            save(m, ckdir)
        first, second = list_checkpoints(ckdir)
        q1 = snapshot_mod.quarantine_checkpoint(first)
        os.rename(second, first)
        q2 = snapshot_mod.quarantine_checkpoint(first)
        assert q1 != q2 and os.path.exists(q1) and os.path.exists(q2)
        assert snapshot_mod.quarantine_checkpoint(first) is None  # vanished


# -------------------------------------------------------------- the format
def test_npz_members_equal_numpy_savez(ckdir):
    arrays = {"a0": RNG.random((3, 4)).astype(np.float32), "a1": np.asarray(7, np.int32),
              "a2": np.zeros((0, 2), np.int64), "a3": RNG.random(5) > 0.5}
    mine = os.path.join(ckdir, "mine.npz")
    snapshot_mod._write_npz(mine, arrays, set())
    ref = io.BytesIO()
    np.savez(ref, **arrays)
    with zipfile.ZipFile(mine) as a, zipfile.ZipFile(io.BytesIO(ref.getvalue())) as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
            assert a.getinfo(name).compress_type == zipfile.ZIP_STORED


def test_manifest_layout_is_the_jax_packages(ckdir):
    m = MulticlassAccuracy(num_classes=5, **CPU)
    x, t = _acc_batch()
    m.update(_t(x), _t(t))
    path = save(m, ckdir, step=4)
    assert os.path.basename(path) == "ckpt-00000004"
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format_version"] == 1 and manifest["payload"] == "state.npz"
    assert manifest["metrics"] == {"metric": "MulticlassAccuracy"}
    assert manifest["entries"] == [
        {"metric": "metric", "state": "num_correct", "kind": "array", "leaves": ["a0"]},
        {"metric": "metric", "state": "num_total", "kind": "array", "leaves": ["a1"]},
    ]
    from torcheval_tpu_torch.metrics.toolkit import _schema_digest_row

    assert manifest["schema_digest"] == [int(v) for v in _schema_digest_row({"metric": m})]


# ------------------------------------------------------------------ bfloat16
def _bf16_auroc(pkg="port"):
    scores, targets = [0.1, 0.7, 0.3, 0.30078125], [0, 1, 1, 0]
    if pkg == "jax":
        import jax.numpy as jnp

        from torcheval_tpu.metrics import BinaryAUROC as JaxAUROC

        m = JaxAUROC()
        m.update(jnp.asarray(scores, jnp.bfloat16), jnp.asarray(targets))
        return m
    m = BinaryAUROC(**CPU)
    m.update(torch.tensor(scores, dtype=torch.bfloat16), torch.tensor(targets))
    return m


def test_bfloat16_cache_round_trips_bit_for_bit(ckdir):
    m = _bf16_auroc()
    path = save(m, ckdir)
    with open(os.path.join(path, "manifest.json")) as f:
        entry = json.load(f)["entries"][0]
    assert entry["state"] == "inputs" and entry["dtypes"] == ["bfloat16"]
    with zipfile.ZipFile(os.path.join(path, "state.npz")) as zf:
        assert b"'descr': '<V2'" in zf.read("a0.npy")[:128]
    fresh = restore(BinaryAUROC(**CPU), path)
    got, want = fresh.state_dict()["inputs"], m.state_dict()["inputs"]
    assert len(got) == len(want) == 1 and got[0].dtype == torch.bfloat16
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
    assert torch.equal(fresh.compute(), m.compute())


def test_jax_written_bfloat16_leaf_is_refused_as_unsupported(ckdir):
    from torcheval_tpu.resilience import save as jax_save

    path = jax_save(_bf16_auroc("jax"), ckdir)
    target = BinaryAUROC(**CPU)
    with pytest.raises(CheckpointError) as ctx:
        restore(target, path)
    assert ctx.value.reason == "unsupported" and "'inputs'" in str(ctx.value)
    assert target.state_dict()["inputs"] == []  # nothing installed


def test_jax_package_cannot_restore_its_own_bfloat16_leaf(ckdir):
    # the reference fault the port does not carry over
    from torcheval_tpu.metrics import BinaryAUROC as JaxAUROC
    from torcheval_tpu.resilience import restore as jax_restore
    from torcheval_tpu.resilience import save as jax_save

    path = jax_save(_bf16_auroc("jax"), ckdir)
    with pytest.raises(TypeError):
        jax_restore(JaxAUROC(), path)


# --------------------------------------------------------- grown sliced
def _sliced_pair(M, kw, capacity=None, agg=False):
    cap = {} if capacity is None else {"capacity": capacity}
    if agg:
        return M.SlicedMetricCollection({"mean": M.Mean(**kw), "max": M.Max(**kw)}, **cap)
    return M.SlicedMetricCollection(
        {"acc": M.BinaryAccuracy(**kw), "auroc": M.BinaryAUROC(approx=1024, **kw)},
        curve_bucket_bits=4, **cap)


def _sliced_batches(n_unique=1500, n=3000, seed=3):
    rng = np.random.default_rng(seed)
    pool = np.arange(n_unique, dtype=np.int64) * 7919 + 13
    out = []
    for _ in range(2):
        ids = np.concatenate([pool, rng.choice(pool, n - n_unique)]) if not out else rng.choice(pool, n)
        out.append((ids, rng.random(n).astype(np.float32), (rng.random(n) < 0.4).astype(np.float32)))
    return out


@pytest.mark.parametrize("agg", [False, True], ids=["acc_sketch", "mean_max"])
def test_grown_sliced_collection_restores_into_a_fresh_one(ckdir, agg):
    import torcheval_tpu_torch.metrics as M

    col = _sliced_pair(M, CPU, capacity=4, agg=agg)
    batches = _sliced_batches()
    for ids, s, t in batches[:1]:
        col.update(ids, _t(s)) if agg else col.update(ids, _t(s), _t(t))
    grown = col.slice_table.capacity
    fresh = _sliced_pair(M, CPU, agg=agg)
    assert fresh.slice_table.capacity < grown
    restore(fresh, save(col, ckdir))
    assert fresh.slice_table.capacity == grown
    for ids, s, t in batches[1:]:
        for c in (col, fresh):
            c.update(ids, _t(s)) if agg else c.update(ids, _t(s), _t(t))
    a, b = col.compute(), fresh.compute()
    for name in a:
        assert np.array_equal(a[name].slice_ids, b[name].slice_ids)
        assert torch.equal(a[name]["values"], b[name]["values"]), name


def test_sliced_restore_without_the_repair_is_refused(ckdir):
    import torcheval_tpu_torch.metrics as M

    col = _sliced_pair(M, CPU, capacity=4)
    ids, s, t = _sliced_batches()[0]
    col.update(ids, _t(s), _t(t))
    path = save(col, ckdir)
    fresh = _sliced_pair(M, CPU)
    for m in fresh.metrics.values():
        m._lead_resizable_states = frozenset()
    with pytest.raises(CheckpointError) as ctx:
        restore(fresh, path)
    assert ctx.value.reason == "schema_mismatch"


def test_jax_package_restores_its_own_grown_sliced_collection(ckdir):
    import jax.numpy as jnp

    import torcheval_tpu.metrics as J
    from torcheval_tpu.resilience import restore as jax_restore
    from torcheval_tpu.resilience import save as jax_save

    col = _sliced_pair(J, {}, capacity=4)
    ids, s, t = _sliced_batches()[0]
    col.update(ids, jnp.asarray(s), jnp.asarray(t))
    fresh = _sliced_pair(J, {})
    assert fresh.slice_table.capacity < col.slice_table.capacity
    jax_restore(fresh, jax_save(col, ckdir))
    a, b = col.compute(), fresh.compute()
    for name in a:
        np.testing.assert_array_equal(np.asarray(a[name]["values"]), np.asarray(b[name]["values"]))


# ---------------------------------------------------------- cross-package
def _np_leaf(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    return np.asarray(x)


def _state_leaves(metrics):
    """``{(metric, state): [host arrays]}`` of every state, in the order
    the checkpoint flattens them."""
    out = {}
    for mkey, m in metrics.items():
        sd = m.state_dict()
        for name in m._state_name_to_reduction:
            v = sd[name]
            if isinstance(v, (list, deque)):
                leaves = [_np_leaf(x) for x in v]
                if isinstance(v, deque):
                    leaves.append(("maxlen", v.maxlen))
            elif isinstance(v, dict):
                leaves = [(k, _np_leaf(x)) for k, x in v.items()]
            else:
                leaves = [_np_leaf(v)]
            out[(mkey, name)] = leaves
    return out


_X64_TO_X32 = {np.dtype(np.int64): np.dtype(np.int32), np.dtype(np.float64): np.dtype(np.float32),
               np.dtype(np.uint64): np.dtype(np.uint32)}


def _assert_states_equal_as_bytes(a, b, into_jax=False):
    """``a`` (the restored states) equal to ``b`` (the saved ones) as
    bytes. ``into_jax``: the JAX package installs a 64-bit leaf at 32 bits
    (its ``jax_enable_x64`` rule, ``torcheval_tpu/resilience/snapshot.py``'s
    module doc); such a leaf must then equal the saved one cast, exactly."""
    assert list(a) == list(b)
    for key in a:
        assert len(a[key]) == len(b[key]), key
        for x, y in zip(a[key], b[key]):
            if isinstance(x, tuple):
                assert x[0] == y[0], key
                x, y = x[1], y[1]
                if not isinstance(x, np.ndarray):
                    assert x == y, key
                    continue
            if into_jax and _X64_TO_X32.get(y.dtype) == x.dtype:
                narrowed = y.astype(x.dtype)
                assert np.array_equal(narrowed.astype(y.dtype), y), key  # exact in 32 bits
                y = narrowed
            assert x.dtype == y.dtype and x.shape == y.shape, (key, x.dtype, y.dtype, x.shape, y.shape)
            assert x.tobytes() == y.tobytes(), key


def _flat_values(v):
    if isinstance(v, dict):
        out = []
        for k in v:
            if k == "slice_ids":
                out.append(np.asarray(v[k]))
            else:
                out.extend(_flat_values(v[k]))
        if hasattr(v, "slice_ids"):
            out.append(np.asarray(v.slice_ids))
        return out
    if isinstance(v, (list, tuple)):
        return [x for item in v for x in _flat_values(item)]
    return [_np_leaf(v)]


def _assert_compute_close(got, want):
    g, w = _flat_values(got), _flat_values(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        if x.dtype.kind in "iub" and y.dtype.kind in "iub":
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x.astype(np.float64), y.astype(np.float64), rtol=RTOL, atol=ATOL)


class _Case:
    """One cross-package case: how to build the holder in a package, and
    its batches as numpy tuples (each fed through ``update``)."""

    def __init__(self, build, batches, feed=None):
        self.build, self.batches, self._feed = build, batches, feed

    def feed(self, holder, pkg):
        conv = _jax_array if pkg == "jax" else _t
        for b in self.batches:
            if self._feed is not None:
                self._feed(holder, b, conv)
            else:
                holder.update(*(conv(x) for x in b))


def _jax_array(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def _pkg(pkg):
    if pkg == "jax":
        import torcheval_tpu.metrics as J

        return J, {}
    import torcheval_tpu_torch.metrics as T

    return T, CPU


def _metrics_of(holder):
    if hasattr(holder, "metrics"):
        return dict(holder.metrics)
    if isinstance(holder, dict):
        return holder
    return {"metric": holder}


def _rng_batches(seed, make, n=4):
    rng = np.random.default_rng(seed)
    return [make(rng) for _ in range(n)]


def _scores_labels(rng, n=48, c=5):
    return rng.random((n, c)).astype(np.float32), rng.integers(0, c, n)


def _binary(rng, n=48):
    return rng.random(n).astype(np.float32), (rng.random(n) < 0.4).astype(np.float32)


def _evaluator(M, kw, pkg):
    if pkg == "jax":
        from torcheval_tpu.parallel import ShardedEvaluator

        return ShardedEvaluator({"acc": M.MulticlassAccuracy(num_classes=5),
                                 "auroc": M.MulticlassAUROC(num_classes=5)})
    from torcheval_tpu_torch.parallel import ShardedEvaluator, data_parallel_mesh

    return ShardedEvaluator({"acc": M.MulticlassAccuracy(num_classes=5, **kw),
                             "auroc": M.MulticlassAUROC(num_classes=5, **kw)},
                            mesh=data_parallel_mesh(device="cpu"))


def _sliced_feed(holder, b, conv):
    ids, s, t = b
    holder.update(ids, conv(s), conv(t))


def _sliced_agg_feed(holder, b, conv):
    ids, s, _ = b
    holder.update(ids, conv(s))


def _throughput_feed(holder, b, conv):
    holder.update(num_processed=int(b[0]), elapsed_time_sec=float(b[1]))


CASES = {
    # the headline pair after one compaction (threshold 64 rows, 4 x 48)
    "headline_pair_compacted": _Case(
        lambda M, kw, pkg: {"acc": M.MulticlassAccuracy(num_classes=5, **kw),
                            "auroc": M.BinaryAUROC(compaction_threshold=64, **kw)},
        _rng_batches(1, lambda r: (*_scores_labels(r), *_binary(r))),
        lambda h, b, conv: (h["acc"].update(conv(b[0]), conv(b[1])),
                            h["auroc"].update(conv(b[2]), conv(b[3])))),
    "windowed_weighted_calibration": _Case(
        lambda M, kw, pkg: M.WindowedWeightedCalibration(num_tasks=2, window_size=3, **kw),
        _rng_batches(2, lambda r: (r.random((2, 16)).astype(np.float32),
                                   (r.random((2, 16)) < 0.3).astype(np.float32),
                                   r.random((2, 16)).astype(np.float32)), n=5)),
    "quantile_and_approx_auroc": _Case(
        lambda M, kw, pkg: {"q": M.Quantile(**kw), "auroc": M.BinaryAUROC(approx=True, **kw)},
        _rng_batches(3, lambda r: (r.standard_normal(64).astype(np.float32), *_binary(r, 64))),
        lambda h, b, conv: (h["q"].update(conv(b[0])), h["auroc"].update(conv(b[1]), conv(b[2])))),
    "throughput": _Case(
        lambda M, kw, pkg: M.Throughput(**kw),
        [(100, 4.0), (250, 1.5), (7, 9.25)], _throughput_feed),
    "grown_sliced_collection": _Case(
        lambda M, kw, pkg: _sliced_pair(M, kw, capacity=4),
        _sliced_batches(), _sliced_feed),
    "grown_sliced_mean_max": _Case(
        lambda M, kw, pkg: _sliced_pair(M, kw, capacity=4, agg=True),
        _sliced_batches(seed=4), _sliced_agg_feed),
    "sharded_evaluator": _Case(
        lambda M, kw, pkg: _evaluator(M, kw, pkg),
        _rng_batches(5, lambda r: _scores_labels(r, 64), n=3)),
    # the metrics whose schema rows are equal in both packages
    "MulticlassAccuracy": _Case(lambda M, kw, pkg: M.MulticlassAccuracy(num_classes=5, **kw),
                                _rng_batches(6, _scores_labels)),
    "BinaryAUROC": _Case(lambda M, kw, pkg: M.BinaryAUROC(**kw), _rng_batches(7, _binary)),
    "BinaryAUPRC": _Case(lambda M, kw, pkg: M.BinaryAUPRC(**kw), _rng_batches(8, _binary)),
    "MulticlassAUROC": _Case(lambda M, kw, pkg: M.MulticlassAUROC(num_classes=5, **kw),
                             _rng_batches(9, _scores_labels)),
    "Mean": _Case(lambda M, kw, pkg: M.Mean(**kw),
                  _rng_batches(10, lambda r: (r.random(32).astype(np.float32),))),
    "Max": _Case(lambda M, kw, pkg: M.Max(**kw),
                 _rng_batches(11, lambda r: (r.standard_normal(32).astype(np.float32),))),
    "Quantile": _Case(lambda M, kw, pkg: M.Quantile(q=(0.1, 0.5, 0.9), **kw),
                      _rng_batches(12, lambda r: (r.random(64).astype(np.float32),))),
    "BinaryNormalizedEntropy": _Case(
        lambda M, kw, pkg: M.BinaryNormalizedEntropy(num_tasks=2, **kw),
        _rng_batches(13, lambda r: (r.uniform(0.01, 0.99, (2, 32)).astype(np.float32),
                                    (r.random((2, 32)) < 0.3).astype(np.float32)))),
    "WeightedCalibration": _Case(
        lambda M, kw, pkg: M.WeightedCalibration(**kw),
        _rng_batches(14, lambda r: (r.random(32).astype(np.float32),
                                    (r.random(32) < 0.3).astype(np.float32)))),
    "ClickThroughRate": _Case(
        lambda M, kw, pkg: M.ClickThroughRate(**kw),
        _rng_batches(15, lambda r: ((r.random(32) < 0.2).astype(np.float32),
                                    r.random(32).astype(np.float32)))),
    "R2Score": _Case(lambda M, kw, pkg: M.R2Score(**kw),
                     _rng_batches(16, lambda r: (r.random(32).astype(np.float32),
                                                 r.random(32).astype(np.float32)))),
    "MulticlassConfusionMatrix": _Case(
        lambda M, kw, pkg: M.MulticlassConfusionMatrix(num_classes=5, **kw),
        _rng_batches(17, lambda r: (r.integers(0, 5, 40), r.integers(0, 5, 40)))),
    "BinaryBinnedPrecisionRecallCurve": _Case(
        lambda M, kw, pkg: M.BinaryBinnedPrecisionRecallCurve(threshold=11, **kw),
        _rng_batches(18, _binary)),
    "NDCG": _Case(lambda M, kw, pkg: M.NDCG(k=3, **kw),
                  _rng_batches(19, lambda r: (r.random((8, 12)).astype(np.float32),
                                              (r.random((8, 12)) < 0.2).astype(np.float32)))),
}


def _compute(holder):
    if isinstance(holder, dict):
        return {k: m.compute() for k, m in holder.items()}
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a world of one syncs nothing
        return holder.compute()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoint_crosses_packages(ckdir, case, direction):
    from torcheval_tpu.resilience import restore as jax_restore
    from torcheval_tpu.resilience import save as jax_save

    spec = CASES[case]
    src_pkg, dst_pkg = ("jax", "port") if direction == "jax_to_port" else ("port", "jax")
    SM, skw = _pkg(src_pkg)
    DM, dkw = _pkg(dst_pkg)
    source = spec.build(SM, skw, src_pkg)
    spec.feed(source, src_pkg)
    path = (jax_save if src_pkg == "jax" else save)(source, ckdir)
    target = spec.build(DM, dkw, dst_pkg)
    (jax_restore if dst_pkg == "jax" else restore)(target, path)
    _assert_states_equal_as_bytes(_state_leaves(_metrics_of(target)), _state_leaves(_metrics_of(source)),
                                  into_jax=dst_pkg == "jax")
    _assert_compute_close(_compute(target), _compute(source))
