"""End-to-end preemption recovery in real gloo processes: the port's
counterpart of ``tests/resilience/test_fault_injection.py``.

Two four-rank worlds of
``torcheval_tpu_torch.utils.test_utils.resilience_worker``, one per class:

* **kill world**: the chaos hook hard-kills rank 2 (``os._exit(43)``) as it
  enters the second sync's descriptor round (round 3). The survivors'
  ``sync_and_compute(..., timeout_s=, on_failure="local")`` returns each
  one's LOCAL value within the deadline with the port's failure count at
  1, and every pre-fault checkpoint (the dead rank's included) restores in
  THIS process to the value its rank had, in the port and in the JAX
  package.
* **straggler world**: rank 2 sleeps past its whole budget instead, so its
  peers' collective really blocks (connections open, nothing errors): the
  survivors' return is the watchdog itself, at ``timeout_s``.

A slice-sharded checkpoint in a two-rank world completes the file: it
restores into an unsharded one-process collection (and the JAX
package's), into an equal mesh, and raises ``"unsupported"`` on an unequal
one.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest

from torcheval_tpu_torch.utils.test_utils import resilience_worker as rw
from torcheval_tpu_torch.utils.test_utils.sharded_worker import _feed, _sliced, _values, sliced_batches

WORLD = 4
LAUNCH_TIMEOUT_S = 240.0


def _world(action):
    outdir = tempfile.mkdtemp(prefix=f"torch_chaos_{action}_")
    env = {
        "TORCHEVAL_TPU_CHAOS": "1",
        "TORCHEVAL_TPU_CHAOS_RANK": str(rw.KILLED_RANK),
        "TORCHEVAL_TPU_CHAOS_ROUND": "3",
        "TORCHEVAL_TPU_CHAOS_ACTION": action,
        "TORCHEVAL_TPU_CHAOS_DELAY_S": str(rw.STRAGGLE_S),
        "TORCHEVAL_TPU_CHAOS_EXIT_CODE": str(rw.CHAOS_EXIT_CODE),
    }
    codes, outs, results = rw.launch(action, outdir, WORLD, LAUNCH_TIMEOUT_S, env)
    return outdir, codes, outs, results


def _local_accuracy(rank, phases):
    s = np.concatenate([rw.make_shard(rank, p)[0] for p in phases])
    l = np.concatenate([rw.make_shard(rank, p)[1] for p in phases])
    return float((s.argmax(1) == l).mean())


@pytest.fixture(scope="module")
def kill_world():
    outdir, codes, outs, results = _world("kill")
    yield outdir, codes, outs, results
    shutil.rmtree(outdir, ignore_errors=True)


@pytest.fixture(scope="module")
def straggler_world():
    outdir, codes, outs, results = _world("delay")
    yield outdir, codes, outs, results
    shutil.rmtree(outdir, ignore_errors=True)


SURVIVORS = [r for r in range(WORLD) if r != rw.KILLED_RANK]


class TestKillWorld:
    def test_killed_rank_died_with_injected_exit_code(self, kill_world):
        _, codes, outs, results = kill_world
        assert codes[rw.KILLED_RANK] == rw.CHAOS_EXIT_CODE, outs[rw.KILLED_RANK][-3000:]
        assert results[rw.KILLED_RANK] is None  # dead before writing results

    @pytest.mark.parametrize("rank", SURVIVORS)
    def test_survivor_exited_cleanly_with_results(self, kill_world, rank):
        _, codes, outs, results = kill_world
        assert codes[rank] == 0, outs[rank][-4000:]
        assert results[rank] is not None

    @pytest.mark.parametrize("rank", SURVIVORS)
    def test_healthy_sync_matches_global_oracle(self, kill_world, rank):
        s = np.concatenate([rw.make_shard(r, 0)[0] for r in range(WORLD)])
        l = np.concatenate([rw.make_shard(r, 0)[1] for r in range(WORLD)])
        assert kill_world[3][rank]["sync1"] == pytest.approx(float((s.argmax(1) == l).mean()), abs=1e-6)

    @pytest.mark.parametrize("rank", SURVIVORS)
    def test_degraded_sync_returns_local_within_deadline(self, kill_world, rank):
        res = kill_world[3][rank]
        assert res["sync2"] == pytest.approx(_local_accuracy(rank, (0, 1)), abs=1e-6)
        assert res["sync2"] == res["local_compute_post"]
        assert res["sync2_elapsed_s"] < rw.TIMEOUT_S + 30.0

    @pytest.mark.parametrize("rank", SURVIVORS)
    def test_failure_count_is_one(self, kill_world, rank):
        res = kill_world[3][rank]
        assert res["failures"] == 1
        # sync 1's two rounds, and round 3, which failed (a failed round is
        # not counted)
        assert res["rounds"] == 2

    @pytest.mark.parametrize("rank", SURVIVORS)
    def test_obs_snapshot_written(self, kill_world, rank):
        import json

        with open(os.path.join(kill_world[0], f"rank{rank}.obs.json")) as f:
            snap = json.load(f)
        assert snap["counters"]["resilience.checkpoint.saves"] == 1.0
        assert snap["spans"]["resilience.checkpoint.save"]["count"] == 1

    @pytest.mark.parametrize("rank", range(WORLD))
    def test_prefault_checkpoint_restores_in_both_packages(self, kill_world, rank):
        # THIS process never saw the workers' state except through the
        # checkpoint; the dead rank's included
        from torcheval_tpu.metrics import MulticlassAccuracy as JaxAccuracy
        from torcheval_tpu.resilience import restore as jax_restore
        from torcheval_tpu_torch.metrics import MulticlassAccuracy
        from torcheval_tpu_torch.resilience import restore

        ckpt = os.path.join(kill_world[0], f"ckpt_rank{rank}")
        fresh = restore(MulticlassAccuracy(num_classes=rw.NUM_CLASSES, device="cpu"), ckpt)
        want = _local_accuracy(rank, (0,))
        if kill_world[3][rank] is not None:
            assert float(fresh.compute()) == kill_world[3][rank]["local_compute_at_ckpt"]
        assert float(fresh.compute()) == pytest.approx(want, abs=1e-6)
        theirs = jax_restore(JaxAccuracy(num_classes=rw.NUM_CLASSES), ckpt)
        assert float(np.asarray(theirs.compute())) == float(fresh.compute())


class TestStragglerWorld:
    @pytest.mark.parametrize("rank", range(WORLD))
    def test_every_rank_survives_and_degrades_to_local(self, straggler_world, rank):
        _, codes, outs, results = straggler_world
        assert codes[rank] == 0, outs[rank][-4000:]
        res = results[rank]
        assert res["sync2"] == res["local_compute_post"]
        assert res["failures"] == 1

    @pytest.mark.parametrize("rank", SURVIVORS)
    def test_survivors_waited_out_the_full_deadline(self, straggler_world, rank):
        elapsed = straggler_world[3][rank]["sync2_elapsed_s"]
        assert rw.TIMEOUT_S - 0.5 <= elapsed < rw.TIMEOUT_S + 30.0

    def test_straggler_burned_its_budget_sleeping(self, straggler_world):
        assert straggler_world[3][rw.KILLED_RANK]["sync2_elapsed_s"] >= rw.STRAGGLE_S - 0.5


# ---------------------------------------------- slice-sharded checkpoints
@pytest.fixture(scope="module")
def sliced_world():
    outdir = tempfile.mkdtemp(prefix="torch_sliced_ckpt_")
    codes, outs, results = rw.launch("sliced_ckpt", outdir, 2, LAUNCH_TIMEOUT_S)
    assert codes == [0, 0], "\n".join(o[-3000:] for o in outs)
    yield outdir, results
    shutil.rmtree(outdir, ignore_errors=True)


def _unsharded_reference():
    return _values(_feed(_sliced(False, None, 64), sliced_batches(300, seed=5)))


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_save_records_the_slice_mesh(sliced_world, rank):
    res = sliced_world[1][rank]
    meshes = [m for m in res["sharded_mesh"] if m is not None]
    # the sliced states (acc 2, sketch 3), never the id lanes
    assert meshes == [{"slices": 2}] * 5
    assert res["saved"] == _unsharded_reference()


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_save_restores_into_an_equal_mesh(sliced_world, rank):
    res = sliced_world[1][rank]
    assert res["equal_mesh"] == res["saved"]
    assert res["equal_streamed"] == res["saved_streamed"]
    assert all(rows["slice_ids_hi"] == 2 * rows[s] for rows in res["equal_tile_rows"].values()
               for s in rows if s != "slice_ids_hi")


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_save_refuses_an_unequal_mesh(sliced_world, rank):
    assert sliced_world[1][rank]["unequal"] == "unsupported"


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_save_restores_unsharded_in_one_process(sliced_world, rank):
    from torcheval_tpu_torch.resilience import restore

    ckpt = os.path.join(sliced_world[0], f"ckpt_rank{rank}")
    fresh = restore(_sliced(False, None), ckpt)
    assert _values(fresh) == sliced_world[1][rank]["saved"]


def test_sharded_save_restores_into_the_jax_package(sliced_world):
    from torcheval_tpu.metrics import BinaryAccuracy, BinaryAUROC, SlicedMetricCollection
    from torcheval_tpu.resilience import restore

    col = SlicedMetricCollection({"acc": BinaryAccuracy(), "auroc": BinaryAUROC(approx=1024)})
    restore(col, os.path.join(sliced_world[0], "ckpt_rank0"))
    got = col.compute()
    want = sliced_world[1][0]["saved"]
    assert [int(i) for i in got["acc"].slice_ids] == want["ids"]
    for name in ("acc", "auroc"):
        np.testing.assert_allclose(np.asarray(got[name]["values"]), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-8)
