"""The port's env-gated fault-injection hooks
(``torcheval_tpu_torch/resilience/chaos.py``), mirroring
``tests/resilience/test_chaos.py`` case for case, plus what the port
changes: the targeted rank is the ``torch.distributed`` rank, the poison
also corrupts torch tensors (as clones), and one environment arms both
packages the same way.

The kill action (``os._exit`` mid-collective) runs only in a disposable
process: ``test_torch_fault_injection.py``'s gloo world.
"""

import os
import shutil
import tempfile
import time
import unittest
from unittest import mock

import numpy as np
import torch

from torcheval_tpu.resilience import chaos as jax_chaos
from torcheval_tpu_torch.resilience import chaos


class TestChaosHooks(unittest.TestCase):
    def tearDown(self):
        chaos.reset_for_tests()

    def _arm(self, **extra):
        env = {
            "TORCHEVAL_TPU_CHAOS": "1",
            "TORCHEVAL_TPU_CHAOS_RANK": "0",  # this process in a 1-proc world
            "TORCHEVAL_TPU_CHAOS_ROUND": "2",
            "TORCHEVAL_TPU_CHAOS_ACTION": "delay",
            "TORCHEVAL_TPU_CHAOS_DELAY_S": "0.3",
        }
        env.update(extra)
        return mock.patch.dict(os.environ, env)

    def test_disarmed_is_a_noop(self):
        with mock.patch.dict(os.environ):
            os.environ.pop("TORCHEVAL_TPU_CHAOS", None)
            chaos.reset_for_tests()
            t0 = time.monotonic()
            for _ in range(1000):
                chaos.on_sync_round()
            self.assertLess(time.monotonic() - t0, 0.5)

    def test_delay_fires_only_at_configured_round(self):
        with self._arm():
            chaos.reset_for_tests()
            t0 = time.monotonic()
            chaos.on_sync_round()  # round 1: no action
            first = time.monotonic() - t0
            t0 = time.monotonic()
            chaos.on_sync_round()  # round 2: the straggler delay
            second = time.monotonic() - t0
            t0 = time.monotonic()
            chaos.on_sync_round()  # round 3: past the target, no action
            third = time.monotonic() - t0
        self.assertLess(first, 0.2)
        self.assertGreaterEqual(second, 0.3)
        self.assertLess(third, 0.2)

    def test_other_rank_never_acts(self):
        with self._arm(TORCHEVAL_TPU_CHAOS_RANK="7"):
            chaos.reset_for_tests()
            t0 = time.monotonic()
            for _ in range(3):
                chaos.on_sync_round()
            self.assertLess(time.monotonic() - t0, 0.2)

    def test_malformed_config_disarms_instead_of_raising(self):
        # a stale TORCHEVAL_TPU_CHAOS=1 without the targeting vars must
        # never be able to break a production sync
        with mock.patch.dict(
            os.environ, {"TORCHEVAL_TPU_CHAOS": "1"}, clear=False
        ):
            for var in (
                "TORCHEVAL_TPU_CHAOS_RANK",
                "TORCHEVAL_TPU_CHAOS_ROUND",
            ):
                os.environ.pop(var, None)
            chaos.reset_for_tests()
            chaos.on_sync_round()  # no raise, no action

    def test_unknown_action_disarms(self):
        with self._arm(TORCHEVAL_TPU_CHAOS_ACTION="explode"):
            chaos.reset_for_tests()
            chaos.on_sync_round()
            chaos.on_sync_round()  # the configured round: still no action


class TestIngestHooks(unittest.TestCase):
    """The queue-boundary actions: poison and ingestion delay (the port has
    no serving queue yet, so the targeting and corruption semantics run in
    isolation)."""

    def tearDown(self):
        chaos.reset_for_tests()

    def _arm(self, **extra):
        env = {
            "TORCHEVAL_TPU_CHAOS": "1",
            "TORCHEVAL_TPU_CHAOS_ACTION": "poison",
            "TORCHEVAL_TPU_CHAOS_TENANT": "t",
            "TORCHEVAL_TPU_CHAOS_STEP": "2",
            "TORCHEVAL_TPU_CHAOS_POISON": "nan",
        }
        env.update(extra)
        return mock.patch.dict(os.environ, env)

    def _batch(self):
        import numpy as np

        return (
            np.ones((4, 3), dtype=np.float32),
            np.zeros(4, dtype=np.int64),
        )

    def test_nan_poison_targets_tenant_and_step_only(self):
        import numpy as np

        with self._arm():
            chaos.reset_for_tests()
            clean = chaos.on_ingest("t", 1, self._batch())
            self.assertFalse(np.isnan(clean[0]).any())
            other = chaos.on_ingest("someone-else", 2, self._batch())
            self.assertFalse(np.isnan(other[0]).any())
            hit = chaos.on_ingest("t", 2, self._batch())
            # the first FLOAT argument is all-NaN; the int labels untouched
            self.assertTrue(np.isnan(hit[0]).all())
            self.assertEqual(hit[1].dtype.kind, "i")

    def test_shape_poison_drops_a_leading_row(self):
        with self._arm(TORCHEVAL_TPU_CHAOS_POISON="shape"):
            chaos.reset_for_tests()
            s, l = self._batch()
            hit = chaos.on_ingest("t", 2, (s, l))
            self.assertEqual(hit[0].shape, (3, 3))
            self.assertEqual(hit[1].shape, (4,))

    def test_ingest_delay_sleeps_at_the_boundary(self):
        with self._arm(
            TORCHEVAL_TPU_CHAOS_ACTION="ingest_delay",
            TORCHEVAL_TPU_CHAOS_DELAY_S="0.3",
        ):
            chaos.reset_for_tests()
            t0 = time.monotonic()
            chaos.on_ingest("t", 1, self._batch())
            self.assertLess(time.monotonic() - t0, 0.2)
            t0 = time.monotonic()
            out = chaos.on_ingest("t", 2, self._batch())
            self.assertGreaterEqual(time.monotonic() - t0, 0.3)
            # a delay never corrupts
            self.assertEqual(out[0].shape, (4, 3))

    def test_load_spike_fires_on_every_batch_from_step(self):
        # NOT one-shot: a load spike models sustained pressure, so every
        # admitted batch at/after the armed step pays the delay
        with self._arm(
            TORCHEVAL_TPU_CHAOS_ACTION="load_spike",
            TORCHEVAL_TPU_CHAOS_DELAY_S="0.15",
        ):
            chaos.reset_for_tests()
            t0 = time.monotonic()
            chaos.on_ingest("t", 1, self._batch())
            self.assertLess(time.monotonic() - t0, 0.1)
            for step in (2, 3):
                t0 = time.monotonic()
                out = chaos.on_ingest("t", step, self._batch())
                self.assertGreaterEqual(
                    time.monotonic() - t0, 0.15, f"step {step}"
                )
            # a load spike never corrupts the batch
            self.assertEqual(out[0].shape, (4, 3))

    def test_hot_tenant_alias_targets_tenant_and_arms_ingest(self):
        with self._arm(
            TORCHEVAL_TPU_CHAOS_ACTION="hot_tenant",
            TORCHEVAL_TPU_CHAOS_DELAY_S="0.15",
        ):
            chaos.reset_for_tests()
            self.assertTrue(chaos.ingest_armed())
            t0 = time.monotonic()
            chaos.on_ingest("someone-else", 2, self._batch())
            self.assertLess(time.monotonic() - t0, 0.1)
            t0 = time.monotonic()
            chaos.on_ingest("t", 2, self._batch())
            self.assertGreaterEqual(time.monotonic() - t0, 0.15)

    def test_wildcard_tenant_and_fires_once(self):
        import numpy as np

        with self._arm(TORCHEVAL_TPU_CHAOS_TENANT="*"):
            chaos.reset_for_tests()
            hit = chaos.on_ingest("anybody", 2, self._batch())
            self.assertTrue(np.isnan(hit[0]).all())
            again = chaos.on_ingest("anybody", 2, self._batch())
            self.assertFalse(np.isnan(again[0]).any())

    def test_sync_armed_process_passes_ingest_untouched_and_vice_versa(self):
        import numpy as np

        with mock.patch.dict(
            os.environ,
            {
                "TORCHEVAL_TPU_CHAOS": "1",
                "TORCHEVAL_TPU_CHAOS_ACTION": "delay",
                "TORCHEVAL_TPU_CHAOS_RANK": "0",
                "TORCHEVAL_TPU_CHAOS_ROUND": "1",
                "TORCHEVAL_TPU_CHAOS_DELAY_S": "0.0",
            },
        ):
            chaos.reset_for_tests()
            out = chaos.on_ingest("t", 1, self._batch())
            self.assertFalse(np.isnan(out[0]).any())
        with self._arm():
            chaos.reset_for_tests()
            t0 = time.monotonic()
            chaos.on_sync_round()
            self.assertLess(time.monotonic() - t0, 0.2)

    def test_missing_ingest_vars_disarm(self):
        with self._arm():
            os.environ.pop("TORCHEVAL_TPU_CHAOS_TENANT")
            chaos.reset_for_tests()
            out = chaos.on_ingest("t", 2, self._batch())
            import numpy as np

            self.assertFalse(np.isnan(out[0]).any())


class TestHostActions(unittest.TestCase):
    """Host-level chaos: targeting and one-shot semantics of the eval-wire
    server hooks. The dying actions (``host_kill`` / ``ack_drop``'s
    ``os._exit``) can only run in a disposable process; here the partition
    directive, the per-tenant submit counting, and the disarmed edges."""

    def tearDown(self):
        chaos.reset_for_tests()

    def _arm(self, action="host_partition", tenant="bob", step="2"):
        return mock.patch.dict(
            os.environ,
            {
                "TORCHEVAL_TPU_CHAOS": "1",
                "TORCHEVAL_TPU_CHAOS_ACTION": action,
                "TORCHEVAL_TPU_CHAOS_TENANT": tenant,
                "TORCHEVAL_TPU_CHAOS_STEP": step,
            },
        )

    def test_disarmed_gate_is_false(self):
        with mock.patch.dict(os.environ):
            os.environ.pop("TORCHEVAL_TPU_CHAOS", None)
            chaos.reset_for_tests()
            self.assertFalse(chaos.host_armed())

    def test_partition_fires_at_tenant_step_only_once(self):
        with self._arm():
            chaos.reset_for_tests()
            self.assertTrue(chaos.host_armed())
            # other tenants and other ops never trip it
            self.assertIsNone(chaos.on_host_request("submit", "alice"))
            self.assertIsNone(chaos.on_host_request("compute", "bob"))
            self.assertIsNone(chaos.on_host_request("submit", "bob"))  # 1
            self.assertEqual(
                chaos.on_host_request("submit", "bob"), "partition"  # 2
            )
            # one-shot: the counter never matches again
            self.assertIsNone(chaos.on_host_request("submit", "bob"))

    def test_ack_drop_directive_returned_for_server_to_honor(self):
        with self._arm(action="ack_drop", step="1"):
            chaos.reset_for_tests()
            self.assertEqual(
                chaos.on_host_request("submit", "bob"), "ack_drop"
            )

    def test_wildcard_tenant_counts_per_tenant(self):
        with self._arm(tenant="*", step="2"):
            chaos.reset_for_tests()
            self.assertIsNone(chaos.on_host_request("submit", "a"))  # a:1
            self.assertIsNone(chaos.on_host_request("submit", "b"))  # b:1
            self.assertEqual(
                chaos.on_host_request("submit", "a"), "partition"  # a:2
            )

    def test_host_actions_do_not_arm_other_hooks(self):
        import numpy as np

        with self._arm():
            chaos.reset_for_tests()
            self.assertFalse(chaos.ingest_armed())
            rng = np.random.default_rng(0)
            batch = (rng.random((4, 2)).astype(np.float32),)
            out = chaos.on_ingest("bob", 2, batch)
            self.assertFalse(np.isnan(out[0]).any())
            t0 = time.monotonic()
            chaos.on_sync_round()
            self.assertLess(time.monotonic() - t0, 0.2)

    def test_ingest_actions_do_not_arm_host_hooks(self):
        with mock.patch.dict(
            os.environ,
            {
                "TORCHEVAL_TPU_CHAOS": "1",
                "TORCHEVAL_TPU_CHAOS_ACTION": "poison",
                "TORCHEVAL_TPU_CHAOS_TENANT": "bob",
                "TORCHEVAL_TPU_CHAOS_STEP": "1",
            },
        ):
            chaos.reset_for_tests()
            self.assertFalse(chaos.host_armed())
            self.assertIsNone(chaos.on_host_request("submit", "bob"))

    def test_missing_step_disarms_with_warning_not_raise(self):
        with self._arm():
            os.environ.pop("TORCHEVAL_TPU_CHAOS_STEP")
            chaos.reset_for_tests()
            self.assertFalse(chaos.host_armed())


class TestRouterKillHooks(unittest.TestCase):
    """The control-plane kill: targeting by point, tenant and 1-based
    matching-op count. ``os._exit`` is mocked so the selection logic is
    testable in-process."""

    def tearDown(self):
        chaos.reset_for_tests()

    def _arm(self, **extra):
        env = {
            "TORCHEVAL_TPU_CHAOS": "1",
            "TORCHEVAL_TPU_CHAOS_ACTION": "router_kill",
            "TORCHEVAL_TPU_CHAOS_TENANT": "*",
            "TORCHEVAL_TPU_CHAOS_STEP": "2",
            "TORCHEVAL_TPU_CHAOS_EXIT_CODE": "47",
        }
        env.update(extra)
        return mock.patch.dict(os.environ, env)

    def test_router_armed_gate(self):
        with self._arm():
            chaos.reset_for_tests()
            self.assertTrue(chaos.router_armed())
        with mock.patch.dict(os.environ):
            os.environ.pop("TORCHEVAL_TPU_CHAOS", None)
            chaos.reset_for_tests()
            self.assertFalse(chaos.router_armed())

    def test_fires_at_the_armed_op_count_with_exit_code(self):
        with self._arm(), mock.patch.object(os, "_exit") as ex:
            chaos.reset_for_tests()
            chaos.on_router_op("submit", "a")  # op 1: no action
            ex.assert_not_called()
            chaos.on_router_op("submit", "b")  # op 2: the kill
            ex.assert_called_once_with(47)

    def test_point_filter_counts_only_matching_ops(self):
        with self._arm(
            TORCHEVAL_TPU_CHAOS_POINT="migrate_exported",
            TORCHEVAL_TPU_CHAOS_STEP="1",
        ), mock.patch.object(os, "_exit") as ex:
            chaos.reset_for_tests()
            for _ in range(5):
                chaos.on_router_op("submit", "a")  # wrong point: uncounted
            ex.assert_not_called()
            chaos.on_router_op("migrate_exported", "a")
            ex.assert_called_once_with(47)

    def test_tenant_filter_counts_only_matching_ops(self):
        with self._arm(
            TORCHEVAL_TPU_CHAOS_TENANT="vic", TORCHEVAL_TPU_CHAOS_STEP="1"
        ), mock.patch.object(os, "_exit") as ex:
            chaos.reset_for_tests()
            chaos.on_router_op("submit", "other")  # uncounted
            ex.assert_not_called()
            chaos.on_router_op("submit", "vic")
            ex.assert_called_once_with(47)

    def test_fires_once_per_process(self):
        with self._arm(TORCHEVAL_TPU_CHAOS_STEP="1"), mock.patch.object(
            os, "_exit"
        ) as ex:
            chaos.reset_for_tests()
            chaos.on_router_op("submit", "a")
            chaos.on_router_op("submit", "a")
            self.assertEqual(ex.call_count, 1)

    def test_router_action_does_not_arm_other_hooks(self):
        with self._arm():
            chaos.reset_for_tests()
            self.assertFalse(chaos.host_armed())
            self.assertFalse(chaos.ingest_armed())
            self.assertFalse(chaos.ckpt_armed())

    def test_malformed_config_disarms(self):
        with self._arm():
            os.environ.pop("TORCHEVAL_TPU_CHAOS_STEP")
            chaos.reset_for_tests()
            self.assertFalse(chaos.router_armed())


class TestCkptCorruptHooks(unittest.TestCase):
    """The silent-bit-rot injector: flips one payload byte of the selected
    save in place. End to end (quarantine and lineage fallback) in
    ``test_torch_snapshot.py``; here the substring targeting, the
    matching-save count, and the flip itself."""

    def tearDown(self):
        chaos.reset_for_tests()

    def setUp(self):
        self.dir = tempfile.mkdtemp(prefix="tpu_chaos_ckpt_")
        self.addCleanup(shutil.rmtree, self.dir, ignore_errors=True)

    def _ckpt(self, name):
        path = os.path.join(self.dir, name)
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "state.npz"), "wb") as f:
            f.write(bytes(range(64)))
        return path

    def _payload(self, path):
        with open(os.path.join(path, "state.npz"), "rb") as f:
            return f.read()

    def _arm(self, **extra):
        env = {
            "TORCHEVAL_TPU_CHAOS": "1",
            "TORCHEVAL_TPU_CHAOS_ACTION": "ckpt_corrupt",
            "TORCHEVAL_TPU_CHAOS_TENANT": "/vic/",
            "TORCHEVAL_TPU_CHAOS_STEP": "1",
        }
        env.update(extra)
        return mock.patch.dict(os.environ, env)

    def test_flips_exactly_one_byte_of_the_matching_save(self):
        path = self._ckpt("vic/ckpt-1")
        before = self._payload(path)
        with self._arm():
            chaos.reset_for_tests()
            self.assertTrue(chaos.ckpt_armed())
            chaos.on_ckpt_saved(path)
        after = self._payload(path)
        diff = [i for i in range(len(before)) if before[i] != after[i]]
        self.assertEqual(diff, [12])
        self.assertEqual(after[12], before[12] ^ 0xFF)

    def test_substring_filter_skips_other_tenants_saves(self):
        other = self._ckpt("bob/ckpt-1")
        vic = self._ckpt("vic/ckpt-1")
        before = self._payload(other)
        with self._arm():
            chaos.reset_for_tests()
            chaos.on_ckpt_saved(other)  # not /vic/: uncounted, untouched
            self.assertEqual(self._payload(other), before)
            vic_before = self._payload(vic)
            chaos.on_ckpt_saved(vic)
            self.assertNotEqual(self._payload(vic), vic_before)

    def test_step_counts_matching_saves_and_fires_once(self):
        g1 = self._ckpt("vic/ckpt-1")
        g2 = self._ckpt("vic/ckpt-2")
        g3 = self._ckpt("vic/ckpt-3")
        with self._arm(TORCHEVAL_TPU_CHAOS_STEP="2"):
            chaos.reset_for_tests()
            before = {p: self._payload(p) for p in (g1, g2, g3)}
            chaos.on_ckpt_saved(g1)  # save 1: intact
            chaos.on_ckpt_saved(g2)  # save 2: flipped
            chaos.on_ckpt_saved(g3)  # one-shot spent: intact
        self.assertEqual(self._payload(g1), before[g1])
        self.assertNotEqual(self._payload(g2), before[g2])
        self.assertEqual(self._payload(g3), before[g3])

    def test_missing_payload_warns_instead_of_raising(self):
        path = os.path.join(self.dir, "vic", "ckpt-9")
        os.makedirs(path)  # no state.npz inside
        with self._arm():
            chaos.reset_for_tests()
            chaos.on_ckpt_saved(path)  # must not raise

    def test_ckpt_action_does_not_arm_router_hooks(self):
        with self._arm():
            chaos.reset_for_tests()
            self.assertFalse(chaos.router_armed())
            self.assertFalse(chaos.host_armed())


class TestPortOnly(unittest.TestCase):
    """Torch tensors, the rank source and the shared environment."""

    def tearDown(self):
        chaos.reset_for_tests()
        jax_chaos.reset_for_tests()

    def _arm(self, **extra):
        env = {
            "TORCHEVAL_TPU_CHAOS": "1",
            "TORCHEVAL_TPU_CHAOS_ACTION": "poison",
            "TORCHEVAL_TPU_CHAOS_TENANT": "t",
            "TORCHEVAL_TPU_CHAOS_STEP": "1",
        }
        env.update(extra)
        return mock.patch.dict(os.environ, env)

    def test_nan_poison_clones_the_first_float_tensor(self):
        labels = torch.zeros(4, dtype=torch.int64)
        scores = torch.ones((4, 3))
        with self._arm():
            chaos.reset_for_tests()
            hit = chaos.on_ingest("t", 1, (labels, scores))
        self.assertIs(hit[0], labels)  # integer tensor skipped, untouched
        self.assertTrue(torch.isnan(hit[1]).all())
        self.assertEqual((hit[1].shape, hit[1].dtype), (scores.shape, scores.dtype))
        self.assertFalse(torch.isnan(scores).any())  # the caller's tensor

    def test_shape_poison_drops_a_tensor_row(self):
        scores = torch.ones((4, 3))
        with self._arm(TORCHEVAL_TPU_CHAOS_POISON="shape"):
            chaos.reset_for_tests()
            hit = chaos.on_ingest("t", 1, (torch.tensor(1.0), scores, np.zeros(4)))
        self.assertEqual(tuple(hit[1].shape), (3, 3))
        self.assertEqual(hit[2].shape, (4,))
        self.assertEqual(tuple(scores.shape), (4, 3))

    def test_poison_of_nothing_eligible_passes_through(self):
        batch = (torch.zeros(1, dtype=torch.int32), "tag")
        with self._arm():
            chaos.reset_for_tests()
            out = chaos.on_ingest("t", 1, batch)
        self.assertEqual(out, batch)

    def test_rank_is_zero_without_a_process_group(self):
        self.assertEqual(chaos._process_rank(), 0)

    def test_ingest_rank_filter_reads_the_torch_rank(self):
        with self._arm(TORCHEVAL_TPU_CHAOS_RANK="1"):
            chaos.reset_for_tests()
            out = chaos.on_ingest("t", 1, (torch.ones(2),))
            self.assertFalse(torch.isnan(out[0]).any())  # rank 0 != 1
            with mock.patch.object(chaos, "_process_rank", return_value=1):
                chaos.reset_for_tests()
                out = chaos.on_ingest("t", 1, (torch.ones(2),))
            self.assertTrue(torch.isnan(out[0]).all())

    def test_one_environment_arms_both_packages_alike(self):
        envs = [
            {"TORCHEVAL_TPU_CHAOS_ACTION": "kill", "TORCHEVAL_TPU_CHAOS_RANK": "1",
             "TORCHEVAL_TPU_CHAOS_ROUND": "3"},
            {"TORCHEVAL_TPU_CHAOS_ACTION": "delay", "TORCHEVAL_TPU_CHAOS_RANK": "0",
             "TORCHEVAL_TPU_CHAOS_ROUND": "2", "TORCHEVAL_TPU_CHAOS_DELAY_S": "1.5"},
            {"TORCHEVAL_TPU_CHAOS_ACTION": "poison", "TORCHEVAL_TPU_CHAOS_TENANT": "t",
             "TORCHEVAL_TPU_CHAOS_STEP": "2", "TORCHEVAL_TPU_CHAOS_POISON": "shape"},
            {"TORCHEVAL_TPU_CHAOS_ACTION": "load_spike", "TORCHEVAL_TPU_CHAOS_TENANT": "*",
             "TORCHEVAL_TPU_CHAOS_STEP": "1", "TORCHEVAL_TPU_CHAOS_RANK": "0"},
            {"TORCHEVAL_TPU_CHAOS_ACTION": "host_kill", "TORCHEVAL_TPU_CHAOS_TENANT": "b",
             "TORCHEVAL_TPU_CHAOS_STEP": "4", "TORCHEVAL_TPU_CHAOS_EXIT_CODE": "9"},
            {"TORCHEVAL_TPU_CHAOS_ACTION": "ack_reorder", "TORCHEVAL_TPU_CHAOS_TENANT": "b",
             "TORCHEVAL_TPU_CHAOS_STEP": "1"},
            {"TORCHEVAL_TPU_CHAOS_ACTION": "router_kill", "TORCHEVAL_TPU_CHAOS_TENANT": "*",
             "TORCHEVAL_TPU_CHAOS_STEP": "2", "TORCHEVAL_TPU_CHAOS_POINT": "submit"},
            {"TORCHEVAL_TPU_CHAOS_ACTION": "ckpt_corrupt", "TORCHEVAL_TPU_CHAOS_TENANT": "/x/",
             "TORCHEVAL_TPU_CHAOS_STEP": "1"},
            {"TORCHEVAL_TPU_CHAOS_ACTION": "kill"},  # misconfigured: disarms
            {"TORCHEVAL_TPU_CHAOS_ACTION": "explode"},
        ]
        for extra in envs:
            with mock.patch.dict(os.environ, {"TORCHEVAL_TPU_CHAOS": "1", **extra}):
                chaos.reset_for_tests()
                jax_chaos.reset_for_tests()
                mine, theirs = chaos._resolve(), jax_chaos._resolve()
            if theirs is False:
                self.assertIs(mine, False, extra)
                continue
            for slot in type(theirs).__slots__:
                self.assertEqual(getattr(mine, slot), getattr(theirs, slot), (extra, slot))
            for gate in ("ingest_armed", "host_armed", "ack_armed", "router_armed", "ckpt_armed"):
                self.assertEqual(getattr(chaos, gate)(), getattr(jax_chaos, gate)(), (extra, gate))

    def test_defaults_equal_the_jax_package(self):
        with mock.patch.dict(os.environ, {"TORCHEVAL_TPU_CHAOS": "1",
                                          "TORCHEVAL_TPU_CHAOS_RANK": "0",
                                          "TORCHEVAL_TPU_CHAOS_ROUND": "1"}):
            for k in ("TORCHEVAL_TPU_CHAOS_ACTION", "TORCHEVAL_TPU_CHAOS_DELAY_S",
                      "TORCHEVAL_TPU_CHAOS_EXIT_CODE"):
                os.environ.pop(k, None)
            chaos.reset_for_tests()
            cfg = chaos._resolve()
        self.assertEqual((cfg.action, cfg.exit_code, cfg.delay_s), ("kill", 43, 30.0))
        for name in ("_ENV_ARM", "_ENV_RANK", "_ENV_ROUND", "_ENV_ACTION", "_ENV_DELAY",
                     "_ENV_EXIT", "_ENV_TENANT", "_ENV_STEP", "_ENV_POISON", "_ENV_POINT"):
            self.assertEqual(getattr(chaos, name), getattr(jax_chaos, name))


if __name__ == "__main__":
    unittest.main()
