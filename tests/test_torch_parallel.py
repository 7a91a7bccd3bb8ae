"""The port's data-parallel helpers on the CPU: ``parallel/bootstrap.py``
(environment resolution and the connection retry ladder, with
``torch.distributed.init_process_group`` replaced by a stand-in, as
``tests/parallel/test_bootstrap.py`` replaces ``jax.distributed``),
``parallel/mesh.py``'s blocks of a global batch, and the distributed
example at world size 1 against the JAX example's numbers (rtol 1e-5,
atol 1e-8). Real multi-process worlds are in ``test_torch_sync.py``.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torcheval_tpu.metrics as J
from torcheval_tpu_torch.examples import distributed_example as example
from torcheval_tpu_torch.parallel import (
    DataParallelMesh,
    block_bounds,
    data_parallel_mesh,
    init_from_env,
    is_initialized,
    shard_batch,
)
from torcheval_tpu_torch.parallel import bootstrap
from torcheval_tpu_torch.parallel.bootstrap import _resolve_env
from torcheval_tpu_torch.utils.test_utils.obs_counts import count, recording

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-8


@pytest.fixture
def obs_on():
    """The obs registry on (and reset): the port's one counter."""
    with recording():
        yield


def jax_example_numbers():
    """``examples/distributed_example.py``'s three numbers: its stream
    (seed 2023, 64 batches of (256, 4)) through the JAX metrics."""
    acc = J.MulticlassAccuracy(num_classes=4)
    f1 = J.MulticlassF1Score(num_classes=4, average="macro")
    auroc = J.BinaryAUROC()
    rng = np.random.default_rng(2023)
    for _ in range(64):
        scores = rng.random((256, 4)).astype(np.float32)
        labels = rng.integers(0, 4, 256)
        acc.update(scores, labels)
        f1.update(scores, labels)
        auroc.update(scores[:, 0], (labels == 0).astype(np.float32))
    return {"accuracy": float(acc.compute()), "f1_macro": float(f1.compute()), "auroc": float(auroc.compute())}


# ------------------------------------------------------------ environment
@pytest.mark.parametrize(
    "env,want",
    [
        ({"COORDINATOR_ADDRESS": "10.0.0.1:1234", "NUM_PROCESSES": "8", "PROCESS_ID": "3"},
         ("10.0.0.1:1234", 8, 3)),
        ({"MASTER_ADDR": "head-node", "MASTER_PORT": "29500", "WORLD_SIZE": "4", "RANK": "1"},
         ("head-node:29500", 4, 1)),
        ({"COORDINATOR_ADDRESS": "jax-coord:1", "MASTER_ADDR": "torch-coord", "MASTER_PORT": "2",
          "NUM_PROCESSES": "16", "WORLD_SIZE": "4", "PROCESS_ID": "5", "RANK": "1"},
         ("jax-coord:1", 16, 5)),
        ({}, (None, None, None)),
    ],
    ids=["jax_style", "torchrun_style", "jax_style_wins", "empty"],
)
def test_resolve_env(env, want):
    assert _resolve_env(env) == want


def test_resolve_env_refuses_half_a_master_and_non_integers():
    for env in ({"MASTER_ADDR": "head-node"}, {"MASTER_PORT": "29500"}):
        with pytest.raises(ValueError, match="MASTER_ADDR and MASTER_PORT"):
            _resolve_env(env)
    with pytest.raises(ValueError, match="WORLD_SIZE='four'"):
        _resolve_env({"WORLD_SIZE": "four"})


@pytest.fixture
def clean_env(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR",
                 "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", bootstrap._CONNECT_ATTEMPTS_ENV):
        monkeypatch.delenv(name, raising=False)


def test_no_coordinator_stays_single_process(clean_env):
    assert not is_initialized()
    assert init_from_env() == (0, 1)
    assert not is_initialized()


def test_consistent_single_process_env_stays_single_process(clean_env, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert init_from_env() == (0, 1)
    assert not is_initialized()


def test_half_configured_launcher_raises(clean_env, monkeypatch):
    with pytest.raises(ValueError, match="no coordinator"):
        init_from_env(num_processes=4)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    with pytest.raises(ValueError, match="no coordinator"):
        init_from_env()


# --------------------------------------------------------- the retry ladder
class _FakeDist:
    """A stand-in for ``init_process_group`` that fails its first
    ``failures`` calls, leaving a half-formed world behind as a failed
    rendezvous can; ``destroy_process_group`` clears it."""

    def __init__(self, monkeypatch, failures, error=RuntimeError("failed to connect")):
        self.calls, self.kwargs, self.sleeps = 0, [], []
        self.failures, self.error, self.partial = failures, error, False
        monkeypatch.setattr(dist, "init_process_group", self.init)
        monkeypatch.setattr(dist, "is_initialized", lambda: self.partial)
        monkeypatch.setattr(dist, "destroy_process_group", self.destroy)
        monkeypatch.setattr(bootstrap.time, "sleep", self.sleeps.append)

    def init(self, **kwargs):
        assert not self.partial, "a retry started from a half-formed world"
        self.calls += 1
        self.kwargs.append(kwargs)
        if self.calls <= self.failures:
            self.partial = True
            raise self.error

    def destroy(self):
        self.partial = False


@pytest.fixture
def world_env(clean_env, monkeypatch):
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": "29999", "WORLD_SIZE": "4",
                 "RANK": "1"}.items():
        monkeypatch.setenv(k, v)


def test_connection_failure_retries_then_succeeds(world_env, monkeypatch, obs_on):
    fake = _FakeDist(monkeypatch, failures=2)
    before = count("bootstrap.retries")
    assert init_from_env(device="cpu", connect_backoff_s=1.0) == (1, 4)
    assert fake.calls == 3 and count("bootstrap.retries") - before == 2
    # exponential base with 0.5-1.5x jitter: 1 s then 2 s nominal
    assert len(fake.sleeps) == 2
    assert 0.5 <= fake.sleeps[0] <= 1.5 and 1.0 <= fake.sleeps[1] <= 3.0
    kw = fake.kwargs[-1]
    assert kw["backend"] == "gloo" and kw["init_method"] == "tcp://localhost:29999"
    assert (kw["world_size"], kw["rank"]) == (4, 1)


def test_gives_up_after_bounded_attempts_with_the_original_error(world_env, monkeypatch):
    fake = _FakeDist(monkeypatch, failures=99, error=RuntimeError("coordinator unreachable"))
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        init_from_env(device="cpu", connect_attempts=3)
    assert fake.calls == 3 and len(fake.sleeps) == 2


def test_configuration_errors_never_retry(world_env, monkeypatch):
    fake = _FakeDist(monkeypatch, failures=99, error=ValueError("bad init_method"))
    with pytest.raises(ValueError):
        init_from_env(device="cpu")
    assert fake.calls == 1 and fake.sleeps == []


def test_attempts_env_override_and_backoff_cap(world_env, monkeypatch):
    fake = _FakeDist(monkeypatch, failures=99)
    monkeypatch.setenv(bootstrap._CONNECT_ATTEMPTS_ENV, "1")
    with pytest.raises(RuntimeError):
        init_from_env(device="cpu")
    assert fake.sleeps == []
    monkeypatch.delenv(bootstrap._CONNECT_ATTEMPTS_ENV)
    with pytest.raises(RuntimeError):
        init_from_env(device="cpu", connect_attempts=4, connect_backoff_s=100.0)
    # every nominal delay (100, 200, 400) is capped at 30 s before jitter
    assert len(fake.sleeps) == 3 and all(s <= 30.0 * 1.5 for s in fake.sleeps)


def test_invalid_attempts_rejected(world_env, monkeypatch):
    _FakeDist(monkeypatch, failures=0)
    with pytest.raises(ValueError, match="connect_attempts"):
        init_from_env(device="cpu", connect_attempts=0)


def test_cuda_ranks_take_nccl_and_the_card_by_local_rank(world_env, monkeypatch):
    fake = _FakeDist(monkeypatch, failures=0)
    chosen = []
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    init_from_env()
    assert fake.kwargs[-1]["backend"] == "nccl" and chosen == [torch.device("cuda", 3)]
    init_from_env(backend="gloo")  # ranks that share a card ask for gloo
    assert fake.kwargs[-1]["backend"] == "gloo"


def test_without_a_card_the_default_device_raises(world_env, monkeypatch):
    _FakeDist(monkeypatch, failures=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_from_env()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data_parallel_mesh()


# -------------------------------------------------------------- the blocks
@pytest.mark.parametrize("n,size", [(256, 4), (50, 4), (3, 4), (0, 4), (7, 1), (1001, 8)])
def test_blocks_cover_every_row_once_with_the_remainder_spread(n, size):
    bounds = [block_bounds(n, size, r) for r in range(size)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    lengths = [stop - start for start, stop in bounds]
    assert max(lengths) - min(lengths) <= 1 and lengths == sorted(lengths, reverse=True)


def test_shard_batch_gives_each_rank_its_block():
    x = np.arange(50 * 3, dtype=np.float32).reshape(50, 3)
    y = np.arange(50)
    blocks = []
    for r in range(4):
        mesh = DataParallelMesh(size=4, rank=r, device=torch.device("cpu"))
        bx, by = shard_batch(mesh, x, y)
        assert bx.device.type == "cpu" and isinstance(by, torch.Tensor)
        assert torch.equal(bx[:, 0] // 3, by.to(torch.float32))
        blocks.append(by)
    assert [b.shape[0] for b in blocks] == [13, 13, 12, 12]
    assert torch.equal(torch.cat(blocks), torch.from_numpy(y))
    single = shard_batch(DataParallelMesh(size=1, rank=0, device=torch.device("cpu")), x)
    assert torch.equal(single, torch.from_numpy(x))


def test_mesh_without_a_world_is_one_rank(clean_env):
    mesh = data_parallel_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device, mesh.processes) == (1, 0, torch.device("cpu"), None)


def test_evaluator_state_dicts_round_trip(clean_env):
    from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassAccuracy
    from torcheval_tpu_torch.parallel import ShardedEvaluator

    mesh = data_parallel_mesh(device="cpu")

    def make():
        return ShardedEvaluator(
            {"acc": MulticlassAccuracy(num_classes=4, device="cpu"), "auroc": BinaryAUROC(device="cpu")},
            mesh=mesh,
        )

    rng = np.random.default_rng(3)
    s, l = rng.random((64, 4)).astype(np.float32), rng.integers(0, 4, 64)
    a = make()
    a.metrics["acc"].update(s, l)
    a.metrics["auroc"].update(s[:, 0], (l == 0).astype(np.float32))
    b = make().load_state_dicts(a.state_dicts())
    assert {k: float(v) for k, v in b.compute().items()} == {k: float(v) for k, v in a.compute().items()}
    with pytest.raises(RuntimeError, match="missing"):
        make().load_state_dicts({"acc": a.state_dicts()["acc"]})
    assert float(b.reset().compute()["auroc"]) == 0.5


# ------------------------------------------------------------ the example
def test_example_at_world_size_one_prints_the_jax_numbers(clean_env):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "torcheval_tpu_torch.examples.distributed_example", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120, check=True,
    ).stdout
    got = {k: float(v) for k, v in re.findall(r"^(accuracy|f1_macro|auroc):\s+(\S+)$", out, re.M)}
    want = jax_example_numbers()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL)
    assert "world: 1 rank(s)" in out


def test_example_stream_is_the_jax_examples():
    assert (example.NUM_BATCHES, example.BATCH_SIZE, example.NUM_CLASSES, example.SEED) == (64, 256, 4, 2023)
