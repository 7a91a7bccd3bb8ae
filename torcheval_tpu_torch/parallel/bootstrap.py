"""Joining a multi-process ``torch.distributed`` world.

JAX counterpart: ``torcheval_tpu/parallel/bootstrap.py`` (``init_from_env``,
``is_initialized``, ``shutdown``). The JAX package joins with
``jax.distributed.initialize``; here :func:`init_from_env` calls
``torch.distributed.init_process_group`` with a TCP rendezvous. It reads the
same environment: ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``,
or the ``torchrun`` form ``MASTER_ADDR`` + ``MASTER_PORT``/``WORLD_SIZE``/
``RANK``, and ``LOCAL_RANK`` for the card. The backend is NCCL when the
ranks hold CUDA devices and gloo on the CPU; ranks that share one card
must ask for gloo, since NCCL refuses two ranks on one GPU. There is no
cluster auto-detection (the JAX package delegates that to JAX's probes for
TPU pods, SLURM and MPI): without a coordinator the process stays a world
of one.
"""

from __future__ import annotations

import datetime
import logging
import os
import random
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from torcheval_tpu_torch.obs import registry as _obs
from torcheval_tpu_torch.parallel.mesh import local_device
from torcheval_tpu_torch.utils import dist as _dist
from torcheval_tpu_torch.utils.devices import DeviceLike, canonical_device

_logger = logging.getLogger(__name__)

__all__ = ["init_from_env", "is_initialized", "shutdown"]

# a worker often comes up before its coordinator: bounded exponential
# backoff with jitter, so that restarted workers do not retry in lockstep
_DEFAULT_CONNECT_ATTEMPTS = 3
_CONNECT_ATTEMPTS_ENV = "TORCHEVAL_TPU_CONNECT_ATTEMPTS"
_BACKOFF_CAP_S = 30.0


def _resolve_env(environ) -> Tuple[Optional[str], Optional[int], Optional[int]]:
    """``(coordinator "host:port", world size, rank)`` from the
    environment; the ``COORDINATOR_ADDRESS`` forms win over the
    ``torchrun`` ones, and a field left unset stays None."""
    coordinator = environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        master_addr = environ.get("MASTER_ADDR")
        master_port = environ.get("MASTER_PORT")
        if (master_addr is None) != (master_port is None):
            raise ValueError(
                "init_from_env: MASTER_ADDR and MASTER_PORT must be set together "
                f"(got MASTER_ADDR={master_addr!r}, MASTER_PORT={master_port!r})"
            )
        if master_addr is not None:
            coordinator = f"{master_addr}:{master_port}"

    def _int(*names: str) -> Optional[int]:
        for name in names:
            raw = environ.get(name)
            if raw is not None:
                try:
                    return int(raw)
                except ValueError:
                    raise ValueError(f"environment variable {name}={raw!r} is not an integer") from None
        return None

    return coordinator, _int("NUM_PROCESSES", "WORLD_SIZE"), _int("PROCESS_ID", "RANK")


# True once this process has joined a ``torch.distributed`` world
is_initialized = _dist.initialized


def _reset_partial_init() -> None:
    """Leave whatever a failed attempt left behind, so the next attempt
    starts from nothing."""
    if dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:  # noqa: BLE001 - a group that never formed
            _logger.debug("init_from_env: partial group teardown failed", exc_info=True)


def init_from_env(
    *,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
    backend: Optional[str] = None,
    connect_attempts: Optional[int] = None,
    connect_backoff_s: float = 1.0,
) -> Tuple[int, int]:
    """Join (or confirm membership in) the ``torch.distributed`` world;
    returns ``(rank, world size)``.

    Keyword arguments override the environment. ``device`` is this rank's
    card, ``cuda:<LOCAL_RANK>`` by default; with a CUDA device the backend
    is NCCL and the device becomes the current one, with ``device="cpu"``
    it is gloo; ``backend`` overrides the choice. Idempotent: an
    initialised world logs and returns its coordinates. With no coordinator
    configured it stays a world of one and returns ``(0, 1)``, unless a
    world size above 1 or a nonzero rank says a launcher was only half
    configured, which raises.

    Connection failures (``RuntimeError``; configuration errors raise
    ``ValueError`` and are never retried) are retried up to
    ``connect_attempts`` times (3, or ``TORCHEVAL_TPU_CONNECT_ATTEMPTS``),
    sleeping ``connect_backoff_s`` seconds and doubling, capped at 30 s,
    each sleep jittered to 0.5-1.5x. Each retry counts one
    ``bootstrap.retries`` (obs registry, while enabled); the last failure
    re-raises."""
    if is_initialized():
        _logger.warning(
            "init_from_env: torch.distributed already initialized (rank %d of %d); "
            "ignoring the new request.",
            dist.get_rank(),
            dist.get_world_size(),
        )
        return dist.get_rank(), dist.get_world_size()

    env_coord, env_world, env_rank = _resolve_env(os.environ)
    coordinator_address = coordinator_address or env_coord
    num_processes = num_processes if num_processes is not None else env_world
    process_id = process_id if process_id is not None else env_rank

    if coordinator_address is None:
        if (num_processes or 1) > 1 or (process_id or 0) > 0:
            raise ValueError(
                "init_from_env: WORLD_SIZE/NUM_PROCESSES/RANK configured but no "
                "coordinator address (set COORDINATOR_ADDRESS or MASTER_ADDR+MASTER_PORT)"
            )
        _logger.info("init_from_env: no coordinator configured; staying single-process.")
        return 0, 1

    device = local_device() if device is None else canonical_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if connect_attempts is None:
        connect_attempts = int(os.environ.get(_CONNECT_ATTEMPTS_ENV, _DEFAULT_CONNECT_ATTEMPTS))
    if connect_attempts < 1:
        raise ValueError(f"connect_attempts must be >= 1, got {connect_attempts}.")
    kwargs = {
        "backend": backend,
        "init_method": f"tcp://{coordinator_address}",
        "world_size": 1 if num_processes is None else num_processes,
        "rank": 0 if process_id is None else process_id,
        "timeout": datetime.timedelta(minutes=10),
    }
    delay_s = connect_backoff_s
    for attempt in range(1, connect_attempts + 1):
        try:
            dist.init_process_group(**kwargs)
            break
        except RuntimeError as e:
            _reset_partial_init()
            if attempt == connect_attempts:
                _logger.error(
                    "init_from_env: coordinator connection failed after %d attempt(s); giving up.",
                    connect_attempts,
                )
                raise
            sleep_s = min(delay_s, _BACKOFF_CAP_S) * (0.5 + random.random())
            _logger.warning(
                "init_from_env: coordinator connection failed (attempt %d/%d: %s); "
                "retrying in %.1fs.",
                attempt,
                connect_attempts,
                e,
                sleep_s,
            )
            _obs.counter("bootstrap.retries")
            time.sleep(sleep_s)
            delay_s *= 2
    return kwargs["rank"], kwargs["world_size"]


def shutdown() -> None:
    """Leave the world (a no-op when not initialised)."""
    if is_initialized():
        dist.destroy_process_group()
