"""Reading the obs registry's counters: the tests', the workers' and
``chip_smoke.py``'s one way to count kernel launches, sync rounds and
folds.

JAX counterpart: none; the JAX package's tests read
``obs.snapshot()["counters"]`` keys directly. The port's counts live only
in the registry (``torcheval_tpu_torch/obs/``), which records while it is
enabled: a reader enables it first (:func:`recording`), then takes
differences of :func:`count` or :func:`launches` around the code it
measures.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

from torcheval_tpu_torch import obs


def parse_key(key: str) -> Tuple[str, Dict[str, str]]:
    """``"name{k=v,...}"`` (the snapshot's key spelling) as ``(name,
    labels)``."""
    if not key.endswith("}") or "{" not in key:
        return key, {}
    name, inner = key[:-1].split("{", 1)
    return name, dict(pair.split("=", 1) for pair in inner.split(",") if pair)


def count(name: str, snapshot: Optional[dict] = None, **labels) -> float:
    """The sum of counter ``name`` over its series whose labels include
    ``labels`` (0 when none was recorded)."""
    counters = (snapshot if snapshot is not None else obs.snapshot())["counters"]
    total = 0.0
    want = {k: str(v) for k, v in labels.items()}
    for key, value in counters.items():
        n, lb = parse_key(key)
        if n == name and all(lb.get(k) == v for k, v in want.items()):
            total += value
    return total


def launches(entry: str, snapshot: Optional[dict] = None) -> int:
    """A hand kernel's launches: its ``jit.calls{entry=}``."""
    return int(count("jit.calls", snapshot, entry=entry))


def folding_window_steps(snapshot: Optional[dict] = None) -> int:
    """Window steps that folded batches (every path but ``compute``)."""
    return int(
        count("deferred.window_steps", snapshot)
        - count("deferred.window_steps", snapshot, path="compute")
    )


def rounds(snapshot: Optional[dict] = None) -> int:
    """Collective rounds through the toolkit's funnel."""
    return int(count("toolkit.sync.rounds", snapshot))


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Obs reset, then enabled inside the block; the previous enable state
    afterwards."""
    was = obs.enabled()
    obs.reset()
    obs.enable()
    try:
        yield
    finally:
        if not was:
            obs.disable()
