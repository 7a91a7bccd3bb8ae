"""Shared machinery of the windowed metrics: a bounded deque of per-update
rows.

JAX counterpart: ``torcheval_tpu/metrics/classification/_windowed.py``. One
place for the window's invariants, so that CTR and calibration cannot
drift apart: its registration, the empty window, the stack-and-sum split,
the merge order and the configuration a merge requires.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Tuple

import torch

from torcheval_tpu_torch.metrics.state import Reduction


class WindowedStateMixin:
    """A bounded per-update window of ``(2, num_tasks)`` stat rows.

    The host class sets ``num_tasks`` and ``enable_lifetime``, calls
    ``_init_window(window_size)``, lists its lifetime states in
    ``_LIFETIME_STATES`` and calls ``_push_window(row_a, row_b)`` from
    ``update``.
    """

    _LIFETIME_STATES: Tuple[str, ...] = ()

    def _init_window(self, window_size: int) -> None:
        if window_size < 1:
            raise ValueError(
                "`window_size` value should be greater than and equal to 1, "
                f"but received {window_size}."
            )
        self.window_size = window_size
        # WINDOW, not CAT: a sync keeps each update's row as its own window
        # entry (a CAT concat would merge a rank's updates into one), and
        # the toolkit ships each rank's rows stacked on the typed wire
        self._add_state("window", deque(maxlen=window_size), reduction=Reduction.WINDOW)

    @property
    def _sync_schema_extra(self) -> Tuple:
        """Folded into the sync's schema digest
        (``toolkit._schema_digest_row``): ranks whose replicas disagree on
        the window's configuration fail on every rank at the exchange, as
        :meth:`_merge_windowed` raises for a local merge."""
        return (self.num_tasks, self.window_size, self.enable_lifetime)

    def _push_window(self, a: torch.Tensor, b: torch.Tensor) -> None:
        self.window.append(torch.stack([a, b]))

    def _window_totals(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.window:
            zeros = torch.zeros((self.num_tasks,), dtype=torch.float32, device=self.device)
            return zeros, zeros
        stacked = torch.sum(torch.stack(list(self.window)), dim=0)
        return stacked[0], stacked[1]

    def _merge_windowed(self, metrics: Iterable) -> None:
        """Fold other replicas: lifetime states by sum, windows by extending
        this one's deque with the others' rows in order (the bound keeps the
        newest ``window_size``). Every replica is checked before any folds,
        so a mismatch raises with ``self`` unchanged."""
        metrics = list(metrics)
        for metric in metrics:
            for attr in ("num_tasks", "window_size", "enable_lifetime"):
                if getattr(self, attr) != getattr(metric, attr):
                    raise ValueError(
                        f"Cannot merge {type(self).__name__} replicas with "
                        f"different `{attr}` ({getattr(self, attr)} vs "
                        f"{getattr(metric, attr)})."
                    )
        for metric in metrics:
            if self.enable_lifetime:
                for name in self._LIFETIME_STATES:
                    setattr(self, name, getattr(self, name) + getattr(metric, name).to(self.device))
            self.window.extend(row.to(self.device) for row in metric.window)
