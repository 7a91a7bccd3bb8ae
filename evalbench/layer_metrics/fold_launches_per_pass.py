"""Launches a pass: the obs registry's ``jit.calls{entry=...}`` summed over
entries (the hand kernels' launches, the deferred window steps and group
folds, the curve and confusion entries), over the obs passes."""


def read(run):
    if run.obs_counters is None:
        return None
    total = sum(v for k, v in run.obs_counters.items() if k.startswith("jit.calls{"))
    return total / run.obs_passes if total else None
