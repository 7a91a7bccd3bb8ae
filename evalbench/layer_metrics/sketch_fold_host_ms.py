"""The host time a pass in the score sketch's folds, in ms: the program's
``metric.fold/<Class>`` spans (``kind=score|mc_score``), each a fold of
staged rows into the resident ``(tp, fp)`` counts, from its obs ring over
the spanned passes without the profiler (``evalbench/core/spans.py``).
None where the program has no such span."""

from evalbench.core import spans

FOLD = "metric.fold/"


def read(run):
    s = spans.of(run)
    if s is None:
        return None
    folds = [ms for (own, _, _), ms in s.host_member.items() if own.startswith(FOLD)]
    return sum(folds) if folds else None
