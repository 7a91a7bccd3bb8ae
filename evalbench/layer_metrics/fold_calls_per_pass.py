"""The deferred members' ``_fold_fn`` calls a pass: the program's counter
``deferred.fold_calls{shape=}`` summed over shapes, over the spanned
passes (``evalbench/core/spans.py``). A stacked or concatenated fold calls
it once a member, a ragged or scanned one once a batch."""

from evalbench.core import spans


def read(run):
    s = spans.of(run)
    return None if s is None else s.fold_calls
