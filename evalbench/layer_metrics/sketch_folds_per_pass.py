"""The score sketch's folds a pass: the program's counter
``sketch.folds{kind=}`` summed over kinds, over the harness's obs passes
(``harness.OBS_PASSES``). A cell that hands a pass's rows to one
``update()`` folds once; a change of fold cadence shows here."""

NAME = "sketch.folds"


def read(run):
    counters = run.obs_counters
    if not counters:
        return None
    found = [v for k, v in counters.items() if k == NAME or k.startswith(NAME + "{")]
    return sum(found) / run.obs_passes if found else None
