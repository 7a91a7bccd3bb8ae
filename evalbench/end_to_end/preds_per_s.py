"""Rows of every pass completed in the window, over the window's seconds."""


def read(run):
    return run.passes * run.rows_per_pass / run.window_s
