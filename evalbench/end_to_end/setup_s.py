"""From the start of ``evalbench/run.py`` to the first timed pass: imports,
CUDA start-up, the kernels' build or load, the inputs, the warm pass."""


def read(run):
    return run.setup_s
