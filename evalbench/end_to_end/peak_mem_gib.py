"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start), in GiB: the pass's inputs, which stay on the card, and the
metrics' state and work."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.peak_bytes / 2**30
