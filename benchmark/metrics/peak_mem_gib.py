"""The device memory allocated at its peak in the window
(``torch.cuda.max_memory_allocated``, reset after the warm-up)."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
