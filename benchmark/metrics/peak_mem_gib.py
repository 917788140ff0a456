"""The card's peak of allocated memory over the warm-up and the window
(``torch.cuda.max_memory_allocated``, reset after the weights are written),
read before any reference work, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
