"""peak_mem_gb: ``torch.cuda.max_memory_allocated()`` over the measured
window, in GB (1e9 bytes): the allocator's peak is reset as the window
opens, so it is the peak of the steady rounds, which every round of a
run reaches alike; the weights' set-up stays well below it."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
