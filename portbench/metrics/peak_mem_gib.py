"""peak_mem_gib: `torch.cuda.max_memory_allocated()` over the window, after
`reset_peak_memory_stats()` at its start, in GiB."""


def read(run):
    return None if run.peak_window_bytes is None else run.peak_window_bytes / 2**30
