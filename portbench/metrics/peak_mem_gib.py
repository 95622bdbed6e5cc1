"""GiB: `torch.cuda.max_memory_allocated()` over the window, reset at its
start. Reads `peak_mem_gib.serve` and `peak_mem_gib.train`."""


def read(run):
    if not run.peak_window_bytes:
        return None
    return run.peak_window_bytes / 2 ** 30
