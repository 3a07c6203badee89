"""The allocator's peak device memory over the window, in GB."""


def read(run):
    b = run.out.get("memory_peak_bytes", 0)
    return b / 1e9 if b else None
