"""The device memory the allocator held at most over the window
(`torch.cuda.max_memory_allocated`, reset at the window's start), in GiB."""


def read(run):
    if run["peak_bytes"] <= 0:
        return None
    return run["peak_bytes"] / 2 ** 30
