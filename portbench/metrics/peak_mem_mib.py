"""peak_mem_mib: the device memory the window's calls took at their peak
beyond what was allocated before it (inputs, tables, set-up):
torch.cuda.max_memory_allocated() over the window less
memory_allocated() just before it."""


def read(w):
    return w.peak_bytes / 2 ** 20 if w.peak_bytes > 0 else None
